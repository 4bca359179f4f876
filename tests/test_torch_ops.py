"""Parity of the PyTorch port's operators (raw_image_pipeline_tpu_torch.ops)
with the JAX package on the CPU: the same seeded numpy inputs through the
JAX function and its port, equal bytes. Also holds every host table and
host-side function the port copied equal to its original, and kernel A
against its plain version on a CUDA card (skipped without one)."""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu import config as jcfg
from raw_image_pipeline_tpu.ops import color_calibration as jcc
from raw_image_pipeline_tpu.ops import color_enhancer as jce
from raw_image_pipeline_tpu.ops import colorspace as jcs
from raw_image_pipeline_tpu.ops import common as jcommon
from raw_image_pipeline_tpu.ops import debayer as jdeb
from raw_image_pipeline_tpu.ops import flip as jflip
from raw_image_pipeline_tpu.ops import gamma as jgamma
from raw_image_pipeline_tpu.ops import resize as jresize
from raw_image_pipeline_tpu.ops import undistortion as jund
from raw_image_pipeline_tpu.ops import vignetting as jvig
from raw_image_pipeline_tpu.ops.debayer_pallas import debayer_bilinear_pallas
from raw_image_pipeline_tpu_torch import config as pcfg
from raw_image_pipeline_tpu_torch.ops import color_calibration as pcc
from raw_image_pipeline_tpu_torch.ops import color_enhancer as pce
from raw_image_pipeline_tpu_torch.ops import colorspace as pcs
from raw_image_pipeline_tpu_torch.ops import common as pcommon
from raw_image_pipeline_tpu_torch.ops import debayer as pdeb
from raw_image_pipeline_tpu_torch.ops import flip as pflip
from raw_image_pipeline_tpu_torch.ops import gamma as pgamma
from raw_image_pipeline_tpu_torch.ops import resize as presize
from raw_image_pipeline_tpu_torch.ops import undistortion as pund
from raw_image_pipeline_tpu_torch.ops import vignetting as pvig
from raw_image_pipeline_tpu_torch.tools import gpu_parity_check as gpc

PHASES = ("rggb", "grbg", "gbrg", "bggr")


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _planes(rng, shape):
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(3)]


def _all_triples(chunk: int, index: int):
    """Chunk `index` of all 2^24 (b, g, r) u8 triples, as three planes."""
    v = np.arange(index * chunk, (index + 1) * chunk, dtype=np.uint32)
    return [((v >> s) & 255).astype(np.uint8) for s in (0, 8, 16)]


# --- config and flagship ---------------------------------------------------


def test_flagship_config_equals_graft_entry():
    from __graft_entry__ import _full_config

    for h, w in ((1080, 1920), (1080, 1440), (91, 117)):
        assert dataclasses.asdict(pcfg.flagship_config(h, w)) == dataclasses.asdict(
            _full_config((h, w))
        )


def test_config_loaders_equal_reference():
    params = jcfg.DEFAULT_PARAMS_PATH
    calib = jcfg.DEFAULT_CALIBRATION_PATH
    color = jcfg.DEFAULT_COLOR_CALIBRATION_PATH
    assert pcfg.DEFAULT_CCC_MODEL_PATH == jcfg.DEFAULT_CCC_MODEL_PATH
    assert dataclasses.asdict(pcfg.load_pipeline_params(params)) == dataclasses.asdict(
        jcfg.load_pipeline_params(params)
    )
    assert dataclasses.asdict(pcfg.load_camera_calibration(calib)) == dataclasses.asdict(
        jcfg.load_camera_calibration(calib)
    )
    assert dataclasses.asdict(pcfg.load_color_calibration(color)) == dataclasses.asdict(
        jcfg.load_color_calibration(color)
    )
    # missing files fall back exactly like the reference loader
    assert pcfg.load_camera_calibration("/nonexistent.yaml") == pcfg.CameraCalibration(
        calibration_available=False
    )


# --- common ----------------------------------------------------------------


def test_fma_and_round_equal_reference():
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(1 << 16).astype(np.float32) * s for s in (3, 7, 100))
    want = np.asarray(jcommon.fma_f32(a, b, c))
    got = pcommon.fma_f32(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c))
    np.testing.assert_array_equal(_np(got), want)
    # single rounding: equal to the f64 product-sum narrowed
    exact = (a.astype(np.float64) * b + c).astype(np.float32)
    assert np.mean(_np(got) == exact) > 0.9999
    x = np.concatenate([np.arange(-3, 260, 0.5), rng.uniform(-10, 300, 4096)]).astype(np.float32)
    np.testing.assert_array_equal(
        _np(pcommon.round_u8(torch.as_tensor(x))), np.asarray(jcommon.round_u8(x))
    )


# --- flip ------------------------------------------------------------------


@pytest.mark.parametrize("angle", [0, 90, 180, 270, 45])
def test_flip_equals_reference(angle):
    img = np.random.default_rng(angle).integers(0, 256, (2, 5, 7), dtype=np.uint8)
    got = pflip.flip(torch.as_tensor(img), angle, spatial_axes=(-2, -1))
    want = jflip.flip(img, angle, spatial_axes=(-2, -1))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    for enc in pdeb.BAYER_ENCODINGS + ("bayer_gbrg16", "rgb8"):
        assert pflip.flipped_bayer_encoding(enc, angle) == jflip.flipped_bayer_encoding(enc, angle)


# --- debayer (kernel A's plain version) ------------------------------------


# then the widths at which kernels A and D change strip width V (8 at 1080,
# 4 at 36, 1 at 17 after a strip of 2), few rows each; last, a height and a
# width of 2, where cv's border replication swaps the stencil's two rows
# (columns)
@pytest.mark.parametrize("hw", [(16, 24), (17, 23), (3, 3), (4, 9), (31, 30),
                                (4, 1080), (4, 36), (5, 17), (2, 8), (8, 2)])
def test_debayer_equals_reference(hw):
    rng = np.random.default_rng(sum(hw))
    bayer = rng.integers(0, 256, (2,) + hw, dtype=np.uint8)
    for phase in PHASES:
        got = pdeb.debayer_bilinear_planar(torch.as_tensor(bayer), phase)  # [B, 3, H, W]
        want = np.asarray(jdeb.debayer_bilinear(bayer, phase))  # [B, H, W, 3]
        np.testing.assert_array_equal(np.moveaxis(_np(got), 1, -1), want)


def test_debayer_equals_pallas_kernel_interpret():
    bayer = np.random.default_rng(5).integers(0, 256, (2, 16, 24), dtype=np.uint8)
    for phase in PHASES:
        want = np.asarray(debayer_bilinear_pallas(bayer, phase, interpret=True))
        got = pdeb.debayer_bilinear_planar(torch.as_tensor(bayer), phase)
        np.testing.assert_array_equal(_np(got), want)


def test_debayer_planes_by_encoding():
    bayer = np.random.default_rng(6).integers(0, 256, (3, 12, 10), dtype=np.uint8)
    for enc in pdeb.BAYER_ENCODINGS:
        got = pdeb.debayer_planes(torch.as_tensor(bayer), enc)
        want = jdeb.debayer_planes(bayer, enc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    with pytest.raises(NotImplementedError):
        pdeb.debayer_planes(torch.as_tensor(bayer), "bayer_gbrg16")


def test_kernel_phase_tables_match_phase_kinds():
    # kernels A and D are instantiated for the four packed tables named in
    # csrc/debayer_strip.cuh, in phase order; the wrapper passes phase_kinds
    src = open(os.path.join(os.path.dirname(pdeb.__file__), "..", "csrc",
                            "debayer_strip.cuh")).read()
    names = dict(re.findall(r"kKinds(\w+) = (0x[0-9A-F]+)", src))
    assert {p: int(names[p.upper()], 16) for p in PHASES} == {p: pdeb.phase_kinds(p)
                                                               for p in PHASES}


def test_phase_kinds_match_site_masks():
    # kernel A's packed phase table says the same as the plain masks
    for phase in PHASES:
        masks = pdeb._site_masks(2, 2, phase, "cpu")
        kinds = pdeb.phase_kinds(phase)
        for cell in range(4):
            kind = (kinds >> (2 * cell)) & 3
            assert bool(masks[kind][cell // 2, cell % 2])


# width -> strip width V at 16-byte-aligned pointers, at an input 8 bytes
# past one, and at an input 1 byte past one
_STRIP_WIDTHS = {1920: (16, 8, 1), 1440: (16, 8, 1), 1080: (8, 8, 1), 36: (4, 4, 1),
                 17: (1, 1, 1), 5: (1, 1, 1), 3: (1, 1, 1)}


@pytest.mark.parametrize("offset", [0, 8, 1])
def test_strip_width(offset):
    # kernels A's and D's V divides the width and both addresses; the
    # output's address counts as the input's does
    k = (0, 8, 1).index(offset)
    for w, want in _STRIP_WIDTHS.items():
        assert pdeb.strip_width(w, 4096 + offset, 8192) == want[k], w
        assert pdeb.strip_width(w, 4096, 8192 + offset) == want[k], w
    assert pdeb.strip_width(1920, 4096 + 4, 8192) == 4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_debayer_cases(hw, dev):
    """Kernels A's and D's inputs on the card at hw: B=2, B=1, and the
    batch slice frames[1:] (its data_ptr() offset by a frame); and at
    1080x1920, views 1 and 8 bytes past a 16-byte boundary."""
    bayer = torch.as_tensor(
        np.random.default_rng(1).integers(0, 256, (3,) + hw, dtype=np.uint8), device=dev
    )
    cases = [bayer[:2], bayer[:1], bayer[1:]]
    if hw == (1080, 1920):
        flat = torch.as_tensor(np.random.default_rng(2).integers(0, 256, 16 + 2 * 1080 * 1920,
                                                                 dtype=np.uint8), device=dev)
        cases += [flat[off:off + 2 * 1080 * 1920].view(2, 1080, 1920) for off in (1, 8)]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(1080, 1920), (1920, 1080), (1080, 1444), (1079, 1439), (3, 5),
                                (3, 3), (2, 1920), (1080, 2), (2, 2)])
def test_kernel_a_equals_plain_on_card(hw):
    dev = _cuda()
    for bayer in card_debayer_cases(hw, dev):
        for phase in PHASES:
            got = pdeb.debayer_bilinear_cuda(bayer, phase)
            assert torch.equal(got, pdeb.debayer_bilinear_planar(bayer, phase))


# --- resize ----------------------------------------------------------------


@pytest.mark.parametrize("src", [(1080, 1920), (1080, 1440), (96, 128), (91, 117), (540, 720)])
def test_resize_tables_equal_reference(src):
    h, w = src
    for a, b in zip(presize._tables_x(w, 360), jresize._tables_x(w, 360)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(presize._tables_y(h, 270), jresize._tables_y(h, 270)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src", [(96, 128), (91, 117), (540, 720), (300, 401)])
def test_resize_equals_reference(src):
    img = np.random.default_rng(src[0]).integers(0, 256, (2,) + src, dtype=np.uint8)
    got = presize.resize_linear_u8_plane(torch.as_tensor(img), 270, 360)
    want = jresize.resize_linear_u8_plane(img, 270, 360)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# --- colour calibration ----------------------------------------------------


def test_color_calibration_equals_reference():
    rng = np.random.default_rng(7)
    b, g, r = _planes(rng, (2, 64, 96))
    for _ in range(6):
        m = rng.uniform(-0.6, 1.6, (3, 3)).astype(np.float32)
        bias = rng.uniform(-20, 20, 3).astype(np.float32)
        got = pcc.color_correct_planes(*map(torch.as_tensor, (b, g, r)),
                                       torch.as_tensor(m), torch.as_tensor(bias))
        want = jcc.color_correct_planes(b, g, r, m, bias)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(_np(x), np.asarray(y))


# --- gamma -----------------------------------------------------------------


@pytest.mark.parametrize("k", [0.9, 0.8, 0.45, 1.7])
def test_gamma_lut_equals_reference(k):
    lut = pgamma.build_gamma_lut(k)
    np.testing.assert_array_equal(lut, jgamma.build_gamma_lut(k))
    # the reference package's poly-served device formula lands on the table
    coeffs, root = jgamma.gamma_poly_coeffs(k)
    idx, val = jgamma.gamma_corrections_poly(k, coeffs, root)
    x = np.arange(256, dtype=np.uint8)
    want = jgamma.gamma_apply_poly(x, coeffs, idx, val, root=root)
    got = pgamma.apply_lut(torch.as_tensor(x), torch.as_tensor(lut))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# --- colour spaces ---------------------------------------------------------


def test_colorspace_host_tables_equal_reference():
    for name in ("_SDIV_TAB", "_HDIV_TAB", "_GAMMA_TAB", "_CBRT_TAB", "_LAB_COEF",
                 "_LAB2_Y_TAB", "_LAB2_IFY_TAB"):
        np.testing.assert_array_equal(getattr(pcs, name), getattr(jcs, name), err_msg=name)
    np.testing.assert_array_equal(pcs._LAB2_INV_GAMMA_TAB, jcs._lab2_inv_gamma_table())
    assert pcs._LAB2_COEF == jcs._LAB2_COEF
    bits = np.random.default_rng(8).integers(0, 1 << 32, 1 << 16, dtype=np.uint64)
    bits = bits.astype(np.uint32)
    np.testing.assert_array_equal(pcs._softfloat_cbrt_f32(bits), jcs._softfloat_cbrt_f32(bits))


# every u8 triple, in chunks (each chunk also runs jitted on the JAX side);
# each chunk's port outputs also hash to the digest tools/gpu_parity_check.py
# holds the card to, over the same chunks
_CHUNK = 1 << 22
assert _CHUNK == gpc.CHUNK


@pytest.mark.parametrize("index", range((1 << 24) // _CHUNK))
def test_lab_roundtrip_all_triples_equal_reference(index):
    b, g, r = _all_triples(_CHUNK, index)
    fwd = pcs.bgr_to_lab_planes(*map(torch.as_tensor, (b, g, r)))
    want = jax.jit(jcs.bgr_to_lab_planes)(b, g, r)
    for x, y in zip(fwd, want):
        np.testing.assert_array_equal(_np(x), np.asarray(y))
    assert gpc.planes_digest(fwd) == gpc.DIGESTS["bgr_to_lab"][index]
    # the inverse, on every (L, a, b) triple
    inv = pcs.lab_to_bgr_planes(*map(torch.as_tensor, (b, g, r)))
    want = jax.jit(jcs.lab_to_bgr_planes)(b, g, r)
    for x, y in zip(inv, want):
        np.testing.assert_array_equal(_np(x), np.asarray(y))
    assert gpc.planes_digest(inv) == gpc.DIGESTS["lab_to_bgr"][index]


@pytest.mark.parametrize("index", range((1 << 24) // _CHUNK))
def test_hsv_all_triples_equal_reference(index):
    b, g, r = _all_triples(_CHUNK, index)
    fwd = pcs.bgr_to_hsv_planes(*map(torch.as_tensor, (b, g, r)))
    want = jax.jit(jcs.bgr_to_hsv_planes)(b, g, r)
    for x, y in zip(fwd, want):
        np.testing.assert_array_equal(_np(x), np.asarray(y))
    assert gpc.planes_digest(fwd) == gpc.DIGESTS["bgr_to_hsv"][index]
    # HSV->BGR in both of cv2's row kernels, on every (h, s, v) triple
    h = (b.astype(np.int32) * 180 // 256).astype(np.uint8)  # h spans [0, 180)
    for port, ref, name in ((pcs.hsv_to_bgr_planes, jcs.hsv_to_bgr_planes, "hsv_to_bgr"),
                            (pcs.hsv_to_bgr_planes_scalar, jcs.hsv_to_bgr_planes_scalar,
                             "hsv_to_bgr_scalar")):
        for hh, suffix in ((h, ""), (b, "_any_h")):  # also h >= 180: cv2 wraps by sector % 6
            got = port(*map(torch.as_tensor, (hh, g, r)))
            want = jax.jit(ref)(hh, g, r)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(_np(x), np.asarray(y))
            assert gpc.planes_digest(got) == gpc.DIGESTS[name + suffix][index]


# --- vignetting ------------------------------------------------------------


def test_vignetting_equals_reference():
    for hw in ((96, 128), (91, 117)):
        np.testing.assert_array_equal(
            pvig.build_vignetting_mask(*hw, 1.5, 1e-3, 1e-6),
            jvig.build_vignetting_mask(*hw, 1.5, 1e-3, 1e-6),
        )
    for k in (0.9, 0.8, 1.3):
        np.testing.assert_array_equal(pvig.composed_gamma_lab_table(k),
                                      jvig.composed_gamma_lab_table(k))
    rng = np.random.default_rng(9)
    b, g, r = _planes(rng, (2, 48, 40))
    mask = jvig.build_vignetting_mask(48, 40, 1.5, 1e-3, 1e-6)
    got = pvig.correct_planes(*map(torch.as_tensor, (b, g, r)), torch.as_tensor(mask))
    want = jvig.correct_planes(b, g, r, mask)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(_np(x), np.asarray(y))
    # gamma composed into the linearize table == gamma stage, then vignetting
    lut = pgamma.build_gamma_lut(0.9)
    comp = torch.as_tensor(pvig.composed_gamma_lab_table(0.9))
    got = pvig.correct_planes(*map(torch.as_tensor, (b, g, r)), torch.as_tensor(mask), comp)
    want = jvig.correct_planes(lut[b], lut[g], lut[r], mask)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(_np(x), np.asarray(y))


# --- colour enhancer -------------------------------------------------------


@pytest.mark.parametrize("gains", [(1.0, 1.2, 1.0), (1.0, 1.5, 1.0), (0.7, 2.3, 1.37)])
def test_enhancer_gain_tables_equal_reference(gains):
    # the reference's f32 multiply + corrections lands on the exact f64 table
    idx, val = jce.gain_corrections(gains)
    i = np.arange(256, dtype=np.uint8)
    tabs = pce.gain_tables(gains)
    for c, g in enumerate(gains):
        want = jce._apply_gain_corr(
            i, jcommon.round_u8(i.astype(np.float32) * np.float32(g)), idx[c], val[c]
        )
        np.testing.assert_array_equal(tabs[c], np.asarray(want))


@pytest.mark.parametrize("w", [64, 45, 20])
def test_enhancer_equals_reference(w):
    gains = (1.0, 1.2, 1.0)
    rng = np.random.default_rng(w)
    b, g, r = _planes(rng, (2, 8, w))
    idx, val = jce.gain_corrections(gains)
    want = jce.enhance_planes(b, g, r, jnp.asarray(gains, jnp.float32), corr=(idx, val))
    got = pce.enhance_planes(*map(torch.as_tensor, (b, g, r)),
                             torch.as_tensor(pce.gain_tables(gains)))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(_np(x), np.asarray(y))


# --- undistortion ----------------------------------------------------------


def _flagship_maps(h, w, mod):
    calib = pcfg.flagship_config(h, w).calibration
    size = (w, h)
    new_K = mod.estimate_new_camera_matrix(calib.K(), calib.D(), size, calib.R(), 0.0, size, 1.0)
    return new_K, mod.init_undistort_rectify_map(calib.K(), calib.D(), calib.R(), new_K, size)


@pytest.mark.parametrize("hw", [(96, 128), (91, 117), (540, 720)])
def test_fisheye_init_and_precompute_equal_reference(hw):
    pk, (pmx, pmy) = _flagship_maps(*hw, pund)
    jk, (jmx, jmy) = _flagship_maps(*hw, jund)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pmx, jmx)
    np.testing.assert_array_equal(pmy, jmy)
    for mode in ("lerp", "fixed32", "float"):
        for a, b in zip(pund.remap_precompute(pmx, pmy, hw, mode=mode),
                        jund.remap_precompute(jmx, jmy, hw, mode=mode)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(96, 128), (91, 117)])
def test_remap_lerp_equals_reference(hw):
    _, (mx, my) = _flagship_maps(*hw, jund)
    # a hostile map too: far out-of-image and border-straddling taps
    rng = np.random.default_rng(10)
    hx = rng.uniform(-3, hw[1] + 2, mx.shape).astype(np.float32)
    hy = rng.uniform(-3, hw[0] + 2, my.shape).astype(np.float32)
    img = rng.integers(0, 256, (2,) + hw + (3,), dtype=np.uint8)
    for map_x, map_y in ((mx, my), (hx, hy)):
        base, weights = jund.remap_precompute(map_x, map_y, hw, mode="lerp")
        want = jund.remap_bilinear_u8(img, base, weights, hw, mode="lerp")
        planes = [torch.as_tensor(img[..., c]) for c in range(3)]
        got = pund.remap_lerp_planes(planes, torch.as_tensor(base),
                                     torch.as_tensor(weights), hw)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
