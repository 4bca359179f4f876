"""Kernel G's CPU side (raw_image_pipeline_tpu_torch/ops/pointwise.py): its
plain version against the JAX package's stage functions on the same seeded
planes, the HSV2BGR fma domain that lets G use the card's fma, the chain's
choice of G's steps, and the wrapper's and binding's bookkeeping. G itself
runs only on a card (tests/test_torch_gpu_path.py, chip_smoke.py)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu.ops import ccc as jccc
from raw_image_pipeline_tpu.ops import color_calibration as jcc
from raw_image_pipeline_tpu.ops import color_enhancer as jce
from raw_image_pipeline_tpu.ops import gamma as jgamma
from raw_image_pipeline_tpu.ops import vignetting as jvig
from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch import pipeline as ppipe
from raw_image_pipeline_tpu_torch.ops import color_enhancer as pce
from raw_image_pipeline_tpu_torch.ops import colorspace as pcs
from raw_image_pipeline_tpu_torch.ops import common as pcommon
from raw_image_pipeline_tpu_torch.ops import gamma as pgamma
from raw_image_pipeline_tpu_torch.ops import pointwise as ppw
from raw_image_pipeline_tpu_torch.ops import vignetting as pvig
from raw_image_pipeline_tpu_torch.tools import workloads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((2, 17, 31), (2, 24, 45))  # W < 32 (all scalar columns); W % 32 != 0
K = 0.9  # the flagship's gamma
ENHANCER_GAINS = (1.1, 1.2, 0.9)


def _inputs(shape, seed):
    """Seeded planes and every step's arguments, numpy."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    planes = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(3)]
    return planes, dict(
        gains=rng.uniform(0.6, 2.4, (b, 3)).astype(np.float32),
        matrix=rng.uniform(-0.6, 1.6, (3, 3)).astype(np.float32),
        bias=rng.uniform(-20, 20, 3).astype(np.float32),
        mask=jvig.build_vignetting_mask(h, w, 1.5, 1e-3, 1e-6),
    )


def _jax_steps(planes, steps, a):
    """The JAX package's stage functions for `steps`, as its pipeline runs
    them: the k gamma by its poly formula and corrections, the BT.709 table
    by its formula and corrections, the folded gamma by
    composed_gamma_lab_fn, the enhancer's f32 gains with gain_corrections."""
    coeffs, root = jgamma.gamma_poly_coeffs(K)
    for step in steps:
        if step == "gains":
            planes = jccc.apply_gains_planes(planes, a["gains"])
        elif step == "calibration":
            planes = jcc.color_correct_planes(*planes, a["matrix"], a["bias"])
        elif step == "lut_k":
            idx, val = jgamma.gamma_corrections_poly(K, coeffs, root)
            planes = [jgamma.gamma_apply_poly(p, coeffs, idx, val, root=root) for p in planes]
        elif step == "lut_bt709":
            idx, val = jgamma.bt709_corrections(True)
            planes = [jgamma.gamma_apply_bt709(p, True, idx, val) for p in planes]
        elif step == "vignetting":
            planes = jvig.correct_planes(*planes, a["mask"])
        elif step == "gamma_vignetting":
            idx, val = jvig.composed_gamma_corrections(K, coeffs, root, jgamma.GAMMA_MAX_CORR)
            fn = jvig.composed_gamma_lab_fn(jnp.asarray(coeffs), idx, val, root)
            planes = jvig.correct_planes(*planes, a["mask"], gamma_fn=fn)
        elif step == "enhancer":
            planes = jce.enhance_planes(*planes, jnp.asarray(ENHANCER_GAINS, jnp.float32),
                                        corr=jce.gain_corrections(ENHANCER_GAINS))
    return [np.asarray(p) for p in planes]


def _port_args(steps, a):
    t = torch.as_tensor
    args = {}
    for step in steps:
        if step == "gains":
            args["gains"] = t(a["gains"])
        elif step == "calibration":
            args.update(matrix=t(a["matrix"]), bias=t(a["bias"]))
        elif step == "lut_k":
            args["lut"] = t(pgamma.build_gamma_lut(K))
        elif step == "lut_bt709":
            args["lut"] = t(pgamma.build_bt709_lut(True))
        elif step == "vignetting":
            args["mask"] = t(a["mask"])
        elif step == "gamma_vignetting":
            args.update(mask=t(a["mask"]), lab_tab=t(pvig.composed_gamma_lab_table(K)))
        elif step == "enhancer":
            args["enhancer_tables"] = t(pce.gain_tables(ENHANCER_GAINS))
    return args


STEP_SETS = {
    "flagship": ("gains", "calibration", "gamma_vignetting", "enhancer"),
    "gpu_parity": ("gains", "calibration", "lut_bt709", "vignetting", "enhancer"),
    "config4": ("calibration", "vignetting", "enhancer"),
    **{s: (s,) for s in ("gains", "calibration", "lut_k", "lut_bt709", "vignetting",
                         "gamma_vignetting", "enhancer")},
}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", list(STEP_SETS))
def test_plain_equals_reference(name, shape):
    steps = STEP_SETS[name]
    planes, a = _inputs(shape, seed=sum(shape) + len(name))
    want = _jax_steps(planes, steps, a)
    got = ppw.pointwise_planes(*map(torch.as_tensor, planes), plain=True,
                               **_port_args(steps, a))
    for x, y in zip(got, want):
        assert x.dtype == torch.uint8
        np.testing.assert_array_equal(x.numpy(), y)
    # on CPU planes the wrapper is the plain version and launches nothing
    before = kernels.POINTWISE.launches
    again = ppw.pointwise_planes(*map(torch.as_tensor, planes), **_port_args(steps, a))
    assert kernels.POINTWISE.launches == before
    for x, y in zip(again, got):
        assert torch.equal(x, y)


def _hsv_operands():
    """HSV2BGR's s and ff, f32, over their whole domains: s = f32(u8 * f32(1/255))
    and ff = hf - floor(hf), hf = f32(u8 * f32(6/180)), as ops/colorspace forms
    them from the gain tables' u8 outputs."""
    u = np.arange(256, dtype=np.float32)
    s = (u * np.float32(1.0 / 255.0)).astype(np.float32)
    hf = (u * np.float32(6.0 / 180.0)).astype(np.float32)
    ff = (hf - np.floor(hf)).astype(np.float32)
    return s, ff


@pytest.mark.parametrize("second", ["ff", "one_minus_ff"])
def test_hsv_fma_emulation_is_a_true_fma_on_its_domain(second):
    """fma_f32(-s, f, 1) (Dekker's emulation) against the exact rational
    1 - s*f rounded once to f32, over all 65 536 (s, f) pairs, f = ff or
    rn(1 - ff): 0 differences, so kernel G's __fmaf_rn gives the plain
    version's bytes. The exact value is formed in numpy's long double: s
    and f are multiples of 2^-32 in [0, 1], so 1 - s*f is a multiple of
    2^-64 in [0, 1], held exactly by its 64-bit (x86) or 113-bit
    significand."""
    assert np.finfo(np.longdouble).nmant >= 63
    s, ff = _hsv_operands()
    f = ff if second == "ff" else (np.float32(1.0) - ff).astype(np.float32)
    assert np.all(s * np.float64(2.0**32) == np.round(s * np.float64(2.0**32)))
    assert np.all(f * np.float64(2.0**32) == np.round(f * np.float64(2.0**32)))
    ss, fs = (x.ravel() for x in np.meshgrid(s, f, indexing="ij"))
    exact = np.longdouble(1) - ss.astype(np.longdouble) * fs.astype(np.longdouble)
    want = exact.astype(np.float32)
    got = pcommon.fma_f32(-torch.as_tensor(ss), torch.as_tensor(fs), 1.0).numpy()
    assert got.shape == (65536,)
    assert int((got.view(np.uint32) != want.view(np.uint32)).sum()) == 0


# --- the chain's choice of G's steps -----------------------------------------

CHAINS = workloads.chains(tp)
STAGE_OF = {  # the plain stage function each step ran as before kernel G
    "gains": "apply_gains_planes", "calibration": "color_correct_planes",
    "lut": "apply_lut", "vignetting": "correct_planes",
    "gamma_vignetting": "correct_planes(composed)", "enhancer": "enhance_planes",
}
# the stages the chain ran before G, per configuration (the former chain's
# conditions: CCC gains in the white balance, the k gamma folded into
# vignetting unless BT.709 or debug, nothing of it on mono frames but the
# gamma table)
BEFORE = {
    "flagship": ("apply_gains_planes", "color_correct_planes", "correct_planes(composed)",
                 "enhance_planes"),
    "gpu_parity": ("apply_gains_planes", "color_correct_planes", "apply_lut", "correct_planes",
                   "enhance_planes"),
    "pointwise_bgr8": ("color_correct_planes", "correct_planes", "enhance_planes"),
    "wb_grey_world": (),
    "wb_pca": (),
    "mono8_float": (),
    "flagship_debug": ("apply_gains_planes", "color_correct_planes", "apply_lut",
                       "correct_planes", "enhance_planes"),
}


def _case(name):
    chain = CHAINS[name.replace("_debug", "")]
    return chain, chain.config(48, 64), chain.kind != "mono", name.endswith("_debug")


@pytest.mark.parametrize("name", list(BEFORE))
def test_pointwise_steps_are_the_stages_the_chain_ran(name, monkeypatch):
    chain, config, is_color, debug = _case(name)
    steps = ppipe.pointwise_steps(config, is_color, debug)
    assert tuple(STAGE_OF[s] for s in steps) == BEFORE[name]
    on_card = ppipe.pointwise_launches(config, is_color, debug)
    assert on_card == ((tuple(steps),) if steps and not debug else tuple((s,) for s in steps))
    assert ppipe.pointwise_launches(config, is_color, debug, on_card=False) == tuple(
        (s,) for s in steps)
    # the plain chain on the CPU calls those stage functions, in that order
    ran = []

    def record(label, fn):
        def wrapped(*args, **kw):
            ran.append(label(*args, **kw) if callable(label) else label)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ppw, "apply_gains_planes",
                        record("apply_gains_planes", ppw.apply_gains_planes))
    monkeypatch.setattr(ppw, "color_correct_planes",
                        record("color_correct_planes", ppw.color_correct_planes))
    monkeypatch.setattr(ppw, "enhance_planes", record("enhance_planes", ppw.enhance_planes))
    monkeypatch.setattr(ppw, "correct_planes", record(
        lambda *a, gamma_tab=None: "correct_planes" + ("(composed)" if gamma_tab is not None
                                                       else ""), ppw.correct_planes))
    monkeypatch.setattr(ppw, "apply_lut", record("apply_lut", ppw.apply_lut))
    pipe = tp.build_pipeline(config, chain.encoding, frame_hw=(48, 64), with_state=True,
                             temporal_mode="sequence", device="cpu", debug=debug)
    frames = workloads.card_frames(torch, "color" if chain.kind == "color" else "bayer", 1, 48,
                                   64, 5, device="cpu")
    if chain.kind == "mono":
        frames = frames[..., 0] if frames.dim() == 4 else frames
    pipe(frames, tp.init_state((), device="cpu"))
    # apply_lut runs three times a LUT step, once a plane
    got = [r for i, r in enumerate(ran) if r != "apply_lut" or ran[i - 1:i] != ["apply_lut"]]
    assert tuple(got) == BEFORE[name]


# --- the wrapper and the binding ---------------------------------------------


def test_wrapper_bookkeeping():
    planes = tuple(torch.zeros((1, 2, 3), dtype=torch.uint8) for _ in range(3))
    assert ppw.pointwise_planes(*planes) == planes  # no step: the planes as they are
    with pytest.raises(ValueError, match="matrix and bias"):
        ppw.pointwise_planes(*planes, matrix=torch.eye(3))
    with pytest.raises(ValueError, match="needs a mask"):
        ppw.pointwise_planes(*planes, lab_tab=torch.zeros(256, dtype=torch.int32))
    # on CPU tensors the kernel's wrapper refuses: the card or nothing
    with pytest.raises(ValueError, match="CUDA"):
        ppw.pointwise_cuda(planes, lut=torch.arange(256, dtype=torch.uint8))


def test_const_tables_match_the_kernels_layout():
    src = open(os.path.join(REPO, kernels.POINTWISE.source)).read()
    offsets = {k: int(v) for k, v in re.findall(r"\b(k[A-Z]\w*) = (\d+)", src)}
    sizes = (("kSdiv", 256), ("kHdiv", 256), ("kCbrt", 3072), ("kY", 256), ("kIfy", 256),
             ("kInvGamma", 8192), ("kLabCoef", 9), ("kLab2Coef", 9))
    at = 0
    for name, size in sizes:
        assert offsets[name] == at, name
        at += size
    assert offsets["kConstTables"] == at == ppw.const_tables().size
    t = ppw.const_tables()
    np.testing.assert_array_equal(t[offsets["kCbrt"]:offsets["kY"]], pcs._CBRT_TAB)
    np.testing.assert_array_equal(t[offsets["kLab2Coef"]:], np.ravel(pcs._LAB2_COEF))
    assert offsets["kFrames"] == ppw.FRAMES_PER_TASK
    assert int(re.search(r"kSimdPx = (\d+)", src).group(1)) == pce.CV_SIMD_PX


def test_kernel_g_is_bound():
    k = kernels.POINTWISE
    assert k in kernels.ALL and k.entry in kernels._SIGNATURES
    assert len(kernels._SIGNATURES[k.entry]) == 24
    assert "pointwise.cu" in kernels.SOURCES
    assert os.path.exists(os.path.join(REPO, k.source))
    for site in k.replaces.split("; "):
        path, rest = site.split(":")
        line, fn = rest.split(" ")
        with open(os.path.join(REPO, path)) as f:
            assert f.readlines()[int(line) - 1].startswith(f"def {fn}("), site


def test_op_layer_keeps_the_reference_positions():
    img = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 9, 40, 3),
                                                            dtype=np.uint8))
    m, bias = np.eye(3, dtype=np.float32) * 1.1, np.zeros(3, np.float32)
    mask = pvig.build_vignetting_mask(9, 40, 1.5, 1e-3, 1e-6)
    from raw_image_pipeline_tpu_torch.ops import color_calibration as pcc

    for fn, args in ((pcc.color_correct, (m, bias)), (pvig.correct, (mask,)),
                     (pce.enhance, (ENHANCER_GAINS,))):
        assert torch.equal(fn(img, *args), fn(img, *args, plain=True))
        with pytest.raises(TypeError):
            fn(img, *args, True)  # plain is keyword-only


def test_pointwise_bgr8_chain_config_is_config4():
    c = CHAINS["pointwise_bgr8"].config(48, 64)
    assert c.color_calibration.enabled and c.vignetting_correction.enabled
    assert ppipe.pointwise_steps(c, True, False) == ("calibration", "vignetting", "enhancer")
