"""The reference package's entry points that reach kernels A-E, on the
CPU through the kernels' plain versions: debayer (A, D), the image-level
log-chroma histograms (B), ccc_response (C) and the remaps (E in float
mode), each against the JAX function on the same seeded inputs at every
leading shape and size of util_op_layer: 0 mismatching bytes or equal f32
bits, but for ccc_response (f32 sums in another order than XLA:CPU's,
held as tests/test_torch_ccc.py holds it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from util_op_layer import CASE_IDS, CASES, F32, LEAD_IDS, LEADS, assert_equal, image, to_np

from raw_image_pipeline_tpu.config import DEFAULT_CCC_MODEL_PATH
from raw_image_pipeline_tpu.models import ccc_model as jmodel
from raw_image_pipeline_tpu.ops import ccc as jccc
from raw_image_pipeline_tpu.ops import debayer as jdeb
from raw_image_pipeline_tpu.ops import undistortion as jund
from raw_image_pipeline_tpu_torch.ops import ccc as pccc
from raw_image_pipeline_tpu_torch.ops import debayer as pdeb
from raw_image_pipeline_tpu_torch.ops import undistortion as pund

BRIGHT, DARK, UV0 = 0.9, 0.1, jccc.UV0


@pytest.fixture(scope="module")
def model():
    return jmodel.load_ccc_model(DEFAULT_CCC_MODEL_PATH)


def _bayer(seed, lead, h, w, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    hi = 256 if dtype == np.uint8 else 65536
    return rng.integers(0, hi, tuple(lead) + (h, w), dtype=dtype)


DEBAYER_CASES = CASES + [((2,), (2, 8)), ((2,), (8, 2))]
DEBAYER_IDS = CASE_IDS + ["2-2x8", "2-8x2"]


@pytest.mark.parametrize("case", DEBAYER_CASES, ids=DEBAYER_IDS)
@pytest.mark.parametrize("algorithm", ["bilinear", "mht"])
def test_debayer_equals_reference(algorithm, case):
    lead, (h, w) = case
    i = DEBAYER_CASES.index(case)
    enc = pdeb.BAYER_ENCODINGS[i % 4]  # each encoding in turn over the cases
    x = _bayer(i * 13 + h, lead, h, w)
    got = pdeb.debayer(torch.as_tensor(x), enc, algorithm)
    assert_equal(got, jdeb.debayer(x, enc, algorithm))
    # the planes the chain takes are the same bytes
    if lead == (2,):
        for c, p in enumerate(pdeb.debayer_planes(torch.as_tensor(x), enc, algorithm)):
            assert torch.equal(p, got[..., c])


@pytest.mark.parametrize("enc", pdeb.BAYER16_ENCODINGS)
def test_debayer16_equals_reference(enc):
    x = _bayer(len(enc), (2, 3), 45, 61, np.uint16)
    assert_equal(pdeb.debayer(torch.as_tensor(x.astype(np.int32)).to(torch.uint16), enc),
                 jdeb.debayer(x, enc))


BRIGHT, DARK, UV0 = 0.9, 0.1, jccc.UV0


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_log_chroma_histograms_equal_reference(case):
    lead, (h, w) = case
    x = image(11 + h, lead, h, w)
    want = np.asarray(jccc.log_chroma_histogram(x, BRIGHT, DARK, UV0))
    assert_equal(pccc.log_chroma_histogram(torch.as_tensor(x), BRIGHT, DARK, UV0), want)
    cuts = (F32(255.0 * BRIGHT), F32(255.0 * DARK), F32(UV0))
    want_rt = np.asarray(jccc.log_chroma_histogram_rt(x, *map(jnp.float32, cuts)))
    assert_equal(want_rt, want)
    assert_equal(pccc.log_chroma_histogram_rt(torch.as_tensor(x), *cuts), want_rt)
    assert want.sum() > 0.5 * max(1, int(np.prod(lead)))  # most pixels counted


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_ccc_response_equals_reference(model, case):
    # the one matmul chain: f32 sums in another order than XLA:CPU's, so
    # held as tests/test_torch_ccc.py holds the plain version: within 1e-5
    # of the response's magnitude, and the same first-occurrence argmax
    lead, (h, w) = case
    hist = np.asarray(jccc.log_chroma_histogram(image(3 + h, lead, h, w), BRIGHT, DARK, UV0))
    filt = (model.filt_dft_re, model.filt_dft_im, model.bias)
    want = np.asarray(jccc.ccc_response(hist, *map(jnp.asarray, filt)))
    got = to_np(pccc.ccc_response(torch.as_tensor(hist), *filt))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert_equal(pccc.response_argmax(torch.as_tensor(got)), jccc.response_argmax(want))


def _maps(seed, h, w, ho, wo):
    """A smooth warp from the [ho, wo] output onto an [h, w] source with
    noise, reaching a little past every border (BORDER_CONSTANT taps)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:ho, 0:wo].astype(np.float64)
    mx = (xx + 0.5) * (w + 3) / wo - 2.0 + 1.5 * np.sin(yy / 7) + rng.normal(0, 0.3, (ho, wo))
    my = (yy + 0.5) * (h + 3) / ho - 2.0 + 1.5 * np.cos(xx / 9) + rng.normal(0, 0.3, (ho, wo))
    return mx.astype(F32), my.astype(F32)


MODES = ["lerp", "float", "fixed32"]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("mode", MODES)
def test_remap_bilinear_u8_equals_reference(mode, case):
    lead, (h, w) = case
    out_hw = (h - 4, w + 3)
    base, weights = jund.remap_precompute(*_maps(h, h, w, *out_hw), (h, w), mode=mode)
    x = image(21 + w, lead, h, w)
    want = jund.remap_bilinear_u8(x, jnp.asarray(base), jnp.asarray(weights), out_hw,
                                  src_hw=(h, w), mode=mode)
    assert_equal(pund.remap_bilinear_u8(torch.as_tensor(x), base, weights, out_hw, (h, w),
                                  mode=mode), want)


@pytest.mark.parametrize("mode", MODES)
def test_remap_per_camera_maps_and_channels_equal_reference(mode):
    h, w, out_hw = 45, 61, (40, 66)
    maps = [jund.remap_precompute(*_maps(s, h, w, *out_hw), (h, w), mode=mode) for s in (1, 2)]
    base, weights = np.stack([m[0] for m in maps]), np.stack([m[1] for m in maps])
    x = image(5, (4,), h, w)
    want = jund.remap_bilinear_u8(x, jnp.asarray(base), jnp.asarray(weights), out_hw,
                                  n_cameras=2, mode=mode)
    assert_equal(pund.remap_bilinear_u8(torch.as_tensor(x), base, weights, out_hw, n_cameras=2,
                                  mode=mode), want)
    # one and four channels
    b1, w1 = maps[0]
    for c in (1, 4):
        xc = image(6 + c, (2,), h, w, c)
        want = jund.remap_bilinear_u8(xc, jnp.asarray(b1), jnp.asarray(w1), out_hw, mode=mode)
        assert_equal(pund.remap_bilinear_u8(torch.as_tensor(xc), b1, w1, out_hw, mode=mode), want)


@pytest.mark.parametrize("lead", LEADS, ids=LEAD_IDS)
@pytest.mark.parametrize("mode", MODES)
def test_remap_bilinear_u8_planes_equals_reference(mode, lead):
    h, w, out_hw = 48, 64, (44, 67)
    base, weights = jund.remap_precompute(*_maps(3, h, w, *out_hw), (h, w), mode=mode)
    x = image(9, lead, h, w)  # [*lead, H, W, 3] -> batch-minor planes [H, W, *lead]
    planes = tuple(np.ascontiguousarray(np.moveaxis(x[..., c], (-2, -1), (0, 1)))
                   for c in range(3))
    want = jund.remap_bilinear_u8_planes(planes, jnp.asarray(base), jnp.asarray(weights),
                                         out_hw, src_hw=(h, w), mode=mode)
    got = pund.remap_bilinear_u8_planes(tuple(map(torch.as_tensor, planes)), base, weights,
                                        out_hw, (h, w), mode=mode)
    assert_equal(got, want)


def test_remap_bilinear_u8_planes_per_camera_equals_reference():
    h, w, out_hw = 45, 61, (40, 66)
    maps = [jund.remap_precompute(*_maps(s, h, w, *out_hw), (h, w), mode="float")
            for s in (4, 5)]
    base, weights = np.stack([m[0] for m in maps]), np.stack([m[1] for m in maps])
    x = image(8, (4,), h, w)
    planes = tuple(np.ascontiguousarray(np.moveaxis(x[..., c], 0, -1)) for c in range(3))
    want = jund.remap_bilinear_u8_planes(planes, jnp.asarray(base), jnp.asarray(weights),
                                         out_hw, n_cameras=2, mode="float")
    got = pund.remap_bilinear_u8_planes(tuple(map(torch.as_tensor, planes)), base, weights,
                                        out_hw, n_cameras=2, mode="float")
    assert_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_remap_from_maps_equals_reference(mode):
    h, w = 45, 61
    mx, my = _maps(7, h, w, 47, 59)
    x = image(10, (2, 3), h, w)
    assert_equal(pund.remap_bilinear_u8_from_maps(torch.as_tensor(x), mx, my, mode),
                 jund.remap_bilinear_u8_from_maps(x, mx, my, mode))


def test_remap_refuses_another_source_size():
    base, weights = pund.remap_precompute(*_maps(1, 45, 61, 40, 40), (45, 61), mode="float")
    with pytest.raises(ValueError, match="precomputed for source"):
        pund.remap_bilinear_u8(torch.zeros((2, 44, 61, 3), dtype=torch.uint8), base, weights,
                               (40, 40), (45, 61), mode="float")




PHASES = ("rggb", "grbg", "gbrg", "bggr")


@pytest.mark.parametrize("case", DEBAYER_CASES, ids=DEBAYER_IDS)
@pytest.mark.parametrize("name", ["debayer_bilinear", "debayer_mht"])
def test_debayer_of_a_phase_equals_reference(name, case):
    # the per-algorithm functions of a CFA phase: [..., H, W] -> [..., H, W, 3]
    lead, (h, w) = case
    i = DEBAYER_CASES.index(case)
    phase = PHASES[i % 4]
    x = _bayer(i * 7 + w, lead, h, w)
    assert_equal(getattr(pdeb, name)(torch.as_tensor(x), phase), getattr(jdeb, name)(x, phase))


@pytest.mark.parametrize("lead", LEADS, ids=LEAD_IDS)
def test_debayer_bilinear16_equals_reference(lead):
    x = _bayer(len(lead), lead, 45, 61, np.uint16)
    got = pdeb.debayer_bilinear16(torch.as_tensor(x.astype(np.int32)).to(torch.uint16), "gbrg")
    assert_equal(got, jdeb.debayer_bilinear16(x, "gbrg"))
