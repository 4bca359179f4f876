"""Parity of the PyTorch port's CCC white balance (ops/ccc.py: histogram =
kernel B's plain version, response = kernel C's plain version, argmax,
gains, Kalman) with the JAX package on the CPU, and of kernels B and C with
their plain versions on a CUDA card (skipped without one). The response's
argmax is also held on a two-peak histogram whose response has two
separate peaks 1e-5 of max |response| apart (tools/workloads.
two_peak_histogram, which chip_smoke.py runs through kernel C on the card).

Three places where the JAX package on the CPU computes other numbers than
the reference's plain arithmetic are pinned here, each with its cause:
  * the histogram's gray value: XLA:CPU contracts the unsealed chain
    (r*.299 + g*.587) + b*.114 into two fmas; the port keeps the plain chain;
  * log/exp: XLA:CPU's own approximations differ from libm (the reference's
    std::log/std::exp) by 1 ulp at a few of the 256 table entries; the
    port serves libm's values;
  * the Kalman covariance: XLA:CPU rewrites (1 - k) * p' into the single
    rounding fma(-k, p', p'); the port keeps the two roundings.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw_image_pipeline_tpu.models.ccc_model import load_ccc_model as jload
from raw_image_pipeline_tpu.ops import ccc as jccc
from raw_image_pipeline_tpu.ops.colorspace import bgr_to_gray_f32
from raw_image_pipeline_tpu_torch.config import DEFAULT_CCC_MODEL_PATH
from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model as pload
from raw_image_pipeline_tpu_torch.ops import ccc as pccc
from raw_image_pipeline_tpu_torch.tools import workloads

F32 = np.float32
BRIGHT, DARK, UV0 = F32(255.0 * 0.8), F32(255.0 * 0.1), F32(-1.421875)  # default cuts


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def model():
    return jload(DEFAULT_CCC_MODEL_PATH)


def _small_planes(seed: int, b: int = 2, h: int = 270, w: int = 360):
    """Seeded colour-cast frames of the working-resize size: smooth random
    colour fields times a per-frame illuminant, plus noise and a few
    saturated and zero pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for _ in range(b):
        base = 60 + 120 * (0.5 + 0.5 * np.sin(6 * xx + rng.uniform(0, 6) + 4 * yy))
        cast = rng.uniform(0.5, 1.6, 3)
        img = base[..., None] * cast * rng.uniform(0.8, 1.2, (h, w, 3))
        img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)
        img[rng.random((h, w)) < 0.01] = 255
        img[rng.random((h, w)) < 0.01, rng.integers(0, 3)] = 0
        out.append(img)
    return np.stack(out)  # [B, h, w, 3] BGR


def _port_planes(img):
    return [torch.as_tensor(np.ascontiguousarray(img[..., c])) for c in range(3)]


def test_ccc_model_loader_equals_reference(model):
    got = pload(DEFAULT_CCC_MODEL_PATH)
    for name in ("width", "height", "filt", "bias", "filt_dft_re", "filt_dft_im"):
        np.testing.assert_array_equal(getattr(got, name), getattr(model, name))


# --- log, exp and the gray mask --------------------------------------------


def _ulps(a, b):
    return np.abs(a.astype(F32).view(np.int32).astype(np.int64)
                  - b.astype(F32).view(np.int32).astype(np.int64))


def test_log_table_against_jnp_log_moves_no_bin():
    x = np.arange(256, dtype=F32)
    jl = np.asarray(jax.jit(jnp.log)(x))
    assert pccc.LOG_TAB[0] == -np.inf and jl[0] == -np.inf
    assert _ulps(pccc.LOG_TAB[1:], jl[1:]).max() <= 1
    # at the default uv0 no (channel, channel) pair lands in another bin
    def bins(tab):
        t = ((tab[1:, None] - tab[None, 1:]).astype(F32) - UV0).astype(F32) * F32(64)
        return np.where(t >= 0, np.floor(t + F32(0.5)), np.ceil(t - F32(0.5)))
    np.testing.assert_array_equal(bins(pccc.LOG_TAB), bins(jl))


def test_exp_table_and_gains():
    lu = (np.arange(256, dtype=F32) * F32(1 / 64) + UV0).astype(F32)
    tab = pccc.exp_table(float(UV0))
    np.testing.assert_array_equal(
        tab, np.array([math.exp(float(v)) for v in lu]).astype(F32))
    je = np.asarray(jax.jit(jnp.exp)(lu))
    assert _ulps(tab, je).max() <= 1
    # given the same exp values, the gain arithmetic is the reference's
    xy = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    uv = xy.reshape(-1, 2).astype(np.int32)
    got = pccc.gains_from_uv_table(torch.as_tensor(uv), torch.as_tensor(np.array(je)))
    np.testing.assert_array_equal(_np(got), np.asarray(jccc.gains_from_uv(uv, UV0)))


def test_gray_mask_all_triples():
    v = np.arange(1 << 24, dtype=np.uint32)
    b, g, r = (((v >> s) & 255).astype(np.uint8) for s in (0, 8, 16))
    fb, fg, fr = (c.astype(F32) for c in (b, g, r))
    plain = ((fr * F32(0.299)).astype(F32) + (fg * F32(0.587)).astype(F32)).astype(F32) \
        + (fb * F32(0.114)).astype(F32)
    want_plain = (plain <= BRIGHT) & (plain > DARK)

    # the port's mask (the plain version's gray and cuts) is the plain chain's
    tb, tg, tr = (torch.as_tensor(c) for c in (b, g, r))
    gray = (tr.float() * pccc._GRAY_R + tg.float() * pccc._GRAY_G) + tb.float() * pccc._GRAY_B
    got = _np((gray <= float(BRIGHT)) & (gray > float(DARK)))
    np.testing.assert_array_equal(got, want_plain)

    # the JAX package's mask, as its histogram computes it
    def include(img):
        gy = bgr_to_gray_f32(img.astype(jnp.float32))
        return (gy <= BRIGHT) & (gy > DARK)

    img = np.stack([b, g, r], -1).reshape(4096, 4096, 3)
    jm = np.asarray(jax.jit(include)(img)).reshape(-1)
    # XLA:CPU contracts the chain into fma(b, .114, fma(r, .299, g*.587))
    f64 = np.float64
    inner = (fr.astype(f64) * f64(F32(0.299)) + (fg * F32(0.587)).astype(F32)).astype(F32)
    fused = (inner.astype(f64) + fb.astype(f64) * f64(F32(0.114))).astype(F32)
    np.testing.assert_array_equal(jm, (fused <= BRIGHT) & (fused > DARK))
    differ = np.nonzero(jm != got)[0]
    assert len(differ) == 6, differ  # recorded in ROADMAP Queue 3


# --- histogram (kernel B's plain version) ----------------------------------


def test_histogram_equals_einsum_path():
    img = _small_planes(1)
    want = jccc.log_chroma_histogram_rt(img, BRIGHT, DARK, UV0, impl="einsum")
    got = pccc.log_chroma_histogram_planes(*_port_planes(img), float(BRIGHT), float(DARK),
                                           float(UV0))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert float(_np(got).sum()) > 0.5  # most pixels counted


def test_histogram_equals_pallas_kernel_interpret():
    # impl="pallas" on the CPU runs _hist_counts_pallas in interpret mode
    img = _small_planes(2, b=2, h=64, w=80)
    planes = _port_planes(img)
    want = np.asarray(jccc.log_chroma_histogram_rt(img, BRIGHT, DARK, UV0, impl="pallas"))
    got = pccc.log_chroma_histogram_planes(*planes, float(BRIGHT), float(DARK), float(UV0))
    np.testing.assert_array_equal(_np(got), want)
    bins = pccc.log_chroma_bins(*planes, float(BRIGHT), float(DARK), float(UV0))
    counts = torch.bincount(bins, minlength=2 * 256 * 256).view(2, 256, 256)
    np.testing.assert_array_equal(_np(counts).astype(F32) * F32(1.0 / (64 * 80)), want)


@pytest.mark.parametrize("b,h,w", [(1, 270, 360), (2, 61, 83)])
def test_histogram_plain_equals_core(b, h, w):
    # the JAX package's histogram core (einsum counts) at the working
    # resize's size and at an odd one: 0 f32 ulps apart
    img = _small_planes(7 + h, b=b, h=h, w=w)
    core = jax.jit(jccc._log_chroma_histogram_core, static_argnames="impl")
    want = np.asarray(core(img, BRIGHT, DARK, UV0, impl="einsum"))
    got = _np(pccc.log_chroma_histogram_plain(*_port_planes(img), float(BRIGHT), float(DARK),
                                              float(UV0)))
    assert got.shape == want.shape == (b, 256, 256)
    assert _ulps(got, want).max() == 0
    assert got.sum() > 0.5 * b  # most pixels counted


# --- response (kernel C's plain version), argmax, gains --------------------


def test_response_close_to_reference_and_argmax_equal(model):
    img = _small_planes(3, b=3)
    hist = np.array(jccc.log_chroma_histogram_rt(img, BRIGHT, DARK, UV0, impl="einsum"))
    want = np.asarray(jccc.ccc_response(hist, model.filt_dft_re, model.filt_dft_im,
                                        model.bias, impl="xla"))
    w = [torch.as_tensor(np.array(a)) for a in (model.filt_dft_re, model.filt_dft_im, model.bias)]
    got = _np(pccc.ccc_response(torch.as_tensor(hist), *w))
    # f32 sums in another order: within 1e-5 of the response's magnitude
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(_np(pccc.response_argmax(torch.as_tensor(got))),
                                  np.asarray(jccc.response_argmax(want)))


@pytest.fixture(scope="module")
def two_peak(model):
    return workloads.two_peak_histogram(model.filt_dft_re, model.filt_dft_im, model.bias)


def test_two_peak_response_argmax_equals_reference(model, two_peak):
    hist, gap, (high, low) = two_peak
    # two separate peaks whose values differ by the stated relative gap
    assert 0.5 * workloads.TWO_PEAK_GAP <= gap <= 2 * workloads.TWO_PEAK_GAP
    assert (high[0] - low[0]) ** 2 + (high[1] - low[1]) ** 2 > 16 ** 2
    want = np.asarray(jccc.ccc_response(hist[None], model.filt_dft_re, model.filt_dft_im,
                                        model.bias, impl="xla"))
    w = [torch.as_tensor(np.array(a)) for a in (model.filt_dft_re, model.filt_dft_im, model.bias)]
    got = _np(pccc.ccc_response(torch.as_tensor(hist[None]), *w))
    jarg = np.asarray(jccc.response_argmax(want))
    np.testing.assert_array_equal(_np(pccc.response_argmax(torch.as_tensor(got))), jarg)
    np.testing.assert_array_equal(jarg, [[high[1], high[0]]])  # (x=col, y=row)
    # the f32 sums of the two packages sit far inside the gap
    assert np.abs(got - want).max() < 0.1 * gap * np.abs(want).max()


def test_ccc_response_plain_leaves_tf32_setting():
    hist = torch.zeros((1, 256, 256))
    w = [torch.zeros((256, 256)) for _ in range(3)]
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            pccc.ccc_response_plain(hist, *w)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_argmax_first_occurrence():
    resp = np.zeros((3, 256, 256), F32)
    resp[0, 5, 9] = resp[0, 5, 200] = resp[0, 100, 1] = 1.0
    resp[1, 255, 255] = 2.0
    resp[2] = -1.0
    got = pccc.response_argmax(torch.as_tensor(resp))
    np.testing.assert_array_equal(_np(got), np.asarray(jccc.response_argmax(resp)))
    np.testing.assert_array_equal(_np(got), [[9, 5], [255, 255], [0, 0]])


def test_apply_gains_equals_reference():
    rng = np.random.default_rng(4)
    planes = [rng.integers(0, 256, (3, 20, 30), dtype=np.uint8) for _ in range(3)]
    uv = rng.integers(0, 256, (3, 2)).astype(np.int32)
    gains = np.array(jccc.gains_from_uv(uv, UV0))
    got = pccc.apply_gains_planes([torch.as_tensor(p) for p in planes], torch.as_tensor(gains))
    want = jccc.apply_gains_planes(planes, gains)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(_np(x), np.asarray(y))


# --- Kalman ----------------------------------------------------------------


def _kalman_oracle(meas, fused_p: bool):
    """numpy f32 recursion of the reference package's kalman_update; p's
    update either as written, (1 - k) * p', or fused, fma(-k, p', p')."""
    x, p, init = np.array([128, 128], F32), F32(0), False
    for z in meas.astype(F32):
        pp = F32(p + F32(1))
        k = F32(pp / F32(pp + F32(10)))
        if fused_p:
            pu = F32(-np.float64(k) * np.float64(pp) + np.float64(pp))
        else:
            pu = F32(F32(F32(1) - k) * pp)
        xu = (x + (k * (z - x).astype(F32)).astype(F32)).astype(F32)
        x, p = (xu, pu) if init else (z.copy(), p)
        init = True
    return x, p


def test_kalman_scan_equals_reference():
    meas = np.random.default_rng(11).integers(0, 256, (9, 2)).astype(np.int32)
    js, juv = jccc.kalman_scan(jccc.kalman_init(()), jnp.asarray(meas))
    ps, puv = pccc.kalman_scan(pccc.kalman_init((), device="cpu"), torch.as_tensor(meas))
    np.testing.assert_array_equal(_np(puv), np.asarray(juv))
    np.testing.assert_array_equal(_np(ps.x), np.asarray(js.x))
    assert bool(ps.initialized) and bool(js.initialized)
    # p: the port keeps the written (1 - k) * p'; the JAX package on the CPU
    # computes the fused form (recorded in ROADMAP Queue 3)
    x, p = _kalman_oracle(meas, fused_p=False)
    np.testing.assert_array_equal(_np(ps.x), x)
    assert _np(ps.p) == p
    _, p_fused = _kalman_oracle(meas, fused_p=True)
    assert np.asarray(js.p) == p_fused


def test_kalman_update_cameras_equals_reference():
    rng = np.random.default_rng(12)
    js, ps = jccc.kalman_init((4,)), pccc.kalman_init((4,), device="cpu")
    for _ in range(2):  # the first step initialises, the second filters
        meas = rng.integers(0, 256, (4, 2)).astype(np.int32)
        js, juv = jccc.kalman_update(js, jnp.asarray(meas))
        ps, puv = pccc.kalman_update(ps, torch.as_tensor(meas))
        np.testing.assert_array_equal(_np(puv), np.asarray(juv))
        for f in ("x", "p", "initialized"):
            np.testing.assert_array_equal(_np(getattr(ps, f)), np.asarray(getattr(js, f)))


# --- kernels B and C on the card -------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_b_equals_plain_on_card():
    dev = _cuda()
    cuts = (float(BRIGHT), float(DARK), float(UV0))
    for b, h, w in ((4, 270, 360), (1, 270, 360), (3, 61, 83)):
        planes = [p.to(dev) for p in _port_planes(_small_planes(5, b=b, h=h, w=w))]
        # the f32 histogram, value for value
        assert torch.equal(pccc.log_chroma_histogram_cuda(*planes, *cuts),
                           pccc.log_chroma_histogram_plain(*planes, *cuts))


@pytest.mark.cuda
def test_kernel_c_equals_plain_on_card(model, two_peak):
    dev = _cuda()
    img = _small_planes(6, b=4)
    hist = pccc.log_chroma_histogram_planes(*[p.to(dev) for p in _port_planes(img)],
                                            float(BRIGHT), float(DARK), float(UV0))
    w = [torch.as_tensor(np.array(a), device=dev)
         for a in (model.filt_dft_re, model.filt_dft_im, model.bias)]
    for x in (hist, torch.as_tensor(two_peak[0][None], device=dev)):
        got = pccc.ccc_response_cuda(x, *w)
        want = pccc.ccc_response_plain(x, *w)
        # f32 sums in another order: within 1e-4 of the response's magnitude
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
        assert torch.equal(pccc.response_argmax(got), pccc.response_argmax(want))
