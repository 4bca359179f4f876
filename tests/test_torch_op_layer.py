"""The port's op layer on the JAX package's terms: every public function of
raw_image_pipeline_tpu/ops/*.py has a counterpart of the same name and
arguments in raw_image_pipeline_tpu_torch/ops (or stands on the list of
what is not ported, with its reason), each counterpart equals the JAX
function on the same seeded inputs on the CPU (the pointwise ops and the
CCC host arithmetic here; the white balances in
test_torch_op_layer_wb.py; the functions that reach kernels A-E in
test_torch_op_layer_kernels.py), and build_pipeline runs a CCC model given
in memory (ccc_model=)."""

import dataclasses
import glob
import importlib
import inspect
import math
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import _frames, _p_after, _track_x
from util_contract import contract_problems, port_object, public_defs
from util_op_layer import CASE_IDS, CASES, F32, LEAD_IDS, LEADS, assert_equal, image, to_np

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu.config import DEFAULT_CCC_MODEL_PATH
from raw_image_pipeline_tpu.models import ccc_model as jmodel
from raw_image_pipeline_tpu.ops import ccc as jccc
from raw_image_pipeline_tpu.ops import color_calibration as jcc
from raw_image_pipeline_tpu.ops import color_enhancer as jce
from raw_image_pipeline_tpu.ops import colorspace as jcs
from raw_image_pipeline_tpu.ops import gamma as jgamma
from raw_image_pipeline_tpu.ops import resize as jresize
from raw_image_pipeline_tpu.ops import vignetting as jvig
from raw_image_pipeline_tpu.pipeline import build_pipeline as jax_build_pipeline
from raw_image_pipeline_tpu.pipeline import init_state as jax_init_state
from raw_image_pipeline_tpu_torch.models import ccc_model as pmodel
from raw_image_pipeline_tpu_torch.ops import ccc as pccc
from raw_image_pipeline_tpu_torch.ops import color_calibration as pcc
from raw_image_pipeline_tpu_torch.ops import color_enhancer as pce
from raw_image_pipeline_tpu_torch.ops import colorspace as pcs
from raw_image_pipeline_tpu_torch.ops import gamma as pgamma
from raw_image_pipeline_tpu_torch.ops import resize as presize
from raw_image_pipeline_tpu_torch.ops import vignetting as pvig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UV0 = jccc.UV0

# --- (a) coverage -------------------------------------------------------------

# a JAX parameter that the port takes in another form, at the same place, and why
REPLACED_PARAMS = {
    ("colorspace", "bgr_to_lab_planes"): {
        "gamma_fn": ("gamma_tab", "the exact int32 table in place of the TPU's "
                                  "correction-served callable")},
    ("vignetting", "correct_planes"): {
        "gamma_fn": ("gamma_tab", "the exact int32 table in place of the TPU's "
                                  "correction-served callable")},
    ("color_enhancer", "enhance_planes"): {
        "gains": ("tables", "the exact f64 gain tables (gain_tables) that the TPU's f32 "
                            "multiply and corrections reproduce")},
}
_CORRECTIONS = ("per-backend LUT corrections and polynomial-served tables that worked "
                "around slow TPU transcendentals; the port serves exact host tables")
_SELECTOR = "TPU implementation selection; the port picks the kernel by the tensor's device"
_PALLAS = "a Pallas wrapper; its counterpart is the port's *_cuda function"
NOT_PORTED = {
    "ccc.set_histogram_impl": _SELECTOR,
    "ccc.set_response_impl": _SELECTOR,
    "debayer.set_bilinear_impl": _SELECTOR,
    "undistortion.set_remap_blend_impl": _SELECTOR,
    **{f"lut.{n}": _CORRECTIONS
       for n in ("derive_corrections", "apply_corrected", "fit_branch_poly", "poly_eval")},
    **{f"gamma.{n}": _CORRECTIONS
       for n in ("gamma_corrections", "gamma_apply", "gamma_poly_coeffs",
                 "gamma_corrections_poly", "gamma_apply_poly", "bt709_corrections")},
    "vignetting.composed_gamma_corrections": _CORRECTIONS,
    "vignetting.composed_gamma_lab_fn": _CORRECTIONS,
    "color_enhancer.gain_corrections": _CORRECTIONS,
    "color_enhancer.enhance_packed": "the batch-minor layout (w_axis); enhance covers "
                                     "[..., H, W, 3]",
    "common.lut_select": "a TPU gather workaround (a select tree); the port gathers",
    "common.seal_f32": "a TPU/XLA contraction workaround; eager torch rounds every op",
    **{f"debayer_pallas.{n}": _PALLAS
       for n in ("tile_rows_for", "debayer_bilinear_pallas", "debayer_bilinear_pallas_nhwc",
                 "debayer_bilinear_pallas_planes", "mht_tile_rows_for", "debayer_mht_pallas",
                 "debayer_mht_pallas_nhwc", "debayer_mht_pallas_planes")},
    "remap_blend_pallas.blend_rows_pallas": _PALLAS,
    **{f"lut.CorrectedTable.{n}": _CORRECTIONS for n in ("__init__", "__call__")},
}
JAX_OPS = sorted(os.path.basename(p)[:-3]
                 for p in glob.glob(os.path.join(REPO, "raw_image_pipeline_tpu", "ops", "*.py"))
                 if not p.endswith("__init__.py"))


def _jax_defs(module):
    return public_defs(os.path.join(REPO, "raw_image_pipeline_tpu", "ops", f"{module}.py"))


@pytest.mark.parametrize("module", JAX_OPS)
def test_every_public_op_has_a_counterpart_or_a_reason(module):
    """Every public def of the JAX module has a port counterpart that takes
    a JAX-style call by position with the same meaning (util_contract's
    rule: the JAX positions, TPU-only parameters left out only at the end
    and only with a reason, the port's own parameters keyword-only)."""
    defs = _jax_defs(module)
    assert defs, module
    ported = {n: s for n, s in defs.items() if f"{module}.{n}" not in NOT_PORTED}
    if not ported:
        return  # a TPU-only module (debayer_pallas, remap_blend_pallas, lut)
    pmod = importlib.import_module(f"raw_image_pipeline_tpu_torch.ops.{module}")
    for name, jsig in ported.items():
        fn = port_object(pmod, name)
        assert fn is not None, f"ops/{module}.py: no counterpart of {name}"
        replaced = {j: p for j, (p, _) in REPLACED_PARAMS.get((module, name), {}).items()}
        problems = contract_problems(jsig, fn, replaced)
        assert not problems, f"ops/{module}.{name}: {problems}"


def test_not_ported_list_names_real_functions():
    for key, reason in NOT_PORTED.items():
        module, name = key.split(".", 1)
        assert name in _jax_defs(module) and reason, key
    for (module, name), repl in REPLACED_PARAMS.items():
        assert set(repl) <= set(_jax_defs(module)[name][0]), (module, name)


@pytest.mark.parametrize("name", ["build_pipeline", "make_params"])
def test_build_pipeline_and_make_params_take_the_reference_arguments(name):
    """Every JAX parameter at its JAX position (build_pipeline's donate, XLA
    buffer donation, is accepted and ignored: eager PyTorch has none), and
    the port's device, mesh and spatial_shards where the JAX function has
    none, keyword-only."""
    jpos, _ = public_defs(os.path.join(REPO, "raw_image_pipeline_tpu", "pipeline.py"))[name]
    params = inspect.signature(getattr(tp, name)).parameters
    pos = [p for p, v in params.items() if v.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD]
    assert pos == jpos
    assert params["device"].kind == inspect.Parameter.KEYWORD_ONLY
    assert set(params) - set(jpos) == {"device"}


# --- (b) equality on the CPU --------------------------------------------------

def _vig_mask(h, w):
    return jvig.build_vignetting_mask(h, w, 1.0, 0.3, -0.2)


MATRIX = np.array([[1.1, -0.05, 0.02], [0.03, 0.95, 0.04], [-0.1, 0.08, 1.2]], F32)
BIAS = np.array([2.5, -1.0, 0.5], F32)
ENHANCER_GAINS = (1.0, 1.2, 0.9)

# name -> (jax call, port call) on one image
POINTWISE = {
    "colorspace.bgr_to_hsv_u8": (jcs.bgr_to_hsv_u8, pcs.bgr_to_hsv_u8),
    "colorspace.hsv_to_bgr_u8": (jcs.hsv_to_bgr_u8, pcs.hsv_to_bgr_u8),
    "colorspace.bgr_to_lab_u8": (jcs.bgr_to_lab_u8, pcs.bgr_to_lab_u8),
    "colorspace.lab_to_bgr_u8": (jcs.lab_to_bgr_u8, pcs.lab_to_bgr_u8),
    "color_calibration.color_correct": (lambda x: jcc.color_correct(x, MATRIX, BIAS),
                                        lambda x: pcc.color_correct(x, MATRIX, BIAS)),
    "gamma.gamma_correct": (lambda x: jgamma.gamma_correct(x, 0.9),
                            lambda x: pgamma.gamma_correct(x, 0.9)),
    "gamma.gamma_apply_bt709": (
        lambda x: jgamma.gamma_apply_bt709(x, True, *map(jnp.asarray,
                                                         jgamma.bt709_corrections(True))),
        lambda x: pgamma.gamma_apply_bt709(x, True)),
    "gamma.apply_lut": (lambda x: jgamma.apply_lut(x, jnp.asarray(jgamma.build_gamma_lut(1.7))),
                        lambda x: pgamma.apply_lut(x, jgamma.build_gamma_lut(1.7))),
    "vignetting.correct": (lambda x: jvig.correct(x, _vig_mask(*x.shape[-3:-1])),
                           lambda x: pvig.correct(x, _vig_mask(*x.shape[-3:-1]))),
    "color_enhancer.enhance": (lambda x: jce.enhance(x, ENHANCER_GAINS),
                               lambda x: pce.enhance(x, ENHANCER_GAINS)),
    "resize.resize_linear_u8": (lambda x: jresize.resize_linear_u8(x, 23, 97),
                                lambda x: presize.resize_linear_u8(x, 23, 97)),
}


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("name", sorted(POINTWISE))
def test_frame_op_equals_reference(name, case):
    lead, (h, w) = case
    x = image(len(name) + h, lead, h, w)
    jfn, pfn = POINTWISE[name]
    assert_equal(pfn(torch.as_tensor(x)), jfn(x))


# XLA:CPU contracts the JAX package's gray chain into
# fma(b, .114, fma(r, .299, g*.587)); the port keeps the plain chain. On
# these seeded frames the two differ at this many f32 values (of 2745,
# 3072, 5490, 6144, 16470, 18432), each side equal to its own formula.
GRAY_FUSED_DIFFERS = {"none-45x61": 385, "none-48x64": 941, "2-45x61": 1035,
                      "2-48x64": 1533, "2x3-45x61": 3144, "2x3-48x64": 4313}


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_gray_equals_each_formula(case):
    lead, (h, w) = case
    x = image(7 + h, lead, h, w)
    got = to_np(pcs.bgr_to_gray_f32(torch.as_tensor(x)))
    want = np.asarray(jcs.bgr_to_gray_f32(x))
    f = x.astype(F32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    plain = ((r * F32(0.299)).astype(F32) + (g * F32(0.587)).astype(F32)).astype(F32) \
        + (b * F32(0.114)).astype(F32)
    f64 = np.float64
    inner = (r.astype(f64) * f64(F32(0.299)) + (g * F32(0.587)).astype(F32)).astype(F32)
    fused = (inner.astype(f64) + b.astype(f64) * f64(F32(0.114))).astype(F32)
    assert_equal(got, plain.astype(F32))
    assert_equal(want, fused)
    assert int((got != want).sum()) == GRAY_FUSED_DIFFERS[CASE_IDS[CASES.index(case)]]


@pytest.mark.parametrize("src,dst", [((1, 61), (23, 97)), ((45, 1), (23, 97)),
                                     ((45, 61), (90, 122)), ((2, 3), (1, 1))])
def test_resize_small_and_upscaled_equals_reference(src, dst):
    x = image(src[0] * 100 + src[1], (2,), *src)
    assert_equal(presize.resize_linear_u8(torch.as_tensor(x), *dst),
                 jresize.resize_linear_u8(x, *dst))


@pytest.fixture(scope="module")
def model():
    return jmodel.load_ccc_model(DEFAULT_CCC_MODEL_PATH)


# XLA:CPU's exp differs from libm's, which the port serves (exp_table), by
# 1 ulp at this many of the 256 table entries at the default uv0
EXP_TABLE_DIFFERS = 25


def test_gains_from_uv_equals_reference_but_for_exp():
    lu = (np.arange(256, dtype=F32) * F32(jccc.BIN_SIZE) + F32(UV0)).astype(F32)
    libm = np.array([math.exp(float(v)) for v in lu]).astype(F32)
    xla = np.asarray(jax.jit(jnp.exp)(lu))
    differ = np.nonzero(libm != xla)[0]
    assert len(differ) == EXP_TABLE_DIFFERS
    uv = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1).astype(np.int32)
    want = np.asarray(jccc.gains_from_uv(uv, UV0))
    got = to_np(pccc.gains_from_uv(torch.as_tensor(uv), UV0))
    assert got.shape == want.shape == (256, 256, 3) and got.dtype == want.dtype

    def formula(tab):  # the gain arithmetic on a given exp table
        g = np.stack([tab[uv[..., 1]], np.ones(uv.shape[:-1], F32), tab[uv[..., 0]]], -1)
        return (g / g.min(-1, keepdims=True)).astype(F32)

    assert_equal(got, formula(libm))
    assert_equal(want, formula(xla))
    touched = np.isin(uv[..., 0], differ) | np.isin(uv[..., 1], differ)
    assert_equal(got[~touched], want[~touched])


@pytest.mark.parametrize("uv_init", [None, (100, 37)])
@pytest.mark.parametrize("lead", LEADS, ids=LEAD_IDS)
def test_kalman_init_equals_reference(lead, uv_init):
    kw = {} if uv_init is None else {"uv_init": uv_init}
    js = jccc.kalman_init(lead, **kw)
    ps = pccc.kalman_init(lead, **kw, device="cpu")
    for f in ("x", "p", "initialized"):
        assert_equal(getattr(ps, f), getattr(js, f))


# --- (c) build_pipeline(ccc_model=) -----------------------------------------


def _rolled(mod, m):
    """A copy of a CCCModel with its filter rolled by one bin along its
    second axis (a roll along the first leaves these frames' peaks)."""
    filt = np.ascontiguousarray(np.roll(m.filt, 1, axis=1))
    dft = np.fft.fft2(filt.astype(np.float64))
    return mod.CCCModel(width=m.width, height=m.height, filt=filt, bias=m.bias,
                        filt_dft_re=dft.real.astype(F32), filt_dft_im=dft.imag.astype(F32))


def test_build_pipeline_runs_a_model_given_in_memory(model):
    hw = (48, 64)
    config = tp.flagship_config(*hw)
    frames = _frames(31, 2, *hw)
    jm = _rolled(jmodel, model)
    pm = _rolled(pmodel, pmodel.load_ccc_model(config.white_balance.ccc_model_path))
    jp = jax_build_pipeline(config, "bayer_gbrg8", frame_hw=hw, with_state=True, ccc_model=jm,
                            temporal_mode="sequence")
    jo, js = jp(frames, jax_init_state(()))
    pp = tp.build_pipeline(config, "bayer_gbrg8", hw, with_state=True, ccc_model=pm,
                           temporal_mode="sequence", device="cpu")
    assert pp.ccc_model is pm
    with mock.patch.object(pccc, "kalman_scan", wraps=pccc.kalman_scan) as scan:
        po, ps = pp(torch.as_tensor(frames), tp.init_state((), device="cpu"))
    meas = to_np(scan.call_args_list[0].args[1])
    assert_equal(po["processed"], jo["processed"])
    # the Kalman state: equal, each side held to its own formula where
    # XLA:CPU contracts the JAX package's update (ROADMAP Queue 3)
    assert_equal(ps.initialized, js.initialized)
    np.testing.assert_array_equal(to_np(ps.x), _track_x(meas, fused=False))
    assert any(np.array_equal(np.asarray(js.x), _track_x(meas, fused=f)) for f in (False, True))
    assert to_np(ps.p) == _p_after(len(meas) - 1, fused=False)
    assert np.asarray(js.p) in (_p_after(len(meas) - 1, fused=f) for f in (False, True))
    # the model is used: the default model's output differs, and make_params
    # takes the same model
    default = tp.build_pipeline(config, "bayer_gbrg8", hw, with_state=True,
                                temporal_mode="sequence", device="cpu")
    do, _ = default(torch.as_tensor(frames), tp.init_state((), device="cpu"))
    assert int((do["processed"] != po["processed"]).sum()) > 0
    params = tp.make_params(config, hw, pm, device="cpu")
    assert_equal(params.ccc_filt_dft_re, pm.filt_dft_re)
    assert dataclasses.is_dataclass(pm)
