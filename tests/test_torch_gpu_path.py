"""The PyTorch port's second slice against the JAX package on the CPU: the
GPU-parity chain (MHT demosaic with no R<->B swap, the BT.709 gamma) and the
float and fixed32 remap modes. Each JAX function and its port get the same
seeded numpy inputs; the tolerance is 0 mismatching bytes, and the Kalman
state is held as tests/test_torch_pipeline.py holds it. Kernels D and E
against their plain versions on a CUDA card (skipped without one)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops import card_debayer_cases
from test_torch_pipeline import _frames, _mosaic_gbrg, _np, _run_both, assert_states_match

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu import RawImagePipeline as JaxRawImagePipeline
from raw_image_pipeline_tpu.ops import debayer as jdeb
from raw_image_pipeline_tpu.ops import gamma as jgamma
from raw_image_pipeline_tpu.ops import undistortion as jund
from raw_image_pipeline_tpu.ops.debayer_pallas import debayer_mht_pallas
from raw_image_pipeline_tpu_torch.ops import common as pcommon
from raw_image_pipeline_tpu_torch.ops import debayer as pdeb
from raw_image_pipeline_tpu_torch.ops import gamma as pgamma
from raw_image_pipeline_tpu_torch.ops import undistortion as pund

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("rggb", "grbg", "gbrg", "bggr")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# --- MHT demosaic (kernel D's plain version) --------------------------------


@pytest.mark.parametrize("hw", [(16, 24), (17, 23), (3, 5), (1, 1), (4, 1080), (4, 36), (5, 17)])
def test_mht_equals_reference(hw):
    # even, odd, and under 4 px (where the reference clamp-pads the whole
    # mosaic); then the widths at which kernel D changes strip width V (8
    # at 1080, 4 at 36, 1 at 17); the four encodings through the
    # pipeline's entry
    rng = np.random.default_rng(sum(hw))
    bayer = rng.integers(0, 256, (2,) + hw, dtype=np.uint8)
    for enc in pdeb.BAYER_ENCODINGS:
        got = pdeb.debayer_planes(torch.as_tensor(bayer), enc, "mht")
        want = np.asarray(jdeb.debayer_mht(bayer, pdeb.phase_for_encoding(enc)))  # [B, H, W, 3]
        np.testing.assert_array_equal(np.stack([_np(g) for g in got], axis=-1), want)


@pytest.mark.parametrize("hw", [(16, 24), (48, 40)])
def test_mht_equals_pallas_kernel_interpret(hw):
    bayer = np.random.default_rng(hw[1]).integers(0, 256, (2,) + hw, dtype=np.uint8)
    for phase in PHASES:
        want = np.asarray(debayer_mht_pallas(bayer, phase, interpret=True))
        got = pdeb.debayer_mht(torch.as_tensor(bayer), phase)
        np.testing.assert_array_equal(_np(got), want)


def test_debayer_planes_dispatch():
    bayer = torch.as_tensor(np.random.default_rng(8).integers(0, 256, (3, 12, 10), np.uint8))
    phase = pdeb.phase_for_encoding("bayer_rggb8")
    for algorithm, fn in (("bilinear", pdeb.debayer_bilinear), ("mht", pdeb.debayer_mht)):
        got = pdeb.debayer_planes(bayer, "bayer_rggb8", algorithm)
        assert torch.equal(torch.stack(got, dim=1), fn(bayer, phase))
    with pytest.raises(NotImplementedError):
        pdeb.debayer_planes(bayer, "bayer_gbrg8", "vng")


# --- BT.709 gamma -----------------------------------------------------------


@pytest.mark.parametrize("forward", [True, False])
def test_bt709_table_equals_reference(forward):
    table = pgamma.build_bt709_lut(forward)
    np.testing.assert_array_equal(table, jgamma.build_bt709_lut(forward))
    # and the reference package's device function over all 256 values
    idx, val = jgamma.bt709_corrections(forward)
    x = np.arange(256, dtype=np.uint8)
    want = np.asarray(jgamma.gamma_apply_bt709(jnp.asarray(x), forward, idx, val))
    got = pgamma.apply_lut(torch.as_tensor(x), torch.as_tensor(table))
    np.testing.assert_array_equal(_np(got), want)


# --- float and fixed32 remaps (kernel E's plain version) --------------------


def _maps(hw, kind):
    """The flagship's fisheye maps, or a hostile map: taps far out of the
    image and straddling its border."""
    h, w = hw
    if kind == "fisheye":
        calib = tp.flagship_config(h, w).calibration
        size = (w, h)
        new_k = jund.estimate_new_camera_matrix(calib.K(), calib.D(), size, calib.R(),
                                                0.0, size, 1.0)
        return jund.init_undistort_rectify_map(calib.K(), calib.D(), calib.R(), new_k, size)
    rng = np.random.default_rng(h * w)
    return ((rng.random((h, w)) * (w + 6) - 3).astype(np.float32),
            (rng.random((h, w)) * (h + 6) - 3).astype(np.float32))


def _remap_both(hw, kind, mode, **jax_kw):
    """The JAX remap_bilinear_u8_planes ([H, W, B] planes in, [Ho, Wo, C, B]
    out) and the port's plain remap on the same planes, as [B, Ho, Wo, C]."""
    mx, my = _maps(hw, kind)
    base, weights = jund.remap_precompute(mx, my, hw, mode=mode)
    planes = np.random.default_rng(7).integers(0, 256, (3, 2) + hw, dtype=np.uint8)
    jplanes = tuple(jnp.asarray(np.moveaxis(p, 0, -1)) for p in planes)
    want = np.asarray(jund.remap_bilinear_u8_planes(jplanes, base, weights, hw, hw,
                                                    mode=mode, **jax_kw))
    fn = pund.remap_float_planes if mode == "float" else pund.remap_fixed32_planes
    got = fn(tuple(torch.as_tensor(p) for p in planes), torch.as_tensor(base),
             torch.as_tensor(weights), hw)
    return _np(got), np.moveaxis(want, -1, 0)


def _fused_float_blend(hw, kind):
    """The float blend with its sums contracted into fmas,
    fma(t3, w3, fma(t2, w2, fma(t1, w1, t0*w0))), each fma exact (the
    port's Dekker fma_f32), on _remap_both's inputs, as [B, Ho, Wo, C]."""
    mx, my = _maps(hw, kind)
    base, weights = jund.remap_precompute(mx, my, hw, mode="float")
    planes = np.random.default_rng(7).integers(0, 256, (3, 2) + hw, dtype=np.uint8)
    t = pund._anchor_taps(tuple(torch.as_tensor(p) for p in planes), torch.as_tensor(base))
    w = [torch.as_tensor(weights[k])[None, :, None] for k in range(4)]
    acc = t[0] * w[0]
    for k in (1, 2, 3):
        acc = pcommon.fma_f32(t[k], w[k], acc)
    return _np(pcommon.round_u8(acc)).reshape((2,) + hw + (3,))


@pytest.mark.parametrize("blend_impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["fisheye", "hostile"])
@pytest.mark.parametrize("hw", [(96, 128), (91, 117)])
def test_remap_float_equals_reference(hw, kind, blend_impl):
    # "pallas" runs kernel E in interpret mode on the CPU; B*C = 6 columns
    # select the tap-pair pack that feeds it, and Ho*Wo is no multiple of
    # its 512-row block at 91x117 (a ragged last block)
    got, want = _remap_both(hw, kind, "float", blend_impl=blend_impl)
    assert got.shape == (2,) + hw + (3,)
    if blend_impl == "xla":
        np.testing.assert_array_equal(got, want)  # the sealed two-rounding blend
        return
    # XLA:CPU compiles the interpreted kernel's unsealed products and sums
    # into an fma chain (ROADMAP Queue 3): it equals that chain exactly,
    # and the port equals the sealed XLA blend (1 byte apart from the
    # interpreted kernel at 91x117 fisheye, an exact .5 tie)
    np.testing.assert_array_equal(want, _fused_float_blend(hw, kind))
    np.testing.assert_array_equal(got, _remap_both(hw, kind, "float", blend_impl="xla")[1])


@pytest.mark.parametrize("kind", ["fisheye", "hostile"])
@pytest.mark.parametrize("hw", [(96, 128), (91, 117)])
def test_remap_fixed32_equals_reference(hw, kind):
    got, want = _remap_both(hw, kind, "fixed32")
    np.testing.assert_array_equal(got, want)


def test_remap_planes_dispatch():
    hw = (24, 32)
    mx, my = _maps(hw, "hostile")
    planes = tuple(torch.as_tensor(p) for p in
                   np.random.default_rng(2).integers(0, 256, (3, 2) + hw, dtype=np.uint8))
    for mode, fn in (("lerp", pund.remap_lerp_planes), ("float", pund.remap_float_planes),
                     ("fixed32", pund.remap_fixed32_planes)):
        base, weights = (torch.as_tensor(a) for a in pund.remap_precompute(mx, my, hw, mode=mode))
        assert torch.equal(pund.remap_planes(planes, base, weights, hw, mode),
                           fn(planes, base, weights, hw))
    with pytest.raises(ValueError):
        pund.remap_planes(planes, base, weights, hw, "nearest")


# --- the three chains -------------------------------------------------------


def _chain_config(name, hw):
    c = tp.flagship_config(*hw)
    if name == "gpu_parity":
        return c.replace(
            debayer=dataclasses.replace(c.debayer, algorithm="mht"),
            gamma_correction=dataclasses.replace(c.gamma_correction, gpu=True, method="default"),
        )
    return c.replace(undistortion=dataclasses.replace(c.undistortion, interpolation=name))


@pytest.mark.parametrize("hw,temporal_mode", [((96, 128), "sequence"), ((91, 117), "cameras")])
@pytest.mark.parametrize("name", ["gpu_parity", "float", "fixed32"])
def test_chain_equals_reference(name, hw, temporal_mode):
    config = _chain_config(name, hw)
    frames = _frames(sum(hw) + len(name), 6, *hw)
    jo, jstates, po, pstates, meas = _run_both(config, hw, frames, temporal_mode,
                                               with_state=True)
    assert set(po) == {"processed", "debayered", "dist_color"} == set(jo)
    for key in po:
        assert po[key].shape == jo[key].shape, key
        assert int((po[key] != jo[key]).sum()) == 0, key  # 0 mismatching bytes
    assert_states_match(jstates, pstates, temporal_mode, meas)


def test_bt709_gamma_feeds_vignetting_unfolded():
    """With BT.709 the gamma table is its own stage and vignetting
    linearizes plain; with the k gamma the LUT is folded into vignetting."""
    hw = (24, 32)
    params = tp.make_params(_chain_config("gpu_parity", hw), hw, device="cpu")
    k_params = tp.make_params(tp.flagship_config(*hw), hw, device="cpu")
    np.testing.assert_array_equal(_np(params.gamma_lut), jgamma.build_bt709_lut(True))
    assert not torch.equal(params.lab_gamma_tab, k_params.lab_gamma_tab)
    assert params.remap_weights.shape[0] == 6
    float_params = tp.make_params(_chain_config("float", hw), hw, device="cpu")
    assert float_params.remap_weights.shape == (4, hw[0] * hw[1])


# --- the API ----------------------------------------------------------------


def _gpu_params_yaml(tmp_path):
    """The example params with the gamma on, method "default" (BT.709 under
    use_gpu), and vignetting and the Kalman track on."""
    with open(os.path.join(REPO, "configs", "pipeline_params_example.yaml")) as f:
        text = f.read()
    text = text.replace('gamma_correction:\n  enabled: false\n  method: "custom"',
                        'gamma_correction:\n  enabled: true\n  method: "default"')
    text = text.replace("vignetting_correction:\n  enabled: false",
                        "vignetting_correction:\n  enabled: true")
    text = text.replace("temporal_consistency: false", "temporal_consistency: true")
    path = tmp_path / "params_gpu.yaml"
    path.write_text(text)
    return str(path)


def _bayer_fixture():
    import cv2

    return _mosaic_gbrg(cv2.imread(os.path.join(REPO, "tests", "fixtures", "alphasense.png")))


def _assert_same_outputs(ppipe, jpipe, bayer):
    got = ppipe.process(bayer, "bayer_gbrg8")
    want = jpipe.process(bayer, "bayer_gbrg8")
    assert got.shape == want.shape == bayer.shape + (3,)
    assert int((got != want).sum()) == 0
    np.testing.assert_array_equal(ppipe.get_dist_debayered_image(),
                                  jpipe.get_dist_debayered_image())
    np.testing.assert_array_equal(ppipe.get_dist_color_image(), jpipe.get_dist_color_image())


def test_api_use_gpu_equals_reference(tmp_path):
    kw = dict(use_gpu=True, params_path=_gpu_params_yaml(tmp_path),
              calibration_path=os.path.join(REPO, "configs", "alphasense_calib_example.yaml"))
    ppipe = tp.RawImagePipeline(device="cpu", **kw)
    jpipe = JaxRawImagePipeline(**kw)
    assert ppipe._config.debayer.algorithm == "mht" and ppipe._config.gamma_correction.gpu
    bayer = _bayer_fixture()
    _assert_same_outputs(ppipe, jpipe, bayer)
    # a second frame advances the Kalman track on both sides
    _assert_same_outputs(ppipe, jpipe, bayer[::-1].copy())


def test_api_setters_equal_reference():
    calib = os.path.join(REPO, "configs", "alphasense_calib_example.yaml")
    ppipe = tp.RawImagePipeline(calibration_path=calib, device="cpu")
    jpipe = JaxRawImagePipeline(calibration_path=calib)
    bayer = _bayer_fixture()
    for use_gpu, mode in ((True, "fixed32"), (False, "float")):
        for pipe in (ppipe, jpipe):
            pipe.set_gpu(use_gpu)
            pipe.set_undistortion_interpolation(mode)
        for module in ("debayer", "gamma_correction", "undistortion"):
            assert (dataclasses.asdict(getattr(ppipe._config, module))
                    == dataclasses.asdict(getattr(jpipe._config, module))), module
        _assert_same_outputs(ppipe, jpipe, bayer)
    with pytest.raises(ValueError):
        ppipe.set_undistortion_interpolation("nearest")


# --- kernels D and E on the card --------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(1080, 1920), (1920, 1080), (1080, 1444), (1079, 1439), (3, 5),
                                (1, 1)])
def test_kernel_d_equals_plain_on_card(hw):
    dev = _cuda()
    for bayer in card_debayer_cases(hw, dev):
        for phase in PHASES:
            got = pdeb.debayer_mht_cuda(bayer, phase)
            assert torch.equal(got, pdeb.debayer_mht(bayer, phase))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fisheye", "hostile"])
@pytest.mark.parametrize("hw", [(1080, 1920), (91, 117)])
def test_kernel_e_equals_plain_on_card(hw, kind):
    dev = _cuda()
    mx, my = _maps(hw, kind)
    base, weights = (torch.as_tensor(a, device=dev)
                     for a in pund.remap_precompute(mx, my, hw, mode="float"))
    planes = tuple(torch.as_tensor(p, device=dev) for p in
                   np.random.default_rng(4).integers(0, 256, (3, 4) + hw, dtype=np.uint8))
    got = pund.remap_float_cuda(planes, base, weights, hw)
    assert torch.equal(got, pund.remap_float_planes(planes, base, weights, hw))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gpu_parity", "float", "fixed32"])
def test_chain_on_card_equals_cpu(name):
    _cuda()
    hw = (96, 128)
    frames = _frames(5, 4, *hw)
    res = {}
    for dev in ("cuda", "cpu"):
        pipe = tp.build_pipeline(_chain_config(name, hw), "bayer_gbrg8", hw, with_state=True,
                                 keep_intermediates=True, temporal_mode="sequence", device=dev)
        out, st = pipe(torch.as_tensor(frames, device=dev), tp.init_state((), dev))
        res[dev] = ({k: v.cpu() for k, v in out.items()}, st)
    for k, v in res["cpu"][0].items():
        assert torch.equal(res["cuda"][0][k], v), k
    for f in ("x", "p", "initialized"):
        assert torch.equal(getattr(res["cuda"][1], f).cpu(), getattr(res["cpu"][1], f)), f
