"""The PyTorch port's second slice against the JAX package on the CPU: the
GPU-parity chain (MHT demosaic with no R<->B swap, the BT.709 gamma) and the
float and fixed32 remap modes. Each JAX function and its port get the same
seeded numpy inputs; the tolerance is 0 mismatching bytes, and the Kalman
state is held as tests/test_torch_pipeline.py holds it. Kernel E's launch
helpers (store width, frame ranges) on the CPU; kernels D and E against
their plain versions on a CUDA card (skipped without one), and kernel F
(the lerp and fixed32 remaps) there too."""

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
from raw_image_pipeline_tpu_torch.tools import workloads

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
        got = pdeb.debayer_mht_planar(torch.as_tensor(bayer), phase)
        np.testing.assert_array_equal(_np(got), want)


def test_debayer_planes_dispatch():
    bayer = torch.as_tensor(np.random.default_rng(8).integers(0, 256, (3, 12, 10), np.uint8))
    phase = pdeb.phase_for_encoding("bayer_rggb8")
    for algorithm, fn in (("bilinear", pdeb.debayer_bilinear_planar),
                          ("mht", pdeb.debayer_mht_planar)):
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
    return workloads.hostile_maps(hw, hw, h * w)


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


@pytest.mark.parametrize("hw", [(96, 128), (91, 117)])
def test_mono_float_remap_equals_reference(hw):
    # one plane through remap_planes (kernel E's C = 1 form on a card)
    # against the JAX remap of that plane alone
    mx, my = _maps(hw, "fisheye")
    base, weights = jund.remap_precompute(mx, my, hw, mode="float")
    plane = np.random.default_rng(9).integers(0, 256, (2,) + hw, dtype=np.uint8)
    want = np.asarray(jund.remap_bilinear_u8_planes((jnp.asarray(np.moveaxis(plane, 0, -1)),),
                                                    base, weights, hw, hw, mode="float"))
    got = pund.remap_planes((torch.as_tensor(plane),), torch.as_tensor(base),
                            torch.as_tensor(weights), hw, "float")
    assert got.shape == (2,) + hw + (1,)
    np.testing.assert_array_equal(_np(got), np.moveaxis(want, -1, 0))


@pytest.mark.parametrize("offset", [0, 4, 1])
def test_remap_run_width(offset):
    # kernel E stores 4-byte words where Wo and the output's address are
    # multiples of 4 and the map is 16-byte aligned, else bytes
    k = (0, 4, 1).index(offset)
    for wo, want in {1920: (4, 4, 1), 1440: (4, 4, 1), 1444: (4, 4, 1), 1439: (1, 1, 1),
                     117: (1, 1, 1), 2: (1, 1, 1)}.items():
        assert pund.remap_run_width(wo, 4096 + offset, 8192, 8192) == want[k], wo
    assert pund.remap_run_width(1920, 4096, 8192 + offset, 8192) == (4, 1, 1)[k]
    assert pund.remap_run_width(1920, 4096, 8192, 8192 + offset) == (4, 1, 1)[k]


def test_remap_frame_chunk():
    # one range of frames where a frame's tiles fill the card (the map is
    # then read once), else ranges down to one frame each
    sms = 132  # an H100 SXM
    fill = sms * pund.REMAP_MIN_BLOCKS * pund.REMAP_BLOCK
    for hw in ((1080, 1920), (1080, 1440)):  # the chains' frames: one range
        tiles = -(-hw[0] // pund.REMAP_TILE[0]) * -(-hw[1] // pund.REMAP_TILE[1])
        for batch in (1, 4, 64):
            assert pund.remap_frame_chunk(batch, pund.REMAP_BLOCK * tiles, sms) == batch
    small = pund.REMAP_BLOCK * (-(-91 // pund.REMAP_TILE[0]) * -(-117 // pund.REMAP_TILE[1]))
    assert small < fill
    assert pund.remap_frame_chunk(4, small, sms) == 1
    assert pund.remap_frame_chunk(64, fill // 4, sms) == 16
    assert pund.remap_frame_chunk(64, fill // 4, 2 * sms) == 8  # a card of more SMs
    for batch in (1, 5, 64):
        for threads in (1, 3000, 20000, 70000, 120000):
            chunk = pund.remap_frame_chunk(batch, threads, sms)
            assert 1 <= chunk <= batch
            if batch * threads <= fill:
                assert chunk == 1


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
            assert torch.equal(got, pdeb.debayer_mht_planar(bayer, phase))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fisheye", "hostile"])
@pytest.mark.parametrize("hw", [(1080, 1920), (91, 117)])
def test_kernel_e_equals_plain_on_card(hw, kind):
    # B=4, B=1 and one mono plane
    dev = _cuda()
    mx, my = _maps(hw, kind)
    base, weights = (torch.as_tensor(a, device=dev)
                     for a in pund.remap_precompute(mx, my, hw, mode="float"))
    planes = tuple(torch.as_tensor(p, device=dev) for p in
                   np.random.default_rng(4).integers(0, 256, (3, 4) + hw, dtype=np.uint8))
    for pl in (planes, tuple(p[:1] for p in planes), planes[:1]):
        got = pund.remap_float_cuda(pl, base, weights, hw)
        assert got.shape == pl[0].shape + (len(pl),)
        assert torch.equal(got, pund.remap_float_planes(pl, base, weights, hw))


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
        out, st = pipe(torch.as_tensor(frames, device=dev), tp.init_state((), device=dev))
        res[dev] = ({k: v.cpu() for k, v in out.items()}, st)
    for k, v in res["cpu"][0].items():
        assert torch.equal(res["cuda"][0][k], v), k
    for f in ("x", "p", "initialized"):
        assert torch.equal(getattr(res["cuda"][1], f).cpu(), getattr(res["cpu"][1], f)), f


def _camera_maps(hw, scales, mode="float"):
    """remap_precompute's maps in `mode` for the flagship's fisheye
    calibration with fx and fy scaled per camera, stacked [C, N] / [C, k,
    N]."""
    h, w = hw
    calib = tp.flagship_config(h, w).calibration
    size = (w, h)
    maps = []
    for s in scales:
        k = calib.K().copy()
        k[0, 0] *= s
        k[1, 1] *= s
        new_k = jund.estimate_new_camera_matrix(k, calib.D(), size, calib.R(), 0.0, size, 1.0)
        mx, my = jund.init_undistort_rectify_map(k, calib.D(), calib.R(), new_k, size)
        maps.append(pund.remap_precompute(mx, my, hw, mode=mode))
    return np.stack([b for b, _ in maps]), np.stack([wt for _, wt in maps])


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(91, 117), (96, 128)])  # byte stores (V=1), word stores (V=4)
def test_kernel_e_per_camera_maps_equals_plain_on_card(hw):
    # 3 cameras x B=2, each camera's block through its own map in one
    # launch, against remap_float_planes block by block
    dev = _cuda()
    base, weights = (torch.as_tensor(a, device=dev) for a in _camera_maps(hw, (1.0, 1.03, 0.97)))
    planes = tuple(torch.as_tensor(p, device=dev) for p in
                   np.random.default_rng(6).integers(0, 256, (3, 6) + hw, dtype=np.uint8))
    out = torch.empty((6,) + hw + (3,), dtype=torch.uint8, device=dev)
    v = pund.remap_run_width(hw[1], out.data_ptr(), base.data_ptr(), weights.data_ptr())
    assert v == (1 if hw[1] % 4 else 4)
    for pl in (planes, planes[:1]):
        got = pund.remap_float_cuda(pl, base, weights, hw)
        assert got.shape == (6,) + hw + (len(pl),)
        for c in range(3):
            want = pund.remap_float_planes(tuple(p[2 * c:2 * c + 2] for p in pl), base[c],
                                           weights[c], hw)
            assert torch.equal(got[2 * c:2 * c + 2], want), c


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lerp", "fixed32"])
@pytest.mark.parametrize("kind", ["fisheye", "hostile", "lerp_hostile"])
@pytest.mark.parametrize("hw", [(1080, 1920), (91, 117)])
def test_kernel_f_equals_plain_on_card(hw, kind, mode):
    # B=4, B=1 and one mono plane, against remap_planes(..., plain=True)
    dev = _cuda()
    mx, my = workloads.lerp_hostile_maps(hw, hw, 8) if kind == "lerp_hostile" else _maps(hw, kind)
    base, weights = (torch.as_tensor(a, device=dev)
                     for a in pund.remap_precompute(mx, my, hw, mode=mode))
    planes = tuple(torch.as_tensor(p, device=dev) for p in
                   np.random.default_rng(5).integers(0, 256, (3, 4) + hw, dtype=np.uint8))
    for pl in (planes, tuple(p[:1] for p in planes), planes[:1]):
        got = pund.remap_lerp_cuda(pl, base, weights, hw, mode=mode)
        assert got.shape == pl[0].shape + (len(pl),)
        assert torch.equal(got, pund.remap_planes(pl, base, weights, hw, mode, plain=True))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lerp", "fixed32"])
@pytest.mark.parametrize("hw", [(91, 117), (96, 128)])  # byte stores (V=1), word stores (V=4)
def test_kernel_f_per_camera_maps_equals_plain_on_card(hw, mode):
    # 3 cameras x B=2 in one launch, and past a batch limit of 1 (a launch
    # per frame), against the plain version camera block by camera block
    dev = _cuda()
    base, weights = (torch.as_tensor(a, device=dev)
                     for a in _camera_maps(hw, (1.0, 1.03, 0.97), mode))
    planes = tuple(torch.as_tensor(p, device=dev) for p in
                   np.random.default_rng(7).integers(0, 256, (3, 6) + hw, dtype=np.uint8))
    want = pund.remap_planes(planes, base, weights, hw, mode, plain=True)
    for limit in (pund.kernels.MAX_BATCH, 1):
        before = pund.kernels.REMAP_LERP.launches
        got = pund.remap_lerp_cuda(planes, base, weights, hw, mode=mode, batch_limit=limit)
        assert pund.kernels.REMAP_LERP.launches - before == (1 if limit > 1 else 6)
        assert torch.equal(got, want), limit


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 96, 128), (3, 17, 31), (2, 91, 117), (1, 3, 5)])
def test_kernel_g_equals_plain_on_card(shape):
    # every step alone, the flagship's and gpu_parity's step sets, on
    # contiguous planes and on views of a [B, 3, H, W] tensor, and past a
    # batch limit of 1 (a launch per frame), against the plain version
    from raw_image_pipeline_tpu_torch.ops import color_enhancer, pointwise, vignetting

    dev = _cuda()
    b, h, w = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.as_tensor(rng.integers(0, 256, (b, 3, h, w), dtype=np.uint8), device=dev)
    mask = torch.as_tensor(vignetting.build_vignetting_mask(h, w, 1.5, 1e-3, 1e-6), device=dev)
    steps = dict(
        gains=dict(gains=torch.as_tensor(rng.uniform(0.4, 2.6, (b, 3)).astype(np.float32),
                                         device=dev)),
        calibration=dict(matrix=torch.as_tensor(rng.uniform(-0.6, 1.6, (3, 3)).astype(
            np.float32), device=dev), bias=torch.as_tensor(rng.uniform(-20, 20, 3).astype(
                np.float32), device=dev)),
        lut=dict(lut=torch.as_tensor(pgamma.build_bt709_lut(True), device=dev)),
        vignetting=dict(mask=mask),
        gamma_vignetting=dict(mask=mask, lab_tab=torch.as_tensor(
            vignetting.composed_gamma_lab_table(0.9), device=dev)),
        enhancer=dict(enhancer_tables=torch.as_tensor(
            color_enhancer.gain_tables((1.1, 1.2, 0.9)), device=dev)))
    sets = [(s,) for s in steps] + [("gains", "calibration", "gamma_vignetting", "enhancer"),
                                    ("gains", "calibration", "lut", "vignetting", "enhancer")]
    for names in sets:
        kw = {k: v for n in names for k, v in steps[n].items()}
        for planes in (tuple(x[:, c].contiguous() for c in range(3)),
                       tuple(x[:, c] for c in range(3))):
            want = pointwise.pointwise_planes(*planes, plain=True, **kw)
            before = pointwise.kernels.POINTWISE.launches
            got = pointwise.pointwise_planes(*planes, **kw)
            assert pointwise.kernels.POINTWISE.launches - before == 1
            for a, c in zip(got, want):
                assert torch.equal(a, c), names
        got = pointwise.pointwise_cuda(planes, batch_limit=1, **kw)
        assert pointwise.kernels.POINTWISE.launches - before == 1 + b
        for a, c in zip(got, want):
            assert torch.equal(a, c), names


@pytest.mark.cuda
@pytest.mark.parametrize("debug", [False, True])
def test_kernel_g_once_a_flagship_call_on_card(debug):
    # the flagship chain runs its whole stretch as one launch of G (one a
    # stage in debug mode), and equals the plain-op chain
    from raw_image_pipeline_tpu_torch import kernels

    dev = _cuda()
    config = tp.flagship_config(96, 128)
    pipe = tp.build_pipeline(config, "bayer_gbrg8", frame_hw=(96, 128), with_state=True,
                             temporal_mode="sequence", device=dev, debug=debug)
    frames = workloads.card_frames(torch, "bayer", 4, 96, 128, 3, device=dev)
    kernels.reset_launch_counts()
    out, _ = pipe(frames, tp.init_state((), device=dev))
    assert kernels.POINTWISE.launches == (5 if debug else 1)
    plain = tp.make_isp_fn(config, "bayer_gbrg8", True, False, temporal_mode="sequence",
                           debug=debug, plain=True)
    ref, _ = plain(pipe.params, frames, tp.init_state((), device=dev))
    assert sorted(out) == sorted(ref)
    for key, v in ref.items():
        assert torch.equal(out[key], v), key


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 96, 128), (3, 17, 36), (2, 9, 31)])
def test_kernel_g_word_and_byte_layouts_on_card(shape):
    # the flagship's, config 4's and gpu_parity's step sets (the first two
    # with instantiations of their own) with [B, H, W, 3] frames in and out,
    # either with planes, and planes and frames 1 and 2 bytes past a 16-byte
    # boundary (the byte path; W % 4 != 0 takes it too), against the plain
    # version
    from raw_image_pipeline_tpu_torch.ops import color_enhancer, pointwise, vignetting

    dev = _cuda()
    b, h, w = shape
    rng = np.random.default_rng(sum(shape) + 1)
    mask = torch.as_tensor(vignetting.build_vignetting_mask(h, w, 1.5, 1e-3, 1e-6), device=dev)
    calib = dict(matrix=torch.as_tensor(rng.uniform(-0.6, 1.6, (3, 3)).astype(np.float32),
                                        device=dev),
                 bias=torch.as_tensor(rng.uniform(-20, 20, 3).astype(np.float32), device=dev))
    enh = dict(enhancer_tables=torch.as_tensor(color_enhancer.gain_tables((1.0, 1.2, 1.0)),
                                               device=dev))
    gains = dict(gains=torch.as_tensor(rng.uniform(0.4, 2.6, (b, 3)).astype(np.float32),
                                       device=dev))
    sets = {
        "flagship": dict(**gains, **calib, **enh, mask=mask, lab_tab=torch.as_tensor(
            vignetting.composed_gamma_lab_table(0.9), device=dev)),
        "config4": dict(**calib, **enh, mask=mask),
        "gpu_parity": dict(**gains, **calib, **enh, mask=mask, lut=torch.as_tensor(
            pgamma.build_bt709_lut(True), device=dev)),
    }
    nhwc = torch.as_tensor(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8), device=dev)
    planes = tuple(torch.as_tensor(rng.integers(0, 256, (b, h, w), dtype=np.uint8), device=dev)
                   for _ in range(3))
    n = b * h * w
    flat = torch.as_tensor(rng.integers(0, 256, 16 + 3 * n, dtype=np.uint8), device=dev)
    cases = [(nhwc.unbind(-1), True), (nhwc.unbind(-1), False), (planes, True)]
    for off in (1, 2):
        cases += [(tuple(flat[off + c * n:off + (c + 1) * n].view(b, h, w) for c in range(3)),
                   False), (flat[off:off + 3 * n].view(b, h, w, 3).unbind(-1), True)]
    for name, kw in sets.items():
        for src, interleaved_out in cases:
            want = pointwise.pointwise_planes(*src, plain=True, **kw)
            out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=dev).unbind(-1)
            got = pointwise.pointwise_cuda(src, out=out if interleaved_out else None, **kw)
            for a, c in zip(got, want):
                assert torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lerp", "fixed32"])
@pytest.mark.parametrize("hw", [(96, 128), (1080, 1920)])
def test_kernel_f_border_map_on_card(hw, mode):
    # taps past every border of the source in tiles that F stages
    # (workloads.border_maps, by the host model remap_tile_census), B=4 and
    # one plane, against the plain version
    dev = _cuda()
    base, weights = (torch.as_tensor(a, device=dev) for a in pund.remap_precompute(
        *workloads.border_maps(hw, hw, 4), hw, mode=mode))
    assert workloads.remap_tile_census(base.cpu(), weights.cpu(), hw, hw, mode)["global"] == 0
    planes = tuple(torch.as_tensor(p, device=dev) for p in
                   np.random.default_rng(6).integers(0, 256, (3, 4) + hw, dtype=np.uint8))
    for pl in (planes, planes[:1]):
        got = pund.remap_lerp_cuda(pl, base, weights, hw, mode=mode)
        assert torch.equal(got, pund.remap_planes(pl, base, weights, hw, mode, plain=True))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fisheye", "hostile", "border"])
@pytest.mark.parametrize("hw", [(91, 117), (96, 128)])  # byte stores (V=1), word stores (V=4)
def test_kernel_f_fixed32_compact_map_on_card(hw, kind):
    # kernel F's fixed32 kernel through its compact map (remap_fixed32_code)
    # and through the weights alone, B=4, B=1 and one mono plane, one map
    # and 2 cameras' stacked maps, against the plain version
    dev = _cuda()
    if kind == "border":
        mx, my = workloads.border_maps(hw, hw, 4)
    else:
        mx, my = _maps(hw, kind)
    base, weights = pund.remap_precompute(mx, my, hw, mode="fixed32")
    stacked = [pund.remap_precompute(*workloads.hostile_maps(hw, hw, 9), hw, mode="fixed32"),
               (base, weights)]
    maps = [(base, weights), tuple(np.stack([m[i] for m in stacked]) for i in (0, 1))]
    planes = tuple(torch.as_tensor(p, device=dev) for p in
                   np.random.default_rng(8).integers(0, 256, (3, 4) + hw, dtype=np.uint8))
    for b_, w_ in maps:
        b_, c_, w_ = (torch.as_tensor(b_, device=dev),
                      torch.as_tensor(pund.remap_fixed32_code(w_), device=dev),
                      torch.as_tensor(w_, device=dev))
        for pl in (planes, tuple(p[:2] for p in planes), planes[:1]):
            want = pund.remap_planes(pl, b_, w_, hw, "fixed32", plain=True)
            for code in (c_, None):
                got = pund.remap_lerp_cuda(pl, b_, w_, hw, mode="fixed32", code=code)
                assert torch.equal(got, want), (b_.dim(), len(pl), code is None)


@pytest.mark.cuda
def test_kernel_g_writes_config4_output_on_card():
    # config 4's chain (no remap) runs its stretch as one launch of G, which
    # writes the [B, H, W, 3] output itself, equal to the plain-op chain
    from raw_image_pipeline_tpu_torch import kernels

    dev = _cuda()
    ch = workloads.chains(tp)["pointwise_bgr8"]
    config = ch.config(45, 64)
    pipe = tp.build_pipeline(config, "bgr8", frame_hw=(45, 64), device=dev)
    frames = workloads.card_frames(torch, "color", 3, 45, 64, 4, device=dev)
    kernels.reset_launch_counts()
    out, _ = pipe(frames, None)
    assert kernels.POINTWISE.launches == 1
    plain = tp.make_isp_fn(config, "bgr8", False, False, plain=True)
    ref, _ = plain(pipe.params, frames, None)
    assert out["processed"].is_contiguous() and torch.equal(out["processed"], ref["processed"])


def test_port_sources_import_no_jax():
    # every module of the port, and chip_smoke.py, imports neither jax nor
    # anything of the JAX package (the card's machine has no jax)
    import ast

    pkg = os.path.join(REPO, "raw_image_pipeline_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    for name in ("parallel/multicamera.py", "runtime/stream.py", "runtime/sources.py",
                 "runtime/control.py", "runtime/native.py", "tools/run_pipeline.py",
                 "tools/apply_pipeline.py", "tools/ccc_tune.py", "tools/stream_bench.py",
                 "tools/gpu_parity_check.py", "tools/color_calibration.py",
                 "tools/png_writer_bench.py",
                 "utils/image_io.py", "utils/logging.py", "utils/profiling.py"):
        assert os.path.join(pkg, name) in files, name
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for m in names:
                root = m.split(".")[0]
                assert root not in ("jax", "jaxlib", "raw_image_pipeline_tpu"), (path, m)


@pytest.mark.cuda
def test_flagship_mesh_on_card_equals_unsharded():
    """The flagship over four logical shards of one card (data 2 x space
    2), both temporal modes, two calls with the state carried: equal to
    the unsharded call on the card, bytes and Kalman state, with kernels
    A, B and C launched on the shards."""
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.parallel import make_mesh

    dev = _cuda()
    hw = (272, 368)
    config = tp.flagship_config(*hw)
    frames = torch.as_tensor(_frames(9, 8, *hw)).to(dev)
    mesh = make_mesh([dev] * 4, space=2)
    for mode in ("cameras", "sequence"):
        whole = tp.build_pipeline(config, "bayer_gbrg8", hw, with_state=True,
                                  temporal_mode=mode, device=dev)
        split = tp.build_pipeline(config, "bayer_gbrg8", hw, with_state=True,
                                  temporal_mode=mode, mesh=mesh)
        assert split.selected_impls["demosaic"] == ("cuda",) * 4
        ws = ss = tp.init_state((4,) if mode == "cameras" else (), device=dev)
        for chunk in torch.split(frames, 4):
            wo, ws = whole(chunk, ws)
            kernels.reset_launch_counts()
            so, ss = split(chunk, ss)
            torch.cuda.synchronize()
            assert all(k.launches == 4 for k in (kernels.DEBAYER_BILINEAR, kernels.CCC_HISTOGRAM,
                                                  kernels.CCC_RESPONSE))
            assert torch.equal(so["processed"].gather(dev), wo["processed"])
            for f in ("x", "p", "initialized"):
                assert torch.equal(getattr(ss, f), getattr(ws, f))


# --- the op layer's entry points on the card --------------------------------


def _op_layer_calls(dev, lead, hw):
    """{name: (call(plain, device), kernel)} for each entry point of the op
    layer that reaches a kernel, on seeded [*lead, H, W(, 3)] frames."""
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model
    from raw_image_pipeline_tpu_torch.ops import ccc as pccc

    rng = np.random.default_rng(sum(hw))
    bayer = rng.integers(0, 256, lead + hw, dtype=np.uint8)
    bgr = rng.integers(0, 256, lead + hw + (3,), dtype=np.uint8)
    model = load_ccc_model(tp.flagship_config(*hw).white_balance.ccc_model_path)
    filt = (model.filt_dft_re, model.filt_dft_im, model.bias)
    hist = pccc.log_chroma_histogram(torch.as_tensor(bgr)).numpy()
    cams = 2 if len(lead) == 2 else 1  # per-camera maps over the first leading dim
    maps = [pund.remap_precompute(*_maps(hw, "fisheye"), hw, mode="float")]
    if cams == 2:
        maps.append(pund.remap_precompute(*_maps(hw, "hostile"), hw, mode="float"))
    base, weights = (np.stack([m[k] for m in maps]) if cams == 2 else maps[0][k]
                     for k in (0, 1))
    flat_bgr = bgr.reshape((-1,) + hw + (3,))

    def on(x, device):
        return torch.as_tensor(x, device=device)

    return {
        "debayer_bilinear": (lambda plain, d: pdeb.debayer(on(bayer, d), "bayer_gbrg8",
                                                           plain=plain),
                             kernels.DEBAYER_BILINEAR),
        "debayer_mht": (lambda plain, d: pdeb.debayer(on(bayer, d), "bayer_rggb8", "mht",
                                                      plain=plain), kernels.DEBAYER_MHT),
        "log_chroma_histogram": (lambda plain, d: pccc.log_chroma_histogram(
            on(bgr, d), 0.9, 0.1, plain=plain), kernels.CCC_HISTOGRAM),
        "log_chroma_histogram_rt": (lambda plain, d: pccc.log_chroma_histogram_rt(
            on(bgr, d), 229.5, 25.5, pccc.UV0, plain=plain), kernels.CCC_HISTOGRAM),
        "ccc_response": (lambda plain, d: pccc.response_argmax(pccc.ccc_response(
            on(hist, d), *filt, plain=plain)), kernels.CCC_RESPONSE),
        "remap_bilinear_u8": (lambda plain, d: pund.remap_bilinear_u8(
            on(flat_bgr, d), base, weights, hw, hw, n_cameras=cams, mode="float", plain=plain),
            kernels.REMAP_FLOAT),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("lead,hw", [((4,), (270, 360)), ((2, 3), (91, 117))])
def test_op_layer_entry_points_launch_kernels_and_equal_plain_on_card(lead, hw):
    """Each NHWC entry point that reaches kernel A-E, on a CUDA tensor: one
    launch of its kernel, and the bytes (the response's argmax) of the same
    call with plain=True on the card and on the CPU."""
    dev = _cuda()
    for name, (call, kernel) in _op_layer_calls(dev, lead, hw).items():
        kernel.launches = 0
        got = call(False, dev)
        torch.cuda.synchronize()
        assert kernel.launches == 1, name
        assert torch.equal(got, call(True, dev)), name
        assert torch.equal(got.cpu(), call(False, "cpu")), name
