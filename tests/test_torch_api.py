"""The PyTorch port's RawImagePipeline surface and the chains it opens
(colour, mono and 16-bit input, debug dumps, microbatch, state files)
against the JAX package on the CPU, with 0 mismatching bytes as the
tolerance; and the API's arrays sharing no memory with its cache."""

import dataclasses
import inspect
import os
from unittest import mock

import cv2
import jax
import numpy as np
import pytest
import torch

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu import RawImagePipeline as JaxRawImagePipeline
from raw_image_pipeline_tpu.pipeline import build_pipeline as jax_build_pipeline
from raw_image_pipeline_tpu.pipeline import init_state as jax_init_state
from raw_image_pipeline_tpu.pipeline import load_state as jax_load_state
from raw_image_pipeline_tpu.pipeline import save_state as jax_save_state
from raw_image_pipeline_tpu_torch import config as pcfg
from test_api_surface import REFERENCE_METHODS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIB = os.path.join(REPO, "configs", "alphasense_calib_example.yaml")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "alphasense.png")


def mosaic_gbrg(bgr):
    out = bgr[..., 1].copy()
    out[..., 0::2, 1::2] = bgr[..., 0::2, 1::2, 0]
    out[..., 1::2, 0::2] = bgr[..., 1::2, 0::2, 2]
    return out


def crop(h=96, w=128):
    return np.ascontiguousarray(cv2.imread(FIXTURE)[100:100 + h, 200:200 + w])


def cast_frames(seed, n, h, w):
    """[n, h, w, 3] u8 BGR frames, each with its own colour cast."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for _ in range(n):
        base = 40 + 200 * (0.5 + 0.5 * np.sin(7 * xx + rng.uniform(0, 6) + 5 * yy))
        img = base[..., None] * rng.uniform(0.4, 1.7, 3) * rng.uniform(0.8, 1.2, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def run_both(config, encoding, frames, with_state=False, temporal_mode="sequence",
             state_shape=(), **kw):
    """The JAX package's build_pipeline and the port's build_pipeline from
    the same parameters on the same frames: (jax outputs, port outputs,
    jax state, port state), outputs as numpy."""
    hw = frames.shape[1:3]
    jp = jax_build_pipeline(config, encoding, frame_hw=hw, with_state=with_state,
                            keep_intermediates=True, temporal_mode=temporal_mode, **kw)
    pp = tp.build_pipeline(config, encoding, hw, with_state=with_state, keep_intermediates=True,
                           temporal_mode=temporal_mode, device="cpu", **kw)
    pp.params = tp.params_from_numpy(jax.tree.map(np.asarray, jp.params), config, device="cpu")
    js = jax_init_state(state_shape) if with_state else None
    ps = tp.init_state(state_shape, device="cpu") if with_state else None
    jo, js = jp(frames, js)
    po, ps = pp(torch.as_tensor(frames), ps)
    return ({k: np.asarray(v) for k, v in jo.items()}, {k: v.numpy() for k, v in po.items()},
            js, ps)


def assert_equal_outputs(jo, po):
    assert set(po) == set(jo)
    for k in po:
        assert po[k].shape == jo[k].shape and po[k].dtype == jo[k].dtype, k
        assert int((po[k] != jo[k]).sum()) == 0, k


# --- the API's arrays share no memory with its cache -------------------------


def test_process_and_getters_return_fresh_arrays():
    pipe = tp.RawImagePipeline(device="cpu")
    bayer = mosaic_gbrg(crop(48, 64))
    out = pipe.process(bayer, "bayer_gbrg8")
    kept = pipe.get_processed_image().copy()
    out[...] = 0
    np.testing.assert_array_equal(pipe.get_processed_image(), kept)
    for getter in (pipe.get_processed_image, pipe.get_dist_debayered_image,
                   pipe.get_dist_color_image):
        arr = getter()
        arr[...] = 1
        assert not np.shares_memory(arr, getter())
    np.testing.assert_array_equal(pipe.get_processed_image(), kept)


# --- the method list ----------------------------------------------------------


def public_methods(cls):
    return {n for n, _ in inspect.getmembers(cls, callable) if not n.startswith("_")}


def test_api_methods_equal_reference_list():
    missing = [m for m in REFERENCE_METHODS if not callable(getattr(tp.RawImagePipeline, m, None))]
    assert not missing
    assert public_methods(tp.RawImagePipeline) == public_methods(JaxRawImagePipeline)


def test_top_level_names_cover_reference():
    # every name the JAX package exports at its top level, the port exports
    # too, as the same kind of thing (each config class the port's own copy)
    import raw_image_pipeline_tpu as jtp

    assert set(jtp.__all__) <= set(tp.__all__)
    for name in jtp.__all__:
        got, want = getattr(tp, name), getattr(jtp, name)
        if isinstance(want, type):
            assert isinstance(got, type) and got.__name__ == want.__name__, name
            if dataclasses.is_dataclass(want):
                assert ([f.name for f in dataclasses.fields(got)]
                        == [f.name for f in dataclasses.fields(want)]), name
        else:
            assert type(got) is type(want), name
    assert tp.__version__ == jtp.__version__


# --- apply, process and the setters against the JAX API ----------------------


@pytest.fixture()
def pipes():
    """(JAX API, port API), both with the shipped params, the Alphasense
    calibration, white balance and undistortion off."""
    out = []
    for cls, kw in ((JaxRawImagePipeline, {}), (tp.RawImagePipeline, {"device": "cpu"})):
        p = cls(False, pcfg.DEFAULT_PARAMS_PATH, pcfg.DEFAULT_CALIBRATION_PATH, "", **kw)
        p.set_white_balance(False)
        p.set_undistortion(False)
        out.append(p)
    return out


def test_apply_in_place_bgr8_equals_reference(pipes):
    img = crop()
    bufs = []
    for p in pipes:
        p.set_gamma_correction(True)
        p.set_gamma_correction_k(0.8)
        p.set_vignetting_correction(True)
        buf = img.copy()
        assert p.apply(buf, "bgr8") is True
        bufs.append(buf)
    assert not np.array_equal(bufs[1], img)
    np.testing.assert_array_equal(bufs[1], bufs[0])
    np.testing.assert_array_equal(bufs[1], pipes[1].get_processed_image())


def test_apply_shape_change_leaves_buffer(pipes):
    img = crop()
    p = pipes[1]
    p.set_flip(True)
    p.set_flip_angle(90)
    buf = img.copy()
    assert p.apply(buf, "bgr8") is True
    np.testing.assert_array_equal(buf, img)
    assert p.get_processed_image().shape == (128, 96, 3)
    frozen = img.copy()
    frozen.setflags(write=False)
    p.set_flip(False)
    assert p.apply(frozen, "bgr8") is True  # read-only buffer: not written


@pytest.mark.parametrize("method", ["simple", "grey_world", "pca", "learned", "ccc"])
def test_api_white_balance_methods_equal_reference(pipes, method):
    bayer = mosaic_gbrg(crop())
    outs = []
    for p in pipes:
        p.set_white_balance(True)
        p.set_white_balance_method(method)
        p.set_white_balance_percentile(10.0)
        p.set_flip(True)
        p.set_flip_angle(270)
        outs.append((p.process(bayer, "bayer_gbrg8"), p.get_dist_debayered_image(),
                     p.get_dist_color_image()))
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)


def test_api_use_gpu_pca_equals_reference():
    bayer = mosaic_gbrg(crop())
    outs = []
    for p in (JaxRawImagePipeline(use_gpu=True), tp.RawImagePipeline(use_gpu=True, device="cpu")):
        p.set_white_balance(True)
        p.set_white_balance_method("pca")
        p.set_gamma_correction(True)
        p.set_gamma_correction_method("default")
        outs.append(p.process(bayer, "bayer_gbrg8"))
    np.testing.assert_array_equal(outs[1], outs[0])


def test_single_frame_rule():
    """[H, W] and [H, W, 1|3] are one frame; [B, H, W] is a batch."""
    pipe = tp.RawImagePipeline(device="cpu")
    pipe.set_white_balance(False)
    img = crop(24, 32)
    assert pipe.process(img, "bgr8").shape == (24, 32, 3)
    assert pipe.process(img[..., :1], "mono8").shape == (24, 32, 1)
    assert pipe.process(img[..., 0], "mono8").shape == (24, 32)
    batch = mosaic_gbrg(np.stack([img, img[::-1]]))
    out = pipe.process(batch, "bayer_gbrg8")
    assert out.shape == (2, 24, 32, 3)
    np.testing.assert_array_equal(out[1], pipe.process(batch[1], "bayer_gbrg8"))


@pytest.mark.parametrize("setup", ["calibrated", "new_size", "uncalibrated", "setters"])
def test_getters_equal_reference(setup):
    args = (False, "", CALIB if setup != "uncalibrated" else "", "")
    pipes = [JaxRawImagePipeline(*args), tp.RawImagePipeline(*args, device="cpu")]
    for p in pipes:
        if setup == "new_size":
            p.set_undistortion_new_image_size(800, 600)
            p.set_undistortion_balance(0.5)
            p.set_undistortion_fov_scale(1.2)
        if setup == "setters":
            p.set_undistortion(False)
            p.set_undistortion_camera_matrix([[300.0, 0, 320], [0, 310.0, 240], [0, 0, 1]])
            p.set_undistortion_distortion_coeffs([0.01, -0.02, 0.003, 0.0])
            p.set_undistortion_distortion_model("equidistant")
            p.set_undistortion_image_size(640, 480)
            p.set_undistortion_rectification_matrix(np.eye(3))
            p.set_undistortion_projection_matrix(np.arange(12.0).reshape(3, 4))
            p.set_color_calibration_matrix(np.arange(9.0).reshape(3, 3))
            p.set_color_calibration_bias([1.0, 2.0, 3.0])
            p.set_vignetting_correction(True)
    names = [m for m in REFERENCE_METHODS if m.startswith(("get_dist_", "get_rect_"))]
    names += ["get_color_calibration_matrix", "get_color_calibration_bias"]
    names += [m for m in public_methods(JaxRawImagePipeline) if m.startswith("is_")]
    assert len(names) == 24
    for name in names:
        want, got = (getattr(p, name)() for p in pipes)
        if isinstance(want, np.ndarray):
            assert got.shape == want.shape and got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert type(got) is type(want) and got == want, name


def test_load_params_and_set_debug_equal_reference(tmp_path):
    params = tmp_path / "params.yaml"
    params.write_text("white_balance:\n  enabled: true\n  method: grey_world\n"
                      "gamma_correction:\n  enabled: true\n  k: 0.7\n")
    img = crop(48, 64)
    outs = []
    for p in (JaxRawImagePipeline(), tp.RawImagePipeline(device="cpu")):
        p.load_params(str(params))
        p.set_debug(True)
        with mock.patch.dict("sys.modules", {"cv2": None}):  # no dump files
            out = p.process(img, "bgr8")
        p.init_undistortion()
        outs.append((out, {k: np.asarray(v) for k, v in p._last_outputs.items()}))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert_equal_outputs(outs[0][1], outs[1][1])
    assert sum(k.startswith("debug/") for k in outs[1][1]) == 8


# --- BASELINE config 4 and the other inputs -----------------------------------


def config4():
    """tests/test_baseline_configs.py's config 4: colour calibration,
    vignetting and the HSV enhancer."""
    c = tp.PipelineConfig()
    return c.replace(
        color_calibration=dataclasses.replace(
            c.color_calibration, enabled=True,
            matrix=(1.3, 0.1, -0.1, 0.05, 1.1, -0.05, -0.1, -0.1, 1.4), bias=(2.0, 0.0, -1.0)),
        vignetting_correction=dataclasses.replace(c.vignetting_correction, enabled=True,
                                                  scale=1.5, a2=1e-3, a4=1e-6),
        color_enhancer=dataclasses.replace(c.color_enhancer, enabled=True, saturation_gain=1.2),
    )


@pytest.mark.parametrize("hw", [(48, 64), (45, 61)])
def test_config4_chain_equals_reference(hw):
    jo, po, _, _ = run_both(config4(), "bgr8", cast_frames(11, 3, *hw))
    assert_equal_outputs(jo, po)
    assert po["processed"].shape == (3, *hw, 3)


def mono_config(hw):
    """The flagship chain (flip, CCC, colour calibration, gamma, vignetting,
    enhancer, undistortion): on mono frames only flip, gamma (as its own
    stage) and the remap run."""
    return tp.flagship_config(*hw)


@pytest.mark.parametrize("layout", ["bhw", "bhw1"])
def test_mono_chain_equals_reference(layout):
    hw = (45, 61)
    frames = cast_frames(12, 3, *hw)[..., 1]
    if layout == "bhw1":
        frames = frames[..., None]
    jo, po, _, _ = run_both(mono_config(hw), "mono8", frames)
    assert_equal_outputs(jo, po)
    assert po["processed"].shape == (3, *hw) + ((1,) if layout == "bhw1" else ())


@pytest.mark.parametrize("mode", ["lerp", "float", "fixed32"])
def test_rgb8_chain_equals_reference(mode):
    hw = (45, 61)
    c = tp.flagship_config(*hw)
    # vignetting and the enhancer on colour frames: config 4's test
    c = c.replace(undistortion=dataclasses.replace(c.undistortion, interpolation=mode),
                  **{f: dataclasses.replace(getattr(c, f), enabled=False)
                     for f in ("vignetting_correction", "color_enhancer")})
    jo, po, js, ps = run_both(c, "rgb8", cast_frames(13, 2, *hw))
    assert_equal_outputs(jo, po)


def test_bayer16_chain_equals_reference():
    hw = (24, 32)
    c = tp.flagship_config(*hw)
    c = c.replace(debayer=dataclasses.replace(c.debayer, bayer16="scale8"),
                  white_balance=dataclasses.replace(c.white_balance, method="grey_world"))
    frames = (cast_frames(14, 2, *hw)[..., 1].astype(np.uint16) * 257
              + np.random.default_rng(0).integers(0, 257, (2, *hw))).astype(np.uint16)
    jo, po, _, _ = run_both(c, "bayer_gbrg16", frames)
    assert_equal_outputs(jo, po)


def test_bayer16_error_mode_raises_reference_message():
    with pytest.raises(ValueError, match=r"Encoding \[bayer_rggb16\] is a valid pattern"):
        tp.build_pipeline(tp.flagship_config(24, 32), "bayer_rggb16", (24, 32), device="cpu")


def test_debug_dumps_equal_reference():
    hw = (24, 32)
    c = tp.flagship_config(*hw)
    frames = mosaic_gbrg(cast_frames(15, 2, *hw))
    jo, po, _, _ = run_both(c, "bayer_gbrg8", frames, debug=True)
    assert_equal_outputs(jo, po)
    assert sorted(k for k in po if k.startswith("debug/")) == [
        "debug/00_debayer", "debug/01_flip", "debug/02_white_balancing",
        "debug/03_color_calibration", "debug/04_gamma_correction",
        "debug/05_vignetting_correction", "debug/06_color_enhancer", "debug/07_undistortion"]
    # 00_debayer is pre-flip (flip 180 moves it)
    assert not np.array_equal(po["debug/00_debayer"], po["debug/01_flip"])


# --- microbatch and state files -------------------------------------------------


@pytest.mark.parametrize("temporal_mode,n,state_shape", [
    ("sequence", 7, ()),  # two chunks of 3 and a remainder of 1
    ("cameras", 6, (3,)),  # three tracks, two chunks
])
def test_microbatch_equals_unchunked_and_reference(temporal_mode, n, state_shape):
    hw = (24, 32)
    c = tp.flagship_config(*hw)
    # the stages after the white balance carry no state; off, they keep
    # the JAX package's compile short
    c = c.replace(**{f: dataclasses.replace(getattr(c, f), enabled=False)
                     for f in ("vignetting_correction", "color_enhancer", "undistortion")})
    frames = mosaic_gbrg(cast_frames(16, n, *hw))
    jo, po, _, ps = run_both(c, "bayer_gbrg8", frames, with_state=True,
                             temporal_mode=temporal_mode, state_shape=state_shape, microbatch=3)
    assert_equal_outputs(jo, po)
    whole = tp.build_pipeline(c, "bayer_gbrg8", hw, with_state=True, keep_intermediates=True,
                              temporal_mode=temporal_mode, device="cpu")
    if temporal_mode == "sequence":  # one track: the whole batch in one call
        wo, ws = whole(torch.as_tensor(frames), tp.init_state(state_shape, device="cpu"))
    else:  # three tracks: the chunks one call at a time
        outs, ws = [], tp.init_state(state_shape, device="cpu")
        for chunk in np.split(frames, 2):
            o, ws = whole(torch.as_tensor(chunk), ws)
            outs.append(o)
        wo = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    for k in wo:
        assert torch.equal(wo[k], torch.as_tensor(po[k])), k
    for f in ("x", "p", "initialized"):
        assert torch.equal(getattr(ws, f), getattr(ps, f)), f
    assert bool(ps.initialized.all())


def test_state_files_load_across_packages(tmp_path):
    js = jax_init_state((2,))
    js = js.__class__(x=js.x + np.float32(3.25), p=js.p + np.float32(0.5),
                      initialized=np.array([True, False]))
    jax_save_state(js, str(tmp_path / "jax_state.npz"))
    ps = tp.load_state(str(tmp_path / "jax_state.npz"), device="cpu")
    for f in ("x", "p", "initialized"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(), np.asarray(getattr(js, f)))
    tp.save_state(ps, str(tmp_path / "port_state.npz"))
    back = jax_load_state(str(tmp_path / "port_state.npz"))
    for f in ("x", "p", "initialized"):
        got, want = np.asarray(getattr(back, f)), np.asarray(getattr(js, f))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# --- on the card ----------------------------------------------------------------


@pytest.mark.cuda
def test_api_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    img = crop()
    bayer = mosaic_gbrg(img)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = tp.RawImagePipeline(device=dev)
        p.set_white_balance_method("grey_world")
        a = p.process(bayer, "bayer_gbrg8")
        buf = img.copy()
        p.apply(buf, "bgr8")
        g = tp.RawImagePipeline(use_gpu=True, device=dev)
        g.set_white_balance_method("pca")
        outs[dev] = (a, buf, g.process(bayer, "bayer_gbrg8"))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("encoding", ["bgr8", "mono8", "bayer_gbrg16"])
def test_inputs_on_card_equal_cpu(encoding):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    hw = (96, 128)
    c = tp.flagship_config(*hw)
    c = c.replace(debayer=dataclasses.replace(c.debayer, bayer16="scale8"))
    frames = cast_frames(17, 4, *hw)
    if encoding == "mono8":
        frames = frames[..., 0]
    elif encoding == "bayer_gbrg16":
        frames = mosaic_gbrg(frames).astype(np.uint16) * 257
    res = {}
    for dev in ("cuda", "cpu"):
        pipe = tp.build_pipeline(c, encoding, hw, with_state=True, temporal_mode="sequence",
                                 microbatch=3, device=dev)
        res[dev] = pipe(torch.as_tensor(frames, device=dev), tp.init_state((), dev))[0]
    assert torch.equal(res["cuda"]["processed"].cpu(), res["cpu"]["processed"])
