"""The PyTorch port's slice as a whole against the JAX package on the CPU:
the flagship chain (and subsets of its stages) through the reference's
build_pipeline and the port's make_isp_fn, from the same parameters
(params_from_numpy / state_from_numpy) and the same seeded frames, over a
sequence of frames in two calls with the Kalman state carried. Also the
API, what the port refuses, and that the port runs with jax blocked."""

import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu import RawImagePipeline as JaxRawImagePipeline
from raw_image_pipeline_tpu.pipeline import build_pipeline as jax_build_pipeline
from raw_image_pipeline_tpu.pipeline import init_state as jax_init_state
from raw_image_pipeline_tpu_torch.ops import ccc as pccc
from raw_image_pipeline_tpu_torch.pipeline import _host_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _mosaic_gbrg(bgr):
    """[..., H, W, 3] BGR -> [..., H, W] bayer_gbrg8 ((0,0)=G (0,1)=B
    (1,0)=R (1,1)=G)."""
    out = bgr[..., 1].copy()
    out[..., 0::2, 1::2] = bgr[..., 0::2, 1::2, 0]
    out[..., 1::2, 0::2] = bgr[..., 1::2, 0::2, 2]
    return out


def _frames(seed, n, h, w):
    """Seeded Bayer frames with a different colour cast each, so that the
    CCC peak and the Kalman track move from frame to frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for _ in range(n):
        base = 50 + 150 * (0.5 + 0.5 * np.sin(7 * xx + rng.uniform(0, 6) + 5 * yy))
        img = base[..., None] * rng.uniform(0.4, 1.7, 3) * rng.uniform(0.85, 1.15, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return _mosaic_gbrg(np.stack(out))


def _p_after(updates: int, fused: bool) -> F32:
    """The Kalman covariance after `updates` filtering steps (it depends on
    the step count only): (1 - k) * p' as written, or fma(-k, p', p')."""
    p = F32(0)
    for _ in range(updates):
        pp = F32(p + F32(1))
        k = F32(pp / F32(pp + F32(10)))
        p = F32(-np.float64(k) * pp + np.float64(pp)) if fused else F32(F32(F32(1) - k) * pp)
    return p


def _track_x(meas, fused: bool):
    """The Kalman x of one track through the peaks meas [T, 2] from a fresh
    state: x = z0, then x + k*(z - x) with both roundings as written, or
    with the update contracted to fma(k, z - x, x) (and p's to its fused
    form, see _p_after)."""
    x, p = meas[0].astype(F32), F32(0)
    for z in meas[1:].astype(F32):
        pp = F32(p + F32(1))
        k = F32(pp / F32(pp + F32(10)))
        d = (z - x).astype(F32)
        if fused:
            x = (np.float64(k) * d.astype(np.float64) + x.astype(np.float64)).astype(F32)
            p = F32(-np.float64(k) * pp + np.float64(pp))
        else:
            x = (x + (k * d).astype(F32)).astype(F32)
            p = F32(F32(F32(1) - k) * pp)
    return x


def _run_both(config, hw, frames, temporal_mode, with_state, calls=2):
    """Run the reference and the port on the same frames in `calls` calls;
    return both outputs (concatenated), the states after each call and the
    CCC peaks the port's "sequence" mode fed its Kalman track ([T, 2], or
    None)."""
    h, w = hw
    jp = jax_build_pipeline(config, "bayer_gbrg8", frame_hw=hw, with_state=with_state,
                            keep_intermediates=True, temporal_mode=temporal_mode)
    params = tp.params_from_numpy(jax.tree.map(np.asarray, jp.params), config, device="cpu")
    fn = tp.make_isp_fn(config, "bayer_gbrg8", with_state, True, temporal_mode=temporal_mode)
    n = frames.shape[0]
    shape = () if temporal_mode == "sequence" else (n // calls,)
    js = jax_init_state(shape) if with_state else None
    ps = tp.state_from_numpy(js.x, js.p, js.initialized, device="cpu") if with_state else None
    jouts, pouts, jstates, pstates = [], [], [], []
    with mock.patch.object(pccc, "kalman_scan", wraps=pccc.kalman_scan) as scan:
        for chunk in np.split(frames, calls):
            jo, js = jp(chunk, js)
            po, ps = fn(params, torch.as_tensor(chunk), ps)
            jouts.append({k: np.asarray(v) for k, v in jo.items()})
            pouts.append({k: _np(v) for k, v in po.items()})
            jstates.append(js)
            pstates.append(ps)
    meas = [_np(c.args[1]) for c in scan.call_args_list]
    cat = lambda outs: {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}  # noqa: E731
    return (cat(jouts), jstates, cat(pouts), pstates,
            np.concatenate(meas) if meas else None)


@pytest.mark.parametrize("hw,temporal_mode", [
    ((96, 128), "sequence"), ((91, 117), "sequence"), ((96, 128), "cameras"),
])
def test_flagship_chain_equals_reference(hw, temporal_mode):
    config = tp.flagship_config(*hw)
    frames = _frames(sum(hw), 6, *hw)
    jo, jstates, po, pstates, meas = _run_both(config, hw, frames, temporal_mode,
                                               with_state=True)
    assert set(po) == {"processed", "debayered", "dist_color"} == set(jo)
    for key in po:
        assert po[key].shape == jo[key].shape, key
        assert int((po[key] != jo[key]).sum()) == 0, key  # 0 mismatching bytes
    if temporal_mode == "sequence":
        # the track moved: the frames' colour casts differ
        assert len({tuple(p.reshape(-1, 3).mean(0).round()) for p in po["processed"]}) > 1
    assert_states_match(jstates, pstates, temporal_mode, meas)


def assert_states_match(jstates, pstates, temporal_mode, meas):
    """The Kalman state after the last of two calls: equal, up to the
    places where XLA:CPU contracts the JAX package's formula (ROADMAP
    Queue 3), where each side is held to its own formula exactly."""
    js, ps = jstates[-1], pstates[-1]
    np.testing.assert_array_equal(_np(ps.initialized), np.asarray(js.initialized))
    if temporal_mode == "sequence":
        # one track through the peaks meas [T, 2]: the port's x keeps both
        # roundings of x + k*(z - x). Whether XLA:CPU contracts the JAX
        # package's scanned update into the fma depends on the program it
        # is compiled into (the float-remap chain's is contracted, the
        # flagship's and the fixed32 chain's are not), so its x is one of
        # the two formulas, exactly
        np.testing.assert_array_equal(_np(ps.x), _track_x(meas, fused=False))
        assert any(np.array_equal(np.asarray(js.x), _track_x(meas, fused=f))
                   for f in (False, True))
        # p depends on the step count only (a filtering step for every
        # frame after the first): the port's is (1 - k) * p' as written,
        # the JAX package's on the CPU the fused form
        assert _np(ps.p) == _p_after(len(meas) - 1, fused=False)
        assert np.asarray(js.p) == _p_after(len(meas) - 1, fused=True)
    else:
        np.testing.assert_array_equal(_np(ps.p), np.asarray(js.p))
        # each camera's track: the first call set x = z1, the second
        # filtered x = x1 + k*(z2 - x1) with k = 1/11. The port keeps the
        # two roundings; the JAX package's unscanned update on the CPU is
        # contracted to fma(k, z2 - x1, x1) (ROADMAP Queue 3). Recover z2
        # from the port's value and hold both sides to their own formula.
        x1 = _np(pstates[0].x)
        np.testing.assert_array_equal(x1, np.asarray(jstates[0].x))
        k = F32(F32(1) / F32(11))
        for got, want, x in zip(_np(ps.x).ravel(), np.asarray(js.x).ravel(), x1.ravel()):
            z = np.arange(256, dtype=F32)
            d = (z - x).astype(F32)
            plain = (x + (k * d).astype(F32)).astype(F32)
            assert got in plain
            zi = int(np.nonzero(plain == got)[0][0])
            assert want == F32(np.float64(k) * np.float64(d[zi]) + np.float64(x))


def _subset(name, hw):
    c = tp.flagship_config(*hw)
    off = lambda field: dataclasses.replace(getattr(c, field), enabled=False)  # noqa: E731
    if name == "no_wb_no_undistortion_flip90":
        return c.replace(white_balance=off("white_balance"), undistortion=off("undistortion"),
                         flip=dataclasses.replace(c.flip, angle=90))
    if name == "gamma_without_vignetting_flip270":
        return c.replace(vignetting_correction=off("vignetting_correction"),
                         color_enhancer=off("color_enhancer"),
                         undistortion=off("undistortion"),
                         flip=dataclasses.replace(c.flip, angle=270))
    if name == "debayer_only":
        return c.replace(**{f: off(f) for f in (
            "flip", "white_balance", "color_calibration", "gamma_correction",
            "vignetting_correction", "color_enhancer", "undistortion")})
    raise KeyError(name)


@pytest.mark.parametrize("name,hw", [
    ("no_wb_no_undistortion_flip90", (64, 96)),
    ("gamma_without_vignetting_flip270", (45, 61)),
    ("debayer_only", (33, 47)),
])
def test_stage_subsets_equal_reference(name, hw):
    config = _subset(name, hw)
    frames = _frames(len(name), 4, *hw)
    jo, _, po, _, _ = _run_both(config, hw, frames, "sequence", with_state=False)
    for key in po:
        assert po[key].shape == jo[key].shape, key
        assert int((po[key] != jo[key]).sum()) == 0, key


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tp.build_pipeline(tp.flagship_config(24, 32), "bayer_gbrg8", (24, 32), device="cuda")


def _saved_state(path):
    tp.save_state(tp.init_state((), device="cpu"), str(path / "state.npz"))
    return str(path / "state.npz")


# each public entry point that places tensors, called without `device`
_DEFAULT_DEVICE_CALLS = {
    "build_pipeline": lambda p: tp.build_pipeline(tp.flagship_config(24, 32), "bayer_gbrg8",
                                                  (24, 32)),
    "RawImagePipeline": lambda p: tp.RawImagePipeline(),
    "make_params": lambda p: tp.make_params(tp.flagship_config(24, 32), (24, 32)),
    "params_from_numpy": lambda p: tp.params_from_numpy(
        _host_fields(tp.flagship_config(24, 32), (24, 32)), tp.flagship_config(24, 32)),
    "init_state": lambda p: tp.init_state(()),
    "state_from_numpy": lambda p: tp.state_from_numpy(np.zeros(2, np.float32), 0.0, False),
    "load_state": lambda p: tp.load_state(_saved_state(p)),
    "kalman_init": lambda p: pccc.kalman_init(()),
}


@pytest.mark.parametrize("entry", sorted(_DEFAULT_DEVICE_CALLS))
def test_entry_point_defaults_to_cuda_and_raises_without_card(entry, tmp_path):
    fn = {"kalman_init": pccc.kalman_init}.get(entry) or getattr(tp, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    # decided here, not at import: without a card the default raises, and
    # nothing falls back to the CPU
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        _DEFAULT_DEVICE_CALLS[entry](tmp_path)


def test_api_process_equals_reference():
    import cv2

    bgr = cv2.imread(os.path.join(REPO, "tests", "fixtures", "alphasense.png"))
    bayer = _mosaic_gbrg(bgr)
    calib = os.path.join(REPO, "configs", "alphasense_calib_example.yaml")
    jpipe = JaxRawImagePipeline(use_gpu=False, calibration_path=calib)
    ppipe = tp.RawImagePipeline(use_gpu=False, calibration_path=calib, device="cpu")
    got = ppipe.process(bayer, "bayer_gbrg8")
    want = jpipe.process(bayer, "bayer_gbrg8")
    assert got.shape == want.shape == bgr.shape
    assert int((got != want).sum()) == 0
    np.testing.assert_array_equal(ppipe.get_dist_debayered_image(),
                                  jpipe.get_dist_debayered_image())
    np.testing.assert_array_equal(ppipe.get_dist_color_image(), jpipe.get_dist_color_image())
    ppipe.reset_white_balance_temporal_consistency()


def test_port_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None  # any import of jax now fails
        import numpy as np, torch
        import raw_image_pipeline_tpu_torch as tp
        h, w = 24, 32
        pipe = tp.build_pipeline(tp.flagship_config(h, w), "bayer_gbrg8", (h, w),
                                 with_state=True, temporal_mode="sequence", device="cpu")
        px = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (2, h, w), np.uint8))
        out, st = pipe(px, tp.init_state((), device="cpu"))
        assert out["processed"].shape == (2, h, w, 3) and bool(st.initialized)
        from raw_image_pipeline_tpu_torch.parallel import build_multicamera_pipeline
        from raw_image_pipeline_tpu_torch.parallel import dryrun, mesh, multihost, spatial
        from raw_image_pipeline_tpu_torch.runtime import control, native, sources, stream
        from raw_image_pipeline_tpu_torch.tools import pod_bench
        split = tp.build_pipeline(tp.flagship_config(h, w), "bayer_gbrg8", (h, w),
                                  mesh=mesh.make_mesh(["cpu"] * 4, space=2))
        assert split(px)[0]["processed"].gather("cpu").shape == (2, h, w, 3)
        assert not any(m == "jax" or m.startswith(("jax.", "raw_image_pipeline_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.cuda
def test_chain_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    hw = (96, 128)
    frames = _frames(3, 4, *hw)
    res = {}
    for dev in ("cuda", "cpu"):
        pipe = tp.build_pipeline(tp.flagship_config(*hw), "bayer_gbrg8", hw, with_state=True,
                                 keep_intermediates=True, temporal_mode="sequence", device=dev)
        out, st = pipe(torch.as_tensor(frames, device=dev), tp.init_state((), device=dev))
        res[dev] = ({k: v.cpu() for k, v in out.items()}, st)
    for k, v in res["cpu"][0].items():
        assert torch.equal(res["cuda"][0][k], v), k
    for f in ("x", "p", "initialized"):
        assert torch.equal(getattr(res["cuda"][1], f).cpu(), getattr(res["cpu"][1], f)), f
