"""The port's camera-blocked multicamera chain (BASELINE config 5 on one
card) against the JAX package on the CPU: build_multicamera_pipeline on
both sides from the same calibrations (the flagship's, fx and fy scaled per
camera), the same seeded frames [4 cameras, B=2] in two calls with the
Kalman state carried; 0 mismatching bytes, and each camera's Kalman state
held as tests/test_torch_pipeline.py holds it. Also the remap with stacked
per-camera maps against the JAX remap, kernel E's camera-blocked grid, and
what build_multicamera_pipeline refuses."""

import dataclasses
import inspect
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import _frames, _np, _p_after, _track_x, assert_states_match

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu.ops import undistortion as jund
from raw_image_pipeline_tpu.parallel.multicamera import (
    build_multicamera_pipeline as jax_build_multicamera,
)
from raw_image_pipeline_tpu.parallel.multicamera import multicamera_state as jax_multicamera_state
from raw_image_pipeline_tpu.pipeline import init_state as jax_init_state
from raw_image_pipeline_tpu.pipeline import make_isp_fn as jax_make_isp_fn
from raw_image_pipeline_tpu.pipeline import make_params as jax_make_params
from raw_image_pipeline_tpu_torch.ops import ccc as pccc
from raw_image_pipeline_tpu_torch.ops import undistortion as pund
from raw_image_pipeline_tpu_torch.parallel import build_multicamera_pipeline, multicamera_state

HW = (48, 64)
CAMERAS, BATCH = 4, 2
SCALES = (1.0, 1.02, 0.98, 1.04)  # fx and fy per camera, as bench.py's config 5


def _calibrations(config, maps):
    """The four cameras' calibrations: config's with fx and fy scaled by
    SCALES ("distinct"), or four equal ones ("shared")."""
    def scaled(s):
        k = list(config.calibration.camera_matrix)
        k[0] *= s
        k[4] *= s
        return dataclasses.replace(config.calibration, camera_matrix=tuple(k))

    return [scaled(s if maps == "distinct" else 1.0) for s in SCALES]


def _config(remap="lerp", wb="ccc"):
    c = tp.flagship_config(*HW)
    c = c.replace(undistortion=dataclasses.replace(c.undistortion, interpolation=remap))
    if wb != "ccc":
        c = c.replace(white_balance=dataclasses.replace(c.white_balance, method=wb,
                                                        temporal_consistency=False))
    return c


def _multicam_frames(seed, calls=1):
    """Seeded Bayer frames [CAMERAS, BATCH * calls, H, W], each with its own
    colour cast."""
    return _frames(seed, CAMERAS * BATCH * calls, *HW).reshape(CAMERAS, BATCH * calls, *HW)


def _run_multicam(config, maps, temporal_mode, with_state, frames, calls=2):
    """The JAX and the port's multicamera chains on the same frames, in
    `calls` calls with the state carried: both outputs per call, both
    states per call, the CCC peaks the port's per-camera scan took ([T, C,
    2], or None) and the port's pipeline."""
    calibs = _calibrations(config, maps)
    jp = jax_build_multicamera(config, calibs, "bayer_gbrg8", HW, with_state=with_state,
                               temporal_mode=temporal_mode)
    pp = build_multicamera_pipeline(config, calibs, "bayer_gbrg8", HW, with_state=with_state,
                                    temporal_mode=temporal_mode, device="cpu")
    js = jax_multicamera_state(CAMERAS, BATCH, temporal_mode) if with_state else None
    ps = multicamera_state(CAMERAS, BATCH, temporal_mode, device="cpu") if with_state else None
    jouts, pouts, jstates, pstates = [], [], [], []
    with mock.patch.object(pccc, "kalman_scan", wraps=pccc.kalman_scan) as scan:
        for chunk in np.split(frames, calls, axis=1):
            jo, js = jp(chunk, js)
            po, ps = pp(torch.as_tensor(chunk), ps)
            jouts.append(np.asarray(jo["processed"]))
            pouts.append(_np(po["processed"]))
            jstates.append(js)
            pstates.append(ps)
    meas = [_np(c.args[1]) for c in scan.call_args_list]
    return jouts, pouts, jstates, pstates, (np.concatenate(meas) if meas else None), pp


def _assert_states(jstates, pstates, temporal_mode, meas):
    if temporal_mode == "cameras":
        # [C, B] independent tracks: each as a single-camera "cameras" track
        assert_states_match(jstates, pstates, "cameras", None)
        return
    # one track per camera through its block's peaks meas [T, C, 2]: the
    # port's x keeps both roundings of x + k*(z - x). XLA:CPU compiles the
    # JAX package's scan over [T, C, 2] into other arithmetic at some steps
    # (at 48x64 the last step of one camera matches (x + k*z) - k*x, neither
    # written formula: ROADMAP Queue 3), so its x is held to 1 ulp of the
    # port's; the truncated peaks that feed the gains, and so every output
    # byte, are equal
    js, ps = jstates[-1], pstates[-1]
    np.testing.assert_array_equal(_np(ps.initialized), np.asarray(js.initialized))
    np.testing.assert_array_equal(_np(ps.x), _track_x(meas, fused=False))
    np.testing.assert_array_max_ulp(np.asarray(js.x), _np(ps.x), maxulp=1)
    assert (_np(ps.p) == _p_after(len(meas) - 1, fused=False)).all()
    assert (np.asarray(js.p) == _p_after(len(meas) - 1, fused=True)).all()


def _jax_single_cameras(config, calibs, temporal_mode, frames, calls=2):
    """Each camera's frames through the JAX package's single-camera chain
    of its own calibration (one jitted chain, each camera's params), in
    `calls` calls with its state carried: [camera][call] processed."""
    fn = jax.jit(jax_make_isp_fn(config, "bayer_gbrg8", True, False,
                                 temporal_mode=temporal_mode, remap_src_hw=HW))
    outs = []
    for c, calib in enumerate(calibs):
        params = jax_make_params(config.replace(calibration=calib), HW)
        st = jax_init_state(() if temporal_mode == "sequence" else (BATCH,))
        outs.append([])
        for chunk in np.split(frames[c], calls):
            o, st = fn(params, chunk, st)
            outs[-1].append(np.asarray(o["processed"]))
    return outs


@pytest.mark.parametrize("maps,temporal_mode,remap", [
    ("distinct", "cameras", "lerp"), ("distinct", "sequence", "lerp"),
    ("shared", "cameras", "lerp"), ("shared", "sequence", "lerp"),
    ("distinct", "sequence", "float"), ("distinct", "cameras", "fixed32"),
])
def test_multicamera_equals_reference(maps, temporal_mode, remap):
    config = _config(remap)
    frames = _multicam_frames(len(maps) + len(temporal_mode) + len(remap), calls=2)
    jouts, pouts, jstates, pstates, meas, pp = _run_multicam(config, maps, temporal_mode, True,
                                                             frames)
    for jo, po in zip(jouts, pouts):
        assert po.shape == jo.shape == (CAMERAS, BATCH) + HW + (3,)
    if remap == "lerp":
        for jo, po in zip(jouts, pouts):
            assert int((po != jo).sum()) == 0  # 0 mismatching bytes
    else:
        # the JAX package's camera-blocked float and fixed32 chains on
        # XLA:CPU differ from its own single-camera chains by 1 at 0.2-1.1%
        # of the bytes, where its HSV enhancer is computed again inside the
        # remap's fused pack (ROADMAP Queue 3); the port equals each
        # camera's single-camera chain of the JAX package byte for byte
        singles = _jax_single_cameras(config, _calibrations(config, maps), temporal_mode,
                                      frames)
        for call, (jo, po) in enumerate(zip(jouts, pouts)):
            for c in range(CAMERAS):
                assert int((po[c] != singles[c][call]).sum()) == 0, (call, c)
            assert np.abs(po.astype(int) - jo).max() <= 1
    _assert_states(jstates, pstates, temporal_mode, meas)
    # a shared calibration is one flat map, distinct ones are stacked
    assert pp.params.remap_base.dim() == (1 if maps == "shared" else 2)
    # the tracks moved, and differ between the cameras
    assert len({tuple(v) for v in _np(pstates[-1].x).reshape(-1, 2)}) > 1


@pytest.mark.parametrize("temporal_mode", ["cameras", "sequence"])
def test_multicamera_equals_single_cameras(temporal_mode):
    # the port alone: each camera's block equals a single-camera chain of
    # its own calibration, state included
    config = _config("float")
    calibs = _calibrations(config, "distinct")
    frames = _multicam_frames(11)
    pp = build_multicamera_pipeline(config, calibs, "bayer_gbrg8", HW, with_state=True,
                                    temporal_mode=temporal_mode, device="cpu")
    out, st = pp(torch.as_tensor(frames),
                 multicamera_state(CAMERAS, BATCH, temporal_mode, device="cpu"))
    for c, calib in enumerate(calibs):
        solo = tp.build_pipeline(config.replace(calibration=calib), "bayer_gbrg8", HW,
                                 with_state=True, temporal_mode=temporal_mode, device="cpu")
        shape = () if temporal_mode == "sequence" else (BATCH,)
        ref, rst = solo(torch.as_tensor(frames[c]), tp.init_state(shape, device="cpu"))
        assert torch.equal(out["processed"][c], ref["processed"]), c
        for f in ("x", "p", "initialized"):
            assert torch.equal(getattr(st, f)[c], getattr(rst, f)), (c, f)


def test_multicamera_grey_world_stateless_equals_reference():
    # after the JAX package's tests/test_multicamera.py:50-64: a grey-world
    # chain, no state
    config = _config(wb="grey_world")
    frames = _multicam_frames(5)
    jouts, pouts, _, pstates, _, _ = _run_multicam(config, "distinct", "cameras", False,
                                                   frames, calls=1)
    assert pstates[0] is None
    assert pouts[0].shape == (CAMERAS, BATCH) + HW + (3,)
    np.testing.assert_array_equal(pouts[0], jouts[0])


@pytest.mark.parametrize("mode", ["lerp", "float", "fixed32"])
def test_remap_stacked_maps_equal_reference(mode):
    # per-camera maps [C, N] / [C, k, N] over a camera-major batch: the
    # port's remap_planes against the JAX remap_bilinear_u8_planes with
    # n_cameras (its planes [H, W, C*B'], its output [C, Ho, Wo, ch, B'])
    h, w = HW
    bases, weights = [], []
    for calib in _calibrations(tp.flagship_config(h, w), "distinct"):
        size = (w, h)
        new_k = jund.estimate_new_camera_matrix(calib.K(), calib.D(), size, calib.R(), 0.0,
                                                size, 1.0)
        mx, my = jund.init_undistort_rectify_map(calib.K(), calib.D(), calib.R(), new_k, size)
        b, wt = jund.remap_precompute(mx, my, HW, mode=mode)
        bases.append(b)
        weights.append(wt)
    base, weight = np.stack(bases), np.stack(weights)
    planes = np.random.default_rng(3).integers(0, 256, (3, CAMERAS * BATCH) + HW, np.uint8)
    want = np.asarray(jund.remap_bilinear_u8_planes(
        tuple(jnp.asarray(np.moveaxis(p, 0, -1)) for p in planes), jnp.asarray(base),
        jnp.asarray(weight), HW, HW, n_cameras=CAMERAS, mode=mode))
    want = np.moveaxis(want, -1, 1).reshape((CAMERAS * BATCH,) + HW + (3,))
    got = pund.remap_planes(tuple(torch.as_tensor(p) for p in planes), torch.as_tensor(base),
                            torch.as_tensor(weight), HW, mode)
    np.testing.assert_array_equal(_np(got), want)
    # and each camera's block is the flat remap through its own map
    for c in range(CAMERAS):
        block = tuple(torch.as_tensor(p[c * BATCH:(c + 1) * BATCH]) for p in planes)
        flat = pund.remap_planes(block, torch.as_tensor(base[c]), torch.as_tensor(weight[c]),
                                 HW, mode)
        assert torch.equal(got[c * BATCH:(c + 1) * BATCH], flat), c


@pytest.mark.parametrize("batch,cameras,chunk", [
    (16, 4, 4), (16, 4, 1), (16, 4, 3), (6, 3, 2), (12, 3, 4), (4, 1, 4), (5, 1, 2), (64, 1, 16),
])
def test_camera_blocked_grid_covers_every_frame_once(batch, cameras, chunk):
    # kernel E's grid rows (grid z a camera, grid y a frame range of its
    # block): every frame of every camera once, through its camera's map
    n = 1080 * 1920
    per = batch // cameras
    seen = []
    for z, y, f0, f1, base_off, weights_off in pund.remap_blocks(batch, cameras, chunk, n):
        assert 0 < f1 - f0 <= chunk
        assert z * per <= f0 < f1 <= (z + 1) * per  # inside its camera's block
        assert (base_off, weights_off) == (z * n, z * 4 * n)
        seen += list(range(f0, f1))
    assert sorted(seen) == list(range(batch))
    # one camera: the single map's grid (ranges of `chunk` frames, offset 0)
    if cameras == 1:
        assert [(f0, f1) for _, _, f0, f1, _, _ in pund.remap_blocks(batch, 1, chunk, n)] == [
            (s, min(batch, s + chunk)) for s in range(0, batch, chunk)]


def test_multicamera_refuses():
    config = _config()
    calibs = _calibrations(config, "distinct")
    # a mesh is accepted: the cameras over data (2 + 1 + 1 over three
    # shards), each shard with its cameras' stacked maps and tracks, equal
    # to the unsharded chain
    from raw_image_pipeline_tpu_torch.parallel import make_mesh

    frames = torch.as_tensor(_multicam_frames(11))
    for mode in ("cameras", "sequence"):
        whole = build_multicamera_pipeline(config, calibs, "bayer_gbrg8", HW, True, mode,
                                           device="cpu")
        split = build_multicamera_pipeline(config, calibs, "bayer_gbrg8", HW, True, mode,
                                           mesh=make_mesh(["cpu"] * 3))
        state = multicamera_state(CAMERAS, BATCH, mode, device="cpu")
        ref, ref_state = whole(frames, state)
        out, out_state = split(frames, state)
        assert torch.equal(out["processed"].gather("cpu"), ref["processed"])
        for f in ("x", "p", "initialized"):
            assert torch.equal(getattr(out_state, f), getattr(ref_state, f))
    with pytest.raises(ValueError):
        build_multicamera_pipeline(config, [], device="cpu")
    odd = dataclasses.replace(calibs[1], image_width=HW[1] + 2)
    with pytest.raises(ValueError, match="one frame size"):
        build_multicamera_pipeline(config, [calibs[0], odd], "bayer_gbrg8", HW, device="cpu")
    # frames whose leading axis is not the cameras
    pp = build_multicamera_pipeline(config, calibs, "bayer_gbrg8", HW, device="cpu")
    with pytest.raises(ValueError):
        pp(torch.zeros((CAMERAS - 1, BATCH) + HW, dtype=torch.uint8))
    with pytest.raises(ValueError):
        pund.remap_planes((torch.zeros((3,) + HW, dtype=torch.uint8),) * 3,
                          pp.params.remap_base, pp.params.remap_weights, HW, "lerp")


@pytest.mark.parametrize("entry", ["build_multicamera_pipeline", "multicamera_state"])
def test_multicamera_defaults_to_cuda(entry):
    fn = {"build_multicamera_pipeline": build_multicamera_pipeline,
          "multicamera_state": multicamera_state}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        if entry == "multicamera_state":
            multicamera_state(CAMERAS, BATCH)
        else:
            config = _config()
            build_multicamera_pipeline(config, _calibrations(config, "distinct"),
                                       "bayer_gbrg8", HW)
