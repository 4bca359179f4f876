"""The port's StreamRunner (runtime/stream.py) on the CPU: the JAX
package's tests/test_stream.py mirrored on the port (stream outputs, slow
decimation, the reset service, RGB output, camera_info, the state
checkpoint, the stateless tail pad and the stateful tail, microbatch), and
the port's runner against the JAX package's on the same frames: every
(stream, index) image byte for byte and the final Kalman state."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
from test_torch_pipeline import _np

import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu.runtime.stream import StreamRunner as JaxStreamRunner
from raw_image_pipeline_tpu_torch.config import PipelineConfig
from raw_image_pipeline_tpu_torch.ops import ccc as pccc
from raw_image_pipeline_tpu_torch.runtime.stream import StreamRunner, make_camera_infos


def _config(temporal_consistency=True, config_type=PipelineConfig):
    cfg = config_type()
    return config_type(
        white_balance=dataclasses.replace(
            cfg.white_balance, enabled=True, method="ccc",
            temporal_consistency=temporal_consistency,
        ),
    )


@pytest.fixture()
def frames():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (32, 48), np.uint8) for _ in range(7)]


def _runner(config, batch_size, **kw):
    return StreamRunner(config, "bayer_gbrg8", (32, 48), batch_size=batch_size, device="cpu",
                        **kw)


def test_stream_outputs_and_slow(frames):
    runner = _runner(_config(), 3, slow_skip=2)
    got = {}
    n = runner.run(iter(frames), lambda s, i, img: got.setdefault(s, []).append(i))
    assert n == 7
    assert got["color"] == list(range(7))
    assert got["debayered"] == list(range(7))
    # slow stream decimated by skip=2 (every 3rd frame)
    assert len(got["color/slow"]) == 2


def test_stream_reset_white_balance(frames):
    runner = _runner(_config(), 2)
    outs1 = []
    runner.run(iter(frames[:2]), lambda s, i, img: outs1.append(img) if s == "color" else None)
    state_after = runner.state
    runner.reset_white_balance()
    assert not _np(runner.state.initialized).any()
    assert _np(state_after.initialized).all()


def test_rgb_output_encoding(frames):
    runner = _runner(_config(), 4, output_encoding="RGB")
    bgr_runner = _runner(_config(), 4)
    a, b = [], []
    runner.run(iter(frames[:2]), lambda s, i, img: a.append(img) if s == "color" else None)
    bgr_runner.run(iter(frames[:2]), lambda s, i, img: b.append(img) if s == "color" else None)
    np.testing.assert_array_equal(a[0], b[0][..., ::-1])


def test_camera_infos():
    from raw_image_pipeline_tpu_torch.config import (
        DEFAULT_CALIBRATION_PATH,
        DEFAULT_PARAMS_PATH,
    )

    api = tp.RawImagePipeline(False, DEFAULT_PARAMS_PATH, DEFAULT_CALIBRATION_PATH, "",
                              device="cpu")
    infos = make_camera_infos(api)
    assert infos["dist"].distortion_model == "equidistant"
    # rectified stream reports no distortion; model string fixed to
    # plumb_bob like the reference (raw_image_pipeline_ros.cpp:318-320)
    assert infos["rect"].distortion_model == "plumb_bob"
    assert infos["rect"].D == [0.0, 0.0, 0.0, 0.0]
    assert infos["dist"].width == 720
    # the same metadata as the JAX package's from the same files
    from raw_image_pipeline_tpu import RawImagePipeline as JaxRawImagePipeline
    from raw_image_pipeline_tpu.runtime.stream import make_camera_infos as jax_camera_infos

    jinfos = jax_camera_infos(JaxRawImagePipeline(False, DEFAULT_PARAMS_PATH,
                                                  DEFAULT_CALIBRATION_PATH, ""))
    assert {k: v.to_dict() for k, v in infos.items()} == \
        {k: v.to_dict() for k, v in jinfos.items()}


def test_state_checkpoint_resume(tmp_path):
    """The Kalman illuminant track checkpoints to disk and resumes with
    bit-identical downstream behavior (SURVEY §5 checkpoint/resume)."""
    st = tp.init_state((), device="cpu")
    st, _ = pccc.kalman_update(st, torch.tensor([100, 120], dtype=torch.int32))
    st, _ = pccc.kalman_update(st, torch.tensor([110, 125], dtype=torch.int32))
    path = str(tmp_path / "wb_state.npz")
    tp.save_state(st, path)
    st2 = tp.load_state(path, device="cpu")
    a = pccc.kalman_update(st, torch.tensor([90, 140], dtype=torch.int32))
    b = pccc.kalman_update(st2, torch.tensor([90, 140], dtype=torch.int32))
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[0].x, b[0].x)
    assert torch.equal(a[0].p, b[0].p)


def test_partial_tail_batch_padded(frames):
    """A stateless run whose frame count is not a batch multiple pads the
    tail dispatch to the batch size and emits exactly the real frames,
    identical to processing them in one batch."""
    cfg = _config(temporal_consistency=False)
    seq = [frames[i % len(frames)] for i in range(5)]  # 5 frames, batch 4
    h, w = seq[0].shape[:2]
    runner = StreamRunner(cfg, "bayer_gbrg8", (h, w), batch_size=4, device="cpu")
    sizes = []
    inner = runner.pipe.fn
    runner.pipe.fn = lambda p, px, st: sizes.append(px.shape[0]) or inner(p, px, st)
    got = {}
    n = runner.run(iter(seq), lambda stream, idx, img: got.setdefault((stream, idx), img))
    assert n == 5
    assert ("color", 4) in got and ("color", 5) not in got
    assert sizes == [4, 4]  # the tail of 1 ran padded

    ref_pipe = tp.build_pipeline(cfg, "bayer_gbrg8", frame_hw=(h, w), keep_intermediates=True,
                                 device="cpu")
    out, _ = ref_pipe(torch.as_tensor(np.stack(seq)))
    for i in range(5):
        np.testing.assert_array_equal(got[("color", i)],
                                      _np(out.get("dist_color", out["processed"])[i]))


def test_stream_runner_microbatch(frames):
    """batch_size beyond single-dispatch memory works via microbatch, with
    identical outputs to the plain runner."""
    cfg = _config(temporal_consistency=False)
    seq = [frames[i % len(frames)] for i in range(4)]
    got_a, got_b = {}, {}
    _runner(cfg, 4).run(iter(seq), lambda s, i, img: got_a.setdefault((s, i), img))
    _runner(cfg, 4, microbatch=2).run(iter(seq), lambda s, i, img: got_b.setdefault((s, i), img))
    assert got_a.keys() == got_b.keys()
    for k in got_a:
        np.testing.assert_array_equal(got_a[k], got_b[k])


def test_stream_runner_stateful_microbatch_tail(frames):
    """A stateful runner with microbatch survives a partial tail batch whose
    size is not a multiple of the microbatch (7 frames, batch_size=4,
    microbatch=2 -> tail of 3), with outputs and the carried Kalman track
    bitwise equal to the plain stateful runner; the tail runs unpadded."""
    got_a, got_b = {}, {}
    plain = _runner(_config(), 4)
    micro = _runner(_config(), 4, microbatch=2)
    sizes = []
    inner = plain.pipe.fn
    plain.pipe.fn = lambda p, px, st: sizes.append(px.shape[0]) or inner(p, px, st)
    na = plain.run(iter(frames), lambda s, i, img: got_a.setdefault((s, i), img))
    nb = micro.run(iter(frames), lambda s, i, img: got_b.setdefault((s, i), img))
    assert na == nb == 7
    assert sizes == [4, 3]
    assert got_a.keys() == got_b.keys()
    for k in got_a:
        np.testing.assert_array_equal(got_a[k], got_b[k])
    assert torch.equal(plain.state.x, micro.state.x)


def test_stream_runner_equals_reference(frames):
    """The port's runner and the JAX package's on the same 7 frames (batch
    3, so a stateful tail of 1; slow_skip=2): the same (stream, index)
    images, byte for byte, and the same final Kalman state (p: each side's
    own formula, ROADMAP Queue 3)."""
    got, jgot = {}, {}
    runner = _runner(_config(), 3, slow_skip=2)
    jrunner = JaxStreamRunner(_config(config_type=_jax_config_type()), "bayer_gbrg8", (32, 48),
                              batch_size=3, slow_skip=2)
    assert runner.run(iter(frames), lambda s, i, img: got.setdefault((s, i), img)) == 7
    assert jrunner.run(iter(frames), lambda s, i, img: jgot.setdefault((s, i), img)) == 7
    assert got.keys() == jgot.keys()
    assert {s for s, _ in got} == {"color", "debayered", "color/slow"}
    for k in got:
        assert got[k].shape == jgot[k].shape, k
        assert int((got[k] != jgot[k]).sum()) == 0, k
    np.testing.assert_array_equal(_np(runner.state.initialized),
                                  np.asarray(jrunner.state.initialized))
    # x equal; p is each side's own formula (XLA:CPU contracts the JAX
    # package's (1 - k) * p', tests/test_torch_pipeline.py)
    np.testing.assert_array_equal(np.asarray(jrunner.state.x), _np(runner.state.x))
    # the track took one filtering step for every frame after the first
    from test_torch_pipeline import _p_after

    assert _np(runner.state.p) == _p_after(6, fused=False)
    assert np.asarray(jrunner.state.p) == _p_after(6, fused=True)


def _jax_config_type():
    from raw_image_pipeline_tpu.config import PipelineConfig as JaxPipelineConfig

    return JaxPipelineConfig


def test_stream_runner_refuses_mesh_and_defaults_to_cuda(frames):
    """A mesh is accepted: each batch is split over it (data 2 x space 2;
    the stateful tail of one frame leaves a data shard without frames) and
    gathered for the sink in order, every image and the Kalman state equal
    to the runner without one. The device defaults to the card."""
    from raw_image_pipeline_tpu_torch.parallel import make_mesh

    got = {}
    for name, kw in (("one", {}), ("mesh", {"mesh": make_mesh(["cpu"] * 4, space=2)})):
        runner = _runner(_config(), 3, **kw)
        out = []
        assert runner.run(iter(frames), lambda s, i, img: out.append((s, i, img.copy()))) == 7
        got[name] = out, runner.state
    (one, one_state), (mesh, mesh_state) = got["one"], got["mesh"]
    assert [(s, i) for s, i, _ in mesh] == [(s, i) for s, i, _ in one]
    for (_, _, a), (_, _, b) in zip(mesh, one):
        np.testing.assert_array_equal(a, b)
    for f in ("x", "p", "initialized"):
        assert torch.equal(getattr(mesh_state, f), getattr(one_state, f))
    assert inspect.signature(StreamRunner).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        StreamRunner(_config(), "bayer_gbrg8", (32, 48))
