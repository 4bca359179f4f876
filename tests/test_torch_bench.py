"""The port's benchmark program (raw_image_pipeline_tpu_torch/tools/bench.py)
against the repository's root bench.py on the CPU: its configurations are
bench.py's field for field, each configuration's chain equals the JAX
package's byte for byte (and in Kalman state) on the same seeded frames,
its checks hold on the CPU, and its main prints bench.py's headline keys.
No test here asserts on a timing."""

import ast
import dataclasses
import json
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from raw_image_pipeline_tpu.config import PipelineConfig as JaxPipelineConfig
from raw_image_pipeline_tpu.parallel.multicamera import (
    build_multicamera_pipeline as jax_build_multicamera_pipeline,
)
from raw_image_pipeline_tpu.pipeline import build_pipeline as jax_build_pipeline
from raw_image_pipeline_tpu.pipeline import init_state as jax_init_state
from raw_image_pipeline_tpu_torch.ops import ccc as pccc
from raw_image_pipeline_tpu_torch.tools import bench
from test_torch_pipeline import _frames, _p_after, _track_x

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = (108, 144)  # bench.py's own CPU smoke size (tests/test_bench_smoke.py)


def _jax_configs(h, w):
    """bench.py's configurations as its config_benchmarks builds them, with
    the batches, microbatch and state it runs them at."""
    rep = dataclasses.replace
    full = ge._full_config((h, w))  # bench.py:242
    cfg1 = JaxPipelineConfig(  # bench.py:245-249
        gamma_correction=rep(full.gamma_correction, enabled=True, method="default", k=0.9))
    cfg2 = JaxPipelineConfig(  # bench.py:298-304
        flip=rep(full.flip, enabled=True, angle=180),
        white_balance=rep(full.white_balance, enabled=True, method="grey_world",
                          temporal_consistency=False),
    )
    cfg3 = full.replace(white_balance=rep(  # bench.py:322-327
        full.white_balance, enabled=True, method="ccc", temporal_consistency=True))
    cfg4 = JaxPipelineConfig(  # bench.py:352-362
        color_calibration=rep(full.color_calibration, enabled=True),
        vignetting_correction=rep(full.vignetting_correction, enabled=True, scale=1.5,
                                  a2=1e-3, a4=1e-6),
        color_enhancer=rep(full.color_enhancer, enabled=True, saturation_gain=1.2),
    )

    def perturb(calib, s):  # bench.py:407-411
        k = list(calib.camera_matrix)
        k[0] *= s
        k[4] *= s
        return rep(calib, camera_matrix=tuple(k))

    calibs = [perturb(full.calibration, s) for s in (1.0, 1.02, 0.98, 1.04)]  # bench.py:413
    return {
        "config1": (cfg1, (16, 64), {}),  # bench.py:255-256
        "config2": (cfg2, (16, 64), {}),  # bench.py:308-309
        "config3": (cfg3, (16, 64), dict(with_state=True, temporal_mode="sequence")),
        "config4": (cfg4, (128, 512), dict(microbatch=128)),  # bench.py:368-374
        "config5": (full, (16, 64), dict(calibrations=calibs)),  # bench.py:427-428
        # bench.py:450, tpu_fps's batches (bench.py:83)
        "config6": (ge._full_config((h, w * 3 // 4)), (16, 64, 128), {}),
    }


@pytest.mark.parametrize("name", [f"config{i}" for i in range(1, 7)])
def test_bench_configs_equal_bench_py(name):
    entry = bench.bench_configs(1080, 1920)[name]
    cfg, batches, extra = _jax_configs(1080, 1920)[name]
    assert dataclasses.asdict(entry.config) == dataclasses.asdict(cfg)
    assert entry.batches == batches
    assert entry.microbatch == extra.get("microbatch")
    assert entry.with_state == extra.get("with_state", False)
    assert entry.temporal_mode == extra.get("temporal_mode", "cameras")
    assert [dataclasses.asdict(c) for c in entry.calibrations] == [
        dataclasses.asdict(c) for c in extra.get("calibrations", [])]
    assert entry.encoding == ("bgr8" if name == "config4" else "bayer_gbrg8")
    if name == "config4":  # bench.py:368
        assert entry.ladder == ((512, 128), (256, None), (128, None))
    if name == "config6":  # the reference's 1.6 MP frame, bench.py:450
        assert entry.hw == (1080, 1440)


def _color_frames(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), np.uint8)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("name", [f"config{i}" for i in range(1, 7)])
def test_bench_chain_equals_jax(name):
    """Each configuration's chain as the tool builds it (build_chain, on the
    CPU) against the JAX package's as bench.py builds it, at 108x144 on
    seeded frames whose colour cast moves from frame to frame: 0
    mismatching bytes over two calls, and config 3's Kalman track carried
    across them equal."""
    h, w = SMALL
    entry = bench.bench_configs(h, w)[name]
    cfg, _, extra = _jax_configs(h, w)[name]
    hw = entry.hw
    if name == "config4":  # microbatch 2 of 5 frames: two chunks and a remainder
        entry = dataclasses.replace(entry, microbatch=2)
        extra = dict(microbatch=2)
    pipe = bench.build_chain(entry, device="cpu")
    if name == "config5":
        jp = jax_build_multicamera_pipeline(cfg, extra["calibrations"], "bayer_gbrg8",
                                            frame_hw=hw)
        frames = _frames(51, 8, *hw).reshape(4, 2, *hw)
        splits = np.split(frames, 2, axis=1)
    else:
        jp = jax_build_pipeline(cfg, entry.encoding, frame_hw=hw, **extra)
        n = 5 if name == "config4" else 4
        frames = (_color_frames(41, n, *hw) if name == "config4"
                  else _frames(sum(hw) + len(name), n, *hw))
        splits = [frames[:n // 2], frames[n // 2:]]
    js = jax_init_state(()) if entry.with_state else None
    ps = bench.tp.init_state((), device="cpu") if entry.with_state else None
    jstates, pstates = [], []
    with mock.patch.object(pccc, "kalman_scan", wraps=pccc.kalman_scan) as scan:
        for chunk in splits:
            jo, js = jp(chunk, js)
            po, ps = pipe(torch.as_tensor(chunk), ps)
            want, got = np.asarray(jo["processed"]), _np(po["processed"])
            assert got.shape == want.shape
            assert int((got != want).sum()) == 0  # 0 mismatching bytes
            jstates.append(js)
            pstates.append(ps)
    if entry.with_state:
        meas = np.concatenate([_np(c.args[1]) for c in scan.call_args_list])
        _assert_track(jstates[-1], pstates[-1], meas)


def _assert_track(js, ps, meas):
    """One "sequence" track through the peaks meas [T, 2], carried over the
    calls. The port keeps both roundings of x + k*(z - x) and (1 - k) * p'
    exactly. XLA:CPU contracts the JAX package's scanned update in a way
    that depends on the program it is compiled into (ROADMAP Queue 3,
    "Recorded"); in this chain without intermediates neither the plain nor
    the per-step fused formula gives its last x, which lies 1 ulp from the
    port's."""
    np.testing.assert_array_equal(_np(ps.initialized), np.asarray(js.initialized))
    np.testing.assert_array_equal(_np(ps.x), _track_x(meas, fused=False))
    assert _np(ps.p) == _p_after(len(meas) - 1, fused=False)
    np.testing.assert_array_max_ulp(np.asarray(js.x), _np(ps.x), maxulp=1)
    np.testing.assert_array_max_ulp(np.asarray(js.p), _np(ps.p), maxulp=1)


def test_colorcal_semantics_check_on_cpu():
    assert bench.colorcal_semantics_check(device="cpu") == 0


def test_ccc_response_precision_check_on_cpu():
    assert bench.ccc_response_precision_check(n=4, device="cpu") == 0


def test_kernel_checks_on_cpu():
    # on the CPU both sides are the plain versions: the checks' code path
    assert bench.kernel_debayer_check(24, 32, device="cpu") == 0
    assert bench.kernel_histogram_check(n=2, device="cpu") == 0


def test_kernel_check_raises_on_a_mismatch():
    from raw_image_pipeline_tpu_torch.ops import debayer

    real = debayer.debayer_planes

    def off_by_one(bayer, encoding, algorithm="bilinear", *, plain=False):
        planes = real(bayer, encoding, algorithm, plain=plain)
        return planes if plain else (planes[0] ^ 1,) + tuple(planes[1:])

    with mock.patch.object(debayer, "debayer_planes", off_by_one):
        with pytest.raises(AssertionError, match="DEBAYER KERNEL REGRESSION"):
            bench.kernel_debayer_check(8, 12, device="cpu")


def test_first_fitting_steps_only_on_out_of_memory():
    tried = []

    def run(b, mb):
        tried.append((b, mb))
        if b > 128:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return b * 2

    ladder = ((512, 128), (256, None), (128, None))
    assert bench.first_fitting(ladder, run) == (128, None, 256)
    assert tried == list(ladder)

    def broken(b, mb):
        raise ValueError("not a memory fault")

    with pytest.raises(ValueError):
        bench.first_fitting(ladder, broken)
    with pytest.raises(RuntimeError, match="no rung"):
        bench.first_fitting(((512, 128),), lambda b, mb: run(b, mb))


def test_cut_divides_every_batch():
    e4 = bench._cut(bench.bench_configs(108, 144)["config4"], 16)
    assert e4.batches == (8, 32) and e4.microbatch == 8
    assert e4.ladder == ((32, 8), (16, None), (8, None))


def test_cpu_fps_runs_small():
    assert bench.cpu_fps(iters=1, h=108, w=144) > 0


def test_card_scaling():
    # one device: None, as bench.py's tpu_scaling on a single chip
    assert bench.card_scaling(48, 64, 1, devices=["cpu"]) is None
    # two logical shards of the CPU: the mesh path runs (no scaling figure)
    assert bench.card_scaling(48, 64, 1, devices=["cpu", "cpu"]) > 0


def test_main_on_cpu_prints_bench_py_keys(capsys):
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        parsed = json.load(f)["parsed"]
    rc = bench.main(["--device", "cpu", "--height", "48", "--width", "64",
                     "--batch-divisor", "16", "--repeats", "1", "--rounds", "1",
                     "--cpu-iters", "1"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    head, details = json.loads(lines[-1]), json.loads(lines[-2])
    assert set(parsed) | {"cpu_fps", "device", "card"} <= set(head)
    assert set(parsed) == set(bench.HEADLINE_KEYS)
    assert head["metric"] == parsed["metric"] and head["unit"] == "frames/s"
    assert head["device"] == "cpu" and head["card"] is None
    assert head["steady_state_batch"] == 8  # 128 // 16
    assert details["checks"] == {"kernel_debayer_check": 0, "ccc_response_precision_check": 0,
                                 "kernel_histogram_check": 0, "colorcal_semantics_check": 0}
    assert sorted(details["configs"]) == sorted([
        "config1_debayer_gamma", "config2_debayer_flip_greyworld_b64",
        "config3_streamed_ccc_kalman", "config4_pointwise_b32_microbatch8",
        "config5_multicamera_4x_distinct_calibs", "config6_alphasense_1.6mp_full_chain"])


def test_main_without_a_card_exits_nonzero(capsys):
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        assert bench.main([]) != 0
    assert capsys.readouterr().out == ""


def test_bench_imports_no_jax():
    with open(bench.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "raw_image_pipeline_tpu", "__graft_entry__", "bench"}
