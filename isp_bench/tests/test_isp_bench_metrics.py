"""The metric arithmetic: the trace's reduction on a small trace, each
reader on the readings, and the stages' byte counts from shapes alone."""

import json
import os

import pytest

from isp_bench import peaks, spec, trace
from isp_bench.run import Readings

DATA = os.path.join(os.path.dirname(__file__), "data", "trace_small.json")


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def synthetic():
    """Two calls: host ranges, the isp_* ranges on the device's timeline,
    kernels (two overlapping), a copy and a set."""
    return {"traceEvents": [
        _ev("user_annotation", "bench.submit", 0, 30),
        _ev("user_annotation", "isp_debayer", 2, 5),
        _ev("user_annotation", "bench.submit", 32, 14),
        _ev("user_annotation", "bench.wait", 50, 150),
        _ev("gpu_user_annotation", "isp_debayer", 10, 20),
        _ev("kernel", "debayer_kernel", 10, 10),
        _ev("kernel", "flip_kernel", 15, 10),  # overlaps the first: 15 us of union
        _ev("gpu_user_annotation", "isp_white_balance", 50, 60),
        _ev("kernel", "hist_kernel", 50, 20),
        _ev("gpu_memset", "Memset (Device)", 80, 10),
        _ev("gpu_memcpy", "Memcpy DtoD", 100, 10),
        _ev("kernel", "outside_window", 500, 100),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]}


def test_trace_reduction():
    s = trace.summarize(synthetic())
    # the window: the first wait's start (50) to the last wait's end (200)
    assert s.window_s == pytest.approx(150e-6)
    assert s.busy_s == pytest.approx((20 + 10 + 10) * 1e-6)
    # a stage's busy time over every traced call, the first included
    assert s.stage_busy_s["isp_debayer"] == pytest.approx(15e-6)
    assert s.stage_busy_s["isp_white_balance"] == pytest.approx(40e-6)
    assert s.device_ops[0] == ("hist_kernel", pytest.approx(20e-6))
    assert "outside_window" not in dict(s.device_ops)
    assert "debayer_kernel" not in dict(s.device_ops)
    # 110-200, 70-80 and 90-100 inside the wait
    gaps = sorted((round(t * 1e6), n) for n, t in s.idle_gaps)
    assert gaps == [(10, "bench.wait"), (10, "bench.wait"), (90, "bench.wait")]
    assert sum(t for _, t in s.idle_gaps) == pytest.approx(s.window_s - s.busy_s)


def test_recorded_trace():
    """A trace recorded on the card (NVIDIA H100 80GB HBM3: two calls of the
    port's all-module flagship configuration at 64x96, B=2, kept to the
    events the reduction reads). At that size the card finishes each call before the host's first wait, so the
    window is all idle, while every stage's range holds its kernels."""
    with open(DATA) as f:
        t = json.load(f)
    s = trace.summarize(t)
    assert s.busy_s == 0 and s.window_s > 0 and s.device_ops == []
    assert len(s.idle_gaps) == 1 and s.idle_gaps[0][1] == pytest.approx(s.window_s)
    assert set(s.stage_busy_s) == {"isp_debayer", "isp_white_balance", "isp_pointwise",
                                   "isp_undistortion"}
    kernels = [e for e in t["traceEvents"] if e["cat"] == "kernel"]
    total = trace.union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels) * 1e-6
    assert 0 < sum(s.stage_busy_s.values()) <= total


def _readings(workload, summary=None, frames=0):
    cell = spec.load_cell(workload)
    return Readings(config=cell.config, traffic=cell.traffic, setup_s=12.5, seconds=10.0,
                    frames=6400, latencies_s=[i * 1e-3 for i in range(1, 101)],
                    enqueue_s=[1e-3, 3e-3], peak_bytes=3 * 2**30, trace=summary,
                    traced_frames=frames)


def test_end_to_end_readers():
    r = _readings("all-modules-1.6mp-b64")
    cell = spec.load_cell("all-modules-1.6mp-b64")
    got = {m.name: m.read(r) for m in cell.end_to_end}
    assert got == {"frames_per_s": 640.0, "batch_ms_p95": pytest.approx(95.0),
                   "peak_device_mib": 3072.0, "setup_s": 12.5}


def test_per_layer_readers():
    s = trace.TraceSummary(window_s=0.5, busy_s=0.4, stage_busy_s={
        "isp_debayer": 0.01, "isp_white_balance": 0.02, "isp_pointwise": 0.05,
        "isp_undistortion": 0.03})
    r = _readings("all-modules-1.6mp-b64", s, frames=1000)
    got = {m.name: m.read(r) for m in spec.load_cell("all-modules-1.6mp-b64").per_layer}
    px = 1080 * 1440
    assert got["host_enqueue_ms"] == pytest.approx(2.0)
    assert got["device_idle_share"] == pytest.approx(20.0)
    assert got["stage_us_per_frame.white_balance"] == pytest.approx(20.0)
    assert got["debayer_roofline"] == pytest.approx(100 * 4 * px * 1000 / 3.35e12 / 0.01)
    assert got["pointwise_roofline"] == pytest.approx(100 * 6 * px * 1000 / 3.35e12 / 0.05)
    assert 0 < got["undistortion_roofline"] < 100 * 6 * px * 1000 / 3.35e12 / 0.03
    # a reader with nothing to read gives nothing, never 0
    none = {m.name: m.read(_readings("launch-1.6mp-b64", trace.TraceSummary(1.0, 0.5), 64))
            for m in spec.load_cell("launch-1.6mp-b64").per_layer}
    assert none["debayer_roofline"] is None and none["undistortion_roofline"] is None
    assert "pointwise_roofline" not in none  # the launch cells have no pointwise range


@pytest.mark.parametrize("config", ["alphasense_all_modules_1.6mp", "alphasense_launch_1.6mp"])
def test_byte_counts_from_shapes(config):
    import importlib

    cfg = spec.load_json(os.path.join(spec.HERE, "configs", config + ".json"))
    (h, w), (fh, fw), (ho, wo) = peaks.frame_dims(cfg)
    assert (h, w) == (fh, fw) == (ho, wo) == tuple(cfg["frame_hw"])
    und = spec.reader("undistortion_roofline").__globals__["source_pixels_read"]
    read = und(cfg)
    # a fisheye rectification reads most, never more, of the source
    assert 0.5 * fh * fw < read <= fh * fw
    assert peaks.roofline_share(3.35e12, 1, 1.0) == pytest.approx(100.0)
    importlib.invalidate_caches()
