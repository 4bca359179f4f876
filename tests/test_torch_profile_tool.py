"""The device-time accounting of raw_image_pipeline_tpu_torch.tools.
profile_chains on synthetic torch.profiler traces: busy time is the union
of the device work's intervals (never above the window it spans), and the
isp_* ranges on the device's timeline are spans, not work."""

import pytest

from raw_image_pipeline_tpu_torch.tools.profile_chains import device_time, union_us


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),  # overlap counted once
    ([(0, 10), (2, 4)], 10.0),  # nested
    ([(20, 30), (0, 10)], 20.0),  # unsorted, with a gap
    ([(0, 10), (10, 20)], 20.0),  # touching
])
def test_union_us(intervals, want):
    assert union_us(intervals) == want


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_device_time_counts_work_once_and_ranges_as_spans():
    trace = {"traceEvents": [
        _ev("gpu_user_annotation", "isp_white_balance", 0, 100),
        _ev("gpu_user_annotation", "isp_debayer", 100, 50),
        _ev("user_annotation", "isp_white_balance", 0, 300),  # host side: ignored
        _ev("cpu_op", "aten::add", 0, 400),  # host side: ignored
        _ev("kernel", "k1", 10, 30),
        _ev("kernel", "k2", 30, 20),  # overlaps k1 by 10
        _ev("gpu_memcpy", "Memcpy HtoD", 90, 20),  # straddles the two ranges
        _ev("gpu_memset", "Memset", 120, 10),
        _ev("gpu_user_annotation", "isp_white_balance", 200, 40),  # a second chunk
        _ev("kernel", "k3", 210, 10),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},  # not a complete event
    ]}
    d = device_time(trace)
    assert d["busy_us"] == 40 + 20 + 10 + 10  # [10, 50) + [90, 110) + [120, 130) + [210, 220)
    assert d["work_sum_us"] == 30 + 20 + 20 + 10 + 10
    assert d["kernels"] == 3
    assert d["window_us"] == 210
    assert d["stages"]["isp_white_balance"] == {"span_us": 140.0, "busy_us": 40 + 10 + 10}
    assert d["stages"]["isp_debayer"] == {"span_us": 50.0, "busy_us": 10 + 10}
    assert d["busy_us"] <= d["window_us"]
