"""The readers of the program's output packs and host call: pack_roofline
on a trace summary and its byte count from the configuration, the two host
readers on the program's span table, and the count of packed outputs
against the packs a CPU call of each configuration makes."""

import os

import pytest
from torch.profiler import ProfilerActivity, profile

from isp_bench import frames, run, spec, trace
from isp_bench.tests.small import small_cell
from raw_image_pipeline_tpu_torch.utils import profiling
from raw_image_pipeline_tpu_torch.utils.profiling import CALL_SPAN, SpanTotals

WORKLOADS = ("all-modules-1.6mp-b64", "launch-1.6mp-b64")
CONFIGS = ("alphasense_all_modules_1.6mp", "alphasense_launch_1.6mp")


def _readings(workload, summary, frames_=0):
    cell = spec.load_cell(workload)
    return run.Readings(config=cell.config, traffic=cell.traffic, setup_s=1.0, seconds=10.0,
                        frames=640, latencies_s=[1e-3], enqueue_s=[1e-3], peak_bytes=1,
                        trace=summary, traced_frames=frames_)


def _read(name, r):
    return spec.reader(name)(r)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_pack_roofline(workload):
    s = trace.TraceSummary(window_s=0.5, busy_s=0.4, stage_busy_s={"isp_pack": 0.06})
    got = _read("pack_roofline", _readings(workload, s, 2048))
    assert got == pytest.approx(100 * 12 * 1440 * 1080 * 2048 / 3.35e12 / 0.06)
    # no isp_pack range, or no trace: nothing
    assert _read("pack_roofline", _readings(workload, trace.TraceSummary(0.5, 0.4), 2048)) is None
    assert _read("pack_roofline", _readings(workload, None)) is None


@pytest.mark.parametrize("config", CONFIGS)
def test_pack_bytes_from_the_configuration(config):
    cfg = spec.load_json(os.path.join(spec.HERE, "configs", config + ".json"))
    bytes_ = spec.reader("pack_roofline").__globals__["pack_bytes"]
    assert bytes_(cfg) == 12 * 1440 * 1080


@pytest.fixture
def table(monkeypatch):
    rows = {}
    monkeypatch.setattr(profiling, "span_table", lambda: dict(rows))
    return rows


def test_host_readers_on_a_span_table(table):
    r = _readings("launch-1.6mp-b64", trace.TraceSummary(0.5, 0.4), 2048)
    # an empty table: no call was recorded
    assert _read("host_launch_ms", r) is None and _read("host_python_ms", r) is None
    table[CALL_SPAN] = SpanTotals(count=4, total_s=8e-3, self_s=1e-3, launch_s=2e-4, launches=4)
    table["isp_white_balance"] = SpanTotals(count=4, total_s=3e-3, self_s=3e-3, launch_s=4e-4,
                                            launches=24)
    table["isp_pack"] = SpanTotals(count=8, total_s=1e-3, self_s=1e-3)
    assert _read("host_launch_ms", r) == pytest.approx(0.15)
    assert _read("host_python_ms", r) == pytest.approx(1.85)
    # an untraced run reads nothing, whatever the table holds
    untraced = _readings("launch-1.6mp-b64", None)
    assert _read("host_launch_ms", untraced) is None and _read("host_python_ms", untraced) is None


def test_host_readers_without_a_span_table(monkeypatch):
    """A program that keeps no span table (a checkout older than the
    table) gives nothing and raises nothing."""
    monkeypatch.delattr(profiling, "span_table")
    r = _readings("all-modules-1.6mp-b64", trace.TraceSummary(0.5, 0.4), 2048)
    assert _read("host_launch_ms", r) is None and _read("host_python_ms", r) is None


@pytest.mark.parametrize("workload", WORKLOADS)
def test_packed_outputs_equal_the_calls_packs(workload):
    cell = small_cell(workload, 96, 128, 2)
    cfg = cell.config
    pool = frames.make_pool(cell.traffic, cfg["encoding"], cfg["frame_hw"], 3, "cpu")
    program = run.PortProgram(cfg, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        program(pool[0], program.init_state())
    ev = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    packs = [(s, e) for n, s, e in ev if n == "isp_pack"]
    stacks = [(s, e) for n, s, e in ev if n == "aten::stack"
              and any(a <= s and e <= b for a, b in packs)]
    count = spec.reader("pack_roofline").__globals__["packed_outputs"]
    assert count(cfg) == len(stacks) == 2
