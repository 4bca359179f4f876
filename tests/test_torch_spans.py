"""The port's spans (utils/profiling.span): the ranges a call of each
benchmark configuration opens under torch.profiler at a small size on the
CPU, and the in-memory span table that recorded calls fill."""

import threading
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from isp_bench import check, frames, run
from isp_bench.tests.small import small_cell
from raw_image_pipeline_tpu_torch import kernels
from raw_image_pipeline_tpu_torch.utils import profiling
from raw_image_pipeline_tpu_torch.utils.profiling import CALL_SPAN, span

def _program(workload, undistort=True):
    cell = small_cell(workload, 96, 128, 2)
    cfg = cell.config
    cfg["pipeline"]["undistortion"]["enabled"] = undistort
    pool = frames.make_pool(cell.traffic, cfg["encoding"], cfg["frame_hw"], 11, "cpu")
    program = run.PortProgram(cfg, "cpu")
    return program, pool


def _build(workload, **kw):
    """The launch profile's pipeline at 96x128 on the CPU, built with kw
    ("processed" alone kept), and its frames."""
    from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model
    from raw_image_pipeline_tpu_torch.pipeline import build_pipeline

    cell = small_cell(workload, 96, 128, 4)
    cfg = cell.config
    pool = frames.make_pool(cell.traffic, cfg["encoding"], cfg["frame_hw"], 12, "cpu")
    pipe = build_pipeline(run.pipeline_config(cfg), cfg["encoding"],
                          frame_hw=tuple(cfg["frame_hw"]),
                          ccc_model=load_ccc_model(check.ccc_model_path(cfg)), device="cpu",
                          **kw)
    return pipe, pool


def _ranges(prof):
    """(name, start, end, thread) of every host event of a profile."""
    return [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()]


def _inside(ev, ranges, name=None):
    """The isp_* ranges (of `name` alone, if given) that hold the event."""
    n, s, e, t = ev
    return [r for r in ranges if r[0].startswith("isp_") and r[3] == t and r[1] <= s
            and e <= r[2] and r is not ev and (name is None or r[0] == name)]


def _innermost(ev, ranges):
    around = _inside(ev, ranges)
    return min(around, key=lambda r: r[2] - r[1])[0] if around else None


@pytest.mark.parametrize("workload,undistort,packs", [
    ("all-modules-1.6mp-b64", True, 2), ("launch-1.6mp-b64", True, 2),
    # no remap: the launch profile's gains leave the planes to a pack;
    # all-modules' pointwise call writes the [B, H, W, 3] output itself
    ("all-modules-1.6mp-b64", False, 2), ("launch-1.6mp-b64", False, 3)])
def test_a_call_opens_its_stages_inside_isp_call(workload, undistort, packs):
    program, pool = _program(workload, undistort)
    state = program.init_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        program(pool[0], state)
    ev = _ranges(prof)
    calls = [r for r in ev if r[0] == CALL_SPAN]
    stages = [r for r in ev if r[0].startswith("isp_") and r[0] != CALL_SPAN]
    assert len(calls) == 1 and stages
    # every stage range inside the one isp_call
    assert all(_inside(r, calls) for r in stages)
    names = {r[0] for r in stages}
    # the flip is hoisted onto the mosaic: no empty isp_flip range
    assert "isp_flip" not in names
    assert ("isp_undistortion" in names) == undistort
    # no stack or cat outside a stage range (on the CPU the plain versions
    # stack inside their own stages; on the card none does); the output
    # packs, the last one too where no remap runs, inside isp_pack
    copies = [r for r in ev if r[0] in ("aten::stack", "aten::cat")]
    assert all(_innermost(r, ev) not in (None, CALL_SPAN) for r in copies)
    packed = [r for r in copies if r[0] == "aten::stack" and _innermost(r, ev) == "isp_pack"]
    assert len(packed) == packs


def test_a_chunked_call_joins_its_chunks_inside_isp_pack():
    """Two chunks of two frames, "processed" alone kept: the join of the
    chunks' outputs is the call's one pack."""
    pipe, pool = _build("launch-1.6mp-b64", microbatch=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe(pool[0], None)
    ev = _ranges(prof)
    cats = [r for r in ev if r[0] == "aten::cat"]
    assert all(_innermost(r, ev) not in (None, CALL_SPAN) for r in cats)
    (join,) = [r for r in ev if r[0] == "isp_pack"]
    assert [x[0] for x in _inside(join, ev)] == [CALL_SPAN]
    assert any(_innermost(r, ev) == "isp_pack" for r in cats)


@pytest.fixture
def table():
    profiling.reset_span_table()
    yield
    profiling.reset_span_table()


def test_calls_record_only_under_the_profiler(table):
    program, pool = _program("launch-1.6mp-b64")
    state = program.init_state()
    for k in range(2):
        _, state = program(pool[k % pool.shape[0]], state)
    assert profiling.span_table() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(3):
            _, state = program(pool[k % pool.shape[0]], state)
    t = profiling.span_table()
    assert t[CALL_SPAN].count == 3 and t["isp_pack"].count == 6
    assert t["isp_undistortion"].count == t["isp_white_balance"].count == 3
    for row in t.values():
        assert 0 <= row.self_s <= row.total_s
    # self time adds up to the calls' time: every stage runs inside a call
    assert sum(r.self_s for r in t.values()) == pytest.approx(t[CALL_SPAN].total_s)
    assert sum(r.launch_s for r in t.values()) <= t[CALL_SPAN].total_s
    profiling.reset_span_table()
    assert profiling.span_table() == {}
    # a span outside any call records nothing, under the profiler too
    with profile(activities=[ProfilerActivity.CPU]):
        with span("isp_pack"):
            pass
    assert profiling.span_table() == {}


def test_a_sharded_call_records_whole(table):
    """Over two row slabs the slabs' chains run in turns, so their stage
    spans overlap and close out of order: the time still goes to one
    span at a time."""
    pipe, pool = _build("all-modules-1.6mp-b64", spatial_shards=2)
    with profile(activities=[ProfilerActivity.CPU]):
        pipe(pool[0], None)
    t = profiling.span_table()
    assert t[CALL_SPAN].count == 1 and t["isp_debayer"].count == 2
    for row in t.values():
        assert 0 <= row.self_s <= row.total_s
    assert sum(r.self_s for r in t.values()) == pytest.approx(t[CALL_SPAN].total_s)


class _SlowEntry:
    """A stand-in for the kernels' library: each C entry takes 2 ms."""

    def __getattr__(self, name):
        def entry(*args):
            time.sleep(0.002)
            return 0
        return entry


def test_a_launch_books_its_c_entry_to_the_innermost_span(table, monkeypatch):
    monkeypatch.setattr(kernels.LIBRARY, "_lib", _SlowEntry())
    monkeypatch.setattr(kernels.DEBAYER_BILINEAR, "launches", 0)
    kernels.DEBAYER_BILINEAR.launch()  # outside a recorded call: counted, not booked
    assert profiling.span_table() == {} and kernels.DEBAYER_BILINEAR.launches == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with span(CALL_SPAN):
            kernels.DEBAYER_BILINEAR.launch()
            with span("isp_debayer"):
                kernels.DEBAYER_BILINEAR.launch()
                kernels.DEBAYER_BILINEAR.launch()
    t = profiling.span_table()
    assert (t[CALL_SPAN].launches, t["isp_debayer"].launches) == (1, 2)
    assert kernels.DEBAYER_BILINEAR.launches == 4
    assert t[CALL_SPAN].launch_s >= 0.002 and t["isp_debayer"].launch_s >= 0.004
    assert t["isp_debayer"].launch_s <= t["isp_debayer"].self_s <= t["isp_debayer"].total_s
    assert t[CALL_SPAN].launch_s + t["isp_debayer"].launch_s <= t[CALL_SPAN].total_s
    assert t[CALL_SPAN].self_s == pytest.approx(t[CALL_SPAN].total_s - t["isp_debayer"].total_s)


def test_spans_on_two_threads_nest_separately(table):
    """Thread A's call stays open while thread B runs a call with a child:
    B's child is B's alone, so A's call keeps all its time as self time."""
    opened, done = threading.Event(), threading.Event()

    def a():
        with span(CALL_SPAN):
            opened.set()
            assert done.wait(10)

    def b():
        assert opened.wait(10)
        with span(CALL_SPAN):
            with span("isp_pack"):
                time.sleep(0.005)
        done.set()

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=f) for f in (a, b)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(20)
        assert not any(th.is_alive() for th in threads)
    t = profiling.span_table()
    assert t[CALL_SPAN].count == 2 and t["isp_pack"].count == 1
    # the calls' time less their self time is B's child alone
    assert t[CALL_SPAN].total_s - t[CALL_SPAN].self_s == pytest.approx(t["isp_pack"].total_s)
