"""The accounting of raw_image_pipeline_tpu_torch.tools on synthetic
inputs: profile_chains on torch.profiler traces (busy time is the union of
the device work's intervals, never above the window it spans; the isp_*
ranges on the device's timeline are spans, not work; a range's host side
counts the CUDA API calls that start in it), the kernel bound and kernels
C's, A's, D's and E's work (tools/measure), the order of compare_checkouts'
turns, sass_census on a listing in cuobjdump's format, and card_tests'
collection of the cuda-marked tests with jax stubbed."""

import json
import math
import subprocess

import pytest

from raw_image_pipeline_tpu_torch.tools import compare_checkouts
from raw_image_pipeline_tpu_torch.tools.compare_checkouts import TURNS, _summary, medians
from raw_image_pipeline_tpu_torch.tools.measure import (
    DEBAYER_OPS_PER_PIXEL,
    bound,
    ccc_response_work,
    debayer_work,
    remap_float_work,
    remap_lerp_work,
)
from raw_image_pipeline_tpu_torch.tools.sass_census import census, pixels_per_thread, resources
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
        _ev("user_annotation", "isp_white_balance", 0, 300),  # the range on the host
        _ev("cpu_op", "aten::add", 0, 400),  # host work, not an API call
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 4),  # host side, in the range
        _ev("cuda_runtime", "cudaLaunchKernel", 305, 4),  # after it
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
    # the copy starts in the white-balance range, the set in the debayer
    # range; the three kernels in the white-balance range's two chunks
    assert d["stages"]["isp_white_balance"] == {
        "span_us": 140.0, "busy_us": 40 + 10 + 10, "kernels": 3, "copies": 1, "sets": 0,
        "host_us": 300.0, "host_api": {"cudaLaunchKernel": [1, 4.0]}}
    assert d["stages"]["isp_debayer"] == {"span_us": 50.0, "busy_us": 10 + 10, "kernels": 0,
                                          "copies": 0, "sets": 1, "host_us": 0,
                                          "host_api": {}}
    assert d["busy_us"] <= d["window_us"]


@pytest.mark.parametrize("bytes_, ops, want_ms, by", [
    (3.35e9, 0, 1.0, "bytes"),  # 3.35 GB at 3.35 TB/s
    (3.35e6, 67e9, 1.0, "operations"),  # 67 GFLOP at 67 TFLOP/s beside 1 us of bytes
])
def test_kernel_bound_is_the_larger_of_bytes_and_operations(bytes_, ops, want_ms, by):
    # bound_ms against the H100 SXM's published peaks
    got = bound(bytes_, ops)
    assert got["bound_by"] == by
    assert got["bound_ms"] == pytest.approx(want_ms, rel=1e-12)


def test_host_api_counts_each_occurrence_of_a_range():
    trace = {"traceEvents": [
        _ev("gpu_user_annotation", "isp_white_balance", 50, 10),
        _ev("user_annotation", "isp_white_balance", 0, 100),
        _ev("user_annotation", "isp_white_balance", 200, 100),  # a second chunk
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 3),
        _ev("cuda_runtime", "cudaLaunchKernel", 210, 5),
        _ev("cuda_driver", "cuLaunchKernelEx", 220, 2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 150, 7),  # between the chunks
    ]}
    st = device_time(trace)["stages"]["isp_white_balance"]
    assert st["host_us"] == 200
    assert st["host_api"] == {"cudaLaunchKernel": [2, 8.0], "cuLaunchKernelEx": [1, 2.0]}


@pytest.mark.parametrize("batch", [1, 4])
def test_ccc_response_bound_counts_the_fewest_operations(batch):
    n, nn = 256, 256 * 256
    work = ccc_response_work(batch, n)
    # X in and resp out per frame; W (two planes) and bias once; f32
    assert work["bytes"] == (2 * batch + 3) * nn * 4
    assert work["dft_bytes"] == work["bytes"] + 2 * nn * 4
    # twelve real n^3 products, 402.7 MFLOP a frame
    assert work["dft_products_ops"] == batch * 402_653_184
    # two real 2-D FFTs, 2.5 N log2 N each, and 10 + 1 per value of the
    # half spectrum and of the frame: far fewer operations, so bytes bound it
    assert work["least_ops"] == batch * (5 * nn * 16 + 10 * 256 * 129 + nn)
    assert work["least_ops"] < work["dft_products_ops"] / 70
    got = bound(work["bytes"], work["least_ops"])
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(work["bytes"] / 3.35e9, rel=1e-12)
    assert math.isclose(bound(work["dft_bytes"], work["dft_products_ops"])["bound_ms"],
                        batch * 402_653_184 / 67e9, rel_tol=1e-12)


def test_compare_turns_alternate_and_summary_reads_the_ccc_range():
    # each build as often first as second, the parent first and last
    assert TURNS == ("old", "new", "new", "old", "old", "new", "new", "old")
    stage = {"span_ms": 4.0, "busy_ms": 0.8, "copies": 0, "sets": 0, "host_ms": 3.9,
             "host_api_ms": {f"api{i}": [i, 0.1 * i] for i in range(6)}}
    r = {"kernels": {"C": {"device_ms": 0.05, "call_ms": 0.1}},
         "frames_per_s": {"flagship 1920x1080": 220.0},
         "profiles": {"flagship": {"wall_ms": 18.0, "busy_ms": 15.0,
                                   "idle_share_unprofiled": 1 / 6,
                                   "stages": {"isp_white_balance": stage}}}}
    s = _summary(r)
    assert s["kernels"] == r["kernels"] and s["frames_per_s"] == r["frames_per_s"]
    c = s["chains"]["flagship"]
    assert (c["ccc_span_ms"], c["ccc_busy_ms"], c["ccc_host_ms"]) == (4.0, 0.8, 3.9)
    # the four costliest API calls, costliest first
    assert list(c["ccc_host_api_ms"]) == ["api5", "api4", "api3", "api2"]


def test_compare_completes_on_a_turn_without_the_ccc_range(tmp_path, monkeypatch, capsys):
    # a turn whose trace lacks the isp_white_balance range: its line is
    # printed without the range's fields and compare.json is written
    stage = {"span_ms": 4.0, "busy_ms": 0.8, "kernels": 8, "copies": 0, "sets": 0,
             "host_ms": 3.9, "host_api_ms": {"cudaLaunchKernel": [8, 0.1]}}

    def turn(stages):
        return {"kernels": {"H": {"device_ms": 0.005, "call_ms": 0.02}},
                "frames_per_s": {"flagship 1920x1080": 2000.0},
                "profiles": {"flagship": {"wall_ms": 2.0, "busy_ms": 0.6,
                                          "idle_share_unprofiled": 0.7, "stages": stages}}}

    calls = []

    def run(cmd, **kw):
        if cmd[0] == "nvidia-smi":
            return subprocess.CompletedProcess(cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n", "")
        calls.append(cmd)
        stages = {"isp_debayer": dict(stage)} if len(calls) == 2 else {
            "isp_white_balance": stage}
        return subprocess.CompletedProcess(cmd, 0, "log\n" + json.dumps(turn(stages)) + "\n", "")

    monkeypatch.setattr(compare_checkouts.subprocess, "run", run)
    out = tmp_path / "compare"
    assert compare_checkouts.main([str(tmp_path / "old"), "--out", str(out)]) == 0
    assert len(calls) == len(TURNS)
    saved = json.loads((out / "compare.json").read_text())
    assert [t["version"] for t in saved["turns"]] == list(TURNS)
    printed = capsys.readouterr().out
    assert "turn 1 new: " in printed and "no CCC range in the trace" in printed
    assert printed.count("CCC span 4.000 busy 0.800") == len(TURNS) - 1
    assert "kernels 8, API cudaLaunchKernel 8x 0.100" in printed
    # the medians: the range's busy time over the turns that show it
    m = medians(saved["turns"])
    assert m["new"]["profiles"]["flagship"]["isp_white_balance"] == [0.8, 0.8, 0.8]
    assert m["new"]["profiles"]["flagship"]["isp_debayer"] == [0.8, 0.8, 0.8]


def test_compare_medians_per_version():
    turns = [{"version": v, "kernels": {"A": {"device_ms": d, "call_ms": 2 * d}},
              "frames_per_s": {"flagship 1920x1080": f}}
             for v, d, f in (("old", 0.035, 220.0), ("new", 0.016, 224.0), ("new", 0.017, 226.0),
                             ("old", 0.034, 230.0), ("old", 0.036, 221.0))]
    m = medians(turns)
    assert m["old"]["kernels"]["A"]["device_ms"] == [0.035, 0.034, 0.036]
    assert m["new"]["kernels"]["A"]["call_ms"] == [0.033, 0.032, 0.034]
    assert m["old"]["frames_per_s"]["flagship 1920x1080"] == [221.0, 220.0, 230.0]
    assert m["new"]["frames_per_s"]["flagship 1920x1080"] == [225.0, 224.0, 226.0]
    assert "profiles" not in m["new"]
    for i, t in enumerate(turns):  # as compare.json holds them
        t["profiles"] = {"flagship": {"wall_ms": 18.0 + i, "busy_ms": 15.0,
                                      "idle_share_unprofiled": 0.1 * i,
                                      "stages": {"isp_debayer": {"busy_ms": 0.05 - 0.01 * i}}}}
    del turns[4]["profiles"]["flagship"]["stages"]["isp_debayer"]  # a trace that missed it
    turns[3]["profiles"]["flagship"]["stages"]["isp_flip"] = {"busy_ms": 0.01}
    p = medians(turns)["old"]["profiles"]["flagship"]
    assert p["isp_flip"] == [0.01, 0.01, 0.01]
    assert p["wall_ms"] == [21.0, 18.0, 22.0] and p["busy_ms"] == [15.0, 15.0, 15.0]
    assert p["isp_debayer"] == pytest.approx([0.035, 0.02, 0.05])  # turns 0 and 3


@pytest.mark.parametrize("algorithm", ["bilinear", "mht"])
def test_debayer_work(algorithm):
    # B=64 1920x1080: a byte in and three out per pixel, and the integer
    # operations of the plain formulas
    px = 64 * 1920 * 1080
    w = debayer_work(px, algorithm)
    assert w == {"bytes": 4 * px, "ops": px * DEBAYER_OPS_PER_PIXEL[algorithm]}
    assert DEBAYER_OPS_PER_PIXEL == {"bilinear": 8.0, "mht": 33.5}
    # at the f32 rate the operations take less than the bytes in both
    got = bound(w["bytes"], w["ops"])
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(4 * px / 3.35e9, rel=1e-12)


@pytest.mark.parametrize("batch, channels", [(4, 3), (64, 3), (4, 1)])
def test_remap_float_work(batch, channels):
    # the float chain's call at 1080x1920: the planes in, the interleaved
    # output out, the 20-byte-a-pixel map once; 91.2 MB at B=4, 837.7 MB
    # at B=64
    n = 1080 * 1920
    w = remap_float_work(batch, 1080, 1920, n, channels)
    assert w["bytes"] == 2 * batch * channels * n + 20 * n
    assert w["ops"] == 7 * batch * channels * n
    if channels == 3:
        assert w["bytes"] == {4: 91_238_400, 64: 837_734_400}[batch]
    # pixels with no weight need no blend
    assert remap_float_work(batch, 1080, 1920, n, channels, live=n // 2)["ops"] == w["ops"] // 2
    got = bound(w["bytes"], w["ops"])
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(w["bytes"] / 3.35e9, rel=1e-12)


@pytest.mark.parametrize("mode, map_bytes, ops", [("lerp", 28, 13), ("fixed32", 20, 9)])
@pytest.mark.parametrize("batch", [4, 64])
def test_remap_lerp_work(mode, map_bytes, ops, batch):
    # kernel F at 1080x1920: the planes in, the output out, a 28-byte (lerp:
    # base and six weights) or 20-byte (fixed32) map a pixel once; the lerp
    # bound 0.0322 ms at B=4 and 0.2550 ms at B=64, fixed32 0.0272 at B=4
    n = 1080 * 1920
    w = remap_lerp_work(batch, 1080, 1920, n, 3, mode)
    assert w["bytes"] == 2 * batch * 3 * n + map_bytes * n
    assert w["ops"] == ops * batch * 3 * n
    got = bound(w["bytes"], w["ops"])
    assert got["bound_by"] == "bytes"
    want = {("lerp", 4): 0.0322, ("lerp", 64): 0.2550, ("fixed32", 4): 0.0272}.get((mode, batch))
    if want:
        assert got["bound_ms"] == pytest.approx(want, abs=5e-5)
    # four cameras' maps read once each, each camera's live pixels blended
    # in its frames
    cams = remap_lerp_work(16, 1080, 1920, n, 3, mode, live=n, maps=4)
    assert cams["bytes"] == 2 * 16 * 3 * n + 4 * map_bytes * n
    assert cams["ops"] == ops * 4 * 3 * n


@pytest.mark.parametrize("batch", [4, 64])
def test_remap_lerp_work_fixed32_compact_map(batch):
    # fixed32 through its compact map: a 4-byte anchor and a 2-byte code a
    # pixel, and the four f32 weights of the explicit pixels; the fixed32
    # chain's 1080p map (3264 explicit pixels) bounds B=4 at 0.0186 ms and
    # B=64 at 0.2414 ms
    n = 1080 * 1920
    w = remap_lerp_work(batch, 1080, 1920, n, 3, "fixed32", explicit=3264)
    assert w["bytes"] == 2 * batch * 3 * n + 6 * n + 16 * 3264
    assert w["ops"] == remap_lerp_work(batch, 1080, 1920, n, 3, "fixed32")["ops"]
    got = bound(w["bytes"], w["ops"])
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx({4: 0.0186, 64: 0.2414}[batch], abs=5e-5)
    cams = remap_lerp_work(16, 1080, 1920, n, 3, "fixed32", maps=4, explicit=4 * 3264)
    assert cams["bytes"] == 2 * 16 * 3 * n + 4 * (6 * n + 16 * 3264)
    # the lerp's map is not coded
    assert (remap_lerp_work(4, 1080, 1920, n, 3, "lerp", explicit=3264)
            == remap_lerp_work(4, 1080, 1920, n, 3, "lerp"))


def test_remap_float_work_per_camera_maps():
    # 4 cameras x B=4 at 1080x1920, a map each: four maps of 20 bytes a
    # pixel read once, each camera's live pixels blended in its 4 frames
    n = 1080 * 1920
    w = remap_float_work(16, 1080, 1920, n, 3, maps=4)
    assert w["bytes"] == 2 * 16 * 3 * n + 4 * 20 * n
    assert w["ops"] == 7 * 16 * 3 * n
    lives = (n // 2, n // 3, n // 4, n // 5)  # each map's live pixels
    assert remap_float_work(16, 1080, 1920, n, 3, live=sum(lives), maps=4)["ops"] == \
        sum(7 * 4 * 3 * live for live in lives)
    # one map is the single-camera work
    assert remap_float_work(4, 1080, 1920, n, 3, maps=1) == remap_float_work(4, 1080, 1920, n, 3)


_LISTING = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_118debayer_mht_kernelILi78ELi16EEEvPKhPhiiii
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;           /* 0x00000a00ff017b82 */
                                                                    /* 0x000fe20000000f00 */
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   SHFL.UP PT, R8, R7, 0x1, RZ ;
        /*0030*/              @!P0 LDG.E.CONSTANT R9, desc[UR4][R2.64+-0x4] ;
        /*0040*/                   PRMT R10, R4, 0x7770, RZ ;
        /*0050*/                   IADD3 R11, R10, R12, R13 ;
        /*0060*/                   IMAD R14, R10, 0xc, R11 ;
        /*0070*/                   STG.E.128 desc[UR4][R16.64], R4 ;
        /*0080*/                   EXIT ;
                Function : _Z5otherv
        /*0000*/                   FADD R1, R2, R3 ;
"""


def test_sass_census_counts_by_class():
    name = "(anonymous namespace)::debayer_mht_kernel<78, 16>(...)"
    got = census(_LISTING.splitlines(), {
        "_ZN12_GLOBAL__N_118debayer_mht_kernelILi78ELi16EEEvPKhPhiiii": name})
    assert got[name]["instructions"] == 9
    assert got[name]["by_class"] == {"memory": 4, "shuffle": 1, "int_alu": 2, "imad": 1,
                                     "control": 1}
    assert got[name]["by_opcode"]["LDG"] == 2
    assert got["_Z5otherv"] == {"instructions": 1, "by_class": {"other": 1},
                                "by_opcode": {"FADD": 1}}
    assert pixels_per_thread(name) == 32
    assert pixels_per_thread("debayer_bilinear_kernel<228, 1>(...)") == 4
    assert pixels_per_thread("void <unnamed>::debayer_mht_kernel<(int)27, (int)8>(...)") == 16
    assert pixels_per_thread("debayer_bilinear_kernel<(int)27, (int)4, (bool)1>(...)") == 8
    assert pixels_per_thread("ccc_response_stage") is None


def test_sass_census_reads_resource_usage():
    # `cuobjdump -res-usage`'s lines: each function's registers, stack
    # (where spills go), shared and local bytes
    listing = """Resource usage:
 Common:
  GLOBAL:0
 Function _Z5otherv:
  REG:56 STACK:144 SHARED:25664 LOCAL:0 CONSTANT[0]:600 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z4mainv:
  REG:48 STACK:0 SHARED:20272 LOCAL:0 CONSTANT[0]:504
"""
    assert resources(listing.splitlines()) == {
        "_Z5otherv": {"registers": 56, "stack": 144, "shared": 25664, "local": 0},
        "_Z4mainv": {"registers": 48, "stack": 0, "shared": 20272, "local": 0}}


def test_card_tests_collects_the_cuda_tests_with_jax_stubbed():
    # tools/card_tests gives jax and cv2 stand-ins so that the test modules
    # collect where neither is installed; run in its own process, so the
    # stand-ins never reach this one
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-m", "raw_image_pipeline_tpu_torch.tools.card_tests", "--collect-only",
         "-q", "tests/test_torch_gpu_path.py"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert "test_kernel_e_equals_plain_on_card" in run.stdout
    assert "test_remap_frame_chunk" not in run.stdout  # not cuda-marked
