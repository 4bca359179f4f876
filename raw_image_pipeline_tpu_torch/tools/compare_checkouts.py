"""Two checkouts of the port on one CUDA card, measured in turns.

    python -m raw_image_pipeline_tpu_torch.tools.compare_checkouts OLD_ROOT [--out DIR]

Run from the root of a checkout, the new one. OLD_ROOT is the root of
another checkout of the repository (an earlier commit unpacked with `git
archive`, say). Each turn is a process of its own on one checkout, in the
order old, new, new, old, twice (TURNS). Every turn measures with this
checkout's tools (measure.py, workloads.py, profile_chains.py, which
import nothing of the package) and imports the package of its own
checkout, through functions every version of the port has:

  * kernels A-J as the chains call them at 1920x1080, B=4:
    ops.debayer.debayer_planes on a seeded mosaic, bilinear (A) and "mht"
    (D, the gpu_parity chain's), ops.ccc.log_chroma_histogram_planes on A's
    planes' working resize (270x360) (B), ops.ccc.ccc_response on that
    histogram (C) and ops.undistortion.remap_planes(..., "float") of A's
    planes through the float chain's fisheye maps (E; "E_off1" the same
    on copies of the planes 1 byte past a 16-byte boundary; "E64" the same
    at B=64, seeded planes) and remap_planes(..., "lerp") through the
    flagship's maps (F; "F_fixed32" through the fixed32 chain's, with its
    compact map where the checkout's params carry one, "F_fixed32_wide"
    through its weights alone, as an op-layer call; "F64", "F64_fixed32"
    and "F64_fixed32_wide" at B=64; a checkout before kernel F runs the
    plain versions there) and
    the flagship's pointwise stretch on A's planes with seeded per-frame
    gains (G: ops.pointwise.pointwise_planes with the flagship's
    parameters; "G64" at B=64; a checkout before kernel G runs the stage
    functions it replaced), the working resize of A's planes (H:
    ops.resize.resize_planes, or resize_linear_u8_plane a plane before
    kernel H; "H64" at B=64, seeded planes), ops.ccc.response_argmax of
    C's response (I; "I64" on 64 seeded f32 responses), "sequence"
    mode's track and gains of its peaks from a fresh state (J: ops.ccc.
    track_gains, or kalman_scan and gains_from_uv_table before kernel J;
    "J64" 64 seeded peaks, config 3's batch; "J512" a 512-frame track;
    "J_cameras" the flagship's default "cameras" mode, four tracks of one
    frame, kalman_update before kernel J) and the chain's whole CCC
    range, H to J, on A's planes ("CCC"; "CCC64" at B=64, seeded planes),
    and the flip of a mosaic, ops.flip.flip (N since kernel N, torch.flip
    before): the flagship's, 180 at B=4 ("N"), 90 at B=4 ("N_90"), 270 at
    B=4 ("N_270") and the wb_* chains', 90 at B=64 ("N64"; "N64_270" at
    270), and the mono chain's gamma table on a mono plane, ops.gamma
    .apply_lut with the 0.9 table (O since kernel O, G's table step on one
    plane before): B=4 1080x1920 ("O") and B=64 1920x1080 ("O64"), and
    the bayer16 chain's debayer of card_frames' 16-bit mosaics to its u8
    planes, ops.debayer.debayer16_planes (P since kernel P, the eager
    int32 stencil and a shift and cast a plane before): B=4 ("P") and B=64
    ("P64") at 1080x1920,
    each with every stream operation its call makes:
    device ms (measure.device_ms) and ms per call, the host's launches
    included (measure.call_ms);
  * the statistical white balances' kernels on card_frames' colour frames,
    B=4 at 1080x1920 and ("...64") B=64 at 1920x1080, where the checkout
    has them: ops.white_balance.wb_stats_cuda in each method's mode
    ("K_simple", "K_grey_world", "K_pca", "K_learned"), learned's
    ops.learned_wb.hist64_cuda into K's histogram ("L"), wb_tables_cuda in
    learned's mode ("M") and in the small modes on K's record of the mode
    ("M_simple", "M_grey_world", "M_pca") and G's table step of PCA's tables
    (ops.pointwise.pointwise_cuda, "G_table");
  * each chain of the flagship family in tools/workloads.py (flagship,
    gpu_parity, float, fixed32): frames/s at each of its sizes (its frames
    in its calls, the Kalman state carried; the median of 7) and the peak
    device bytes of one such run, and one
    profiled call at 1920x1080 (profile_chains.profile_chain): wall, device
    busy time, and per isp_* range its GPU span, busy time, host time and
    CUDA API calls;
  * each wb_* chain (BASELINE config 2: kernel A at B=64 on the flipped
    1920x1080 mosaic, then the statistical white balance, kernels K, L, M
    and G's table step since they exist): frames/s and one profiled call,
    whose "CCC range" fields hold its isp_white_balance range, the
    statistical white balance;
  * the mono8 chain (the flagship on mono frames: the flip, the gamma
    table, the lerp remap) and the bayer16 chain (the flagship on 16-bit
    Bayer frames, at 1920x1080 and 1440x1080): frames/s and one profiled
    call.

Prints one line per turn, then per version the median and range over its
turns of each kernel's times, each chain's frames/s and its profile's
wall, busy time, idle share and busy time per stage, and, last, a JSON
line of the main numbers; writes every number and each turn's traces
under --out (default build/compare). With --summarize, it reads such a
compare.json and prints its medians and ranges again.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_TOOLS_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_DIR = os.path.dirname(os.path.dirname(_TOOLS_DIR))
FLAGSHIP_FAMILY = ("flagship", "gpu_parity", "float", "fixed32")
WB_CHAINS = ("wb_simple", "wb_grey_world", "wb_pca", "wb_learned")
MONO_CHAINS = ("mono8",)
BAYER16_CHAINS = ("bayer16",)
CCC_RANGE = "isp_white_balance"
FPS_REPS = 7
TURNS = ("old", "new", "new", "old") * 2  # each build meets the card's drift alike


def _fps(tp, torch, workloads, name: str, h: int, w: int):
    """(frames/s, peak device bytes) of a chain at h x w: its frames in its
    calls, the state carried, host clock around the calls, the median of
    FPS_REPS; the peak of one run after the warm-up, as chip_smoke.py's
    chains phase reads it (max_memory_allocated after
    reset_peak_memory_stats: the frames and the worker's other tensors
    count, so compare a chain with another chain of the same turn)."""
    import time

    ch = workloads.chains(tp)[name]
    pipe = tp.build_pipeline(ch.config(h, w), ch.encoding, frame_hw=(h, w), with_state=True,
                             temporal_mode="sequence", device="cuda", microbatch=ch.microbatch)
    frames = workloads.card_frames(torch, ch.kind, ch.frames, h, w, workloads.SEED + len(name))
    per = ch.frames // ch.calls

    def run():
        state = tp.init_state((), device="cuda")
        for c in range(ch.calls):
            _, state = pipe(frames[c * per:(c + 1) * per], state)
        torch.cuda.synchronize()

    run()
    torch.cuda.reset_peak_memory_stats()
    run()
    peak = torch.cuda.max_memory_allocated()
    walls = []
    for _ in range(FPS_REPS):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    return ch.frames / statistics.median(walls), peak


def _worker(root: str, out: str) -> dict:
    """One turn: the package of the checkout at `root`, measured (run by
    path, so that this directory's tools import as top-level modules and
    the package comes from `root`)."""
    sys.path.insert(1, root)
    import numpy as np
    import torch

    import measure
    import profile_chains
    import workloads

    import raw_image_pipeline_tpu_torch as tp
    from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model
    from raw_image_pipeline_tpu_torch.ops import ccc, debayer, flip, gamma, undistortion
    from raw_image_pipeline_tpu_torch.ops.resize import resize_linear_u8_plane

    if not os.path.abspath(tp.__file__).startswith(os.path.join(root, "")):
        raise RuntimeError(f"imported {tp.__file__}, not the package under {root}")
    g = torch.Generator(device="cuda")
    g.manual_seed(workloads.SEED)
    bayer = torch.randint(0, 256, (4, 1080, 1920), generator=g, device="cuda",
                          dtype=torch.uint8)
    encoding = "bayer_grbg8"  # the flagship's gbrg mosaic after the flip
    small = [resize_linear_u8_plane(p, ccc.SMALL_H, ccc.SMALL_W).contiguous()
             for p in debayer.debayer_planes(bayer, encoding)]
    wb = tp.flagship_config(1080, 1920).white_balance
    cuts = tuple(float(np.float32(v)) for v in (255.0 * wb.saturation_bright_thr,
                                                 255.0 * wb.saturation_dark_thr, wb.ccc_uv0))
    model = load_ccc_model(wb.ccc_model_path)
    wr, wi, bias = (torch.as_tensor(a, device="cuda")
                    for a in (model.filt_dft_re, model.filt_dft_im, model.bias))
    hist = ccc.log_chroma_histogram_planes(*small, *cuts)
    maps = tp.make_params(workloads.chains(tp)["float"].config(1080, 1920), (1080, 1920),
                          device="cuda")
    planes = [p.contiguous() for p in debayer.debayer_planes(bayer, encoding)]
    n = planes[0].numel()
    unaligned = [torch.empty(16 + n, dtype=torch.uint8, device="cuda")[1:1 + n].view(p.shape)
                 for p in planes]
    for dst, src in zip(unaligned, planes):
        dst.copy_(src)
    big = [torch.randint(0, 256, (64, 1080, 1920), generator=g, device="cuda", dtype=torch.uint8)
           for _ in range(3)]

    gamma_lut = torch.as_tensor(gamma.build_gamma_lut(0.9), device="cuda")
    mono64 = big[0].view(64, 1920, 1080)  # the wb_* chains' size as mono planes
    lerp_maps = {mode: tp.make_params(workloads.chains(tp)[name].config(1080, 1920),
                                      (1080, 1920), device="cuda")
                 for mode, name in (("lerp", "flagship"), ("fixed32", "fixed32"))}

    fl = tp.make_params(tp.flagship_config(1080, 1920), (1080, 1920), device="cuda")
    gains = {b: 0.5 + 1.5 * torch.rand((b, 3), generator=g, device="cuda") for b in (4, 64)}
    try:
        from raw_image_pipeline_tpu_torch.ops.pointwise import pointwise_planes
    except ImportError:  # a checkout before kernel G
        pointwise_planes = None

    def stretch(pl):
        """The flagship's pointwise stretch (gains, calibration, gamma∘Lab
        vignetting, enhancer) on three planes."""
        gn = gains[pl[0].shape[0]]
        if pointwise_planes is not None:
            return pointwise_planes(*pl, gains=gn, matrix=fl.color_matrix, bias=fl.color_bias,
                                    mask=fl.vignetting_mask, lab_tab=fl.lab_gamma_tab,
                                    enhancer_tables=fl.enhancer_tables)
        from raw_image_pipeline_tpu_torch.ops import color_calibration, color_enhancer, vignetting

        pl = ccc.apply_gains_planes(pl, gn)
        pl = color_calibration.color_correct_planes(*pl, fl.color_matrix, fl.color_bias)
        pl = vignetting.correct_planes(*pl, fl.vignetting_mask, gamma_tab=fl.lab_gamma_tab)
        return color_enhancer.enhance_planes(*pl, fl.enhancer_tables)

    try:
        from raw_image_pipeline_tpu_torch.ops.resize import resize_planes
        from raw_image_pipeline_tpu_torch.ops.ccc import track_gains
    except ImportError:  # a checkout before kernels H and J
        resize_planes = track_gains = None
    exp_tab = torch.as_tensor(ccc.exp_table(cuts[2]), device="cuda")
    fresh = ccc.kalman_init((), device="cuda")
    resp = ccc.ccc_response(hist, wr, wi, bias)
    uv = {4: ccc.response_argmax(resp),
          **{n: torch.randint(0, 256, (n, 2), generator=g, device="cuda", dtype=torch.int32)
             for n in (64, 512)}}
    resp64 = torch.randn((64, ccc.HIST_N, ccc.HIST_N), generator=g, device="cuda")

    def resize(pl):
        """The working resize of three planes (H)."""
        if resize_planes is not None:
            return resize_planes(pl, pl[0].shape[-2], ccc.SMALL_H, ccc.SMALL_W)
        return [resize_linear_u8_plane(p, ccc.SMALL_H, ccc.SMALL_W) for p in pl]

    def track(peaks, cameras=False):
        """"Sequence" mode's track of the peaks from a fresh state and the
        gains (J); "cameras" mode's tracks, a frame each, with `cameras`."""
        if track_gains is not None:
            kw = (dict(track_shape=(peaks.shape[0],)) if cameras
                  else dict(track_shape=(), steps=peaks.shape[0]))
            return track_gains(peaks, exp_tab, fresh, **kw)
        _, filtered = (ccc.kalman_update if cameras else ccc.kalman_scan)(fresh, peaks)
        return ccc.gains_from_uv_table(filtered, exp_tab)

    def ccc_range(pl):
        """The chain's CCC range on three planes: H, B, C, I, J."""
        h = ccc.log_chroma_histogram_planes(*resize(pl), *cuts)
        return track(ccc.response_argmax(ccc.ccc_response(h, wr, wi, bias)))

    def remap(pl, mode="float", code=True):
        m = maps if mode == "float" else lerp_maps[mode]
        # the chain's compact fixed32 map, where the checkout has one
        kw = ({"code": m.remap_code} if code and getattr(m, "remap_code", None) is not None
              else {})
        return undistortion.remap_planes(pl, m.remap_base, m.remap_weights, (1080, 1920), mode,
                                         **kw)

    mosaic16 = {b: workloads.card_frames(torch, "bayer16", b, 1080, 1920, workloads.SEED + b)
                for b in (4, 64)}
    try:
        debayer16 = debayer.debayer16_planes
    except AttributeError:  # a checkout before kernel P: the chain's eager route
        def debayer16(x, enc):
            full = debayer.debayer_bilinear16_planar(x, debayer.phase_for_encoding(enc))
            return tuple((full[:, c] >> 8).to(torch.uint8) for c in range(3))

    wb_calls = {}
    try:
        from raw_image_pipeline_tpu_torch.ops import learned_wb, pointwise
        from raw_image_pipeline_tpu_torch.ops import white_balance as wbal
        wbal.wb_stats_cuda
    except (ImportError, AttributeError):  # a checkout before kernels K, L and M
        wbal = None
    if wbal is not None:
        for sfx, (b, h, w) in (("", (4, 1080, 1920)), ("64", (64, 1920, 1080))):
            x = workloads.card_frames(torch, "color", b, h, w, workloads.SEED + b)
            pl = tuple(x[..., c].contiguous() for c in range(3))
            del x
            for method, param in (("simple", 20.0), ("grey_world", 0.8), ("pca", None),
                                  ("learned", 0.8)):
                wb_calls[f"K_{method}{sfx}"] = (
                    lambda pl=pl, m=method, p=param: wbal.wb_stats_cuda(pl, m, p))
            t255 = learned_wb.learned_t255(0.8)
            rec, lhist = wbal.wb_stats_cuda(pl, "learned", 0.8)
            learned_wb.hist64_cuda(pl, rec, t255, lhist)
            tabs = wbal.wb_tables(pl, "pca")
            wb_calls[f"L{sfx}"] = (lambda pl=pl, rec=rec, t255=t255, acc=lhist.clone():
                                   learned_wb.hist64_cuda(pl, rec, t255, acc))
            wb_calls[f"M{sfx}"] = (lambda rec=rec, lhist=lhist, n=h * w:
                                   wbal.wb_tables_cuda(rec, "learned", 0.8, n, lhist))
            for method, param in (("simple", 20.0), ("grey_world", 0.8), ("pca", None)):
                wb_calls[f"M_{method}{sfx}"] = (
                    lambda m=method, p=param, r=wbal.wb_stats_cuda(pl, method, param), n=h * w:
                    wbal.wb_tables_cuda(r, m, p, n))
            wb_calls[f"G_table{sfx}"] = (lambda pl=pl, t=tabs: pointwise.pointwise_cuda(
                pl, wb_tables=t.tables, wb_nan=t.nan))

    calls = {"A": lambda: debayer.debayer_planes(bayer, encoding),
             "B": lambda: ccc.log_chroma_histogram_planes(*small, *cuts),
             "C": lambda: ccc.ccc_response(hist, wr, wi, bias),
             "D": lambda: debayer.debayer_planes(bayer, encoding, "mht"),
             "E": lambda: remap(planes),
             "E_off1": lambda: remap(unaligned),
             "E64": lambda: remap(big),
             "F": lambda: remap(planes, "lerp"),
             "F_fixed32": lambda: remap(planes, "fixed32"),
             "F64": lambda: remap(big, "lerp"),
             "F64_fixed32": lambda: remap(big, "fixed32"),
             "F_fixed32_wide": lambda: remap(planes, "fixed32", code=False),
             "F64_fixed32_wide": lambda: remap(big, "fixed32", code=False),
             "G": lambda: stretch(planes),
             "G64": lambda: stretch(big),
             "H": lambda: resize(planes),
             "H64": lambda: resize(big),
             "I": lambda: ccc.response_argmax(resp),
             "I64": lambda: ccc.response_argmax(resp64),
             "J": lambda: track(uv[4]),
             "J64": lambda: track(uv[64]),
             "J_cameras": lambda: track(uv[4], cameras=True),
             "J512": lambda: track(uv[512]),
             "CCC": lambda: ccc_range(planes),
             "CCC64": lambda: ccc_range(big),
             "N": lambda: flip.flip(bayer, 180, (1, 2)),
             "N_90": lambda: flip.flip(bayer, 90, (1, 2)),
             "N_270": lambda: flip.flip(bayer, 270, (1, 2)),
             "N64": lambda: flip.flip(big[0], 90, (1, 2)),
             "N64_270": lambda: flip.flip(big[0], 270, (1, 2)),
             "O": lambda: gamma.apply_lut(bayer, gamma_lut),
             "O64": lambda: gamma.apply_lut(mono64, gamma_lut),
             "P": lambda: debayer16(mosaic16[4], "bayer_gbrg16"),
             "P64": lambda: debayer16(mosaic16[64], "bayer_gbrg16"),
             **wb_calls}
    res = {"kernels": {k: {"device_ms": measure.device_ms(f), "call_ms": measure.call_ms(f)}
                       for k, f in calls.items()},
           "frames_per_s": {}, "peak_bytes": {}, "profiles": {}}
    del big, mono64, unaligned, calls, wb_calls, mosaic16
    torch.cuda.empty_cache()
    for name in FLAGSHIP_FAMILY + WB_CHAINS + MONO_CHAINS + BAYER16_CHAINS:
        ch = workloads.chains(tp)[name]
        for h, w in ch.sizes:
            key = f"{name} {w}x{h}"
            res["frames_per_s"][key], res["peak_bytes"][key] = _fps(tp, torch, workloads,
                                                                   name, h, w)
        res["profiles"][name] = profile_chains.profile_chain(tp, torch, workloads, name, out)
        torch.cuda.empty_cache()
    return res


def _summary(r: dict) -> dict:
    """The numbers of one turn that its printed line and the last JSON
    line carry."""
    ccc = {}
    for name, p in r["profiles"].items():
        st = p["stages"].get(CCC_RANGE, {})
        api = sorted(st.get("host_api_ms", {}).items(), key=lambda kv: -kv[1][1])
        ccc[name] = {"wall_ms": p["wall_ms"], "busy_ms": p["busy_ms"],
                     "idle_share": p["idle_share_unprofiled"],
                     "ccc_span_ms": st.get("span_ms"), "ccc_busy_ms": st.get("busy_ms"),
                     "ccc_host_ms": st.get("host_ms"), "ccc_kernels": st.get("kernels"),
                     "ccc_host_api_ms": dict(api[:4])}
    return {"kernels": r["kernels"], "frames_per_s": r["frames_per_s"], "chains": ccc}


def turn_line(s: dict) -> str:
    """The printed line of one turn's summary (_summary); a chain whose
    trace lacks the CCC range gets its line without the range's fields."""
    def chain(n, c):
        line = (f"{n} wall {c['wall_ms']:.3f} busy {c['busy_ms']:.3f} idle "
                f"{100 * c['idle_share']:.1f}%")
        if c["ccc_span_ms"] is None:
            return line + ", no CCC range in the trace"
        return (line + f", CCC span {c['ccc_span_ms']:.3f} busy {c['ccc_busy_ms']:.3f} host "
                f"{c['ccc_host_ms']:.3f}, kernels {c['ccc_kernels']}, API "
                + ", ".join(f"{a} {n_calls}x {ms:.3f}" for a, (n_calls, ms)
                            in c["ccc_host_api_ms"].items()))

    return (f"turn {s['turn']} {s['version']}: kernels (device / per call ms) "
            + ", ".join(f"{k} {v['device_ms']:.5f} / {v['call_ms']:.5f}"
                        for k, v in s["kernels"].items())
            + "; frames/s " + ", ".join(f"{k} {v:.2f}" for k, v in s["frames_per_s"].items())
            + "; " + "; ".join(chain(n, c) for n, c in s["chains"].items()))


def _stages(turns, chain: str) -> list:
    """The isp_* ranges that chain's profile shows in any of the turns (a
    trace may miss one)."""
    seen = {}
    for t in turns:
        seen.update(dict.fromkeys(t["profiles"][chain]["stages"]))
    return list(seen)


def medians(turns) -> dict:
    """{version: {"kernels": {kernel: {metric: [median, min, max]}},
    "frames_per_s": {chain: [median, min, max]}, "profiles": {chain:
    {"wall_ms" | "busy_ms" | "idle_share" | stage: [median, min, max]}}}}
    over each version's turns; a profile's stage is its busy ms, over the
    turns whose trace shows it, and "profiles" is there where the turns
    carry them (compare.json's do), "peak_bytes" ({chain: [median, min,
    max]}) where they carry it."""
    def spread(values):
        return [statistics.median(values), min(values), max(values)]

    out = {}
    for version in sorted({t["version"] for t in turns}):
        mine = [t for t in turns if t["version"] == version]
        out[version] = {
            "kernels": {k: {m: spread([t["kernels"][k][m] for t in mine]) for m in v}
                        for k, v in mine[0]["kernels"].items()},
            "frames_per_s": {c: spread([t["frames_per_s"][c] for t in mine])
                             for c in mine[0]["frames_per_s"]},
        }
        if "peak_bytes" in mine[0]:
            out[version]["peak_bytes"] = {c: spread([t["peak_bytes"][c] for t in mine])
                                          for c in mine[0]["peak_bytes"]}
        if "profiles" in mine[0]:
            out[version]["profiles"] = {
                c: {"wall_ms": spread([t["profiles"][c]["wall_ms"] for t in mine]),
                    "busy_ms": spread([t["profiles"][c]["busy_ms"] for t in mine]),
                    "idle_share": spread([t["profiles"][c]["idle_share_unprofiled"]
                                          for t in mine]),
                    **{st: spread([t["profiles"][c]["stages"][st]["busy_ms"] for t in mine
                                   if st in t["profiles"][c]["stages"]])
                       for st in _stages(mine, c)}}
                for c in mine[0]["profiles"]}
    return out


def _print_medians(turns) -> None:
    for version, m in medians(turns).items():
        print(f"{version}, median (range) over {sum(t['version'] == version for t in turns)} "
              "turns: kernels (device / per call ms) " + ", ".join(
                  f"{k} {v['device_ms'][0]:.5f} ({v['device_ms'][1]:.5f}-{v['device_ms'][2]:.5f})"
                  f" / {v['call_ms'][0]:.5f} ({v['call_ms'][1]:.5f}-{v['call_ms'][2]:.5f})"
                  for k, v in m["kernels"].items())
              + "; frames/s " + ", ".join(f"{c} {a:.2f} ({lo:.2f}-{hi:.2f})"
                                          for c, (a, lo, hi) in m["frames_per_s"].items())
              + "".join(f"; peak device bytes {c} {a} ({lo}-{hi})"
                        for c, (a, lo, hi) in m.get("peak_bytes", {}).items()),
              flush=True)
        for c, p in m.get("profiles", {}).items():
            print(f"{version} {c} profile, median (range) ms: " + ", ".join(
                f"{k} {a:.3f} ({lo:.3f}-{hi:.3f})" for k, (a, lo, hi) in p.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_root", help="root of the other (earlier) checkout, or with "
                                     "--summarize a compare.json")
    ap.add_argument("--out", default=os.path.join("build", "compare"))
    ap.add_argument("--summarize", action="store_true",
                    help="print the medians of an earlier run's compare.json")
    args = ap.parse_args(argv)
    if args.summarize:
        with open(args.old_root) as f:
            saved = json.load(f)
        print(saved["card"])
        _print_medians(saved["turns"])
        return 0
    roots = {"old": os.path.abspath(args.old_root), "new": _REPO_DIR}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip() or "nvidia-smi: no output"
    print(card, flush=True)
    full, summary = [], []
    for i, version in enumerate(TURNS):
        out = os.path.abspath(os.path.join(args.out, f"turn{i}_{version}"))
        os.makedirs(out, exist_ok=True)
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                              roots[version], out],
                             cwd=roots[version], capture_output=True, text=True)
        if run.returncode:
            print(f"turn {i} ({version}) failed:\n{run.stdout[-4000:]}\n{run.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        r = json.loads(run.stdout.strip().splitlines()[-1])
        full.append({"turn": i, "version": version, **r})
        s = {"turn": i, "version": version, **_summary(r)}
        summary.append(s)
        print(turn_line(s), flush=True)
    with open(os.path.join(args.out, "compare.json"), "w") as f:
        json.dump({"card": card, "roots": roots, "turns": full}, f)
    _print_medians(full)
    print(json.dumps({"card": card, "turns": summary}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        root, out = sys.argv[2:]
        print(json.dumps(_worker(os.path.abspath(root), out)))
        sys.exit(0)
    sys.exit(main())
