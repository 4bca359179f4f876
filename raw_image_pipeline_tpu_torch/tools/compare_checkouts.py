"""Two checkouts of the port on one CUDA card, measured in turns.

    python -m raw_image_pipeline_tpu_torch.tools.compare_checkouts OLD_ROOT [--out DIR]

Run from the root of a checkout, the new one. OLD_ROOT is the root of
another checkout of the repository (an earlier commit unpacked with `git
archive`, say). Each turn is a process of its own on one checkout, in the
order old, new, new, old, twice (TURNS). Every turn measures with this
checkout's tools (measure.py, workloads.py, profile_chains.py, which
import nothing of the package) and imports the package of its own
checkout, through functions every version of the port has:

  * kernels A-E as the chains call them at 1920x1080, B=4:
    ops.debayer.debayer_planes on a seeded mosaic, bilinear (A) and "mht"
    (D, the gpu_parity chain's), ops.ccc.log_chroma_histogram on A's
    planes' working resize (270x360) (B), ops.ccc.ccc_response on that
    histogram (C) and ops.undistortion.remap_planes(..., "float") of A's
    planes through the float chain's fisheye maps (E; "E_off1" the same
    on copies of the planes 1 byte past a 16-byte boundary; "E64" the same
    at B=64, seeded planes), each with every stream operation its call makes:
    device ms (measure.device_ms) and ms per call, the host's launches
    included (measure.call_ms);
  * each chain of the flagship family in tools/workloads.py (flagship,
    gpu_parity, float, fixed32): frames/s at each of its sizes (its frames
    in its calls, the Kalman state carried; the median of 7), and one
    profiled call at 1920x1080 (profile_chains.profile_chain): wall, device
    busy time, and per isp_* range its GPU span, busy time, host time and
    CUDA API calls;
  * frames/s of wb_pca and wb_grey_world (BASELINE config 2, kernel A at
    B=64 on the flipped 1920x1080 mosaic), where A's share of the chain is
    largest.

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
FPS_ONLY = ("wb_pca", "wb_grey_world")  # frames/s, no profile
CCC_RANGE = "isp_white_balance"
FPS_REPS = 7
TURNS = ("old", "new", "new", "old") * 2  # each build meets the card's drift alike


def _fps(tp, torch, workloads, name: str, h: int, w: int) -> float:
    """frames/s of a chain at h x w: its frames in its calls, the state
    carried, host clock around the calls; the median of FPS_REPS."""
    import time

    ch = workloads.chains(tp)[name]
    pipe = tp.build_pipeline(ch.config(h, w), ch.encoding, frame_hw=(h, w), with_state=True,
                             temporal_mode="sequence", device="cuda", microbatch=ch.microbatch)
    frames = workloads.card_frames(torch, ch.kind, ch.frames, h, w, workloads.SEED + len(name))
    per = ch.frames // ch.calls

    def run():
        state = tp.init_state((), "cuda")
        for c in range(ch.calls):
            _, state = pipe(frames[c * per:(c + 1) * per], state)
        torch.cuda.synchronize()

    run()
    walls = []
    for _ in range(FPS_REPS):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    return ch.frames / statistics.median(walls)


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
    from raw_image_pipeline_tpu_torch.ops import ccc, debayer, undistortion
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
    hist = ccc.log_chroma_histogram(*small, *cuts)
    maps = tp.make_params(workloads.chains(tp)["float"].config(1080, 1920), (1080, 1920), "cuda")
    planes = [p.contiguous() for p in debayer.debayer_planes(bayer, encoding)]
    n = planes[0].numel()
    unaligned = [torch.empty(16 + n, dtype=torch.uint8, device="cuda")[1:1 + n].view(p.shape)
                 for p in planes]
    for dst, src in zip(unaligned, planes):
        dst.copy_(src)
    big = [torch.randint(0, 256, (64, 1080, 1920), generator=g, device="cuda", dtype=torch.uint8)
           for _ in range(3)]

    def remap(pl):
        return undistortion.remap_planes(pl, maps.remap_base, maps.remap_weights, (1080, 1920),
                                         "float")

    calls = {"A": lambda: debayer.debayer_planes(bayer, encoding),
             "B": lambda: ccc.log_chroma_histogram(*small, *cuts),
             "C": lambda: ccc.ccc_response(hist, wr, wi, bias),
             "D": lambda: debayer.debayer_planes(bayer, encoding, "mht"),
             "E": lambda: remap(planes),
             "E_off1": lambda: remap(unaligned),
             "E64": lambda: remap(big)}
    res = {"kernels": {k: {"device_ms": measure.device_ms(f), "call_ms": measure.call_ms(f)}
                       for k, f in calls.items()},
           "frames_per_s": {}, "profiles": {}}
    del big, unaligned, calls
    torch.cuda.empty_cache()
    for name in FLAGSHIP_FAMILY:
        ch = workloads.chains(tp)[name]
        for h, w in ch.sizes:
            res["frames_per_s"][f"{name} {w}x{h}"] = _fps(tp, torch, workloads, name, h, w)
        res["profiles"][name] = profile_chains.profile_chain(tp, torch, workloads, name, out)
        torch.cuda.empty_cache()
    for name in FPS_ONLY:
        for h, w in workloads.chains(tp)[name].sizes:
            res["frames_per_s"][f"{name} {w}x{h}"] = _fps(tp, torch, workloads, name, h, w)
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
                     "ccc_host_ms": st.get("host_ms"),
                     "ccc_host_api_ms": dict(api[:4])}
    return {"kernels": r["kernels"], "frames_per_s": r["frames_per_s"], "chains": ccc}


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
    carry them (compare.json's do)."""
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
                                          for c, (a, lo, hi) in m["frames_per_s"].items()),
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
        print(f"turn {i} {version}: kernels (device / per call ms) "
              + ", ".join(f"{k} {v['device_ms']:.5f} / {v['call_ms']:.5f}"
                          for k, v in s["kernels"].items())
              + "; frames/s " + ", ".join(f"{k} {v:.2f}" for k, v in s["frames_per_s"].items())
              + "; " + "; ".join(
                  f"{n} wall {c['wall_ms']:.3f} busy {c['busy_ms']:.3f} idle "
                  f"{100 * c['idle_share']:.1f}%, CCC span {c['ccc_span_ms']:.3f} busy "
                  f"{c['ccc_busy_ms']:.3f} host {c['ccc_host_ms']:.3f}, API "
                  + ", ".join(f"{a} {n_calls}x {ms:.3f}" for a, (n_calls, ms)
                              in c["ccc_host_api_ms"].items())
                  for n, c in s["chains"].items()), flush=True)
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
