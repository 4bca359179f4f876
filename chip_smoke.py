#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

It builds the hand-written kernels from csrc/ (nvcc, sm_90a, one process
per source, into build/kernels/), then:

  1. holds each kernel against its plain PyTorch version on the card, at the
     shapes the chains give it, and times both (median of 20 runs, CUDA
     events):
       A debayer     — 0 mismatching bytes at 1080x1920 and 1080x1440 (B=4)
                       and at an odd size;
       B histogram   — 0 mismatching counts;
       C response    — equal argmax, max |diff| <= 1e-4 * max |resp|;
       D MHT debayer — 0 mismatching bytes at 1080x1920, 1080x1440,
                       1079x1439 and 3x5 (B=4);
       E float remap — 0 mismatching bytes on the float chain's fisheye
                       maps at 1920x1080 (B=4);
  2. drives four chains through build_pipeline(config, "bayer_gbrg8",
     with_state=True, temporal_mode="sequence", device="cuda"), 8 seeded
     frames in 2 calls with the Kalman state carried, each at 1920x1080:
       flagship   — flagship_config(h, w), also at 1440x1080 (A, B, C);
       gpu_parity — MHT demosaic and the BT.709 gamma, the reference's
                    use_gpu=True semantics, also at 1440x1080 (D, B, C);
       float      — the float remap (A, B, C, E);
       fixed32    — the fixed32 remap, plain torch ops (A, B, C);
     the launch counts are set to 0 just before each chain's 1920x1080 run
     and read just after, and each kernel of that chain must have launched;
     `processed` and the state must equal, byte for byte, the same chain
     with every op on its plain version on the card; frames/s is printed;
  3. runs each chain at 96x128 on the card and on the CPU (plain versions)
     and requires equal bytes and Kalman state.

It prints the card's name and power limit, the build time, one line per
check, a JSON line of the kernels and, last, {"ok": true, "device": ...}.
Any failure, and a machine without a CUDA device, exits non-zero without
the last line. It imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
N_TIMED = 20
FRAMES, CALLS = 8, 2
SMALL = (96, 128)


def _chains(tp):
    """name -> (config for (h, w), sizes (h, w), the kernels the chain runs)."""
    import dataclasses

    def gpu_parity(h, w):
        c = tp.flagship_config(h, w)
        return c.replace(
            debayer=dataclasses.replace(c.debayer, algorithm="mht"),
            gamma_correction=dataclasses.replace(c.gamma_correction, gpu=True,
                                                 method="default"),
        )

    def remap(mode):
        def config(h, w):
            c = tp.flagship_config(h, w)
            return c.replace(undistortion=dataclasses.replace(c.undistortion,
                                                              interpolation=mode))
        return config

    full = ((1080, 1920), (1080, 1440))
    return {
        "flagship": (tp.flagship_config, full,
                     ("debayer_bilinear", "ccc_histogram", "ccc_response")),
        "gpu_parity": (gpu_parity, full, ("debayer_mht", "ccc_histogram", "ccc_response")),
        "float": (remap("float"), full[:1],
                  ("debayer_bilinear", "ccc_histogram", "ccc_response", "remap_float")),
        "fixed32": (remap("fixed32"), full[:1],
                    ("debayer_bilinear", "ccc_histogram", "ccc_response")),
    }


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def _time_ms(fn, n: int = N_TIMED) -> float:
    """Median device time of fn() over n runs, by CUDA events (after one
    warm-up run)."""
    import torch

    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels(tp, torch, rng):
    """Phase 1: each kernel against its plain version on the card."""
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model
    from raw_image_pipeline_tpu_torch.ops import ccc, debayer, undistortion
    from raw_image_pipeline_tpu_torch.ops.resize import resize_linear_u8_plane

    dev = torch.device("cuda")
    rows = {}
    phase = debayer.phase_for_encoding("bayer_grbg8")  # the flipped gbrg mosaic
    for (h, w) in ((1080, 1920), (1080, 1440), (1079, 1439)):
        bayer = torch.as_tensor(rng.integers(0, 256, (4, h, w), dtype="uint8"), device=dev)
        got = debayer.debayer_bilinear_cuda(bayer, phase)
        want = debayer.debayer_bilinear(bayer, phase)
        bad = int((got != want).sum())
        print(f"kernel A debayer B=4 {h}x{w}: {bad} mismatching bytes")
        if bad:
            raise AssertionError(f"kernel A: {bad} mismatching bytes at {h}x{w}")
        if (h, w) == (1080, 1920):
            ms = _time_ms(lambda: debayer.debayer_bilinear_cuda(bayer, phase))
            plain_ms = _time_ms(lambda: debayer.debayer_bilinear(bayer, phase))
            planes = [got[:, c] for c in (2, 1, 0)]  # R<->B swap, as the chain
    rows["A"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)
    print(f"kernel A time B=4 1080x1920: {ms:.4f} ms, plain {plain_ms:.4f} ms")

    cfg = tp.flagship_config(1080, 1920).white_balance
    cuts = (float(torch.tensor(255.0 * cfg.saturation_bright_thr, dtype=torch.float32)),
            float(torch.tensor(255.0 * cfg.saturation_dark_thr, dtype=torch.float32)),
            float(torch.tensor(cfg.ccc_uv0, dtype=torch.float32)))
    small = [resize_linear_u8_plane(p, ccc.SMALL_H, ccc.SMALL_W).contiguous() for p in planes]
    got = ccc.log_chroma_counts_cuda(*small, *cuts)
    want = ccc.log_chroma_counts_plain(*small, *cuts)
    bad = int((got != want).sum())
    print(f"kernel B histogram B=4 270x360: {bad} mismatching counts "
          f"({int(want.sum())} pixels counted)")
    if bad:
        raise AssertionError(f"kernel B: {bad} mismatching counts")
    ms = _time_ms(lambda: ccc.log_chroma_counts_cuda(*small, *cuts))
    plain_ms = _time_ms(lambda: ccc.log_chroma_counts_plain(*small, *cuts))
    rows["B"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)
    print(f"kernel B time: {ms:.4f} ms, plain {plain_ms:.4f} ms")

    model = load_ccc_model(cfg.ccc_model_path)
    wr, wi, bias = (torch.as_tensor(a, device=dev) for a in
                    (model.filt_dft_re, model.filt_dft_im, model.bias))
    hist = ccc.log_chroma_histogram(*small, *cuts)
    got = ccc.ccc_response_cuda(hist, wr, wi, bias)
    want = ccc.ccc_response_plain(hist, wr, wi, bias)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    same_argmax = bool(torch.equal(ccc.response_argmax(got), ccc.response_argmax(want)))
    print(f"kernel C response B=4: max |diff| {err:.3e} (limit {1e-4 * scale:.3e}), "
          f"argmax equal: {same_argmax}")
    if not (err <= 1e-4 * scale and same_argmax):
        raise AssertionError("kernel C disagrees with its plain version")
    ms = _time_ms(lambda: ccc.ccc_response_cuda(hist, wr, wi, bias))
    plain_ms = _time_ms(lambda: ccc.ccc_response_plain(hist, wr, wi, bias))
    rows["C"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    print(f"kernel C time: {ms:.4f} ms, plain {plain_ms:.4f} ms")

    for (h, w) in ((1080, 1920), (1080, 1440), (1079, 1439), (3, 5)):
        bayer = torch.as_tensor(rng.integers(0, 256, (4, h, w), dtype="uint8"), device=dev)
        got = debayer.debayer_mht_cuda(bayer, phase)
        want = debayer.debayer_mht(bayer, phase)
        bad = int((got != want).sum())
        print(f"kernel D MHT debayer B=4 {h}x{w}: {bad} mismatching bytes")
        if bad:
            raise AssertionError(f"kernel D: {bad} mismatching bytes at {h}x{w}")
        if (h, w) == (1080, 1920):
            ms = _time_ms(lambda: debayer.debayer_mht_cuda(bayer, phase))
            plain_ms = _time_ms(lambda: debayer.debayer_mht(bayer, phase))
            planes = [got[:, c].contiguous() for c in range(3)]  # no swap under MHT
    rows["D"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)
    print(f"kernel D time B=4 1080x1920: {ms:.4f} ms, plain {plain_ms:.4f} ms")

    config = _chains(tp)["float"][0](1080, 1920)
    params = tp.make_params(config, (1080, 1920), dev)
    base, weights = params.remap_base, params.remap_weights
    got = undistortion.remap_float_cuda(planes, base, weights, (1080, 1920))
    want = undistortion.remap_float_planes(planes, base, weights, (1080, 1920))
    bad = int((got != want).sum())
    print(f"kernel E float remap B=4 1080x1920: {bad} mismatching bytes "
          f"({int((weights == 0).all(0).sum())} of {base.numel()} pixels fully outside)")
    if bad:
        raise AssertionError(f"kernel E: {bad} mismatching bytes")
    ms = _time_ms(lambda: undistortion.remap_float_cuda(planes, base, weights, (1080, 1920)))
    plain_ms = _time_ms(lambda: undistortion.remap_float_planes(planes, base, weights,
                                                                (1080, 1920)))
    rows["E"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)
    print(f"kernel E time: {ms:.4f} ms, plain {plain_ms:.4f} ms")
    for k in kernels.ALL:
        k.launches = 0  # the comparisons above are not the main path's
    return rows


def _run_chain(call, frames, state):
    """FRAMES frames in CALLS calls of call(pixels, state), the state carried
    across them."""
    outs = []
    per = frames.shape[0] // CALLS
    for c in range(CALLS):
        out, state = call(frames[c * per:(c + 1) * per], state)
        outs.append(out["processed"])
    return outs, state


def check_chains(tp, torch, rng):
    """Phase 2: each chain at full size, kernels vs plain. Returns
    {kernel name: launches in the 1920x1080 run of the first chain that runs
    it} and {(chain, size): (frames/s, plain frames/s)}."""
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.pipeline import make_isp_fn

    launches, fps = {}, {}
    for name, (make_config, sizes, path_kernels) in _chains(tp).items():
        for (h, w) in sizes:
            config = make_config(h, w)
            pipe = tp.build_pipeline(config, "bayer_gbrg8", frame_hw=(h, w), with_state=True,
                                     temporal_mode="sequence", device="cuda")
            plain_fn = make_isp_fn(config, "bayer_gbrg8", True, False,
                                   temporal_mode="sequence", remap_src_hw=(h, w), plain=True)
            plain = lambda px, st: plain_fn(pipe.params, px, st)  # noqa: E731
            frames = torch.as_tensor(rng.integers(0, 256, (FRAMES, h, w), dtype="uint8"),
                                     device="cuda")
            label = f"chain {name} {w}x{h}"
            main_run = (h, w) == (1080, 1920)
            if main_run:
                kernels.reset_launch_counts()
            outs, state = _run_chain(pipe, frames, tp.init_state((), "cuda"))
            torch.cuda.synchronize()
            if main_run:
                counts = {k.name: k.launches for k in kernels.ALL}
                print(f"{label} kernel launches: {counts}")
                if not all(counts[k] > 0 for k in path_kernels):
                    raise AssertionError(f"{label}: a kernel of the path was not launched: "
                                         f"{counts}, expected {path_kernels}")
                for k in path_kernels:
                    launches.setdefault(k, counts[k])
            ref, ref_state = _run_chain(plain, frames, tp.init_state((), "cuda"))
            for o in outs:
                if o.shape != (FRAMES // CALLS, h, w, 3) or o.dtype != torch.uint8:
                    raise AssertionError(f"{label} processed: shape {tuple(o.shape)} {o.dtype}")
            bad = sum(int((a != b).sum()) for a, b in zip(outs, ref))
            same_state = (torch.equal(state.x, ref_state.x)
                          and torch.equal(state.p, ref_state.p)
                          and torch.equal(state.initialized, ref_state.initialized))
            print(f"{label} B={FRAMES} in {CALLS} calls: {bad} mismatching bytes vs "
                  f"the plain chain; Kalman state equal: {same_state} "
                  f"(x={state.x.tolist()}, p={float(state.p)})")
            if bad or not same_state:
                raise AssertionError(f"{label} differs from the plain chain")

            def timed(call):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _run_chain(call, frames, tp.init_state((), "cuda"))
                torch.cuda.synchronize()
                return FRAMES / (time.perf_counter() - t0)

            k_fps = statistics.median(timed(pipe) for _ in range(5))
            p_fps = statistics.median(timed(plain) for _ in range(5))
            fps[(name, f"{w}x{h}")] = (k_fps, p_fps)
            print(f"{label} frames/s: {k_fps:.2f} (plain ops: {p_fps:.2f}), "
                  f"host clock around 2 calls of B={FRAMES // CALLS}, median of 5")
    return launches, fps


def check_small(tp, torch, rng):
    """Phase 3: each chain on the card equals it on the CPU at a small size."""
    h, w = SMALL
    frames = rng.integers(0, 256, (4, h, w), dtype="uint8")
    for name, (make_config, _, _) in _chains(tp).items():
        res = {}
        for dev in ("cuda", "cpu"):
            pipe = tp.build_pipeline(make_config(h, w), "bayer_gbrg8", frame_hw=(h, w),
                                     with_state=True, keep_intermediates=True,
                                     temporal_mode="sequence", device=dev)
            out, st = pipe(torch.as_tensor(frames, device=dev), tp.init_state((), dev))
            res[dev] = ({k: v.cpu() for k, v in out.items()}, st)
        bad = sum(int((res["cuda"][0][k] != res["cpu"][0][k]).sum()) for k in res["cpu"][0])
        same_state = all(torch.equal(getattr(res["cuda"][1], f).cpu(), getattr(res["cpu"][1], f))
                         for f in ("x", "p", "initialized"))
        print(f"chain {name} {w}x{h} on the card vs on the CPU: {bad} mismatching bytes, "
              f"Kalman state equal: {same_state}")
        if bad or not same_state:
            raise AssertionError(f"chain {name}: the card's chain differs from the CPU chain")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device (torch.cuda.is_available() is false)")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import raw_image_pipeline_tpu_torch as tp
        from raw_image_pipeline_tpu_torch import kernels
    except ImportError as e:
        return _fail(f"the port is not beside this script ({e})")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.LIBRARY.get()
    built = kernels.LIBRARY.build_seconds
    print(f"kernel build: {time.perf_counter() - t0:.2f} s"
          + ("" if built is not None else " (already built)"))

    rng = np.random.default_rng(SEED)
    try:
        rows = check_kernels(tp, torch, rng)
        launches, fps = check_chains(tp, torch, rng)
        check_small(tp, torch, rng)
    except Exception as e:  # the smoke test's boundary: report and fail
        import traceback

        traceback.print_exc()
        return _fail(repr(e))

    names = {"A": kernels.DEBAYER_BILINEAR, "B": kernels.CCC_HISTOGRAM,
             "C": kernels.CCC_RESPONSE, "D": kernels.DEBAYER_MHT, "E": kernels.REMAP_FLOAT}
    print(json.dumps({"chain_frames_per_s": [
        {"chain": name, "size": size, "kernels": a, "plain": b}
        for (name, size), (a, b) in fps.items()]}))
    # launches: the count in the 1920x1080 run of the first chain that runs
    # the kernel (A, B, C: flagship; D: gpu_parity; E: float)
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": launches[k.name], **rows[key]}
        for key, k in names.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
