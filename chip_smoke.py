#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

It builds the hand-written kernels from csrc/ (nvcc, sm_90a, one process
per source, into build/kernels/), then:

  1. holds each kernel against its plain PyTorch version on the card, at the
     shapes the chains give it, and times both on the device
     (tools/measure.device_ms), beside its bound (tools/measure.bound: the
     larger of its bytes over 3.35 TB/s and its operations over
     67 TFLOP/s; for C the operations of real-input FFTs, the fewest known
     for its function, and beside it the bound of the twelve DFT products
     that C computes; for A and D the integer operations of their plain
     formulas) and, for B, torch.bincount of the same bin indices:
       A debayer     — 0 mismatching bytes in the four phases at every
                       strip width V the wrapper picks: 1080x1920,
                       1080x1440 (V=16), 1920x1080 (8), 1080x1444 (4),
                       1079x1439, 3x5 and 3x3 (1), each at B=4 and B=1,
                       on frames[1:] of a 1079x1439 batch and on views 1
                       and 8 bytes past a 16-byte boundary; also timed at
                       B=64 1920x1080 (the wb_* chains' call, ten times
                       the L2 cache: ms_b64 beside bound_ms_b64);
       B histogram   — the f32 histogram equal value for value at B=4 and
                       B=1 270x360 and at B=3 135x241;
       C response    — equal argmax, max |diff| <= 1e-4 * max |resp|, on the
                       seeded frames' histograms (B=4) and on a two-peak
                       histogram whose response's two peaks differ by 1e-5
                       of max |resp| (tools/workloads.two_peak_histogram);
       D MHT debayer — as A, with 1x1 in place of 3x3;
       E float remap — 0 mismatching bytes on the float chain's fisheye
                       maps at 1920x1080 (B=4);
  2. drives each chain through build_pipeline(config, encoding,
     with_state=True, temporal_mode="sequence", device="cuda"), the Kalman
     state carried across the calls, at 1920x1080:
       flagship   — flagship_config(h, w), also at 1440x1080 (A, B, C);
       gpu_parity — MHT demosaic and the BT.709 gamma, the reference's
                    use_gpu=True semantics, also at 1440x1080 (D, B, C);
       float      — the float remap (A, B, C, E);
       fixed32    — the fixed32 remap, plain torch ops (A, B, C);
         (each 8 seeded frames in 2 calls)
       wb_simple, wb_grey_world, wb_pca, wb_learned — BASELINE config 2:
                    debayer, flip 90 and the statistical white balance,
                    128 frames made on the card in 2 calls of B=64 (A);
       pointwise_bgr8 — BASELINE config 4: colour calibration, vignetting
                    and the HSV enhancer on 512 bgr8 frames in one call
                    with microbatch=128 (no kernel), its peak device
                    memory printed;
     the launch counts are set to 0 just before each chain's 1920x1080 run
     and read just after, and each kernel of that chain must have launched;
     `processed` and the state must equal, byte for byte, the same chain
     with every op on its plain version on the card; the first 3 frames of
     each wb_* chain and the first 128-frame chunk of pointwise_bgr8 must
     also equal the chain on the CPU, byte for byte; frames/s is printed;
     then the flagship at B=70 with microbatch=32 must equal the unchunked
     chain, bytes and Kalman state;
  3. runs each chain at 96x128 on the card and on the CPU (plain versions)
     and requires equal bytes and Kalman state, the flagship in debug mode
     (every stage's dump), plus mono8, rgb8 and 16-bit Bayer input; then
     the RawImagePipeline API on the card against the API on the CPU:
     process with a grey-world WB, apply on a bgr8 buffer, and use_gpu=True
     with pca (D).

It prints the card's name and power limit, the build time, one line per
check, a JSON line of the kernels (with each one's launches on the main
path and per flagship call) and, last, {"ok": true, "device": ...}.
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

SMALL = (96, 128)
MICROBATCH_CHECK = (70, 32)  # frames, microbatch


def _small_frames(np, kind: str, n: int, h: int, w: int, seed: int):
    """n seeded small numpy frames of `kind`, each with its own colour cast."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    bgr = []
    for _ in range(n):
        base = 40 + 200 * (0.5 + 0.5 * np.sin(7 * xx + rng.uniform(0, 6) + 5 * yy))
        img = base[..., None] * rng.uniform(0.4, 1.7, 3) * rng.uniform(0.8, 1.2, (h, w, 3))
        bgr.append(np.clip(img, 0, 255).astype(np.uint8))
    bgr = np.stack(bgr)
    mosaic = bgr[..., 1].copy()
    mosaic[..., 0::2, 1::2] = bgr[..., 0::2, 1::2, 0]
    mosaic[..., 1::2, 0::2] = bgr[..., 1::2, 0::2, 2]
    return {"color": bgr, "mono": bgr[..., 1].copy(), "bayer": mosaic,
            "bayer16": (mosaic.astype(np.uint16) * 257
                        + rng.integers(0, 257, mosaic.shape)).astype(np.uint16)}[kind]


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


# (H, W) at which kernels A and D are held against their plain versions:
# every strip width V the wrapper can pick (ops/debayer.strip_width): 16 at
# 1920 and 1440 wide, 8 at 1080 (the wb_* chains' flipped mosaic), 4 at
# 1444, 1 at odd widths
DEBAYER_SHAPES = {
    "A": ((1080, 1920), (1080, 1440), (1920, 1080), (1080, 1444), (1079, 1439), (3, 5), (3, 3)),
    "D": ((1080, 1920), (1080, 1440), (1920, 1080), (1080, 1444), (1079, 1439), (3, 5), (1, 1)),
}
DEBAYER_B64 = (64, 1920, 1080)  # the wb_* chains' call: ten times the L2 cache
PHASES = ("rggb", "grbg", "gbrg", "bggr")


def check_debayer(torch, rng, key, algorithm, cuda_fn, plain_fn, phase):
    """Phase 1: kernel A or D against its plain version, 0 mismatching bytes
    in all four phases, at each of DEBAYER_SHAPES[key] at B=4 and B=1, on
    frames[1:] of a B=4 1079x1439 batch, and on B=2 1080x1920 views 1 and 8
    bytes past a 16-byte boundary; each line names the strip width V of its
    launches. Then the device times at B=4 1080x1920 (and the plain
    version's) and at DEBAYER_B64. Returns the B=4 1080x1920 output in
    `phase` and the kernel's row."""
    from raw_image_pipeline_tpu_torch.ops.debayer import strip_width
    from raw_image_pipeline_tpu_torch.tools.measure import bound, debayer_work, device_ms

    def frames(*shape):
        return torch.as_tensor(rng.integers(0, 256, shape, dtype="uint8"), device="cuda")

    cases = [(f"B={b} {h}x{w}", frames(b, h, w))
             for (h, w) in DEBAYER_SHAPES[key] for b in (4, 1)]
    cases.append(("frames[1:] of B=4 1079x1439", frames(4, 1079, 1439)[1:]))
    flat = frames(16 + 2 * 1080 * 1920)
    cases += [(f"B=2 1080x1920 at {off} bytes past a 16-byte boundary",
               flat[off:off + 2 * 1080 * 1920].view(2, 1080, 1920)) for off in (1, 8)]
    for label, bayer in cases:
        bad, widths = 0, set()
        for ph in PHASES:
            got = cuda_fn(bayer, ph)
            bad += int((got != plain_fn(bayer, ph)).sum())
            widths.add(strip_width(bayer.shape[2], bayer.data_ptr(), got.data_ptr()))
        print(f"kernel {key} {label} (V={sorted(widths)}): {bad} mismatching bytes in "
              f"{len(PHASES)} phases")
        if bad:
            raise AssertionError(f"kernel {key}: {bad} mismatching bytes at {label}")
    bayer = cases[0][1]  # B=4 1080x1920
    ms = device_ms(lambda: cuda_fn(bayer, phase))
    plain_ms = device_ms(lambda: plain_fn(bayer, phase))
    g = torch.Generator(device="cuda")
    g.manual_seed(int(rng.integers(1 << 31)))
    big = torch.randint(0, 256, DEBAYER_B64, generator=g, device="cuda", dtype=torch.uint8)
    ms_b64 = device_ms(lambda: cuda_fn(big, phase))
    work, work_b64 = debayer_work(bayer.numel(), algorithm), debayer_work(big.numel(), algorithm)
    del big
    b64 = bound(bytes_=work_b64["bytes"], ops=work_b64["ops"])
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
               **bound(bytes_=work["bytes"], ops=work["ops"]),
               ms_b64=ms_b64, bound_ms_b64=b64["bound_ms"])
    print(f"kernel {key} time B=4 1080x1920: {ms:.4f} ms (bound {row['bound_ms']:.4f}, "
          f"{row['bound_by']}), plain {plain_ms:.4f} ms; B={DEBAYER_B64[0]} "
          f"{DEBAYER_B64[1]}x{DEBAYER_B64[2]}: {ms_b64:.4f} ms (bound {b64['bound_ms']:.4f}, "
          f"{b64['bound_by']})")
    return cuda_fn(bayer, phase), row


def check_kernels(tp, torch, rng):
    """Phase 1: each kernel against its plain version on the card."""
    import numpy as np

    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model
    from raw_image_pipeline_tpu_torch.ops import ccc, debayer, undistortion
    from raw_image_pipeline_tpu_torch.ops.resize import resize_linear_u8_plane
    from raw_image_pipeline_tpu_torch.tools import workloads
    from raw_image_pipeline_tpu_torch.tools.measure import bound, ccc_response_work, device_ms

    dev = torch.device("cuda")
    rows = {}
    phase = debayer.phase_for_encoding("bayer_grbg8")  # the flipped gbrg mosaic
    planes, rows["A"] = check_debayer(torch, rng, "A", "bilinear",
                                      debayer.debayer_bilinear_cuda, debayer.debayer_bilinear,
                                      phase)
    planes = [planes[:, c] for c in (2, 1, 0)]  # R<->B swap, as the chain

    cfg = tp.flagship_config(1080, 1920).white_balance
    cuts = (float(torch.tensor(255.0 * cfg.saturation_bright_thr, dtype=torch.float32)),
            float(torch.tensor(255.0 * cfg.saturation_dark_thr, dtype=torch.float32)),
            float(torch.tensor(cfg.ccc_uv0, dtype=torch.float32)))
    small = [resize_linear_u8_plane(p, ccc.SMALL_H, ccc.SMALL_W).contiguous() for p in planes]
    odd = [torch.as_tensor(rng.integers(1, 256, (3, 135, 241), dtype="uint8"), device=dev)
           for _ in range(3)]
    for label, bgr in (("B=4 270x360", small), ("B=1 270x360", [p[:1] for p in small]),
                       ("B=3 135x241", odd)):
        got = ccc.log_chroma_histogram_cuda(*bgr, *cuts)
        want = ccc.log_chroma_histogram_plain(*bgr, *cuts)
        bad = int((got != want).sum())
        print(f"kernel B histogram {label}: {bad} mismatching f32 values "
              f"({int(torch.count_nonzero(want))} bins filled)")
        if bad:
            raise AssertionError(f"kernel B: {bad} mismatching values at {label}")
    bins = ccc.log_chroma_bins(*small, *cuts)
    ms = device_ms(lambda: ccc.log_chroma_histogram_cuda(*small, *cuts))
    plain_ms = device_ms(lambda: ccc.log_chroma_histogram_plain(*small, *cuts))
    library_ms = device_ms(lambda: torch.bincount(bins, minlength=4 * ccc.HIST_N ** 2))
    rows["B"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     **bound(bytes_=3 * small[0].numel() + ccc.LOG_TAB.nbytes
                             + small[0].shape[0] * ccc.HIST_N ** 2 * 4, ops=0))
    print(f"kernel B time B=4 270x360: {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bincount "
          f"of the {bins.numel()} bin indices {library_ms:.4f} ms")

    model = load_ccc_model(cfg.ccc_model_path)
    wr, wi, bias = (torch.as_tensor(a, device=dev) for a in
                    (model.filt_dft_re, model.filt_dft_im, model.bias))
    hist = ccc.log_chroma_histogram(*small, *cuts)
    two_peak, gap, peaks = workloads.two_peak_histogram(model.filt_dft_re, model.filt_dft_im,
                                                        model.bias)
    err = 0.0
    for label, x in (("B=4 seeded frames", hist),
                     (f"two-peak fixture (peaks {peaks}, relative gap {gap:.3e})",
                      torch.as_tensor(two_peak[None], device=dev))):
        got = ccc.ccc_response_cuda(x, wr, wi, bias)
        want = ccc.ccc_response_plain(x, wr, wi, bias)
        e = float((got - want).abs().max())
        scale = float(want.abs().max())
        same_argmax = bool(torch.equal(ccc.response_argmax(got), ccc.response_argmax(want)))
        print(f"kernel C response {label}: max |diff| {e:.3e} (limit {1e-4 * scale:.3e}), "
              f"argmax equal: {same_argmax}")
        if not (e <= 1e-4 * scale and same_argmax):
            raise AssertionError(f"kernel C disagrees with its plain version on {label}")
        err = max(err, e)
    ms = device_ms(lambda: ccc.ccc_response_cuda(hist, wr, wi, bias))
    plain_ms = device_ms(lambda: ccc.ccc_response_plain(hist, wr, wi, bias))
    # the bound of C's function (real-input FFTs: bytes bound it), and
    # beside it that of the twelve DFT products that C computes
    work = ccc_response_work(hist.shape[0], ccc.HIST_N)
    as_products = bound(bytes_=work["dft_bytes"], ops=work["dft_products_ops"])
    rows["C"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                     **bound(bytes_=work["bytes"], ops=work["least_ops"]),
                     dft_products_bound_ms=as_products["bound_ms"])
    print(f"kernel C time B=4: {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{rows['C']['bound_ms']:.5f} ms ({rows['C']['bound_by']}), as twelve DFT products "
          f"{as_products['bound_ms']:.5f} ms")

    planes, rows["D"] = check_debayer(torch, rng, "D", "mht", debayer.debayer_mht_cuda,
                                      debayer.debayer_mht, phase)
    planes = [planes[:, c].contiguous() for c in range(3)]  # no swap under MHT

    config = workloads.chains(tp)["float"].config(1080, 1920)
    params = tp.make_params(config, (1080, 1920), dev)
    base, weights = params.remap_base, params.remap_weights
    got = undistortion.remap_float_cuda(planes, base, weights, (1080, 1920))
    want = undistortion.remap_float_planes(planes, base, weights, (1080, 1920))
    bad = int((got != want).sum())
    print(f"kernel E float remap B=4 1080x1920: {bad} mismatching bytes "
          f"({int((weights == 0).all(0).sum())} of {base.numel()} pixels fully outside)")
    if bad:
        raise AssertionError(f"kernel E: {bad} mismatching bytes")
    ms = device_ms(lambda: undistortion.remap_float_cuda(planes, base, weights, (1080, 1920)))
    plain_ms = device_ms(lambda: undistortion.remap_float_planes(planes, base, weights,
                                                                (1080, 1920)))
    # the planes and the maps in, [4, h, w, 3] out
    moved = (2 * sum(p.numel() for p in planes) + base.numel() * base.element_size()
             + weights.numel() * weights.element_size())
    rows["E"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                     **bound(bytes_=moved, ops=0))
    print(f"kernel E time: {ms:.4f} ms, plain {plain_ms:.4f} ms")
    for k in kernels.ALL:
        k.launches = 0  # the comparisons above are not the main path's
    return rows


def _run_chain(call, frames, state, calls):
    """The frames in `calls` calls of call(pixels, state), the state carried
    across them."""
    outs = []
    per = frames.shape[0] // calls
    for c in range(calls):
        out, state = call(frames[c * per:(c + 1) * per], state)
        outs.append(out["processed"])
    return outs, state


def _same_state(torch, a, b) -> bool:
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in ("x", "p", "initialized"))


def _out_hw(config, h: int, w: int):
    """processed's [H, W]: the calibration size when the remap runs, else
    the frame after the flip."""
    from raw_image_pipeline_tpu_torch.pipeline import _post_flip_shape, _runs_undistortion

    if _runs_undistortion(config):
        return config.calibration.image_height, config.calibration.image_width
    return _post_flip_shape(h, w, config.flip.angle if config.flip.enabled else 0)


def check_chains(tp, torch, rng):
    """Phase 2: each chain at full size, kernels vs plain. Returns
    {kernel name: launches in the 1920x1080 run of the first chain that runs
    it}, {kernel name: grids on the device per call of the flagship at
    1920x1080},
    {(chain, size): (frames/s, plain frames/s)} and {chain: peak device
    bytes of its 1920x1080 run}."""
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.pipeline import _chunked_fn, make_isp_fn
    from raw_image_pipeline_tpu_torch.tools import workloads

    launches, per_flagship_call, fps, peak = {}, {}, {}, {}
    for name, ch in workloads.chains(tp).items():
        if ch.small_only:
            continue
        for (h, w) in ch.sizes:
            config = ch.config(h, w)
            pipe = tp.build_pipeline(config, ch.encoding, frame_hw=(h, w), with_state=True,
                                     temporal_mode="sequence", device="cuda",
                                     microbatch=ch.microbatch)
            plain_fn = make_isp_fn(config, ch.encoding, True, False, temporal_mode="sequence",
                                   plain=True)
            if ch.microbatch:
                plain_fn = _chunked_fn(plain_fn, ch.microbatch)
            plain = lambda px, st: plain_fn(pipe.params, px, st)  # noqa: E731
            if ch.kind == "bayer" and name in ("flagship", "gpu_parity", "float", "fixed32"):
                frames = torch.as_tensor(rng.integers(0, 256, (ch.frames, h, w), dtype="uint8"),
                                         device="cuda")
            else:
                frames = workloads.card_frames(torch, ch.kind, ch.frames, h, w,
                                               workloads.SEED + len(name))
            label = f"chain {name} {w}x{h}"
            main_run = (h, w) == (1080, 1920)
            torch.cuda.synchronize()
            if main_run:
                kernels.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
            outs, state = _run_chain(pipe, frames, tp.init_state((), "cuda"), ch.calls)
            torch.cuda.synchronize()
            if main_run:
                peak[name] = torch.cuda.max_memory_allocated()
                counts = {k.name: k.launches for k in kernels.ALL}
                print(f"{label} kernel launches: {counts}")
                if not all(counts[k] > 0 for k in ch.kernels):
                    raise AssertionError(f"{label}: a kernel of the path was not launched: "
                                         f"{counts}, expected {ch.kernels}")
                for k in ch.kernels:
                    launches.setdefault(k, counts[k])
                if name == "flagship":  # grids on the device, per call
                    per_flagship_call = {k.name: k.launches * k.grids / ch.calls
                                         for k in kernels.ALL}
            ref, ref_state = _run_chain(plain, frames, tp.init_state((), "cuda"), ch.calls)
            want = (ch.frames // ch.calls, *_out_hw(config, h, w), 3)
            for o in outs:
                if tuple(o.shape) != want or o.dtype != torch.uint8:
                    raise AssertionError(f"{label} processed: shape {tuple(o.shape)} {o.dtype}, "
                                         f"expected {want} uint8")
            bad = sum(int((a != b).sum()) for a, b in zip(outs, ref))
            same_state = _same_state(torch, state, ref_state)
            moved = sum(int((o != f).sum()) for o, f in zip(outs, frames.split(want[0]))
                        ) if ch.kind == "color" else None
            print(f"{label} B={ch.frames} in {ch.calls} calls"
                  + (f" (microbatch {ch.microbatch})" if ch.microbatch else "")
                  + f": {bad} mismatching bytes vs the plain chain; Kalman state equal: "
                  f"{same_state} (x={state.x.tolist()}, p={float(state.p)})"
                  + (f"; {moved} bytes changed from the input" if moved is not None else ""))
            if bad or not same_state or moved == 0:
                raise AssertionError(f"{label} differs from the plain chain")
            if ch.cpu_frames and main_run:
                check_on_cpu(tp, torch, label, config, ch, frames, outs[0])
            del outs, ref

            def timed(call):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _run_chain(call, frames, tp.init_state((), "cuda"), ch.calls)
                torch.cuda.synchronize()
                return ch.frames / (time.perf_counter() - t0)

            k_fps = statistics.median(timed(pipe) for _ in range(ch.reps))
            p_fps = statistics.median(timed(plain) for _ in range(ch.reps))
            fps[(name, f"{w}x{h}")] = (k_fps, p_fps)
            print(f"{label} frames/s: {k_fps:.2f} (plain ops: {p_fps:.2f}), host clock around "
                  f"{ch.calls} calls of B={ch.frames // ch.calls}, median of {ch.reps}"
                  + (f"; peak device memory {peak[name] / 2**30:.2f} GiB" if main_run else ""))
            del frames
            torch.cuda.empty_cache()
    return launches, per_flagship_call, fps, peak


def check_on_cpu(tp, torch, label, config, ch, frames, card_out):
    """Phase 2: the first ch.cpu_frames frames of a full-size run through
    the same chain on the CPU (in chunks of 32 frames) equal the card's
    output, byte for byte. These chains carry no state across frames."""
    n = ch.cpu_frames
    pipe = tp.build_pipeline(config, ch.encoding, frame_hw=tuple(frames.shape[1:3]),
                             with_state=True, temporal_mode="sequence", device="cpu",
                             microbatch=32)
    t0 = time.perf_counter()
    out, _ = pipe(frames[:n].cpu(), tp.init_state((), "cpu"))
    bad = int((out["processed"] != card_out[:n].cpu()).sum())
    print(f"{label}: the first {n} frames on the CPU ({time.perf_counter() - t0:.1f} s): "
          f"{bad} mismatching bytes vs the card")
    if bad:
        raise AssertionError(f"{label}: the card's chain differs from the CPU chain")


def check_microbatch(tp, torch, rng):
    """Phase 2: the flagship at B=70 with microbatch=32 (two chunks and a
    remainder of 6) equals the unchunked chain, bytes and Kalman state."""
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.tools import workloads

    n, mb = MICROBATCH_CHECK
    h, w = 1080, 1920
    frames = workloads.card_frames(torch, "bayer", n, h, w, workloads.SEED + 70)
    res = {}
    for chunk in (mb, None):
        pipe = tp.build_pipeline(tp.flagship_config(h, w), "bayer_gbrg8", frame_hw=(h, w),
                                 with_state=True, temporal_mode="sequence", device="cuda",
                                 microbatch=chunk)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out, st = pipe(frames, tp.init_state((), "cuda"))
        torch.cuda.synchronize()
        res[chunk] = (out["processed"], st, {k.name: k.launches for k in kernels.ALL})
    bad = int((res[mb][0] != res[None][0]).sum())
    same_state = _same_state(torch, res[mb][1], res[None][1])
    print(f"microbatch flagship 1920x1080 B={n}, microbatch {mb}: {bad} mismatching bytes vs "
          f"unchunked; Kalman state equal: {same_state}; launches {res[mb][2]} "
          f"(unchunked {res[None][2]})")
    if bad or not same_state or res[mb][2]["debayer_bilinear"] != -(-n // mb):
        raise AssertionError("microbatch differs from the unchunked chain")


def check_small(tp, torch, np):
    """Phase 3: each chain on the card equals it on the CPU at a small size;
    also the flagship in debug mode, every dump compared."""
    from raw_image_pipeline_tpu_torch.tools import workloads

    h, w = SMALL
    for name, ch in workloads.chains(tp).items():
        frames = _small_frames(np, ch.kind, 4, h, w, workloads.SEED + len(name))
        debug = name == "flagship"
        res = {}
        for dev in ("cuda", "cpu"):
            pipe = tp.build_pipeline(ch.config(h, w), ch.encoding, frame_hw=(h, w),
                                     with_state=True, keep_intermediates=True,
                                     temporal_mode="sequence", device=dev, debug=debug,
                                     microbatch=3 if ch.microbatch else None)
            out, st = pipe(torch.as_tensor(frames, device=dev), tp.init_state((), dev))
            res[dev] = ({k: v.cpu() for k, v in out.items()}, st)
        if set(res["cuda"][0]) != set(res["cpu"][0]):
            raise AssertionError(f"chain {name}: different outputs {sorted(res['cuda'][0])}")
        bad = sum(int((res["cuda"][0][k] != res["cpu"][0][k]).sum()) for k in res["cpu"][0])
        same_state = _same_state(torch, res["cuda"][1], res["cpu"][1])
        print(f"chain {name} ({ch.encoding}) {w}x{h} on the card vs on the CPU: "
              f"{bad} mismatching bytes in {len(res['cpu'][0])} outputs, "
              f"Kalman state equal: {same_state}")
        if bad or not same_state:
            raise AssertionError(f"chain {name}: the card's chain differs from the CPU chain")


def check_api(tp, torch, np):
    """The API on the card against the API on the CPU: the shipped params
    with a grey-world WB, process
    on a Bayer frame, apply on a bgr8 buffer, and use_gpu=True with pca
    (kernel D)."""
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.tools.workloads import SEED

    bgr = _small_frames(np, "color", 1, 540, 720, SEED + 5)[0]
    bayer = _small_frames(np, "bayer", 1, 540, 720, SEED + 6)[0]
    res = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        p = tp.RawImagePipeline(device=dev)
        p.set_white_balance_method("grey_world")
        a = p.process(bayer, "bayer_gbrg8")
        buf = bgr.copy()
        p.apply(buf, "bgr8")
        g = tp.RawImagePipeline(use_gpu=True, device=dev)
        g.set_white_balance(True)
        g.set_white_balance_method("pca")
        c = g.process(bayer, "bayer_gbrg8")
        res[dev] = (a, buf, c, {k.name: k.launches for k in kernels.ALL})
    bad = [int((x != y).sum()) for x, y in zip(res["cuda"][:3], res["cpu"][:3])]
    counts = res["cuda"][3]
    print(f"API on the card vs on the CPU (process grey_world, apply bgr8, use_gpu pca): "
          f"{bad} mismatching bytes; launches {counts}")
    if any(bad) or counts["debayer_bilinear"] < 1 or counts["debayer_mht"] < 1:
        raise AssertionError("the API on the card differs from the API on the CPU")
    if np.array_equal(res["cuda"][1], bgr) or np.array_equal(res["cuda"][0], res["cuda"][2]):
        raise AssertionError("the API's calls left the frames unchanged")


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
        from raw_image_pipeline_tpu_torch.tools import measure, workloads
    except ImportError as e:
        return _fail(f"the port is not beside this script ({e})")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output"
    print(smi_line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.LIBRARY.get()
    built = kernels.LIBRARY.build_seconds
    print(f"kernel build: {time.perf_counter() - t0:.2f} s"
          + ("" if built is not None else " (already built)"))

    rng = np.random.default_rng(workloads.SEED)
    try:
        rows = check_kernels(tp, torch, rng)
        launches, per_flagship_call, fps, peak = check_chains(tp, torch, rng)
        check_microbatch(tp, torch, rng)
        check_small(tp, torch, np)
        check_api(tp, torch, np)
    except Exception as e:  # the smoke test's boundary: report and fail
        import traceback

        traceback.print_exc()
        return _fail(repr(e))

    names = {"A": kernels.DEBAYER_BILINEAR, "B": kernels.CCC_HISTOGRAM,
             "C": kernels.CCC_RESPONSE, "D": kernels.DEBAYER_MHT, "E": kernels.REMAP_FLOAT}
    print(json.dumps({"chain_frames_per_s": [
        {"chain": name, "size": size, "kernels": a, "plain": b}
        for (name, size), (a, b) in fps.items()],
        "peak_device_bytes_1920x1080": peak}))
    # launches: the wrapper's count in the 1920x1080 run of the first chain
    # that runs the kernel (A, B, C: flagship; D: gpu_parity; E: float);
    # launches_per_flagship_call: the grids it put on the device per call
    print(f"bound_ms against the H100 SXM's published peaks "
          f"({measure.PEAK_BYTES_PER_S / 1e12} TB/s, {measure.PEAK_F32_FLOP_PER_S / 1e12} "
          f"TFLOP/s f32) on this card: {smi_line}")
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": launches[k.name], "grids_per_launch": k.grids,
         "launches_per_flagship_call": per_flagship_call[k.name], **rows[key]}
        for key, k in names.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
