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
                       1079x1439, 3x5 and 3x3 (1), and at a height or a
                       width of 2 (2x1920, 1080x2, 2x2), each at B=4 and B=1,
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
                       maps at 1920x1080 and 1440x1080 (B=4 and B=1) and
                       at 1439x1079 and 117x91, the 1920x1080 map cropped
                       to 1439x1079 and 117x91, on frames[1:], hostile
                       maps at 1439x1079 and 117x91, a source of height 1,
                       planes 1 and 8 bytes and the map 4 bytes past a
                       16-byte boundary, and a mono plane; timed at B=4,
                       at B=4 on planes 1 byte off (ms_unaligned) and at
                       B=64 1920x1080 (ms_b64); then with per-camera maps,
                       4 cameras x B=4 1080x1920 through four distinct
                       fisheye maps in one launch, 0 mismatching bytes
                       against each camera's block, timed beside its bound
                       (ms_cameras4, bound_ms_cameras4) and one camera's
                       launch at B=4 (ms_cameras1);
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
     chain, bytes and Kalman state; then the camera-blocked multicamera
     chains (BASELINE config 5 on one card) multicam4 and multicam4_float,
     4 cameras x B=4 in 2 calls in both temporal modes, each kernel of the
     chain launched once per call, equal to the plain-op multicamera chain
     and to four single-camera chains, and with four equal calibrations one
     flat map (E launched with cameras=1), frames/s beside the four
     single-camera chains'; then the streamed Kalman chain (BASELINE config
     3): 42 1920x1080 frames written as raw files, read back through the
     port's FramePump, run through StreamRunner(batch_size=4) and held,
     every stream's every frame and the final state, against build_pipeline
     on the same batches, frames/s beside bare chain calls;
  3. runs each chain at 96x128 on the card and on the CPU (plain versions)
     and requires equal bytes and Kalman state, the flagship in debug mode
     (every stage's dump), plus mono8, rgb8 and 16-bit Bayer input; then
     the RawImagePipeline API on the card against the API on the CPU:
     process with a grey-world WB, apply on a bgr8 buffer, and use_gpu=True
     with pca (D);
  4. drives the port's user programs (raw_image_pipeline_tpu_torch/tools)
     on the card: run_pipeline's directory raw mode at the reference's
     launch-file profile on the 1.6 MP sensor (flip 180, CCC, undistortion
     with balance 0.5 and fov_scale 1.2; configs/alphasense_launch_profile
     .yaml, alphasense_calib_1.6mp_example.yaml), 24 raw 1440x1080 frames in
     batches of 8, with the lerp and the float remap, on seeded synthetic
     frames and on frames mosaicked from the Alphasense fixture: every
     written PNG decoded against the plain-op chain on the card (every
     frame) and the CPU chain (the first 2), camera_info.yaml against the
     CPU API's, launches counted over each run, frames/s with the writes
     beside StreamRunner with a null sink, one colour frame's write by
     image_io (and by cv2 where it imports); run_pipeline --listen
     --control (6 frames paced one output at a time, reset_white_balance
     and reload_params between frames 2 and 3) against the CPU API;
     apply_pipeline and ccc_tune (both modes) on the fixture against
     --device cpu (files, printed text, gains' bits); gpu_parity_check whole
     (all 2^24 triples of the exact colour spaces against their digests,
     the white-balance oracle goldens, the 540x720 chain card vs CPU);
     stream_bench on 64 1080x1920 raw frames; stage_timings of the flagship
     at 1920x1080, B=4.

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
# 1444, 1 at odd widths; for A also a height or a width of 2, where cv's
# border replication swaps the stencil's two rows or columns
DEBAYER_SHAPES = {
    "A": ((1080, 1920), (1080, 1440), (1920, 1080), (1080, 1444), (1079, 1439), (3, 5), (3, 3),
          (2, 1920), (1080, 2), (2, 2)),
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


REMAP_B64 = (64, 1080, 1920)  # kernel E past the L2 cache: 837.7 MB moved


def check_remap(tp, torch, rng, planes):
    """Phase 1: kernel E against remap_float_planes, 0 mismatching bytes, on
    the float chain's fisheye maps at 1080x1920 and 1080x1440 (B=4 and
    B=1) and at 1079x1439 and 91x117 (B=4), the 1080x1920 map cropped to
    1079x1439 and 91x117 over a 1080x1920 source (staged tiles under byte
    stores), frames[1:] of a B=4 batch, hostile maps at 1079x1439 and
    91x117, a source of height 1 (taps leave [0, H*W)), planes 1 and 8 bytes
    past a 16-byte boundary, the map 4 bytes past one (V=1) and one mono
    plane; each line names the store width V of its launch. Then the device
    times at B=4 1080x1920 on `planes` (kernel D's output, and the plain
    version's), on copies of them 1 byte past a 16-byte boundary (every
    tile gathers from global memory) and at REMAP_B64. Returns the
    kernel's row."""
    from raw_image_pipeline_tpu_torch.ops import undistortion
    from raw_image_pipeline_tpu_torch.tools import workloads
    from raw_image_pipeline_tpu_torch.tools.measure import bound, device_ms, remap_float_work

    dev = torch.device("cuda")

    def frames(*shape):
        return [torch.as_tensor(rng.integers(0, 256, shape, dtype="uint8"), device=dev)
                for _ in range(3)]

    def maps(out_hw, src_hw, kind):
        if kind == "fisheye":
            params = tp.make_params(workloads.chains(tp)["float"].config(*out_hw), out_hw, dev)
            return params.remap_base, params.remap_weights
        mx, my = workloads.hostile_maps(out_hw, src_hw, out_hw[0] * out_hw[1])
        return tuple(torch.as_tensor(a, device=dev)
                     for a in undistortion.remap_precompute(mx, my, src_hw, mode="float"))

    fisheye = {hw: maps(hw, hw, "fisheye") for hw in ((1080, 1920), (1080, 1440))}
    base, weights = fisheye[(1080, 1920)]
    cases = [(f"fisheye B={b} {h}x{w}", frames(b, h, w), *fisheye[(h, w)], (h, w))
             for (h, w) in fisheye for b in (4, 1)]
    cases.append(("fisheye frames[1:] of B=4 1080x1920",
                  [p[1:] for p in frames(4, 1080, 1920)], base, weights, (1080, 1920)))
    cases += [(f"fisheye B=4 {h}x{w}", frames(4, h, w), *maps((h, w), (h, w), "fisheye"), (h, w))
              for (h, w) in ((1079, 1439), (91, 117))]
    # the 1080x1920 map cropped: a source 16-byte aligned (staged tiles)
    # under an odd output width (byte stores, partial 64-column tiles)
    for (h, w), (r0, c0) in (((1079, 1439), (0, 0)), ((91, 117), (494, 901))):
        crop = (slice(r0, r0 + h), slice(c0, c0 + w))
        cases.append((f"fisheye B=4 1080x1920 source, its map cropped to {h}x{w} at ({r0}, {c0})",
                      frames(4, 1080, 1920), base.view(1080, 1920)[crop].reshape(-1).contiguous(),
                      weights.view(4, 1080, 1920)[(slice(None), *crop)].reshape(4, -1).contiguous(),
                      (h, w)))
    cases += [(f"hostile B=4 {h}x{w}", frames(4, h, w), *maps((h, w), (h, w), "hostile"), (h, w))
              for (h, w) in ((1079, 1439), (91, 117))]
    cases.append(("hostile B=4 1x128 source to 96x128", frames(4, 1, 128),
                  *maps((96, 128), (1, 128), "hostile"), (96, 128)))
    flat = torch.as_tensor(rng.integers(0, 256, 16 + 2 * 1080 * 1920, dtype="uint8"), device=dev)
    cases += [(f"fisheye B=2 planes {off} bytes past a 16-byte boundary",
               [flat[off:off + 2 * 1080 * 1920].view(2, 1080, 1920)] * 3, base, weights,
               (1080, 1920)) for off in (1, 8)]
    shifted = torch.empty(4 + weights.numel(), dtype=torch.float32, device=dev)
    shifted[1:1 + weights.numel()] = weights.reshape(-1)
    cases.append(("fisheye B=4, the weights 4 bytes past a 16-byte boundary",
                  frames(4, 1080, 1920), base, shifted[1:1 + weights.numel()].view(4, -1),
                  (1080, 1920)))
    cases.append(("fisheye B=4 mono", frames(4, 1080, 1920)[:1], base, weights, (1080, 1920)))
    for label, pl, b_, w_, hw in cases:
        got = undistortion.remap_float_cuda(pl, b_, w_, hw)
        bad = int((got != undistortion.remap_float_planes(pl, b_, w_, hw)).sum())
        v = undistortion.remap_run_width(hw[1], got.data_ptr(), b_.data_ptr(), w_.data_ptr())
        print(f"kernel E float remap {label} (V={v}): {bad} mismatching bytes "
              f"({int((w_ == 0).all(0).sum())} of {b_.numel()} pixels fully outside)")
        if bad:
            raise AssertionError(f"kernel E: {bad} mismatching bytes at {label}")
    del cases, flat, shifted
    hw = (1080, 1920)
    ms = device_ms(lambda: undistortion.remap_float_cuda(planes, base, weights, hw))
    plain_ms = device_ms(lambda: undistortion.remap_float_planes(planes, base, weights, hw))
    n = planes[0].numel()
    unaligned = [torch.empty(16 + n, dtype=torch.uint8, device=dev)[1:1 + n].view(p.shape)
                 for p in planes]
    for dst, src in zip(unaligned, planes):
        dst.copy_(src)
    if not torch.equal(undistortion.remap_float_cuda(unaligned, base, weights, hw),
                       undistortion.remap_float_cuda(planes, base, weights, hw)):
        raise AssertionError("kernel E: planes 1 byte past a 16-byte boundary differ")
    ms_unaligned = device_ms(lambda: undistortion.remap_float_cuda(unaligned, base, weights, hw))
    del unaligned
    g = torch.Generator(device="cuda")
    g.manual_seed(int(rng.integers(1 << 31)))
    big = [torch.randint(0, 256, REMAP_B64, generator=g, device="cuda", dtype=torch.uint8)
           for _ in range(3)]
    ms_b64 = device_ms(lambda: undistortion.remap_float_cuda(big, base, weights, hw))
    del big
    live = int((weights != 0).any(0).sum())
    work = remap_float_work(planes[0].shape[0], *hw, base.numel(), 3, live)
    work_b64 = remap_float_work(REMAP_B64[0], *hw, base.numel(), 3, live)
    b64 = bound(bytes_=work_b64["bytes"], ops=work_b64["ops"])
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
               **bound(bytes_=work["bytes"], ops=work["ops"]),
               ms_b64=ms_b64, bound_ms_b64=b64["bound_ms"], ms_unaligned=ms_unaligned)
    print(f"kernel E time B=4 1080x1920: {ms:.4f} ms (bound {row['bound_ms']:.4f}, "
          f"{row['bound_by']}), plain {plain_ms:.4f} ms, planes 1 byte past a 16-byte boundary "
          f"(no staged tile) {ms_unaligned:.4f} ms; B={REMAP_B64[0]} "
          f"{REMAP_B64[1]}x{REMAP_B64[2]}: {ms_b64:.4f} ms (bound {b64['bound_ms']:.4f}, "
          f"{b64['bound_by']})")
    return row


MULTICAM_E = (4, 4, 1080, 1920)  # kernel E per camera: cameras, frames a camera, H, W


def check_remap_cameras(tp, torch, rng, row):
    """Phase 1: kernel E with per-camera maps, one launch for [4 cameras x
    B=4] 1080x1920 planes through the four distinct fisheye maps of the
    multicam4_float chain (tools/workloads.multicam_calibrations), stacked
    [4, N] / [4, 4, N], against remap_float_planes camera block by camera
    block: 0 mismatching bytes. Then its device time beside its byte bound
    (the planes in, the output out, four maps of 20 bytes a pixel), and on
    the same line the single-camera launch (cameras=1, camera 0's map) at
    B=4. Adds ms_cameras4, bound_ms_cameras4 and ms_cameras1 to E's row."""
    from raw_image_pipeline_tpu_torch.ops import undistortion
    from raw_image_pipeline_tpu_torch.parallel import build_multicamera_pipeline
    from raw_image_pipeline_tpu_torch.tools import workloads
    from raw_image_pipeline_tpu_torch.tools.measure import bound, device_ms, remap_float_work

    cams, per, h, w = MULTICAM_E
    hw = (h, w)
    config = workloads.multicam_chains(tp)["multicam4_float"].config(h, w)
    calibs = workloads.multicam_calibrations(config.calibration)
    params = build_multicamera_pipeline(config, calibs, "bayer_gbrg8", hw, device="cuda").params
    base, weights = params.remap_base, params.remap_weights
    g = torch.Generator(device="cuda")
    g.manual_seed(int(rng.integers(1 << 31)))
    planes = [torch.randint(0, 256, (cams * per, h, w), generator=g, device="cuda",
                            dtype=torch.uint8) for _ in range(3)]
    for pl in (planes, planes[:1]):
        got = undistortion.remap_float_cuda(pl, base, weights, hw)
        bad = sum(int((got[c * per:(c + 1) * per] != undistortion.remap_float_planes(
            [p[c * per:(c + 1) * per] for p in pl], base[c], weights[c], hw)).sum())
            for c in range(cams))
        v = undistortion.remap_run_width(w, got.data_ptr(), base.data_ptr(), weights.data_ptr())
        print(f"kernel E float remap per camera: {cams} cameras x B={per} {w}x{h}, "
              f"{len(pl)} channel(s), maps {tuple(base.shape)} (V={v}): {bad} mismatching bytes")
        if bad:
            raise AssertionError(f"kernel E per camera: {bad} mismatching bytes")
    del got
    ms = device_ms(lambda: undistortion.remap_float_cuda(planes, base, weights, hw))
    first = [p[:per] for p in planes]
    ms1 = device_ms(lambda: undistortion.remap_float_cuda(first, base[0], weights[0], hw))
    live = int((weights != 0).any(1).sum())
    work = remap_float_work(cams * per, h, w, base.shape[1], 3, live, maps=cams)
    b = bound(bytes_=work["bytes"], ops=work["ops"])
    row.update(ms_cameras4=ms, bound_ms_cameras4=b["bound_ms"], ms_cameras1=ms1)
    print(f"kernel E time per camera, {cams} cameras x B={per} {w}x{h} in one launch: {ms:.4f} ms "
          f"(bound {b['bound_ms']:.4f}, {b['bound_by']}); one camera (cameras=1) B={per}: "
          f"{ms1:.4f} ms")


def check_kernels(tp, torch, rng):
    """Phase 1: each kernel against its plain version on the card."""
    import numpy as np

    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model
    from raw_image_pipeline_tpu_torch.ops import ccc, debayer
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

    rows["E"] = check_remap(tp, torch, rng, planes)
    check_remap_cameras(tp, torch, rng, rows["E"])
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


def check_multicam(tp, torch):
    """Phase 2: the camera-blocked chains multicam4 and multicam4_float
    (tools/workloads.multicam_chains: 4 cameras x B=4 1920x1080, fx and fy
    scaled per camera) in both temporal modes, with state, in 2 calls. The
    launch counts are set to 0 just before each run and read just after:
    each kernel of the chain must launch once per call (A, B and C once for
    all four cameras, E once with its four maps). Each run must equal (i)
    the plain-op multicamera chain and (ii) four single-camera chains
    (build_pipeline), each camera's block with its own calibration, bytes
    and Kalman state per camera; (iii) four equal calibrations must give
    one flat map, and E a launch with cameras=1, equal to the plain chain.
    Returns {chain: (frames/s, frames/s of the four single-camera
    chains)}."""
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.parallel import (
        build_multicamera_pipeline,
        multicamera_state,
    )
    from raw_image_pipeline_tpu_torch.pipeline import _post_flip_shape, make_isp_fn
    from raw_image_pipeline_tpu_torch.tools import workloads

    h, w = 1080, 1920
    enc = "bayer_gbrg8"
    cams = len(workloads.MULTICAM_SCALES)
    fps = {}
    for name, ch in workloads.multicam_chains(tp).items():
        config = ch.config(h, w)
        calibs = workloads.multicam_calibrations(config.calibration)
        src = _post_flip_shape(h, w, config.flip.angle if config.flip.enabled else 0)
        per = ch.frames // ch.calls
        frames = workloads.card_frames(torch, "bayer", cams * ch.frames, h, w,
                                       workloads.SEED + len(name)).view(cams, ch.frames, h, w)
        multi = build_multicamera_pipeline(config, calibs, enc, (h, w), with_state=True,
                                           temporal_mode="sequence", device="cuda")
        solo = [tp.build_pipeline(config.replace(calibration=c), enc, (h, w), with_state=True,
                                  temporal_mode="sequence", device="cuda") for c in calibs]

        def run(fn, params, mode, cameras=cams, px=frames):
            """The frames in ch.calls calls of fn, the state carried."""
            state = (multicamera_state(cams, per, mode, "cuda") if cameras > 1 else
                     tp.init_state(() if mode == "sequence" else (per,), "cuda"))
            outs = []
            for c in range(ch.calls):
                chunk = px[:, c * per:(c + 1) * per] if cameras > 1 else px[c * per:(c + 1) * per]
                out, state = fn(params, chunk, state)
                outs.append(out["processed"])
            return outs, state

        for mode in ("sequence", "cameras"):
            label = f"multicamera {name} {w}x{h} {cams} cameras x B={per} ({mode})"
            fn, plain_fn = (make_isp_fn(config.replace(calibration=calibs[0]), enc, True, False,
                                        temporal_mode=mode, remap_src_hw=src, n_cameras=cams,
                                        plain=plain) for plain in (False, True))
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            outs, state = run(fn, multi.params, mode)
            torch.cuda.synchronize()
            counts = {k.name: k.launches for k in kernels.ALL}
            print(f"{label} kernel launches per call: "
                  f"{ {k: v / ch.calls for k, v in counts.items()} }")
            if any(counts[k] != ch.calls for k in ch.kernels):
                raise AssertionError(f"{label}: kernels {ch.kernels} must launch once per call: "
                                     f"{counts} in {ch.calls} calls")
            for o in outs:
                if tuple(o.shape) != (cams, per, h, w, 3) or o.dtype != torch.uint8:
                    raise AssertionError(f"{label}: processed {tuple(o.shape)} {o.dtype}")
            ref, ref_state = run(plain_fn, multi.params, mode)
            bad = sum(int((a != b).sum()) for a, b in zip(outs, ref))
            same = _same_state(torch, state, ref_state)
            single_fn = make_isp_fn(config, enc, True, False, temporal_mode=mode,
                                    remap_src_hw=src)
            bad_single, same_single = [], []
            for c, pipe in enumerate(solo):
                one, one_state = run(single_fn, pipe.params, mode, 1, frames[c])
                bad_single.append(sum(int((a[c] != b).sum()) for a, b in zip(outs, one)))
                same_single.append(all(torch.equal(getattr(state, f)[c], getattr(one_state, f))
                                       for f in ("x", "p", "initialized")))
            print(f"{label}: {bad} mismatching bytes vs the plain-op multicamera chain, Kalman "
                  f"state equal: {same}; vs four single-camera chains: {bad_single} mismatching "
                  f"bytes, states equal: {same_single} (x={state.x.reshape(-1).tolist()})")
            if bad or not same or any(bad_single) or not all(same_single):
                raise AssertionError(f"{label} differs")
            if mode == "sequence":
                def timed(call):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    return cams * ch.frames / (time.perf_counter() - t0)

                fps[name] = (statistics.median(timed(lambda: run(fn, multi.params, mode))
                                               for _ in range(ch.reps)),
                             statistics.median(timed(lambda: [
                                 run(single_fn, p.params, mode, 1, frames[c])
                                 for c, p in enumerate(solo)]) for _ in range(ch.reps)))
                print(f"{label} frames/s: {fps[name][0]:.2f} ({cams * per} frames a call), four "
                      f"single-camera chains of B={per}: {fps[name][1]:.2f}; median of {ch.reps}")
        # (iii) four equal calibrations share one flat map
        shared = build_multicamera_pipeline(config, [calibs[0]] * cams, enc, (h, w),
                                            with_state=True, temporal_mode="sequence",
                                            device="cuda")
        cameras_arg = []
        launch = kernels.REMAP_FLOAT.launch
        kernels.REMAP_FLOAT.launch = lambda *a: (cameras_arg.append(a[6]), launch(*a))[1]
        try:
            outs, state = run(shared.fn, shared.params, "sequence")
        finally:
            del kernels.REMAP_FLOAT.launch  # the class's method again
        plain_fn = make_isp_fn(config, enc, True, False, temporal_mode="sequence",
                               remap_src_hw=src, n_cameras=cams, plain=True)
        ref, ref_state = run(plain_fn, shared.params, "sequence")
        bad = sum(int((a != b).sum()) for a, b in zip(outs, ref))
        flat = shared.params.remap_base.dim() == 1
        print(f"multicamera {name} with four equal calibrations: one flat map {flat} "
              f"{tuple(shared.params.remap_base.shape)}, kernel E launched with cameras="
              f"{cameras_arg}; {bad} mismatching bytes vs the plain-op chain, Kalman state equal: "
              f"{_same_state(torch, state, ref_state)}")
        if (not flat or bad or not _same_state(torch, state, ref_state)
                or ("remap_float" in ch.kernels) != bool(cameras_arg)
                or any(c != 1 for c in cameras_arg)):
            raise AssertionError(f"multicamera {name}: the shared map's run is wrong")
        del frames, multi, solo, shared, outs, ref
        torch.cuda.empty_cache()
    return fps


def check_stream(tp, torch, np, root):
    """Phase 2: the streamed Kalman chain (BASELINE config 3): the
    flagship at 1920x1080 through StreamRunner(batch_size=4) on the card.
    Its STREAM_FRAMES frames are written as raw files and read back through
    the port's FramePump (the native library, built with make, or numpy
    reads where it does not build; the line says which). The launch counts
    are set to 0 before the run and read after it: A, B and C launch once
    per batch, the stateful tail of 2 included. Every stream's every frame
    and the final Kalman state must equal build_pipeline(...,
    keep_intermediates=True, temporal_mode="sequence") called on the same
    batches with the state carried. Returns (the runner's frames/s, the
    bare chain's frames/s with synchronous copies in and out)."""
    import tempfile

    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.runtime import native
    from raw_image_pipeline_tpu_torch.runtime.stream import StreamRunner
    from raw_image_pipeline_tpu_torch.tools import workloads

    h, w = 1080, 1920
    n, b = workloads.STREAM_FRAMES, workloads.STREAM_BATCH
    config = tp.flagship_config(h, w)
    frames = workloads.card_frames(torch, "bayer", n, h, w, workloads.SEED + n).cpu().numpy()
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as d:
        paths = [os.path.join(d, f"frame_{i:03d}.raw") for i in range(n)]
        for p, f in zip(paths, frames):
            f.tofile(p)
        # the pump's library alone: the sink's needs OpenCV's headers;
        # without a toolchain the frames are read with numpy
        try:
            subprocess.run(["make", "-C", native._NATIVE_DIR, "libframe_pump.so"],
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"stream: make of the native pump failed: {e!r}")
        t0 = time.perf_counter()
        if native.native_available():
            how = "the native FramePump"
            pump = native.FramePump(paths, (h, w), batch=b)
            read = np.concatenate(list(pump))
            pump.close()
        else:
            how = "numpy reads (the native pump's library did not build)"
            read = np.stack([np.fromfile(p, np.uint8).reshape(h, w) for p in paths])
        read_s = time.perf_counter() - t0
    print(f"stream: {n} raw {w}x{h} frames read back through {how} in {read_s:.3f} s: "
          f"equal to those written: {np.array_equal(read, frames)}")
    if not np.array_equal(read, frames):
        raise AssertionError("stream: the frames read back differ from those written")

    runner = StreamRunner(config, "bayer_gbrg8", (h, w), batch_size=b, device="cuda")
    got = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    count = runner.run(iter(read), lambda s, i, img: got.setdefault((s, i), img))
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels.ALL}
    batches = -(-n // b)
    print(f"stream flagship {w}x{h} StreamRunner(batch_size={b}): {count} frames, "
          f"{len(got)} images; kernel launches {counts} ({batches} batches)")
    if count != n or any(counts[k] != batches for k in
                         ("debayer_bilinear", "ccc_histogram", "ccc_response")):
        raise AssertionError("stream: frames or launches wrong")
    pipe = tp.build_pipeline(config, "bayer_gbrg8", (h, w), with_state=True,
                             keep_intermediates=True, temporal_mode="sequence", device="cuda")
    state = tp.init_state((), "cuda")
    bad, seen = 0, 0
    for s in range(0, n, b):
        out, state = pipe(torch.as_tensor(read[s:s + b], device="cuda"), state)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for i in range(out["processed"].shape[0]):
            for stream, key in (("color", "dist_color"), ("color_rect", "processed"),
                                ("debayered", "debayered")):
                bad += int((got[(stream, s + i)] != out[key][i]).sum())
                seen += 1
    same = _same_state(torch, runner.state, state)
    print(f"stream vs build_pipeline on the same batches, the state carried: {bad} mismatching "
          f"bytes in {seen} of {len(got)} images; Kalman state equal: {same} "
          f"(x={runner.state.x.tolist()}, p={float(runner.state.p)})")
    if bad or seen != len(got) or not same:
        raise AssertionError("stream: the runner differs from the chain")
    del got

    def runner_fps():
        runner.reset_white_balance()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(iter(read), lambda s, i, img: None)
        return n / (time.perf_counter() - t0)

    def bare_fps():
        st = tp.init_state((), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(0, n, b):
            o, st = pipe(torch.as_tensor(read[s:s + b]).to("cuda"), st)
            _ = {k: v.cpu() for k, v in o.items()}
        return n / (time.perf_counter() - t0)

    turns = [(runner_fps(), bare_fps()) for _ in range(3)]
    fps = (statistics.median(t[0] for t in turns), statistics.median(t[1] for t in turns))
    print(f"stream frames/s: StreamRunner {fps[0]:.2f}, bare chain calls with synchronous "
          f"copies {fps[1]:.2f} (host clock over {n} frames, median of 3 turns)")
    return fps


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


TOOLS_FRAMES, TOOLS_BATCH, TOOLS_CPU_FRAMES, LIVE_FRAMES = 24, 8, 2, 6


def _captured(fn, *args):
    """(fn(*args), what it printed), the print echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    print(buf.getvalue(), end="")
    return result, buf.getvalue()


def _camera_infos_equal(tp, out_dir, params, calib, interpolation=None) -> bool:
    import yaml

    from raw_image_pipeline_tpu_torch.runtime.stream import make_camera_infos

    api = tp.RawImagePipeline(False, params, calib, "", device="cpu")
    if interpolation:
        api.set_undistortion_interpolation(interpolation)
    want = yaml.safe_load(yaml.safe_dump(
        {k: v.to_dict() for k, v in make_camera_infos(api).items()}))
    with open(os.path.join(out_dir, "camera_info.yaml")) as f:
        return yaml.safe_load(f) == want


def _write_ms(write, path, img, reps=5):
    """[median, least, most] ms of `reps` writes of img to path."""
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        write(path, img)
        runs.append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(runs), min(runs), max(runs)]


def check_run_pipeline(tp, torch, np, root, d):
    """run_pipeline's directory raw mode at the launch profile on the
    1.6 MP sensor, with the lerp remap and with the float remap (kernel E),
    on two contents: seeded synthetic frames and frames mosaicked from the
    Alphasense fixture (real content). Every written PNG is decoded and
    held against the plain-op chain on the card for every frame and the
    CPU chain for the first frames; camera_info.yaml against the CPU API's;
    kernel launches counted over the tool's run. Returns {"<content>
    <mode>": frames/s with the writes, "<content> <mode> null sink":
    frames/s of StreamRunner with a null sink, "<content> image_io write
    ms": one color frame written on one thread, [median, least, most] of
    5, and "<content> cv2 write ms" the same by cv2.imwrite where cv2
    imports (not used by the port)}."""
    import re
    from concurrent.futures import ThreadPoolExecutor

    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.pipeline import make_isp_fn, make_params
    from raw_image_pipeline_tpu_torch.runtime.stream import StreamRunner
    from raw_image_pipeline_tpu_torch.tools import run_pipeline, workloads
    from raw_image_pipeline_tpu_torch.utils import image_io

    h, w = workloads.LAUNCH_PROFILE_HW
    n, b = TOOLS_FRAMES, TOOLS_BATCH
    params, calib = (os.path.join(root, f) for f in workloads.LAUNCH_PROFILE)
    fixture = image_io.imread(os.path.join(root, "tests", "fixtures", "alphasense.png"),
                              image_io.IMREAD_COLOR)
    contents = {
        "synthetic": workloads.card_frames(torch, "bayer", n, h, w, workloads.SEED + 80),
        "fixture": workloads.fixture_frames(torch, fixture, n, h, w),
    }
    streams = (("color", "dist_color"), ("color_rect", "processed"), ("debayered", "debayered"))
    names = [f"frame_{i:03d}" for i in range(n)]
    cv2 = image_io.cv2_module()
    result = {}
    for content, frames in contents.items():
        host = frames.cpu().numpy()
        in_dir = os.path.join(d, f"raw_{content}")
        os.makedirs(in_dir)
        for name, f in zip(names, host):
            f.tofile(os.path.join(in_dir, name + ".raw"))
        for mode in ("lerp", "float"):
            label = f"tools run_pipeline {w}x{h} {content} {mode}"
            config = run_pipeline.pipeline_config(
                params, calib, tp.config.DEFAULT_COLOR_CALIBRATION_PATH,
                mode if mode == "float" else None)
            p = make_params(config, (h, w), "cuda")
            plain_fn = make_isp_fn(config, "bayer_gbrg8", False, True, plain=True)
            refs = []
            for s in range(0, n, b):
                ref, _ = plain_fn(p, frames[s:s + b], None)
                refs.append({k: v.cpu().numpy() for k, v in ref.items()})
            cpu_pipe = tp.build_pipeline(config, "bayer_gbrg8", (h, w),
                                         keep_intermediates=True, device="cpu")
            t0 = time.perf_counter()
            cpu_out, _ = cpu_pipe(torch.as_tensor(host[:TOOLS_CPU_FRAMES]), None)
            cpu_s = time.perf_counter() - t0
            out_dir = os.path.join(d, f"out_{content}_{mode}")
            argv = ["-i", in_dir, "-o", out_dir, "-p", params, "-c", calib,
                    "--raw-shape", f"{h}x{w}", "-e", "bayer_gbrg8", "-b", str(b)]
            if mode == "float":
                argv += ["--remap-interpolation", "float"]
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            count, text = _captured(run_pipeline.main, argv)
            torch.cuda.synchronize()
            counts = {k.name: k.launches for k in kernels.ALL}
            path_kernels = ("debayer_bilinear", "ccc_histogram", "ccc_response") + (
                ("remap_float",) if mode == "float" else ())
            print(f"{label}: {count} frames written, kernel launches {counts}")
            if count != n or any(counts[k] != n // b for k in path_kernels):
                raise AssertionError(f"{label}: frames or launches wrong")
            result[f"{content} {mode}"] = float(
                re.search(r"\(([0-9.]+) frames/s", text).group(1))
            bad_card = bad_cpu = pngs = 0
            t0 = time.perf_counter()
            with ThreadPoolExecutor(8) as pool:  # the decoders release the GIL
                for s in range(0, n, b):
                    keys = [(i, st, key) for i in range(s, s + b) for st, key in streams]
                    decoded = pool.map(lambda k: image_io.imread(
                        os.path.join(out_dir, k[1], names[k[0]] + ".png"),
                        image_io.IMREAD_UNCHANGED), keys)
                    for (i, _, key), got in zip(keys, decoded):
                        pngs += 1
                        bad_card += int((got != refs[s // b][key][i - s]).sum())
                        if i < TOOLS_CPU_FRAMES:
                            bad_cpu += int((got != cpu_out[key][i].numpy()).sum())
            decode_s = time.perf_counter() - t0
            infos = _camera_infos_equal(tp, out_dir, params, calib,
                                        mode if mode == "float" else None)
            print(f"{label}: {pngs} PNGs decoded in {decode_s:.1f} s: {bad_card} mismatching "
                  f"bytes vs the plain-op chain on the card, {bad_cpu} vs the CPU chain on the "
                  f"first {TOOLS_CPU_FRAMES} frames ({cpu_s:.1f} s); camera_info.yaml equal to "
                  f"the CPU API's: {infos}")
            if bad_card or bad_cpu or not infos or pngs != 3 * n:
                raise AssertionError(f"{label}: the tool's outputs differ")
            runner = StreamRunner(config, "bayer_gbrg8", (h, w), batch_size=b, device="cuda")
            runner.run(iter(host[:b]), lambda *a: None)  # warm

            def null_fps():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runner.run(iter(host), lambda *a: None)
                return n / (time.perf_counter() - t0)

            result[f"{content} {mode} null sink"] = statistics.median(
                null_fps() for _ in range(3))
            print(f"{label} frames/s: {result[f'{content} {mode}']:.2f} with the PNG writes, "
                  f"{result[f'{content} {mode} null sink']:.2f} for StreamRunner with a "
                  f"null sink (median of 3)")
        # the color frame before the remap: the same image in both modes
        img = refs[0]["dist_color"][0]
        one = os.path.join(d, f"one_{content}.png")
        writes = {"image_io": image_io.imwrite}
        if cv2 is not None:
            writes["cv2"] = cv2.imwrite
        for name, write in writes.items():
            result[f"{content} {name} write ms"] = _write_ms(write, one, img)
        print(f"tools one {w}x{h} {content} color frame written on one thread, ms (median "
              f"of 5, least-most): " + "; ".join(
                  "{} {:.1f} ({:.1f}-{:.1f})".format(name, *result[f"{content} {name} write ms"])
                  for name in writes))
    return result


def check_live(tp, torch, np, root, d):
    """run_pipeline --listen --control at the launch profile on the 1.6 MP
    sensor, driven by run_pipeline.drive_live: LIVE_FRAMES frames, frame
    k+1 sent only once output k exists, the commands reset_white_balance
    and reload_params between frames 2 and 3; each output against the CPU
    API's process of its frame, with the same commands."""
    from raw_image_pipeline_tpu_torch.tools import run_pipeline, workloads
    from raw_image_pipeline_tpu_torch.utils import image_io

    h, w = workloads.LAUNCH_PROFILE_HW
    params, calib = (os.path.join(root, f) for f in workloads.LAUNCH_PROFILE)
    frames = workloads.card_frames(torch, "bayer", LIVE_FRAMES, h, w,
                                   workloads.SEED + 81).cpu().numpy()
    out_dir = os.path.join(d, "live")
    t0 = time.perf_counter()
    n, replies = run_pipeline.drive_live(
        frames, out_dir, ["--raw-shape", f"{h}x{w}", "-e", "bayer_gbrg8", "-p", params,
                          "-c", calib], ("reset_white_balance", "reload_params"), 3, 120.0)
    seconds = time.perf_counter() - t0
    api = tp.RawImagePipeline(False, params, calib, "", device="cpu")
    bad = 0
    for k, f in enumerate(frames):
        if k == 3:
            api.reset_white_balance_temporal_consistency()
            api.load_params(params)
        got = image_io.imread(os.path.join(out_dir, f"{k:06d}.png"), image_io.IMREAD_UNCHANGED)
        bad += int((got != api.process(f, "bayer_gbrg8")).sum())
    print(f"tools run_pipeline --listen --control {w}x{h}: {n} frames in {seconds:.1f} s, "
          f"replies {replies}; {bad} mismatching bytes vs the CPU API")
    if n != LIVE_FRAMES or replies != ["ok", "ok params reloaded"] or bad:
        raise AssertionError("tools: live mode differs")


def check_small_tools(tp, torch, np, root, d):
    """apply_pipeline and ccc_tune (the argmax and the debug-offset mode) on
    tests/fixtures/alphasense.png, on the card and with --device cpu: equal
    output files and printed text."""
    from raw_image_pipeline_tpu_torch.tools import apply_pipeline, ccc_tune
    from raw_image_pipeline_tpu_torch.utils import image_io

    fixture = os.path.join(root, "tests", "fixtures", "alphasense.png")
    runs = {
        "apply_pipeline": (apply_pipeline.main, lambda o: ["-i", fixture, "-o", o],
                           ("output_process.png", "output_apply.png")),
        "ccc_tune": (ccc_tune.main, lambda o: ["-i", fixture, "-o",
                                               os.path.join(o, "ccc.png")], ("ccc.png",)),
        "ccc_tune offsets": (ccc_tune.main, lambda o: [
            "-i", fixture, "-o", os.path.join(o, "ccc.png"), "--lu-offset", "0.3",
            "--lv-offset", "-0.2"], ("ccc.png",)),
    }
    for name, (fn, argv, files) in runs.items():
        res = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(d, name.replace(" ", "_"), dev)
            os.makedirs(out, exist_ok=True)
            ret, text = _captured(fn, argv(out) + ["--device", dev])
            imgs = [image_io.imread(os.path.join(out, f), image_io.IMREAD_UNCHANGED)
                    for f in files]
            res[dev] = (ret, text.replace(out, "OUT"), imgs)
        bad = sum(int((a != b).sum()) for a, b in zip(res["cuda"][2], res["cpu"][2]))
        same_text = res["cuda"][1] == res["cpu"][1]
        same_ret = (res["cuda"][0] is None and res["cpu"][0] is None) or np.array_equal(
            np.asarray(res["cuda"][0]).view(np.uint32), np.asarray(res["cpu"][0]).view(np.uint32))
        print(f"tools {name} on the card vs --device cpu: {bad} mismatching bytes in "
              f"{len(files)} PNGs, printed text equal: {same_text}, gains' bits equal: {same_ret}")
        if bad or not same_text or not same_ret:
            raise AssertionError(f"tools {name}: the card differs from the CPU")


def check_tools(tp, torch, np, root):
    """Phase 4: the port's user programs on the card (run_pipeline,
    apply_pipeline, ccc_tune, gpu_parity_check, stream_bench,
    stage_timings), each step's seconds printed. Returns the numbers the
    JSON line keeps."""
    import tempfile

    from raw_image_pipeline_tpu_torch.tools import gpu_parity_check, stream_bench, workloads
    from raw_image_pipeline_tpu_torch.utils import stage_timings

    def step(name, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        print(f"tools step {name}: {time.perf_counter() - t:.1f} s", flush=True)
        return result

    out = {}
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as d:
        out["run_pipeline"] = step("run_pipeline", check_run_pipeline, tp, torch, np, root, d)
        step("live", check_live, tp, torch, np, root, d)
        step("apply_pipeline and ccc_tune", check_small_tools, tp, torch, np, root, d)
        t = time.perf_counter()
        step("gpu_parity_check", gpu_parity_check.main)
        out["gpu_parity_check_s"] = time.perf_counter() - t
        out["stream_bench_fps"] = step("stream_bench", stream_bench.main, [
            "--frames", "64", "--batch", "32", "--frames-dir", os.path.join(d, "stream")])
    px = workloads.card_frames(torch, "bayer", 4, 1080, 1920, workloads.SEED + 82).cpu().numpy()
    timings = step("stage_timings", stage_timings, tp.flagship_config(1080, 1920),
                   "bayer_gbrg8", px, None, 5, "cuda")
    out["stage_timings_ms"] = {k: v * 1e3 for k, v in timings.items()}
    print("tools stage_timings flagship 1920x1080 B=4, ms (least of 5 calls, cumulative "
          "differences): " + ", ".join(f"{k} {v:.3f}" for k, v in out["stage_timings_ms"].items()))
    return out


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

    def phase(name, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
        return result

    try:
        rows = phase("kernels", check_kernels, tp, torch, rng)
        launches, per_flagship_call, fps, peak = phase("chains", check_chains, tp, torch, rng)
        phase("microbatch", check_microbatch, tp, torch, rng)
        multicam_fps = phase("multicamera", check_multicam, tp, torch)
        stream_fps = phase("stream", check_stream, tp, torch, np, root)
        phase("small", check_small, tp, torch, np)
        phase("api", check_api, tp, torch, np)
        tools = phase("tools", check_tools, tp, torch, np, root)
    except Exception as e:  # the smoke test's boundary: report and fail
        import traceback

        traceback.print_exc()
        return _fail(repr(e))

    names = {"A": kernels.DEBAYER_BILINEAR, "B": kernels.CCC_HISTOGRAM,
             "C": kernels.CCC_RESPONSE, "D": kernels.DEBAYER_MHT, "E": kernels.REMAP_FLOAT}
    print(json.dumps({"chain_frames_per_s": [
        {"chain": name, "size": size, "kernels": a, "plain": b}
        for (name, size), (a, b) in fps.items()],
        "peak_device_bytes_1920x1080": peak,
        "multicam_frames_per_s": [
            {"chain": name, "size": "1920x1080", "cameras": len(workloads.MULTICAM_SCALES),
             "kernels": a, "four_single_cameras": b} for name, (a, b) in multicam_fps.items()],
        "stream_frames_per_s": {"chain": "flagship", "size": "1920x1080",
                                "runner": stream_fps[0], "bare_calls": stream_fps[1]},
        "tools": tools}))
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
