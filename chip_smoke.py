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
                       timed beside torch.fft.irfft2(rfft2(hist) * W) + bias
                       (library_ms; whether its argmax equals C's on both
                       is printed, not required);
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
       F lerp and fixed32 remap — in each mode 0 mismatching bytes on E's
                       cases with the mode's maps, on lerp-hostile maps
                       (coordinates on integers and halves, within 2^-20
                       of integers, near 0 and past each border) at
                       1439x1079 and 117x91, on 4 cameras x B=4 1920x1080
                       through four distinct maps in one launch, at B=64
                       and on 2 cameras x 10 frames past a batch limit
                       lowered to 7 (four launches), fixed32 through its
                       compact map (remap_fixed32_code) and through the
                       weights alone (the op layer's call), also on the
                       fixed32 chain's own params at B=4 and B=64; timed at
                       B=4 and B=64 beside the plain version and the bound
                       (fixed32's with its compact map's bytes, and through
                       the weights alone under *_wide_fixed32), and 4
                       cameras x B=4 (lerp under the row's main keys,
                       fixed32 under *_fixed32);
       G pointwise stretch — 0 mismatching bytes against
                       pointwise_planes(..., plain=True) with each step
                       alone (per-frame gains, calibration, the BT.709
                       table, vignetting with either linearize table, the
                       enhancer) and with the flagship's and gpu_parity's
                       sets at B=4 1080x1920, 1079x1439, 1080x1444, 17x31
                       and 3x5 and at B=64 1080x1920, on views of a
                       [B, 3, H, W] tensor, past a batch limit lowered to
                       3, and on all 2^24 BGR triples as one 4096x4096
                       frame; timed at B=4 and B=64 beside the plain
                       version and the bound (operations);
       N flip        — 0 mismatching bytes against torch.flip (its plain
                       version) at 90, 180 and 270: B=4 1080x1920 mosaics
                       whole and in slabs of rows, three planes of one set
                       of strides in one launch, a view 1 byte off, B=64
                       at 90 (the wb_* chains' call), odd sizes (1079x1439,
                       1081x1920, 17x31, 1x5, 5x1), u16, [..., 3] u8 and
                       f32 frames and f64 pairs, each call's launches
                       counted (check_flip); timed at B=4 (each angle) and
                       B=64 (90, 270, 180) beside the plain version, the bound
                       and torch.flip alone (library_ms);
       P 16-bit debayer — in u8 mode (each value >> 8, the chain's) and u16
                       mode (the op layer's), 0 mismatching values against
                       its plain version in the four phases at A's shapes
                       at B=4 and B=1 (each frame holding 0 and 65535), on
                       B=4 1080x1920 frames of 0 and 65535 only, frames[1:]
                       of a 1079x1439 batch and views 2 and 8 bytes past a
                       16-byte boundary, each line with its strip widths V
                       (check_debayer16); both modes timed at B=4 and B=64
                       1920x1080 beside the bound (tools/measure
                       .debayer16_work), the plain versions at B=4;
     then the ccc_range phase (check_ccc_range): the CCC range's own
     kernels against their plain versions, at the shapes the chain gives
     them:
       H working resize — 0 mismatching bytes on both paths (rows, the
                       chain's from 8 frames; gather, below) where the
                       rows path applies, else on the gather path: the
                       chain's three planes at 1920x1080 and 1440x1080,
                       B=4 and B=64, every slab of
                       a 2- and 4-way row split against the whole frame's
                       rows, an odd crop (1079x1439), upsamples (91x117,
                       269x361, 3x5), planes off a 16-byte boundary, past a
                       batch limit lowered to 7, the op layer's strided
                       [B, H, W, 3] input (also written interleaved), and
                       planes of two strides refused; timed at B=4 and B=64
                       on both paths beside the sector floor and the tap
                       bound;
       I argmax      — equal int32 peaks against torch.argmax and numpy at
                       every cluster size forced and at its own choice, on
                       real responses (fixture and noise frames), planted
                       ties, +0.0/-0.0, equal, -inf, +inf, NaN and
                       last-index frames, frames off a 16-byte boundary,
                       and traps across the slices' boundaries at B = 1,
                       4, 16, 64, 140 in all nine dtypes; the f64 responses
                       and the planted frames in f16, bf16 and the integer
                       dtypes through response_argmax; timed at B = 1, 4,
                       16, 64 beside torch.argmax (library_ms);
       J track       — equal gains and Kalman state bit for bit in
                       the "cameras", "sequence", camera-blocked and
                       gathered layouts and without the filter, fresh,
                       seeded and carried states, tracks of 511 to 70 000
                       frames (across J's stages, past 65 535), NaN, +inf,
                       -0.0 and -3.7 covariances, J straight behind kernel
                       I and behind a torch.cat, the given state untouched;
                       timed at B=4 ("sequence" and "cameras"), B=64 and
                       512 frames beside its latency floor;
     then one flagship call at 1920x1080, B=4, must launch H, B, C, I and J
     once each (8 grids) and its flip (N) once, and its profiled isp_white_balance range must
     hold those 8 kernels and no copy, set or synchronising API call (the
     call profiled up to 3 times until a trace shows the range; none
     fails the phase);
     then the wb_range phase (check_wb_range): the statistical white
     balances' kernels against their plain versions:
       K statistics, L learned's 64^3 histogram, M per-frame tables, and G's
                     table step — equal records, histograms, tables, PCA's
                     NaN flags and learned's features (bit for bit), 0
                     mismatching bytes out of G, for simple (p 20; 2 and 35
                     at the small shapes), grey_world (0.8; 1.2, the u16
                     wrap rule), pca and learned (0.8) at B=64 1920x1080
                     (the wb_* chains' call), B=4 1080x1920, 1079x1439,
                     17x31 and 3x5, on planes 1 byte off a 16-byte boundary,
                     interleaved planes, and edge frames (saturated, black,
                     a constant channel, planted equal brightest sums in
                     the body and the tail, noise) at 45x61 and 1079x1439;
                     M's learned mode (a thread-block cluster a frame) on
                     synthetic 64^3 histograms (workloads.learned_histograms:
                     ties at T across every block boundary, 299-301
                     occupied bins, one bin, all counts equal, a max count
                     of 2^21 - 1, an empty one) at the rule's cluster and
                     each size forced (M_CLUSTERS);
                     each timed at B=4 and B=64
                     beside its plain version and its bound, torch.bincount
                     of the same bins as K's (simple) and L's library time,
                     M's learned mode also at each cluster size forced;
                     each wb_* chain at B=64 launches K and M (and L) and
                     its flip (N) once a call, and its profiled isp_white_balance range holds at
                     most 3 kernels (4 for learned) and no bincount, topk or
                     sort, copy, set or synchronising API call;
       O LUT         — (check_lut, in the same phase) 0 mismatching bytes
                     against the plain gather with a seeded table: mono
                     planes at B=4 1080x1920, B=64 1920x1080, 1079x1439,
                     17x31 and 3x5, whole, in row slabs, cropped, every
                     other frame, 1 and 8 bytes off a 16-byte boundary,
                     [..., H, W, 3] frames, an interleaved channel, 1-d,
                     0-d and empty tensors, one launch of O a call and none
                     of G; timed at B=4 and B=64 (the mono chain's call)
                     beside its bound, the gather and one torch.gather
                     (library_ms, the int64 index cast apart);
     then the ops phase (check_ops): the reference package's entry points
     that reach a kernel, on [..., H, W(, 3)] CUDA frames at 1080x1920
     (leading dims (4,)) and at a random odd crop (leading dims (2, 3)):
     debayer bilinear (A) and MHT (D) in the four encodings, debayer of
     the four 16-bit encodings (P), resize_linear_u8 (H),
     log_chroma_histogram and _rt (B) on the 270x360 resize, ccc_response
     (C), response_argmax (I), estimate_illuminant (H, B, C, I),
     ccc_balance_white (and J, two calls with the state carried),
     remap_bilinear_u8 in float (E), lerp and fixed32 mode (F) with
     one map and with per-camera maps, color_correct, vignetting.correct
     and enhance (G), balance_white_simple, _grey_world, _pca and
     balance_white_learned_model (K, M, L, G), apply_lut (O) and flip at
     90, 180 and 270 (N); each
     against plain=True on the card and the planar
     path of the chain, 0 mismatching bytes, with its device time; then
     (check_ops_contract) the calls the JAX package takes that the kernels
     once refused: the histograms over kernel B's 524160 pixels (1080x1920,
     727x1001 and 733x821: runs of pixels as frames of their own, a tail),
     float remaps of 2 and 4 channels, lerp and fixed32 remaps of 4, and
     batch_minor=True (one map and four), A, D, E and F at B = 65537, and
     B, C, E and F past a batch limit lowered to 7, each against plain=True
     with the launches it must make;
     the phase's launches go to the kernels line as launches_ops;
  2. drives each chain through build_pipeline(config, encoding,
     with_state=True, temporal_mode="sequence", device="cuda"), the Kalman
     state carried across the calls, at 1920x1080:
       flagship   — flagship_config(h, w), also at 1440x1080 (N, A, H, B,
                    C, I, J, G, F);
       gpu_parity — MHT demosaic and the BT.709 gamma, the reference's
                    use_gpu=True semantics, also at 1440x1080 (N, D, H, B,
                    C, I, J, G, F);
       float      — the float remap (N, A, H, B, C, I, J, G, E);
       fixed32    — the fixed32 remap (N, A, H, B, C, I, J, G, F);
         (each 8 seeded frames in 2 calls)
       wb_simple, wb_grey_world, wb_pca, wb_learned — BASELINE config 2:
                    debayer, flip 90 and the statistical white balance,
                    128 frames made on the card in 2 calls of B=64 (N, A,
                    K, M, L for learned, G's table step);
       pointwise_bgr8 — BASELINE config 4: colour calibration, vignetting
                    and the HSV enhancer on 512 bgr8 frames in one call
                    with microbatch=128 (G), its peak device memory
                    printed;
       mono8      — the flagship configuration on mono8 frames, 8 in 2
                    calls: the flip 180 (N), the gamma table (O) and the
                    lerp remap of the one plane (F);
       bayer16    — the flagship configuration on bayer_gbrg16 frames
                    (bayer16 "scale8"), also at 1440x1080, 8 in 2 calls:
                    P in u8 mode, the planes' flip 180 (N), the CCC range
                    (H, B, C, I, J), G and F; its peak device memory
                    printed with the others;
     the launch counts are set to 0 just before each chain's 1920x1080 run
     and read just after, and each kernel of that chain must have launched
     in each of its calls;
     `processed` and the state must equal, byte for byte, the same chain
     with every op on its plain version on the card; the first 3 frames of
     each wb_* chain and the first 128-frame chunk of pointwise_bgr8 must
     also equal the chain on the CPU, byte for byte; frames/s is printed;
     then the flagship at B=70 with microbatch=32 must equal the unchunked
     chain, bytes and Kalman state; then the camera-blocked multicamera
     chains (BASELINE config 5 on one card) multicam4 (F) and
     multicam4_float (E), 4 cameras x B=4 in 2 calls in both temporal modes,
     each kernel of the chain launched once per call, equal to the plain-op
     multicamera chain and to four single-camera chains, and with four equal
     calibrations one flat map (F or E launched with cameras=1), frames/s
     beside the four
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
     at 1920x1080, B=4;
  5. runs the mesh (raw_image_pipeline_tpu_torch/parallel) over logical
     shards of cuda:0: the flagship at 1920x1080, 2 calls of B=4 with the
     state carried, over (data 2, space 2) and (1, 4) in both temporal
     modes, the float (E) and gpu_parity (D) chains over (1, 4), multicam4
     over data 2 and StreamRunner over (2, 1), each equal to the unsharded
     call byte for byte and in state, the launch counts set to 0 just
     before each sharded run and read just after (every kernel of the
     chain launched once per shard and call); frames/s sharded and
     unsharded on the one card (no scaling figure); each flagship slab's
     remap window; tools/pod_bench.py at 1920x1080, batch 4 a device, as
     one process and as two gloo ranks on the card, and two NCCL ranks on
     the card, which must refuse;
  6. runs the port's benchmark program (tools/bench.py, the root
     bench.py's counterpart) in a process of its own at its full sizes with
     fewer repeats: the flagship at B = 16, 64 and 128, configs 1-6, the
     four checks (A and D, B, C's argmax against f64, the colour
     calibration over 2^24 triples) at 0 mismatches, the CPU arm; every
     key of bench.py's headline in its last line, the kernels of each run
     launched in it; prints that line.

It prints the card's name and power limit, the build time, one line per
check, a JSON line of the mesh phase, a JSON line of the kernels (with
each one's launches on the main path and per flagship call) and, last,
{"ok": true, "device": ...}.
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
# kernel P: A's shapes (every strip width; a height or a width of 2), and
# the bayer16 chain's call at B=4 and B=64 where it is timed
DEBAYER16_SHAPES = DEBAYER_SHAPES["A"]
DEBAYER16_TIMED = ((4, 1080, 1920), (64, 1080, 1920))


def _fixture_planes(torch, n: int, h: int, w: int):
    """The chain's debayered views of n frames of the Alphasense fixture
    (workloads.fixture_frames, kernel A): natural content, whose
    neighbouring pixels share table entries and tap boxes."""
    from raw_image_pipeline_tpu_torch.ops import debayer
    from raw_image_pipeline_tpu_torch.tools import workloads
    from raw_image_pipeline_tpu_torch.utils import image_io

    bgr = image_io.imread(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                       "fixtures", "alphasense.png"))
    return debayer.debayer_planes(workloads.fixture_frames(torch, bgr, n, h, w), "bayer_grbg8")


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


def check_debayer16(torch, rng):
    """Phase 1: kernel P against its plain version in both modes (u8, each
    value >> 8, and u16), 0 mismatching values in all four phases, at each
    of DEBAYER16_SHAPES at B=4 and B=1 (every frame with 0 and 65535 in it),
    on B=4 1080x1920 frames of 0 and 65535 only, on frames[1:] of a B=4
    1079x1439 batch, and on B=2 1080x1920 views 2 and 8 bytes past a
    16-byte boundary; each line names the strip widths V of its launches.
    Then the device times of both modes at DEBAYER16_TIMED and the plain
    versions' at B=4, beside the bound. Returns the kernel's row (u8 mode,
    the chain's, under the main keys)."""
    from raw_image_pipeline_tpu_torch.ops import debayer
    from raw_image_pipeline_tpu_torch.tools.measure import bound, debayer16_work, device_ms

    modes = {"u8": torch.uint8, "u16": torch.uint16}

    def frames(*shape, values=None):
        x = (rng.integers(0, 65536, shape) if values is None else rng.choice(values, shape))
        x = x.astype("uint16")
        if x.ndim > 1:
            x[..., 0, 0], x[..., -1, -1] = 0, 65535
        return torch.as_tensor(x, device="cuda")

    def values(t):  # u16 compared through an int16 view: few ops take uint16 on the card
        return t.view(torch.int16) if t.dtype == torch.uint16 else t

    cases = [(f"B={b} {h}x{w}", frames(b, h, w)) for (h, w) in DEBAYER16_SHAPES for b in (4, 1)]
    cases.append(("B=4 1080x1920 of 0 and 65535 only", frames(4, 1080, 1920, values=[0, 65535])))
    cases.append(("frames[1:] of B=4 1079x1439", frames(4, 1079, 1439)[1:]))
    flat = frames(8 + 2 * 1080 * 1920)
    cases += [(f"B=2 1080x1920 at {2 * off} bytes past a 16-byte boundary",
               flat[off:off + 2 * 1080 * 1920].view(2, 1080, 1920)) for off in (1, 4)]
    for label, bayer in cases:
        for mode, dtype in modes.items():
            bad, widths = 0, set()
            for ph in PHASES:
                got = debayer.debayer_bilinear16_cuda(bayer, ph, out_dtype=dtype)
                want = debayer.debayer_bilinear16_plain(bayer, ph, out_dtype=dtype)
                if got.dtype != dtype or got.shape != want.shape:
                    raise AssertionError(f"kernel P {mode} {label}: {got.dtype} "
                                         f"{tuple(got.shape)}, expected {dtype}")
                bad += int((values(got) != values(want)).sum())
                widths.add(debayer.strip_width(bayer.shape[2], bayer.data_ptr(), got.data_ptr(),
                                               2, got.element_size()))
            print(f"kernel P {mode} {label} (V={sorted(widths)}): {bad} mismatching values in "
                  f"{len(PHASES)} phases")
            if bad:
                raise AssertionError(f"kernel P: {bad} mismatching values in {mode} mode at "
                                     f"{label}")
    del cases, flat
    phase = debayer.phase_for_encoding("bayer_gbrg16")  # the bayer16 chain's
    row = dict(max_abs_err=0.0, library_ms=None)
    for b, h, w in DEBAYER16_TIMED:
        bayer = frames(b, h, w)
        for mode, dtype in modes.items():
            ms = device_ms(lambda: debayer.debayer_bilinear16_cuda(bayer, phase, out_dtype=dtype))
            work = debayer16_work(bayer.numel(), dtype.itemsize)
            bd = bound(bytes_=work["bytes"], ops=work["ops"])
            line = (f"kernel P time {mode} B={b} {w}x{h}: {ms:.4f} ms (bound {bd['bound_ms']:.4f}, "
                    f"{bd['bound_by']}, {100 * bd['bound_ms'] / ms:.1f}%)")
            key = ("" if mode == "u8" else "_u16") + ("" if b == 4 else f"_b{b}")
            if b == 4:
                plain_ms = device_ms(lambda: debayer.debayer_bilinear16_plain(bayer, phase,
                                                                              out_dtype=dtype))
                row[f"plain_ms{key}"] = plain_ms
                line += f", plain {plain_ms:.4f} ms"
            row[f"ms{key}"] = ms
            row.update({f"bound_ms{key}": bd["bound_ms"], f"bound_by{key}": bd["bound_by"]})
            print(line)
        del bayer
    torch.cuda.empty_cache()
    return row


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
            params = tp.make_params(workloads.chains(tp)["float"].config(*out_hw), out_hw,
                                    device=dev)
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


REMAP_LERP_MODES = ("lerp", "fixed32")  # kernel F's modes; lerp is the main path's
REMAP_LERP_LIMIT = (2, 10, 7)  # cameras, frames a camera, lowered batch limit: 4 launches


def check_remap_lerp(tp, torch, rng, planes):
    """Phase 1: kernel F against its plain versions (remap_planes(...,
    plain=True)) in lerp and in fixed32 mode, 0 mismatching bytes, on E's
    cases (check_remap) with the mode's maps: the fisheye maps at 1080x1920
    and 1080x1440 (B=4 and B=1) and at 1079x1439 and 91x117, the 1080x1920
    map cropped to 1079x1439 and 91x117 over a 1080x1920 source, frames[1:]
    of a B=4 batch, hostile maps (workloads.hostile_maps) and lerp-hostile
    maps (workloads.lerp_hostile_maps: coordinates on integers and halves,
    within 2^-20 of integers, near 0 and past each border) at 1079x1439 and
    91x117, border maps (workloads.border_maps: taps past every border of
    the source, in tiles F stages; each case names its tiles by the host
    model workloads.remap_tile_census, which no kernel reports) at
    1080x1920 and 96x128, a source of height 1, planes 1 and 8 bytes and
    the weights 4 bytes past a 16-byte boundary, one mono plane; then 4
    cameras x B=4 1080x1920 through the four distinct fisheye maps of the
    multicam4 chain in one launch, B=64 1080x1920, and REMAP_LERP_LIMIT's 2
    cameras x 10 frames past a batch limit lowered to 7 (four launches).
    Fixed32 runs each case twice, through the compact map
    (undistortion.remap_fixed32_code of the case's weights) and without it
    (the op layer's call, every pixel's weights read), and also on the
    fixed32 chain's own params (remap_code) at B=4 and B=64. Each line names
    the store width V of its launch. Then the flagship
    map's tiles by that host model, on a line of their own, and the device
    times at B=4 1080x1920 on `planes` (kernel D's output) and on the
    fixture frames (_fixture_planes), at REMAP_B64, and the plain versions'
    at both, beside each bound (fixed32's with its compact map's bytes,
    measure.remap_lerp_work(explicit=), and the 20-byte map's beside it).
    Returns F's row: lerp, the main path's mode, under the main keys,
    fixed32 under *_fixed32."""
    import dataclasses

    import numpy as np

    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.ops import undistortion
    from raw_image_pipeline_tpu_torch.parallel import build_multicamera_pipeline
    from raw_image_pipeline_tpu_torch.tools import workloads
    from raw_image_pipeline_tpu_torch.tools.measure import bound, device_ms, remap_lerp_work

    dev = torch.device("cuda")
    row = dict(max_abs_err=0.0, library_ms=None)

    def frames(*shape):
        return [torch.as_tensor(rng.integers(0, 256, shape, dtype="uint8"), device=dev)
                for _ in range(3)]

    def with_mode(config, mode):
        return config.replace(undistortion=dataclasses.replace(config.undistortion,
                                                               interpolation=mode))

    g = torch.Generator(device="cuda")
    g.manual_seed(int(rng.integers(1 << 31)))
    big = [torch.randint(0, 256, REMAP_B64, generator=g, device="cuda", dtype=torch.uint8)
           for _ in range(3)]
    hw = (1080, 1920)
    for mode in REMAP_LERP_MODES:
        rows = undistortion.REMAP_WEIGHT_ROWS[mode]

        def maps(out_hw, src_hw, kind):
            if kind == "fisheye":
                config = with_mode(tp.flagship_config(*out_hw), mode)
                p = tp.make_params(config, out_hw, device=dev)
                return p.remap_base, p.remap_weights
            fn = {"hostile": workloads.hostile_maps, "lerp-hostile": workloads.lerp_hostile_maps,
                  "border": workloads.border_maps}[kind]
            mx, my = fn(out_hw, src_hw, out_hw[0] * out_hw[1])
            return tuple(torch.as_tensor(a, device=dev)
                         for a in undistortion.remap_precompute(mx, my, src_hw, mode=mode))

        fisheye = {s: maps(s, s, "fisheye") for s in ((1080, 1920), (1080, 1440))}
        base, weights = fisheye[hw]
        cases = [(f"fisheye B={b} {h}x{w}", frames(b, h, w), *fisheye[(h, w)], (h, w))
                 for (h, w) in fisheye for b in (4, 1)]
        cases.append(("fisheye frames[1:] of B=4 1080x1920",
                      [p[1:] for p in frames(4, *hw)], base, weights, hw))
        cases += [(f"fisheye B=4 {h}x{w}", frames(4, h, w), *maps((h, w), (h, w), "fisheye"),
                   (h, w)) for (h, w) in ((1079, 1439), (91, 117))]
        for (h, w), (r0, c0) in (((1079, 1439), (0, 0)), ((91, 117), (494, 901))):
            crop = (slice(r0, r0 + h), slice(c0, c0 + w))
            cases.append((f"fisheye B=4 1080x1920 source, its map cropped to {h}x{w} at "
                          f"({r0}, {c0})", frames(4, *hw),
                          base.view(hw)[crop].reshape(-1).contiguous(),
                          weights.view((rows,) + hw)[(slice(None), *crop)].reshape(rows, -1)
                          .contiguous(), (h, w)))
        cases += [(f"{kind} B=4 {h}x{w}", frames(4, h, w), *maps((h, w), (h, w), kind), (h, w))
                  for kind in ("hostile", "lerp-hostile") for (h, w) in ((1079, 1439), (91, 117))]
        # taps past every border of the source, in tiles that stay staged
        for h, w in (hw, (96, 128)):
            bb, bw = maps((h, w), (h, w), "border")
            census = workloads.remap_tile_census(bb.cpu(), bw.cpu(), (h, w), (h, w), mode)
            cases.append((f"border B=4 {h}x{w} (tiles by the host model: {census})",
                          frames(4, h, w), bb, bw, (h, w)))
        cases.append(("hostile B=4 1x128 source to 96x128", frames(4, 1, 128),
                      *maps((96, 128), (1, 128), "hostile"), (96, 128)))
        flat = torch.as_tensor(rng.integers(0, 256, 16 + 2 * hw[0] * hw[1], dtype="uint8"),
                               device=dev)
        cases += [(f"fisheye B=2 planes {off} bytes past a 16-byte boundary",
                   [flat[off:off + 2 * hw[0] * hw[1]].view((2,) + hw)] * 3, base, weights, hw)
                  for off in (1, 8)]
        shifted = torch.empty(4 + weights.numel(), dtype=torch.float32, device=dev)
        shifted[1:1 + weights.numel()] = weights.reshape(-1)
        cases.append(("fisheye B=4, the weights 4 bytes past a 16-byte boundary",
                      frames(4, *hw), base, shifted[1:1 + weights.numel()].view(rows, -1), hw))
        cases.append(("fisheye B=4 mono", frames(4, *hw)[:1], base, weights, hw))
        config = with_mode(workloads.multicam_chains(tp)["multicam4"].config(*hw), mode)
        cams = workloads.multicam_calibrations(config.calibration)
        mp = build_multicamera_pipeline(config, cams, "bayer_gbrg8", hw, device="cuda").params
        cameras4 = (f"{len(cams)} cameras x B=4 1080x1920, maps {tuple(mp.remap_base.shape)}",
                    frames(4 * len(cams), *hw), mp.remap_base, mp.remap_weights, hw)
        cases.append(cameras4)
        cases.append((f"fisheye B={REMAP_B64[0]} 1080x1920", big, base, weights, hw))
        if mode == "fixed32":  # the fixed32 chain's own params, with their code
            cp = tp.make_params(workloads.chains(tp)["fixed32"].config(*hw), hw, device=dev)
            cases += [(f"fixed32 chain's map B={len(pl[0])} 1080x1920", pl, cp.remap_base,
                       cp.remap_weights, hw) for pl in (frames(4, *hw), big)]
            del cp
        for label, pl, b_, w_, out_hw in cases:
            want = undistortion.remap_planes(pl, b_, w_, out_hw, mode, plain=True)
            codes = [None]
            if mode == "fixed32":  # the compact map first, then the op layer's call
                codes.insert(0, torch.as_tensor(undistortion.remap_fixed32_code(w_.cpu().numpy()),
                                                device=dev))
            for code in codes:
                got = undistortion.remap_lerp_cuda(pl, b_, w_, out_hw, mode=mode, code=code)
                bad = int((got != want).sum())
                v = undistortion.remap_run_width(out_hw[1], got.data_ptr(), b_.data_ptr(),
                                                 w_.data_ptr(),
                                                 0 if code is None else code.data_ptr())
                form = ("" if mode != "fixed32" else ", the weights (no code)" if code is None
                        else f", compact map ({int((code == undistortion.FIXED32_EXPLICIT).sum())}"
                             f" explicit pixels)")
                print(f"kernel F {mode} remap {label}{form} (V={v}): {bad} mismatching bytes")
                if bad:
                    raise AssertionError(f"kernel F {mode}: {bad} mismatching bytes at {label}"
                                         f"{form}")
            del want
        del cases, flat, shifted, got
        cam, per, limit = REMAP_LERP_LIMIT
        lm = [undistortion.remap_precompute(*workloads.lerp_hostile_maps((91, 117), (91, 117), s),
                                            (91, 117), mode=mode) for s in range(cam)]
        lb, lw = (torch.as_tensor(np.stack([m[i] for m in lm]), device=dev) for i in (0, 1))
        pl = frames(cam * per, 91, 117)
        lc = (torch.as_tensor(undistortion.remap_fixed32_code(lw.cpu().numpy()), device=dev)
              if mode == "fixed32" else None)
        before = kernels.REMAP_LERP.launches
        got = undistortion.remap_lerp_cuda(pl, lb, lw, (91, 117), mode=mode, batch_limit=limit,
                                           code=lc)
        made = kernels.REMAP_LERP.launches - before
        bad = int((got != undistortion.remap_planes(pl, lb, lw, (91, 117), mode,
                                                    plain=True)).sum())
        print(f"kernel F {mode} remap {cam} cameras x {per} 91x117, batch limit {limit}: {bad} "
              f"mismatching bytes, {made} launches")
        if bad or made != cam * -(-per // limit):
            raise AssertionError(f"kernel F {mode}: the lowered batch limit's run is wrong")

        code = (torch.as_tensor(undistortion.remap_fixed32_code(weights.cpu().numpy()),
                                device=dev) if mode == "fixed32" else None)

        def fn(pl_, b_=base, w_=weights, c_=code):
            return lambda: undistortion.remap_lerp_cuda(pl_, b_, w_, hw, mode=mode, code=c_)

        def plain(pl_):
            return lambda: undistortion.remap_planes(pl_, base, weights, hw, mode, plain=True)

        census = workloads.remap_tile_census(base.cpu(), weights.cpu(), hw, hw, mode)
        print(f"kernel F {mode} flagship map's tiles at 1080x1920 by the host model "
              f"(workloads.remap_tile_census, not counted on the card): {census}")
        fixture = [p.contiguous() for p in _fixture_planes(torch, 4, *hw)]
        live = int((weights[undistortion.REMAP_WEIGHT_ROWS[mode] - 4:] != 0).any(0).sum())
        _, _, cb, cw, _ = cameras4
        cc = (torch.as_tensor(undistortion.remap_fixed32_code(cw.cpu().numpy()), device=dev)
              if mode == "fixed32" else None)

        def explicit(c):  # the compact map's explicit pixels (fixed32), else None
            return None if c is None else int((c == undistortion.FIXED32_EXPLICIT).sum())

        work = remap_lerp_work(planes[0].shape[0], *hw, base.numel(), 3, mode, live,
                               explicit=explicit(code))
        work64 = remap_lerp_work(REMAP_B64[0], *hw, base.numel(), 3, mode, live,
                                 explicit=explicit(code))
        cam_live = int((cw[:, undistortion.REMAP_WEIGHT_ROWS[mode] - 4:] != 0).any(1).sum())
        work_cams = remap_lerp_work(4 * len(cams), *hw, base.numel(), 3, mode, cam_live,
                                    maps=len(cams), explicit=explicit(cc))
        cam_planes = cameras4[1]
        times = dict(ms=device_ms(fn(planes)), ms_fixture=device_ms(fn(fixture)),
                     plain_ms=device_ms(plain(planes), n=5),
                     **bound(bytes_=work["bytes"], ops=work["ops"]),
                     ms_b64=device_ms(fn(big)), plain_ms_b64=device_ms(plain(big), n=3),
                     bound_ms_b64=bound(bytes_=work64["bytes"], ops=work64["ops"])["bound_ms"],
                     ms_cameras4=device_ms(fn(cam_planes, cb, cw, cc)),
                     bound_ms_cameras4=bound(bytes_=work_cams["bytes"],
                                             ops=work_cams["ops"])["bound_ms"])
        if mode == "fixed32":  # the op layer's call (no code), and the 20-byte map's bound
            wide = {b: remap_lerp_work(b, *hw, base.numel(), 3, mode, live)
                    for b in (planes[0].shape[0], REMAP_B64[0])}
            times.update(ms_wide=device_ms(fn(planes, c_=None)),
                         ms_b64_wide=device_ms(fn(big, c_=None)),
                         bound_ms_wide=bound(wide[planes[0].shape[0]]["bytes"],
                                             wide[planes[0].shape[0]]["ops"])["bound_ms"],
                         bound_ms_b64_wide=bound(wide[REMAP_B64[0]]["bytes"],
                                                 wide[REMAP_B64[0]]["ops"])["bound_ms"],
                         explicit=explicit(code))
            print(f"kernel F fixed32 time through the weights (no code, the op layer's call): "
                  f"B=4 {times['ms_wide']:.4f} ms, B={REMAP_B64[0]} {times['ms_b64_wide']:.4f} "
                  f"ms; compact map B=4 {times['ms']:.4f} ms "
                  f"({100 * times['bound_ms'] / times['ms']:.1f}% of its bound "
                  f"{times['bound_ms']:.4f}), B={REMAP_B64[0]} {times['ms_b64']:.4f} ms "
                  f"({100 * times['bound_ms_b64'] / times['ms_b64']:.1f}% of "
                  f"{times['bound_ms_b64']:.4f}); the 20-byte map's bound "
                  f"{times['bound_ms_wide']:.4f} / {times['bound_ms_b64_wide']:.4f} ms")
        del cameras4, cam_planes, mp, fixture
        print(f"kernel F {mode} time B=4 1080x1920: {times['ms']:.4f} ms (bound "
              f"{times['bound_ms']:.4f}, {times['bound_by']}; fixture frames "
              f"{times['ms_fixture']:.4f} ms), plain {times['plain_ms']:.4f} ms; "
              f"B={REMAP_B64[0]}: {times['ms_b64']:.4f} ms (bound {times['bound_ms_b64']:.4f}), "
              f"plain {times['plain_ms_b64']:.4f} ms; {len(cams)} cameras x B=4 in one launch: "
              f"{times['ms_cameras4']:.4f} ms (bound {times['bound_ms_cameras4']:.4f})")
        if mode != "lerp":  # bytes bound both modes; the row's bound_by is lerp's
            times = {k + "_" + mode: v for k, v in times.items() if k != "bound_by"}
        row.update(times)
        torch.cuda.empty_cache()
    del big
    torch.cuda.empty_cache()
    return row


# (frames, H, W) at which kernel G is held against its plain version:
# 1080p, W % 32 != 0 with odd H, W % 32 != 0 with even H, W < 32, tiny
POINTWISE_SHAPES = ((4, 1080, 1920), (4, 1079, 1439), (4, 1080, 1444), (4, 17, 31), (4, 3, 5))
POINTWISE_B64 = (64, 1080, 1920)
POINTWISE_LIMIT = (10, 3)  # frames, lowered batch limit: 4 launches
# kernel G's step sets: name -> steps (the flagship's call first)
POINTWISE_SETS = {
    "flagship (gains, calibration, gamma∘Lab vignetting, enhancer)":
        ("gains", "calibration", "gamma_vignetting", "enhancer"),
    "gpu_parity (gains, calibration, BT.709 LUT, vignetting, enhancer)":
        ("gains", "calibration", "lut", "vignetting", "enhancer"),
    **{s: (s,) for s in ("gains", "calibration", "lut", "vignetting", "gamma_vignetting",
                         "enhancer")},
}


def check_pointwise(tp, torch, rng):
    """Phase 1: kernel G (ops/pointwise.pointwise_cuda) against
    pointwise_planes(..., plain=True), 0 mismatching bytes, with each step
    alone and with the flagship's and gpu_parity's step sets
    (POINTWISE_SETS: per-frame gains, a seeded calibration, the BT.709
    table, vignetting with OpenCV's linearize table and with the k=0.9
    gamma composed into it, the flagship's enhancer gains) at
    POINTWISE_SHAPES and POINTWISE_B64; the flagship's set on the chain's
    debayered planes (views of a [B, 3, H, W] tensor), in the word layouts
    in and out (interleaved [B, H, W, 3] in and out, and either with
    planes) at 1080x1920 and 1079x1436, on planes and interleaved frames 1
    and 2 bytes past a 16-byte boundary (the byte path), and past a batch
    limit lowered to 3 (POINTWISE_LIMIT: four launches); then all 2^24 BGR
    triples as one 4096x4096 frame with its vignetting mask through both
    sets, with unit gains and an identity calibration (so every triple
    reaches every step) and with the seeded ones. Then G's device time at
    B=4 and B=64 1080x1920 with the flagship's set (the main path's call),
    at B=4 also on the fixture frames (_fixture_planes), the plain
    version's, and the bound (tools/measure.pointwise_work). Returns G's
    row."""
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.ops import pointwise
    from raw_image_pipeline_tpu_torch.ops.color_enhancer import gain_tables
    from raw_image_pipeline_tpu_torch.ops.colorspace import _GAMMA_TAB
    from raw_image_pipeline_tpu_torch.ops.gamma import build_bt709_lut
    from raw_image_pipeline_tpu_torch.ops.vignetting import (
        build_vignetting_mask,
        composed_gamma_lab_table,
    )
    from raw_image_pipeline_tpu_torch.tools.measure import bound, device_ms, pointwise_work

    dev = torch.device("cuda")

    def t(a, dtype=None):
        return torch.as_tensor(a, device=dev, dtype=dtype)

    matrix = t(rng.uniform(-0.6, 1.6, (3, 3)).astype("float32"))
    bias = t(rng.uniform(-20, 20, 3).astype("float32"))
    tables = dict(lut=t(build_bt709_lut(True)), enhancer_tables=t(gain_tables((1.0, 1.2, 1.0))),
                  composed=t(composed_gamma_lab_table(0.9)), opencv=t(_GAMMA_TAB, torch.int32))

    def args(steps, b, h, w, unit=False):
        out = {}
        for step in steps:
            if step == "gains":
                out["gains"] = (torch.ones((b, 3), device=dev) if unit else
                                t(rng.uniform(0.4, 2.6, (b, 3)).astype("float32")))
            elif step == "calibration":
                out.update(matrix=torch.eye(3, device=dev) if unit else matrix,
                           bias=torch.zeros(3, device=dev) if unit else bias)
            elif step == "lut":
                out["lut"] = tables["lut"]
            elif step in ("vignetting", "gamma_vignetting"):
                out.update(mask=t(build_vignetting_mask(h, w, 1.5, 1e-3, 1e-6)),
                           lab_tab=tables["composed" if step == "gamma_vignetting" else "opencv"])
            elif step == "enhancer":
                out["enhancer_tables"] = tables["enhancer_tables"]
        return out

    def held(label, planes, kw, **extra):
        got = pointwise.pointwise_cuda(planes, **kw, **extra)
        want = pointwise.pointwise_planes(*planes, **kw, plain=True)
        bad = sum(int((a != b).sum()) for a, b in zip(got, want))
        print(f"kernel G {label}: {bad} mismatching bytes")
        if bad:
            raise AssertionError(f"kernel G: {bad} mismatching bytes at {label}")

    def frames(b, h, w):
        return [t(rng.integers(0, 256, (b, h, w), dtype="uint8")) for _ in range(3)]

    flagship = next(iter(POINTWISE_SETS.values()))
    for b, h, w in POINTWISE_SHAPES + (POINTWISE_B64,):
        planes = frames(b, h, w)
        sets = POINTWISE_SETS if (b, h, w) != POINTWISE_B64 else dict(
            list(POINTWISE_SETS.items())[:2])
        for name, steps in sets.items():
            held(f"B={b} {h}x{w} {name}", planes, args(steps, b, h, w))
        del planes
    b, h, w = POINTWISE_SHAPES[0]
    x = t(rng.integers(0, 256, (b, 3, h, w), dtype="uint8"))
    held(f"B={b} {h}x{w} on views of a [B, 3, H, W] tensor, flagship", [x[:, c] for c in range(3)],
         args(flagship, b, h, w))
    # the word layouts in and out (interleaved [B, H, W, 3], config 4's),
    # and planes off a 4-byte boundary, which take the byte path
    for hh, ww in ((h, w), (1079, 1436)):
        nhwc = t(rng.integers(0, 256, (b, hh, ww, 3), dtype="uint8"))
        dst = torch.empty_like(nhwc)
        kw = args(flagship, b, hh, ww)
        for label, src, out in (("[B, H, W, 3] in and out", nhwc.unbind(-1), dst.unbind(-1)),
                                ("[B, H, W, 3] in, planes out", nhwc.unbind(-1), None),
                                ("planes in, [B, H, W, 3] out", frames(b, hh, ww), dst.unbind(-1))):
            held(f"B={b} {hh}x{ww} {label}, flagship", src, kw, out=out)
        n = b * hh * ww
        flat = torch.empty(16 + 3 * n, dtype=torch.uint8, device=dev)
        for off in (1, 2):
            src = [flat[off + c * n:off + (c + 1) * n].view(b, hh, ww) for c in range(3)]
            for p in src:
                p.copy_(t(rng.integers(0, 256, (b, hh, ww), dtype="uint8")))
            held(f"B={b} {hh}x{ww} planes {off} bytes past a 16-byte boundary, flagship", src, kw)
            inter = flat[off:off + 3 * n].view(b, hh, ww, 3).unbind(-1)
            held(f"B={b} {hh}x{ww} [B, H, W, 3] {off} bytes past a 16-byte boundary in and out, "
                 f"flagship", inter, kw, out=dst.unbind(-1))
        del nhwc, dst, flat, src, inter
    n, limit = POINTWISE_LIMIT
    planes = frames(n, 17, 31)
    before = kernels.POINTWISE.launches
    held(f"B={n} 17x31, batch limit {limit}, flagship", planes, args(flagship, n, 17, 31),
         batch_limit=limit)
    made = kernels.POINTWISE.launches - before
    print(f"kernel G B={n}, batch limit {limit}: {made} launches")
    if made != -(-n // limit):
        raise AssertionError(f"kernel G: {made} launches past the batch limit")
    i = torch.arange(1 << 24, device=dev, dtype=torch.int32)
    triples = [((i >> s) & 255).to(torch.uint8).view(1, 4096, 4096) for s in (0, 8, 16)]
    for name, steps in list(POINTWISE_SETS.items())[:2]:
        for unit in (True, False):
            held(f"all 2^24 triples as one 4096x4096 frame, {name}, "
                 f"{'unit gains and calibration' if unit else 'seeded gains and calibration'}",
                 triples, args(steps, 1, 4096, 4096, unit))
    del triples, i, x
    torch.cuda.empty_cache()

    def timed(b, h, w, n):
        planes = frames(b, h, w)
        kw = args(flagship, b, h, w)
        ms = device_ms(lambda: pointwise.pointwise_cuda(planes, **kw))
        plain_ms = device_ms(lambda: pointwise.pointwise_planes(*planes, **kw, plain=True), n=n)
        work = pointwise_work(b, h, w, ("gains", "calibration", "vignetting", "enhancer"))
        return ms, plain_ms, bound(bytes_=work["bytes"], ops=work["ops"])

    ms, plain_ms, bd = timed(*POINTWISE_SHAPES[0], 5)
    ms64, plain64, bd64 = timed(*POINTWISE_B64, 2)
    fixture = _fixture_planes(torch, *POINTWISE_SHAPES[0])
    kw = args(flagship, *POINTWISE_SHAPES[0])
    ms_fixture = device_ms(lambda: pointwise.pointwise_cuda(fixture, **kw))
    del fixture
    torch.cuda.empty_cache()
    row = dict(max_abs_err=0.0, ms=ms, ms_fixture=ms_fixture, plain_ms=plain_ms, library_ms=None,
               **bd, share=bd["bound_ms"] / ms, ms_b64=ms64, plain_ms_b64=plain64,
               bound_ms_b64=bd64["bound_ms"], share_b64=bd64["bound_ms"] / ms64)
    print(f"kernel G time B=4 1080x1920, the flagship's steps: {ms:.4f} ms (bound "
          f"{bd['bound_ms']:.4f}, {bd['bound_by']}; {100 * row['share']:.1f}%; fixture frames "
          f"{ms_fixture:.4f} ms), plain {plain_ms:.4f} ms; B=64: {ms64:.4f} ms (bound "
          f"{bd64['bound_ms']:.4f}; {100 * row['share_b64']:.1f}%), plain {plain64:.4f} ms; no "
          f"PyTorch call computes it")
    return row


# kernel H's batches, at 1920x1080 and 1440x1080: the chains' B=4 and B=64,
# and 8-16 around where the rows path overtakes the gather path
# (ops/resize.ROWS_MIN_BATCH)
CCC_RESIZE_BATCHES = (4, 8, 9, 10, 12, 14, 16, 64)
CCC_RESIZE_SHAPES = tuple((b, 1080, w) for w in (1920, 1440) for b in CCC_RESIZE_BATCHES)
# an odd crop, upsamples (height and width below 270x360) and a 3x5 frame
CCC_RESIZE_ODD = ((4, 1079, 1439), (4, 91, 117), (4, 269, 361), (3, 3, 5))
CCC_RESIZE_LIMIT = (20, 7)  # frames, lowered batch limit: 3 launches
ARGMAX_CLUSTERS = (1, 2, 4, 8, 16)  # kernel I's cluster sizes, each forced in ccc_range
ARGMAX_BATCHES = (1, 4, 16, 64, 140)  # kernel I's batches with the traps across its slices
# the earlier designs' device ms (H a thread an output pixel, I a block a
# frame) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel table),
# printed beside this run's: H three planes to 270x360 by (batch, width),
# I by batch
CCC_EARLIER_MS = {("H", 4, 1920): 0.0055, ("H", 64, 1920): 0.0852, ("I", 4): 0.0079,
                  ("I", 64): 0.0082, ("J", 4): 0.0033, ("J", 64): 0.0181}
CCC_TRACK_LONG = 512  # a "sequence" track this long: every rounding of the filter, many times
CCC_TRACK_STAGES = 5000  # a track across several of kernel J's stages (ops/ccc.TRACK_CHUNK)
CCC_TRACK_PAST = 70000  # a track past 65 535 frames (kernels.MAX_BATCH)


def _bits(torch, t):
    """A tensor's bits, for a bitwise comparison of f32 values (-0.0 and
    NaN included)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def check_ccc_range(tp, torch, rng, root, smi_line):
    """Phase ccc_range: the CCC range's own kernels against their plain
    versions on the card, then the flagship's isp_white_balance range.

      H working resize — 0 mismatching bytes against resize_planes(...,
                  plain=True) on its default path, then on each other path
                  that applies (rows where the strides and the shared
                  memory allow, gather): the chain's three planes (views of
                  a [B, 3, H, W] tensor, which must take the gather path
                  below ROWS_MIN_BATCH frames and the rows path from there)
                  at CCC_RESIZE_SHAPES (1920x1080 and 1440x1080 at
                  CCC_RESIZE_BATCHES),
                  every slab (y0, y1, row0) of a 2- and a 4-way row split of
                  the 1080-row frame equal to those rows of the whole frame,
                  CCC_RESIZE_ODD (an odd crop and upsamples), planes 1 and 8
                  bytes off a 16-byte boundary, a batch limit lowered to 7
                  (CCC_RESIZE_LIMIT), the op layer's strided planes of a [B,
                  H, W, 3] frame and its resize_linear_u8 (interleaved out,
                  one launch), and three planes of two strides refused
                  (ValueError, no launch); timed at CCC_RESIZE_SHAPES on
                  both paths (where the rows path starts to win) beside
                  the sector floor (the tapped rows read whole,
                  what the rows path is judged against) and the tap bound;
      I argmax   — equal int32 peaks against torch.argmax
                  (response_argmax_plain) and numpy's argmax on the host, at
                  every cluster size forced (ARGMAX_CLUSTERS) and at the
                  kernel's own choice: the responses of the fixture frames
                  and of noise (B=4, B=64, B=140), planted ties, +0.0/-0.0
                  ties, frames of equal values, -inf and +inf frames, NaNs
                  (the first wins), a peak at the last index, a batch 4
                  bytes off a 16-byte boundary (the scalar loads), and the
                  traps across the slices' boundaries
                  (workloads.argmax_across_slices) at ARGMAX_BATCHES in all
                  nine dtypes; response_argmax (one launch each) on the
                  fixture's responses in f64 and the planted frames in f16,
                  bf16, u8, i8, i16, i32 and i64; timed at B = 1, 4, 8,
                  16, 32, 64 at its own cluster and at each forced one
                  (ops/ccc.argmax_cluster's rule), beside
                  torch.argmax;
      J track    — equal gains and Kalman state bit for bit
                  against track_plain in the four layouts ("cameras",
                  "sequence", camera-blocked, the mesh's gathered peaks)
                  and without the filter, from fresh and from seeded
                  states, two calls with the state carried, 512-frame,
                  CCC_TRACK_STAGES-frame (several of J's stages) and
                  CCC_TRACK_PAST-frame tracks, carried states with a p of
                  NaN, +inf or -0.0, a p of -3.701562 (55 dividing steps,
                  past the gains J makes before it walks), and J launched
                  straight behind the torch op that makes
                  its peaks (the mesh's gathered peaks, a torch.cat) and
                  behind kernel I; the given state left as it was; timed
                  at the flagship's B=4 "cameras" and "sequence" calls,
                  config 3's B=64 and a 512-frame track (device ms and ms
                  a call) beside its latency floor
                  (measure.ccc_track_floor: an empty block launched and
                  timed as J is, here, and the chain's dependent steps).

    Then the flagship at 1920x1080, B=4, "sequence" mode: one call with the
    counts set to 0 must launch H, B, C, I and J once each (8 grids), and
    its profiled call's isp_white_balance range must hold those 8 kernels
    and no copy, set or synchronising API call: the call is profiled up to
    3 times until a trace shows the range with the device's work, and the
    phase fails if none does. Each time is printed beside the earlier
    design's (CCC_EARLIER_MS). Returns {"H", "I", "J": the kernels line's row}."""
    import json

    import numpy as np

    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model
    from raw_image_pipeline_tpu_torch.ops import ccc
    from raw_image_pipeline_tpu_torch.ops.resize import (
        ROWS_MIN_BATCH,
        _resize_bands_on,
        _tables_x,
        _tables_y,
        resize_linear_u8,
        resize_path,
        resize_planes,
        resize_rows_cuda,
    )
    from raw_image_pipeline_tpu_torch.parallel.mesh import split_rows
    from raw_image_pipeline_tpu_torch.parallel.spatial import resize_slab
    from raw_image_pipeline_tpu_torch.tools import workloads
    from raw_image_pipeline_tpu_torch.tools.measure import (
        bound,
        ccc_argmax_work,
        call_ms,
        ccc_resize_work,
        ccc_track_floor,
        ccc_track_work,
        device_ms,
        kalman_chain,
    )
    from raw_image_pipeline_tpu_torch.tools.profile_chains import device_time

    dev = torch.device("cuda")
    sh, sw = ccc.SMALL_H, ccc.SMALL_W

    def u8(shape):
        return torch.as_tensor(rng.integers(0, 256, shape, dtype="uint8"), device=dev)

    # --- H ---
    def held_h(label, planes, src_h, y0=0, y1=sh, row0=0, launches=1, **kw):
        """Kernel H on its default path (resize_path's choice for the
        batch), then on each other path that applies ("rows" where the
        strides and the shared memory allow it, "gather"): 0 mismatching
        bytes against the plain version and `launches` launches each."""
        h, w = planes[0].shape[-2:]
        flat = planes[0].reshape(-1, h, w)
        slots = _resize_bands_on(src_h, w, sh, sw, str(planes[0].device), y0, y1, row0)[1]
        default = resize_path(flat.stride(-1), 1, w, min(3, len(planes)), slots, flat.shape[0])
        rows_ok = resize_path(flat.stride(-1), 1, w, min(3, len(planes)), slots) == "rows"
        want = resize_planes(planes, src_h, sh, sw, y0, y1, row0, plain=True)
        got = None
        for path in dict.fromkeys((default, "rows" if rows_ok else default, "gather")):
            before = kernels.CCC_RESIZE.launches
            out = resize_rows_cuda(planes, src_h, sh, sw, y0, y1, row0,
                                   path=None if path == default else path, **kw)
            made = kernels.CCC_RESIZE.launches - before
            bad = sum(int((a != b).sum()) for a, b in zip(out, want))
            print(f"kernel H {label}, {path} path{' (default)' if path == default else ''}: "
                  f"{bad} mismatching bytes, {made} launches")
            if bad or made != launches:
                raise AssertionError(f"kernel H: {bad} mismatching bytes, {made} launches "
                                     f"(expected {launches}) at {label}, {path} path")
            got = out if got is None else got
        return got, default

    def read(src_h, src_w):  # the distinct source rows and columns the taps read
        sx, sx2, _, _ = _tables_x(src_w, sw)
        sy, sy2, _, _ = _tables_y(src_h, sh)
        return len(set(sy) | set(sy2)), len(set(sx) | set(sx2))

    timed = {}
    plain_timed = ((4, 1920), (64, 1920))
    for b, h, w in CCC_RESIZE_SHAPES:
        x = u8((b, 3, h, w))
        planes = [x[:, c] for c in (2, 1, 0)]  # the chain's R<->B swapped views
        whole, path = held_h(f"B={b} {h}x{w} -> {sh}x{sw}, views of a [B, 3, H, W] tensor",
                             planes, h)
        expected = "rows" if b >= ROWS_MIN_BATCH else "gather"
        if path != expected:
            raise AssertionError(f"kernel H: the chain's planes at B={b} {h}x{w} took the "
                                 f"{path} path, not the {expected} path")
        if b == 4 and w == 1920:
            for space in (2, 4):
                for r0, r1 in split_rows(h, space):
                    y0, y1, a, e = resize_slab(h, sh, r0, r1)
                    got, _ = held_h(f"B={b} {h}x{w} slab {space}-way rows [{r0}, {r1}): output "
                                    f"rows [{y0}, {y1}) from source rows [{a}, {e})",
                                    [p[:, a:e] for p in planes], h, y0, y1, a)
                    bad = sum(int((g != wh[:, y0:y1]).sum()) for g, wh in zip(got, whole))
                    if bad:
                        raise AssertionError(f"kernel H: slab [{r0}, {r1}) differs from the "
                                             f"whole frame's rows by {bad} bytes")
        rows_read, cols_read = read(h, w)
        work = ccc_resize_work(b, 3, rows_read, cols_read, sh, sw, w)
        timed[b, w] = (device_ms(lambda: resize_rows_cuda(planes, h, sh, sw, 0, sh, 0,
                                                          path="rows")),
                       device_ms(lambda: resize_rows_cuda(planes, h, sh, sw, 0, sh, 0,
                                                          path="gather")),
                       device_ms(lambda: resize_planes(planes, h, sh, sw, plain=True),
                                 n=20 if b == 4 else 3) if (b, w) in plain_timed else None,
                       bound(bytes_=work["bytes"], ops=work["ops"]),
                       bound(bytes_=work["sector_bytes"], ops=work["ops"]))
        del x, planes, whole
    for b, h, w in CCC_RESIZE_ODD:
        x = u8((b, 3, h, w))
        held_h(f"B={b} {h}x{w} -> {sh}x{sw}", [x[:, c] for c in range(3)], h)
    for off in (1, 8):  # planes whose every row starts off a 16-byte boundary
        buf = u8((4 * 3 * 1080 * 1920 + off,))
        x = buf[off:].view(4, 3, 1080, 1920)
        held_h(f"B=4 1080x1920 planes {off} bytes off a 16-byte boundary",
               [x[:, c] for c in range(3)], 1080)
    x = u8((4, 3, 1080, 1920))
    before = kernels.CCC_RESIZE.launches
    try:
        resize_rows_cuda([x[:, 0], x[:, 1].contiguous(), x[:, 2]], 1080, sh, sw, 0, sh, 0)
    except ValueError as e:
        print(f"kernel H B=4 1080x1920, planes of two strides: refused ({e})"[:200])
    else:
        raise AssertionError("kernel H: planes of two strides were not refused")
    if kernels.CCC_RESIZE.launches != before:
        raise AssertionError("kernel H: launched on planes of two strides")
    n, limit = CCC_RESIZE_LIMIT
    x = u8((n, 3, 91, 117))
    held_h(f"B={n} 91x117, batch limit {limit}", [x[:, c] for c in range(3)], 91,
           launches=-(-n // limit), batch_limit=limit)
    img = u8((4, 1080, 1920, 3))
    held_h("B=4 1080x1920, the op layer's strided planes of a [B, H, W, 3] frame",
           img.unbind(-1), 1080)
    before = kernels.CCC_RESIZE.launches
    got = resize_linear_u8(img, sh, sw)
    made = kernels.CCC_RESIZE.launches - before
    bad = int((got != resize_linear_u8(img, sh, sw, plain=True)).sum())
    print(f"kernel H resize_linear_u8 [4, 1080, 1920, 3] -> [4, {sh}, {sw}, 3] (strided planes "
          f"in, interleaved out: the gather path): {bad} mismatching bytes, {made} launches")
    if bad or made != 1 or not got.is_contiguous():
        raise AssertionError("kernel H: the op layer's strided resize")
    del x, img, got, buf
    torch.cuda.empty_cache()
    rows = {}
    for (b, w), (ms, gather_ms, plain_ms, bd, sec) in sorted(timed.items()):
        chosen = "rows" if b >= ROWS_MIN_BATCH else "gather"
        print(f"kernel H time B={b} 1080x{w} -> {sh}x{sw}, three planes: rows path {ms:.4f} "
              f"ms, gather path {gather_ms:.4f} ms, the {chosen} path taken (the earlier "
              f"design: "
              f"{CCC_EARLIER_MS.get(('H', b, w), 'not timed')}); sector floor "
              f"{sec['bound_ms']:.5f} ms ({100 * sec['bound_ms'] / ms:.1f}%, what the rows path "
              f"is judged against), tap bound {bd['bound_ms']:.5f} ms ({bd['bound_by']}; "
              f"{100 * bd['bound_ms'] / ms:.1f}%)"
              + (f", plain {plain_ms:.4f} ms" if plain_ms is not None else "")
              + f"; no PyTorch call computes it [{smi_line}]")
    (ms, gms, plain_ms, bd, sec), (ms64, gms64, plain64, bd64, sec64) = (timed[4, 1920],
                                                                          timed[64, 1920])

    def taken(b, w):  # the device ms of the path the chain takes (resize_path)
        return timed[b, w][0 if b >= ROWS_MIN_BATCH else 1]

    # at B=4 the chain takes the gather path, at B=64 the rows path
    rows["H"] = dict(max_abs_err=0.0, ms=gms, plain_ms=plain_ms, library_ms=None, **bd,
                     share=bd["bound_ms"] / gms, path="gather", rows_ms=ms,
                     sector_bound_ms=sec["bound_ms"], sector_share=sec["bound_ms"] / gms,
                     gather_ms=gms, ms_b64=ms64, plain_ms_b64=plain64,
                     bound_ms_b64=bd64["bound_ms"], share_b64=bd64["bound_ms"] / ms64,
                     sector_bound_ms_b64=sec64["bound_ms"],
                     sector_share_b64=sec64["bound_ms"] / ms64, gather_ms_b64=gms64,
                     ms_1440=taken(4, 1440), ms_b64_1440=taken(64, 1440))

    # --- I ---
    cfg = tp.flagship_config(1080, 1920).white_balance
    model = load_ccc_model(cfg.ccc_model_path)
    filt = tuple(torch.as_tensor(a, device=dev)
                 for a in (model.filt_dft_re, model.filt_dft_im, model.bias))
    cuts = tuple(float(np.float32(v)) for v in (255.0 * cfg.saturation_bright_thr,
                                                255.0 * cfg.saturation_dark_thr, cfg.ccc_uv0))

    def responses(planes):
        small = resize_planes(planes, planes[0].shape[-2], sh, sw)
        return ccc.ccc_response(ccc.log_chroma_histogram_planes(*small, *cuts), *filt)

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def chosen(resp):
        """The cluster size response_argmax_cuda picks for resp."""
        _, largest = ccc._argmax_card(resp.device.index, ccc.ARGMAX_DTYPES[resp.dtype],
                                      resp.data_ptr() % 16 == 0)
        return ccc.argmax_cluster(resp.shape[0], sms, largest)

    def held_i(label, resp, clusters=(0,)):
        """Kernel I at each of `clusters` (0: its own choice) against
        torch.argmax and numpy's argmax on the host."""
        want = ccc.response_argmax_plain(resp)
        flat = resp.reshape(resp.shape[0], -1)
        flat = (flat.float() if flat.dtype == torch.bfloat16 else flat).cpu().numpy()
        idx = np.argmax(flat, axis=-1)
        host = torch.as_tensor(np.stack([idx % ccc.HIST_N, idx // ccc.HIST_N], -1)
                               .astype(np.int32), device=dev)
        for c in clusters:
            before = kernels.CCC_ARGMAX.launches
            got = ccc.response_argmax_cuda(resp, cluster=c)
            made = kernels.CCC_ARGMAX.launches - before
            bad = int((got != want).sum()) + int((got != host).sum())
            size = c or chosen(resp)
            print(f"kernel I {label}, cluster {size}{'' if c else ' (its choice)'}: {bad} "
                  f"mismatching int32 values against torch.argmax and numpy's argmax, {made} "
                  f"launches (peaks {got[:2].tolist()})")
            if bad or made != 1:
                raise AssertionError(f"kernel I: {bad} mismatching values, {made} launches at "
                                     f"{label}, cluster {size}")

    every = (0,) + ARGMAX_CLUSTERS
    fixture = responses(_fixture_planes(torch, 4, 1080, 1920))
    noise = responses([u8((64, 1080, 1920)) for _ in range(3)])
    held_i("B=4 the fixture frames' responses", fixture, every)
    held_i("B=64 the noise frames' responses", noise, every)
    n2 = ccc.HIST_N ** 2
    planted = torch.as_tensor(rng.normal(0, 1, (12, n2)).astype("float32"), device=dev)
    planted[0, [1234, 40000]] = 50.0  # a tie: the lower index
    planted[1] = 5.0  # all equal: index 0
    planted[2] = -float("inf")
    planted[3] = -1.0
    planted[3, 9000], planted[3, 700] = 0.0, -0.0  # +0.0 and -0.0 tie: the first
    planted[4] = -1.0
    planted[4, 700], planted[4, 9000] = 0.0, -0.0
    planted[5, [30000, 60000]] = float("nan")  # the first NaN
    planted[6, 0], planted[6, n2 - 1] = 1e38, float("nan")
    planted[7, 0] = float("nan")
    planted[8, [100, 200]] = float("inf")
    planted[9, n2 - 1] = 100.0  # the last index
    planted[10] = -0.0
    planted[10, 5] = 0.0  # +0.0 after -0.0: the first (index 0)
    planted[11, 1023] = 20.0  # a warp's and a block's reduction boundary
    planted[11, 1024] = 20.0
    planted = planted.view(12, ccc.HIST_N, ccc.HIST_N)
    held_i("planted ties, +0.0/-0.0, equal, -inf, +inf, NaN and last-index frames", planted,
           every)
    buf = torch.empty(12 * n2 + 1, dtype=torch.float32, device=dev)
    off = buf[1:].view(12, ccc.HIST_N, ccc.HIST_N)
    off.copy_(planted)
    held_i("the planted frames 4 bytes off a 16-byte boundary (scalar loads)", off, every)
    # ties planted across every cluster size's slice boundaries, at each
    # batch, in every dtype: each cluster size forced and the kernel's choice
    for b in ARGMAX_BATCHES:
        frames = torch.as_tensor(workloads.argmax_across_slices(workloads.SEED + b, b),
                                 device=dev)
        ints = torch.nan_to_num(frames * 8, posinf=100, neginf=-100)
        for dtype in ccc.ARGMAX_DTYPES:
            resp = (frames if dtype.is_floating_point else ints).to(dtype)
            held_i(f"B={b} ties across the slices' boundaries, {dtype}", resp, every)
        del frames, ints, resp
    typed = [("the fixture frames' responses in f64", fixture.double())]
    for dtype in (torch.float16, torch.bfloat16):
        typed.append((f"the planted frames in {dtype}", planted.to(dtype)))
    ints = torch.nan_to_num(planted * 8, posinf=100, neginf=-100)
    for dtype in (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64):
        typed.append((f"the planted frames x8 in {dtype}", ints.to(dtype)))
    for label, resp in typed:
        before = kernels.CCC_ARGMAX.launches
        got = ccc.response_argmax(resp)
        made = kernels.CCC_ARGMAX.launches - before
        bad = int((got != ccc.response_argmax_plain(resp)).sum())
        print(f"kernel I response_argmax, {label}: {bad} mismatching int32 values against "
              f"torch.argmax, {made} launches")
        if bad or made != 1:
            raise AssertionError(f"kernel I: {bad} mismatching values, {made} launches at "
                                 f"{label}")
    big = torch.cat([noise, noise, noise[:12]])  # B=140: past the SMs, cluster 1
    held_i(f"B={big.shape[0]} the noise frames' responses", big, every)
    by_batch = {1: fixture[:1], 4: fixture, 8: noise[:8], 16: noise[:16], 32: noise[:32],
                64: noise}
    i_ms = {}
    for b, resp in by_batch.items():
        i_ms[b] = (device_ms(lambda: ccc.response_argmax_cuda(resp)), chosen(resp))
        forced = {c: device_ms(lambda: ccc.response_argmax_cuda(resp, cluster=c))
                  for c in ARGMAX_CLUSTERS}
        print(f"kernel I time B={b}: {i_ms[b][0]:.4f} ms at its cluster {i_ms[b][1]} (the earlier "
              f"design: {CCC_EARLIER_MS.get(('I', b), 'not timed')}); forced "
              + ", ".join(f"{c}: {t:.4f}" for c, t in forced.items()) + f" ms [{smi_line}]")
    ms, ms64 = i_ms[4][0], i_ms[64][0]
    plain_ms = device_ms(lambda: ccc.response_argmax_plain(fixture))
    library_ms = device_ms(lambda: torch.argmax(fixture.view(4, -1), dim=-1))
    library64 = device_ms(lambda: torch.argmax(noise.view(64, -1), dim=-1))
    bd, bd64 = (bound(bytes_=w["bytes"], ops=w["ops"]) for w in (ccc_argmax_work(4),
                                                                   ccc_argmax_work(64)))
    rows["I"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bd,
                     share=bd["bound_ms"] / ms, cluster=i_ms[4][1], ms_b64=ms64,
                     cluster_b64=i_ms[64][1], library_ms_b64=library64,
                     bound_ms_b64=bd64["bound_ms"], share_b64=bd64["bound_ms"] / ms64,
                     ms_b1=i_ms[1][0], ms_b16=i_ms[16][0])
    print(f"kernel I time B=4: {ms:.4f} ms (bound {bd['bound_ms']:.5f}, {bd['bound_by']}), "
          f"plain {plain_ms:.4f} ms, torch.argmax {library_ms:.4f} ms; B=64 {ms64:.4f} ms "
          f"(bound {bd64['bound_ms']:.5f}), torch.argmax {library64:.4f} ms [{smi_line}]")
    uv4 = ccc.response_argmax(fixture)
    del noise, planted, buf, off, ints, typed, big, by_batch
    torch.cuda.empty_cache()

    # --- J ---
    exp_tab = torch.as_tensor(ccc.exp_table(cuts[2]), device=dev)

    def peaks(n):
        return torch.as_tensor(rng.integers(0, 256, (n, 2), dtype="int32"), device=dev)

    def seeded_state(shape, p=None):
        """A seeded state of `shape`; `p` given: every p that value and
        every track initialized (a NaN p carried from an earlier call)."""
        ps = rng.uniform(0, 9, shape) if p is None else np.full(shape, p)
        init = rng.integers(0, 2, shape) if p is None else np.ones(shape)
        return ccc.KalmanState(
            x=torch.as_tensor(rng.uniform(0, 255, shape + (2,)).astype("float32"), device=dev),
            p=torch.as_tensor(ps.astype("float32"), device=dev),
            initialized=torch.as_tensor(init.astype(bool), device=dev))

    fields = ("x", "p", "initialized")

    def held_j(label, uv, state, make=None, **kw):
        """Kernel J against track_plain; `make`, if given, makes the peaks
        right before J's launch (J then follows the op that wrote them)."""
        kept = None if state is None else [getattr(state, f).clone() for f in fields]
        if make is not None:
            uv = make()
        before = kernels.CCC_TRACK.launches
        got = ccc.track_cuda(uv, exp_tab, state, **kw)
        made = kernels.CCC_TRACK.launches - before
        want = ccc.track_plain(uv, exp_tab, state, **kw)
        bad = int((_bits(torch, got[1]) != _bits(torch, want[1])).sum())
        same = (got[0] is None) == (want[0] is None) and (got[0] is None or all(
            getattr(got[0], f).shape == getattr(want[0], f).shape and torch.equal(
                _bits(torch, getattr(got[0], f)), _bits(torch, getattr(want[0], f)))
            for f in fields))
        untouched = kept is None or all(torch.equal(_bits(torch, k), _bits(torch, getattr(
            state, f))) for k, f in zip(kept, fields))
        print(f"kernel J {label}: {bad} mismatching gains (bits), state equal bit for "
              f"bit: {same}, the given state untouched: {untouched}, {made} launches")
        if bad or not same or not untouched or made != 1:
            raise AssertionError(f"kernel J disagrees with its plain version at {label}")
        return got

    fresh = lambda shape=(): ccc.kalman_init(shape, device=dev)  # noqa: E731
    held_j("cameras B=4, fresh state ()", uv4, fresh(), track_shape=(4,))
    st = held_j("cameras B=64, seeded state (64,)", peaks(64), seeded_state((64,)),
                track_shape=(64,))[0]
    held_j("cameras B=64, the state carried", peaks(64), st, track_shape=(64,))
    st = held_j("sequence B=4 (the flagship's call), fresh", uv4, fresh(), track_shape=(),
                steps=4)[0]
    held_j("sequence B=4, the state carried", peaks(4), st, track_shape=(), steps=4)
    held_j("sequence B=64 (config 3's call), seeded", peaks(64), seeded_state(()),
           track_shape=(), steps=64)
    for n in (CCC_TRACK_LONG, ccc.TRACK_CHUNK - 1, ccc.TRACK_CHUNK + 1, CCC_TRACK_STAGES,
              CCC_TRACK_PAST):
        held_j(f"sequence {n} frames, fresh", peaks(n), fresh(), track_shape=(), steps=n)
    held_j("camera-blocked 4 cameras x 16, fresh (4,)", peaks(64), fresh((4,)),
           track_shape=(4,), steps=16)
    held_j("camera-blocked 4 cameras x 4, seeded (4,)", peaks(16), seeded_state((4,)),
           track_shape=(4,), steps=4)
    held_j(f"camera-blocked 3 cameras x {ccc.TRACK_CHUNK + 9}, seeded (3,)",
           peaks(3 * (ccc.TRACK_CHUNK + 9)), seeded_state((3,)), track_shape=(3,),
           steps=ccc.TRACK_CHUNK + 9)
    for label, p in (("NaN", float("nan")), ("+inf", float("inf")), ("-0.0", -0.0)):
        st = held_j(f"sequence B=64, a carried p of {label}", peaks(64), seeded_state((), p),
                    track_shape=(), steps=64)[0]
        held_j(f"sequence B=64, the state after a p of {label} carried", peaks(64), st,
               track_shape=(), steps=64)
        held_j(f"cameras B=4, a carried p of {label}", uv4, seeded_state((4,), p),
               track_shape=(4,))
    # p near the map's other fixed point: 55 dividing steps, past the gains
    # J makes before it walks (its k is negative, so the peaks are x's own)
    far = ccc.KalmanState(x=torch.tensor([100.0, 50.0], device=dev),
                          p=torch.tensor(-3.701562, device=dev),
                          initialized=torch.tensor(True, device=dev))
    held_j("sequence B=64 from p = -3.701562 (55 dividing steps)",
           torch.tensor([[100, 50]] * 64, dtype=torch.int32, device=dev), far, track_shape=(),
           steps=64)
    every = torch.cat([uv4, peaks(4)])  # the mesh's gathered peaks of 2 data shards
    held_j("gathered peaks of 2 data shards x 4 frames", every, fresh(), track_shape=(),
           steps=8)
    other = peaks(4)
    held_j("gathered peaks made by torch.cat right before J's launch", None, fresh(),
           make=lambda: torch.cat([uv4, other]), track_shape=(), steps=8)
    for label, kw in (("sequence", dict(track_shape=(), steps=4)),
                      ("cameras", dict(track_shape=(4,)))):
        held_j(f"{label} B=4 straight behind kernel I (its peaks)", None, fresh(),
               make=lambda: ccc.response_argmax_cuda(fixture), **kw)
    held_j("no Kalman B=4", uv4, None, track_shape=(4,))
    held_j("no Kalman B=64", peaks(64), None, track_shape=(64,))
    # timed: "sequence" B=4 (the flagship's chains), "cameras" B=4 (the
    # flagship's default mode), config 3's B=64, a 512-frame track
    uv64, uv512, st0 = peaks(64), peaks(CCC_TRACK_LONG), fresh()
    calls = {"sequence4": (uv4, dict(track_shape=(), steps=4)),
             "cameras4": (uv4, dict(track_shape=(4,))),
             "sequence64": (uv64, dict(track_shape=(), steps=64)),
             f"sequence{CCC_TRACK_LONG}": (uv512, dict(track_shape=(), steps=CCC_TRACK_LONG))}
    lib, stream = kernels.LIBRARY.get(), torch.cuda.current_stream(dev).cuda_stream

    def empty_launch():  # a block that only waits, launched as J is: the floor's launch term
        err = lib.isp_ccc_track_empty(stream)
        if err:
            raise RuntimeError(f"kernel J's empty launch: CUDA error {err} "
                               f"({lib.isp_error_string(err).decode()})")

    empty_ms = device_ms(empty_launch)
    j_ms = {}
    for key, (u, kw) in calls.items():
        ms = device_ms(lambda: ccc.track_cuda(u, exp_tab, st0, **kw))
        per_call = call_ms(lambda: ccc.track_cuda(u, exp_tab, st0, **kw))
        steps = kw.get("steps", 1)
        floor = ccc_track_floor(empty_ms, *kalman_chain(0.0, False, steps))
        j_ms[key] = (ms, per_call, floor["floor_ms"])
        earlier = CCC_EARLIER_MS.get(("J", steps)) if key.startswith("sequence") else None
        print(f"kernel J time, {key}: {ms:.5f} ms (the earlier design: "
              f"{earlier if earlier is not None else 'not timed'}), {per_call:.5f} ms a call; "
              f"latency floor {floor['floor_ms']:.5f} ms (an empty launch {empty_ms:.5f} + "
              f"the chain {floor['chain_ms']:.5f}; {100 * floor['floor_ms'] / ms:.1f}%) "
              f"[{smi_line}]")
    ms, per_call, floor4 = j_ms["sequence4"]
    ms64, _, floor64 = j_ms["sequence64"]
    plain_ms = device_ms(lambda: ccc.track_plain(uv4, exp_tab, st0, track_shape=(), steps=4))
    plain64 = device_ms(lambda: ccc.track_plain(uv64, exp_tab, st0, track_shape=(), steps=64),
                        n=5)
    bd, bd64 = (bound(bytes_=w["bytes"], ops=w["ops"]) for w in (
        ccc_track_work(4, 1, True), ccc_track_work(64, 1, True)))
    rows["J"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, **bd,
                     share=bd["bound_ms"] / ms, floor_ms=floor4, floor_share=floor4 / ms,
                     call_ms=per_call, empty_launch_ms=empty_ms,
                     ms_cameras=j_ms["cameras4"][0], call_ms_cameras=j_ms["cameras4"][1],
                     floor_share_cameras=j_ms["cameras4"][2] / j_ms["cameras4"][0],
                     ms_b64=ms64, plain_ms_b64=plain64, bound_ms_b64=bd64["bound_ms"],
                     share_b64=bd64["bound_ms"] / ms64, floor_ms_b64=floor64,
                     floor_share_b64=floor64 / ms64,
                     ms_512=j_ms[f"sequence{CCC_TRACK_LONG}"][0],
                     floor_share_512=(j_ms[f"sequence{CCC_TRACK_LONG}"][2]
                                      / j_ms[f"sequence{CCC_TRACK_LONG}"][0]))
    print(f"kernel J time, a sequence track of B=4: {ms:.4f} ms (byte bound "
          f"{bd['bound_ms']:.2e}, {bd['bound_by']}; latency floor {floor4:.5f}, "
          f"{100 * floor4 / ms:.1f}%), plain {plain_ms:.4f} ms; B=64 {ms64:.4f} ms (floor "
          f"{100 * floor64 / ms64:.1f}%), plain {plain64:.4f} ms; no PyTorch call computes it "
          f"[{smi_line}]")

    # --- the flagship's isp_white_balance range ---
    from torch.profiler import ProfilerActivity, profile

    pipe = tp.build_pipeline(tp.flagship_config(1080, 1920), "bayer_gbrg8",
                             frame_hw=(1080, 1920), with_state=True, temporal_mode="sequence",
                             device="cuda")
    frames = workloads.card_frames(torch, "bayer", 4, 1080, 1920, workloads.SEED + 16)
    state = tp.init_state((), device="cuda")
    pipe(frames, state)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    pipe(frames, state)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels.ALL}
    mine = [k for k in kernels.ALL if k.name in workloads.CCC_KERNELS]
    grids = sum(k.launches * k.grids for k in mine)
    print(f"flagship 1920x1080 B=4, one call: CCC range launches "
          f"{ {k.name: k.launches for k in mine} } ({grids} grids); all {counts}")
    if any(k.launches != 1 for k in mine) or counts["flip"] != 1:
        raise AssertionError(f"the flagship's CCC range or its flip (N): a kernel not launched "
                             f"once: {counts}")
    path = os.path.join(root, "build", "ccc_range_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for attempt in range(1, 4):  # a trace may come back without the device's work
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe(frames, state)
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = device_time(json.load(f))
        os.remove(path)
        wb = trace["stages"].get("isp_white_balance")
        if trace["kernels"] and wb is not None:
            break
        print(f"flagship isp_white_balance range, profile {attempt}: the trace shows no "
              f"device work or no such range")
    else:
        raise AssertionError("the flagship's isp_white_balance range: no trace of 3 showed "
                             "it, so its kernels, copies and syncs went unchecked")
    syncs = {a: n for a, (n, _) in wb["host_api"].items()
             if "Synchronize" in a or "Memcpy" in a or "Memset" in a}
    print(f"flagship isp_white_balance range, profiled: {wb['kernels']} kernels, "
          f"{wb['copies']} copies, {wb['sets']} sets, span {wb['span_us']:.1f} us, busy "
          f"{wb['busy_us']:.1f} us, host {wb['host_us']:.1f} us, synchronising or copying "
          f"API calls {syncs} [{smi_line}]")
    if wb["kernels"] != grids or wb["copies"] or wb["sets"] or syncs:
        raise AssertionError(f"the flagship's isp_white_balance range runs more than "
                             f"kernels H, B, C, I and J: {wb}")
    del frames, pipe, fixture
    kernels.reset_launch_counts()  # the comparisons above are not the main path's
    torch.cuda.empty_cache()
    return rows


WB_METHODS = (("simple", 20.0), ("grey_world", 0.8), ("pca", None), ("learned", 0.8))
# the methods' other parameters, at the small shapes: simple's p, grey-world's
# wrap rule (t255 > 257)
WB_EXTRA = (("simple", 2.0), ("simple", 35.0), ("grey_world", 1.2))
# (B, H, W): the wb_* chains' call (1920x1080 after flip 90), the flagship's
# frames, an odd crop, small frames
WB_SHAPES = ((64, 1920, 1080), (4, 1080, 1920), (3, 1079, 1439), (3, 17, 31), (3, 3, 5))
# (label, (B, H, W)) at which K and L are timed: the batch sizes of a frame
# spread over the card (1, 4, 16), the wb_* chains' call (64)
WB_TIMED = (("b1", (1, 1080, 1920)), ("b4", (4, 1080, 1920)), ("b16", (16, 1080, 1920)),
            ("b64", (64, 1920, 1080)))
M_CLUSTERS = (1, 2, 4, 8, 16)  # kernel M's learned cluster sizes, each forced in wb_range
WB_KERNELS = {"simple": ("wb_stats", "wb_tables"), "grey_world": ("wb_stats", "wb_tables"),
              "pca": ("wb_stats", "wb_tables"), "learned": ("wb_stats", "wb_hist64", "wb_tables")}


def _wb_edge_frames(torch, h: int, w: int, dev):
    """[6, h, w, 3] u8 frames at the methods' edges: fully saturated, all
    black, a constant channel (PCA's NaN pattern), two planted equal
    brightest kept sums at body positions of two lanes, and at the last
    pixel and a body pixel (the 8-lane rank's tail), and a noise frame."""
    import numpy as np

    rng = np.random.default_rng(h * 1000 + w)
    x = rng.integers(0, 61, (6, h, w, 3)).astype(np.uint8)
    x[0], x[1] = 255, 0
    x[2, ..., 0] = 77
    n = h * w
    body = n // 8 * 8
    for f, sites in ((3, (9, 2) if n >= 16 else (1, 2)), (4, (n - 1, min(16, body - 1)))):
        for i in sites:
            x[f].reshape(n, 3)[i] = (120, 60, 10)
    x[5] = rng.integers(0, 256, (h, w, 3))
    return torch.as_tensor(x, device=dev)


# kernel O's cases: (label, shape of the frames made, view of them); timed
# at B=4 1080x1920 and B=64 1920x1080 mono planes (the mono chain's call,
# the wb_* chains' size)
LUT_SHAPES = ((4, 1080, 1920), (64, 1920, 1080), (3, 1079, 1439), (3, 17, 31), (3, 3, 5))
LUT_TIMED = (("b4", (4, 1080, 1920)), ("b64", (64, 1920, 1080)))


def check_lut(torch, seed: int, smi_line):
    """Kernel O (ops/gamma.lut_cuda, apply_lut's path on the card) against
    the plain gather, bit for bit, with a seeded table: mono planes at
    LUT_SHAPES whole, the mesh's row slabs of them (a view at the frame
    stride), a crop of columns (a view at the row stride), every other
    frame, views 1 and 8 bytes off a 16-byte boundary, [..., H, W, 3]
    frames (4 x 1080 x 1920 and 2 x 45 x 61), 1-d, 0-d and empty tensors,
    and an interleaved channel (copied first); each call one launch of O
    (none for the empty) and none of G. Then O timed at LUT_TIMED beside
    its bound (measure.lut_work), the plain gather and one torch.gather of
    the same lookup on int64 indices (the cast timed apart), and on a slab
    and a view 1 byte off. Returns O's row, its main numbers at B=64."""
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.ops import gamma
    from raw_image_pipeline_tpu_torch.tools.measure import bound, device_ms, lut_work

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lut = torch.randint(0, 256, (256,), generator=g, dtype=torch.uint8, device=dev)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8, device=dev)

    def held(label, v):
        before, g_before = kernels.LUT.launches, kernels.POINTWISE.launches
        got = gamma.apply_lut(v, lut)
        made = kernels.LUT.launches - before
        want = gamma.apply_lut(v, lut, plain=True)
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        print(f"kernel O {label} {tuple(v.shape)}: {bad} mismatching bytes, {made} launch")
        if (bad or made != (1 if v.numel() else 0) or not got.is_contiguous()
                or kernels.POINTWISE.launches != g_before):
            raise AssertionError(f"kernel O {label} {tuple(v.shape)}: {bad} mismatching bytes, "
                                 f"{made} launches")

    for b, h, w in LUT_SHAPES:
        x = u8(b, h, w)
        held("planes", x)
        held("row slab", x[:, h // 4:h // 2 + 3])
        held("crop of columns", x[:, :, 1:w - 2])
        held("every other frame", x[::2])
        rows = (x.numel() - 16) // w  # room for 16 bytes off
        for off in (1, 8):
            flat = x.reshape(-1)[off:off + rows * w]
            held(f"{off} bytes off", flat.view(rows, w)[:, :w - 1])
            held(f"flat, {off} bytes off", flat)
        del x
    c3 = u8(4, 1080, 1920, 3)
    held("frames", c3)
    held("interleaved channel", c3[..., 1])
    del c3
    held("frames", u8(2, 45, 61, 3))
    held("1-d", u8(5))
    held("0-d", u8(1)[0])
    held("empty", u8(3, 0, 7))
    torch.cuda.empty_cache()

    row = {}
    for size, (b, h, w) in LUT_TIMED:
        x = u8(b, h, w)
        ms = device_ms(lambda: gamma.apply_lut(x, lut))
        plain = device_ms(lambda: gamma.apply_lut(x, lut, plain=True), n=2 if b == 64 else 5)
        idx = x.reshape(1, -1).long()
        cast = device_ms(lambda: x.reshape(1, -1).long())
        library = device_ms(lambda: torch.gather(lut[None], 1, idx))
        del idx
        bd = bound(**{"bytes_": lut_work(x.numel())["bytes"], "ops": 0})
        slab = x[:, h // 4:h // 2]
        ms_slab = device_ms(lambda: gamma.apply_lut(slab, lut))
        bd_slab = bound(**{"bytes_": lut_work(slab.numel())["bytes"], "ops": 0})["bound_ms"]
        off = x.reshape(-1)[1:1 + x.numel() - 16]
        ms_off = device_ms(lambda: gamma.apply_lut(off, lut))
        row.update({f"ms_{size}": ms, f"plain_ms_{size}": plain, f"library_ms_{size}": library,
                    f"index_cast_ms_{size}": cast, f"bound_ms_{size}": bd["bound_ms"],
                    f"bound_by_{size}": bd["bound_by"], f"ms_{size}_slab": ms_slab,
                    f"bound_ms_{size}_slab": bd_slab, f"ms_{size}_off1": ms_off})
        print(f"kernel O time {size} ({b}x{h}x{w} u8): {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, {100 * bd['bound_ms'] / ms:.1f}%), "
              f"one torch.gather {library:.4f} ms (the int64 index cast {cast:.4f} ms apart); "
              f"rows {h // 4}-{h // 2} {ms_slab:.4f} ms (bound {bd_slab:.4f}, "
              f"{100 * bd_slab / ms_slab:.1f}%), 1 byte off {ms_off:.4f} ms [{smi_line}]")
        del x, slab, off
        torch.cuda.empty_cache()
    main = "b64"
    return dict(max_abs_err=0.0, ms=row[f"ms_{main}"], plain_ms=row[f"plain_ms_{main}"],
                bound_ms=row[f"bound_ms_{main}"], bound_by=row[f"bound_by_{main}"],
                share=row[f"bound_ms_{main}"] / row[f"ms_{main}"],
                library_ms=row[f"library_ms_{main}"], **row)


def check_wb_range(tp, torch, rng, smi_line):
    """Phase wb_range: the statistical white balances' kernels K (the
    statistics), L (learned's 64^3 histogram) and M (the per-frame tables)
    and G's table step against their plain versions on the card: equal
    records, histograms, tables, NaN flags and learned's features (bit for
    bit), and 0 mismatching bytes out of G, and out of K, M (L) and G
    launched back to back as the chain launches them (balance_white_planes),
    for each method (and simple at p 2
    and 35, grey-world at 1.2 where the u16 wrap rule applies) at
    WB_SHAPES, on planes 1 byte off a 16-byte boundary, on interleaved
    planes (column stride 3) and on the edge frames (_wb_edge_frames) at
    45x61 and 1079x1439, and on the frame families of
    workloads.wb_frames at 1080x1920 (learned also at a threshold of 1.0,
    where all_bins keeps every bin; big_bin and constant put more than
    65 535 pixels in one bin); then kernel O (check_lut); then K's four
    modes and L timed at
    B = 1, 4, 16 (1080x1920) and 64 (1920x1080) on card_frames and on the
    fixture's frames, M and G's table step at B=4 and 64 on card_frames,
    each beside its plain version and its bound (M's simple, grey-world and
    PCA modes also beside their floor, an empty launch of their grid
    launched as M's: isp_wb_tables_empty), with torch.bincount of the
    same bins as K's (simple) and L's library time and one indexing call of
    the same lookup as G's; then each wb_* chain at B=64 1920x1080: K, M
    (and L) launched in its call, and its profiled isp_white_balance range
    holding at most 3
    kernels (4 for learned: K, L, M, G) and no bincount, topk or sort, no
    copy, set or synchronising API call (up to 3 profiles until a trace
    shows the range). Returns the kernels' rows (K, L, M, O) and G's table
    step's keys."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.ops import learned_wb, pointwise
    from raw_image_pipeline_tpu_torch.ops import white_balance as wb
    from raw_image_pipeline_tpu_torch.tools import workloads
    from raw_image_pipeline_tpu_torch.tools.measure import (bound, device_ms, pointwise_work,
                                                            wb_hist64_work, wb_stats_work,
                                                            wb_tables_work)
    from raw_image_pipeline_tpu_torch.tools.profile_chains import device_time, range_kernel_names
    from raw_image_pipeline_tpu_torch.utils import image_io

    dev = torch.device("cuda")
    seed = int(rng.integers(1 << 30))
    fixture = image_io.imread(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                           "fixtures", "alphasense.png"))

    def colour(b, h, w, s):
        return workloads.card_frames(torch, "color", b, h, w, seed + s)

    def planes(x, off=0):  # contiguous planes, or views `off` bytes past a 16-byte boundary
        if not off:
            return tuple(x[..., c].contiguous() for c in range(3))
        buf = torch.empty((3, x.numel() // 3 + 32), dtype=torch.uint8, device=dev)
        out = []
        for c in range(3):
            v = buf[c, off:off + x.numel() // 3].view(x.shape[:-1])
            v.copy_(x[..., c])
            out.append(v)
        return tuple(out)

    def held(label, pl, method, param):
        """K, L, M and G's table step on planes `pl` against their plain
        versions; raises on a difference."""
        h, w = pl[0].shape[-2:]
        want = wb.wb_stats_plain(pl, method, param)
        got = wb.wb_stats_cuda(pl, method, param)
        hist = want_hist = feats = None
        bad = {}
        if method == "learned":
            got, hist = got
            t255 = learned_wb.learned_t255(param)
            want_hist = learned_wb.hist64_plain(pl, want, t255)
            learned_wb.hist64_cuda(wb._check_planes(pl, "kernel L"), got, t255, hist)
            bad["histogram"] = int((hist != want_hist).sum())
            feats = torch.empty((got.shape[0], 4, 2), dtype=torch.float32, device=dev)
        bad["record"] = int((got != want).sum())
        t = wb.wb_tables_cuda(got, method, param, h * w, hist, features=feats)
        p = wb.wb_tables_plain(want, method, param, h * w, want_hist)
        bad["tables"] = int((t.tables != p.tables).sum())
        if p.nan is not None:
            bad["nan flags"] = int((t.nan != p.nan).sum())
        if feats is not None:
            pf = learned_wb.features_plain(want, want_hist)
            bad["features"] = int((feats.view(torch.int32) != pf.view(torch.int32)).sum())
        out = pointwise.pointwise_cuda(pl, wb_tables=p.tables, wb_nan=p.nan)
        ref = pointwise.pointwise_plain(*pl, wb_tables=p.tables, wb_nan=p.nan)
        bad["G bytes"] = sum(int((a != b).sum()) for a, b in zip(out, ref))
        # K, L, M and G back to back as the chain launches them
        chained = wb.balance_white_planes(pl, method, param)
        bad["K-M-G chain bytes"] = sum(int((a != b).sum()) for a, b in zip(chained, ref))
        print(f"wb_range {method}{'' if param is None else f' {param}'} {label}: "
              + ", ".join(f"{v} mismatching {k}" for k, v in bad.items()))
        if any(bad.values()):
            raise AssertionError(f"wb_range {method} {label}: {bad}")

    for method, param in WB_METHODS + WB_EXTRA:
        shapes = WB_SHAPES if (method, param) in WB_METHODS else WB_SHAPES[3:]
        for i, (b, h, w) in enumerate(shapes):
            held(f"B={b} {h}x{w}", planes(colour(b, h, w, i)), method, param)
        if (method, param) not in WB_METHODS:
            continue
        x = colour(4, 1080, 1920, 7)
        held("B=4 1080x1920, planes 1 byte off", planes(x, 1), method, param)
        held("B=4 1080x1920, interleaved planes", (x[..., 0], x[..., 1], x[..., 2]), method,
             param)
        for h, w in ((45, 61), (1079, 1439)):
            held(f"edge frames {h}x{w}", planes(_wb_edge_frames(torch, h, w, dev)), method,
                 param)
        del x
        for kind in workloads.WB_FAMILIES:
            x = workloads.wb_frames(torch, kind, 2, 1080, 1920, seed + 11, bgr=fixture, device=dev)
            held(f"{kind} B=2 1080x1920", planes(x), method, param)
            if method == "learned":  # at t255 = 255 all_bins keeps every bin
                held(f"{kind} B=2 1080x1920", planes(x), method, 1.0)
            del x
    # kernel M's learned mode on synthetic histograms, at the rule's cluster
    # and each size forced
    labels, record, hist = workloads.learned_histograms(torch, workloads.SEED + 5, device=dev)
    want_t = learned_wb.learned_tables_plain(record, hist)
    want_f = learned_wb.features_plain(record, hist)
    for cluster in (None,) + M_CLUSTERS:
        feats = torch.empty((len(labels), 4, 2), dtype=torch.float32, device=dev)
        t = wb.wb_tables_cuda(record, "learned", 0.8, 1, hist, features=feats, cluster=cluster)
        bad = {label: (int((t.tables[i] != want_t[i]).sum()),
                       int((feats[i].view(torch.int32) != want_f[i].view(torch.int32)).sum()))
               for i, label in enumerate(labels)}
        print(f"wb_range M learned, synthetic histograms, cluster "
              f"{cluster or 'of the rule'}: (mismatching tables, features) {bad}")
        if any(a or b for a, b in bad.values()):
            raise AssertionError(f"wb_range M learned on synthetic histograms, cluster "
                                 f"{cluster}: {bad}")
    del record, hist, want_t, want_f
    lut_row = check_lut(torch, int(rng.integers(1 << 31)), smi_line)  # kernel O
    torch.cuda.empty_cache()

    # --- times beside the bounds: K and L at B = 1, 4, 16 (1080x1920) and 64
    # (1920x1080) on card_frames and the fixture's frames; M and G on card_frames
    # at B=4 and 64 ---
    rows = {"K": {}, "L": {}, "M": {}, "G": {}}
    lib, stream = kernels.LIBRARY.get(), torch.cuda.current_stream(dev).cuda_stream

    def m_floor(method, b):
        """M's latency floor in a small mode, device ms: b empty blocks of
        the mode's threads, launched as M launches it (each mode reads a few
        hundred bytes a frame: its least time is the launch)."""
        mode = wb.METHODS.index(method)

        def empty():
            err = lib.isp_wb_tables_empty(mode, b, stream)
            if err:
                raise RuntimeError(f"empty launch: CUDA error {err} "
                                   f"({lib.isp_error_string(err).decode()})")

        return device_ms(empty)

    def timed(name, label, ms, plain, work, library=None, library_call="torch.bincount of the "
              "same bins"):
        bd = bound(bytes_=work["bytes"], ops=work["ops"])
        rows[name].update({f"ms_{label}": ms, f"plain_ms_{label}": plain,
                           f"bound_ms_{label}": bd["bound_ms"], f"bound_by_{label}": bd["bound_by"]})
        if library is not None:
            rows[name][f"library_ms_{label}"] = library
        print(f"wb_range time {name} {label}: {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, {100 * bd['bound_ms'] / ms:.1f}%)"
              + ("" if library is None else f", {library_call} {library:.4f} ms")
              + f" [{smi_line}]")

    def lookup_ms(tables, idx_of, label):
        """one PyTorch indexing call of G's lookup (torch.gather of int64
        indices), the indices' cast timed apart"""
        idx = idx_of()
        cast = device_ms(idx_of)
        ms = device_ms(lambda: torch.gather(tables, 1, idx))
        rows["G"][f"index_cast_ms_{label}"] = cast
        print(f"wb_range time G {label}: one torch.gather of the lookup {ms:.4f} ms, the int64 "
              f"index cast {cast:.4f} ms apart [{smi_line}]")
        return ms

    for family in ("card", "fixture"):
        for size, (b, h, w) in WB_TIMED:
            x = (colour(b, h, w, 9) if family == "card"
                 else workloads.fixture_colour(torch, fixture, b, h, w))
            pl = planes(x)
            del x
            sfx = size if family == "card" else f"{size}_fixture"
            main = family == "card" and size in ("b4", "b64")  # M and G too
            n = 2 if b == 64 else 5  # the plain versions' calls a run
            for method, param in WB_METHODS:
                label = f"{method}_{sfx}"
                rec = wb.wb_stats_cuda(pl, method, param)
                want = wb.wb_stats_plain(pl, method, param)
                library = None
                if method == "simple":
                    bins = (torch.stack(pl, 1).reshape(b, 3, -1).long()
                            + (torch.arange(3 * b, device=dev) * 256).reshape(b, 3, 1)).reshape(-1)
                    library = device_ms(lambda: torch.bincount(bins, minlength=3 * b * 256), n=n)
                    del bins
                timed("K", label, device_ms(lambda: wb.wb_stats_cuda(pl, method, param)),
                      device_ms(lambda: wb.wb_stats_plain(pl, method, param), n=n),
                      wb_stats_work(b, h, w, method), library)
                hist = want_hist = None
                if method == "learned":
                    rec, hist = rec
                    t255 = learned_wb.learned_t255(param)
                    learned_wb.hist64_cuda(pl, rec, t255, hist)
                    want_hist = learned_wb.hist64_plain(pl, want, t255)
                    Bp, Gp, Rp = (p.to(torch.int32) for p in pl)
                    keep = torch.maximum(torch.maximum(Bp, Gp), Rp) < t255
                    hi = torch.clamp(want[:, learned_wb.HI], min=64).float()[:, None, None]
                    idx = [torch.clamp(torch.floor(c.float() * 64.0 / hi).long(), 0, 63)
                           for c in (Bp, Gp, Rp)]
                    bins = torch.where(keep, (idx[0] * 64 + idx[1]) * 64 + idx[2]
                                       + (torch.arange(b, device=dev) * 64 ** 3)[:, None, None],
                                       b * 64 ** 3).reshape(-1)
                    del Bp, Gp, Rp, idx
                    kept = int(keep.sum())
                    del keep
                    library = device_ms(lambda: torch.bincount(bins, minlength=b * 64 ** 3 + 1),
                                        n=n)
                    del bins
                    # L adds into K's zeroed histogram; timed alone, the adds pile up
                    timed("L", sfx,
                          device_ms(lambda: learned_wb.hist64_cuda(pl, rec, t255, hist)),
                          device_ms(lambda: learned_wb.hist64_plain(pl, want, t255), n=n),
                          wb_hist64_work(b, h, w, kept), library)
                    hist.copy_(want_hist)
                if main:
                    palettes = ([min(300, int(c)) for c in (want_hist > 0).sum(-1).tolist()]
                                if want_hist is not None else ())
                    timed("M", label,
                          device_ms(lambda: wb.wb_tables_cuda(rec, method, param, h * w, hist)),
                          device_ms(lambda: wb.wb_tables_plain(want, method, param, h * w,
                                                               want_hist), n=n),
                          wb_tables_work(b, method, palettes))
                    if method == "learned":  # the readings behind wb_tables_cluster
                        sweep = {c: device_ms(lambda: wb.wb_tables_cuda(rec, method, param,
                                                                        h * w, hist, cluster=c))
                                 for c in M_CLUSTERS}
                        rows["M"].update({f"ms_{label}_cluster{c}": v for c, v in sweep.items()})
                        print(f"wb_range time M {label} by cluster size: "
                              + ", ".join(f"{c}: {v:.4f} ms" for c, v in sweep.items())
                              + f" [{smi_line}]")
                if main and method != "learned":  # M's small modes beside their floor
                    ms, floor = rows["M"][f"ms_{label}"], m_floor(method, b)
                    rows["M"][f"floor_ms_{label}"] = floor
                    print(f"wb_range time M {label}: {ms:.5f} ms against its floor, an empty "
                          f"launch of its grid as M's, {floor:.5f} ms ({ms / floor:.2f}x the "
                          f"floor, {100 * floor / ms:.1f}%) [{smi_line}]")
                if main and method == "pca":  # G's table step, with PCA's NaN flags read
                    t = wb.wb_tables(pl, method, param)
                    library = lookup_ms(
                        t.tables.reshape(3 * b, 256),
                        lambda: torch.stack(pl, 1).reshape(3 * b, -1).long(), f"table_step_{size}")
                    timed("G", f"table_step_{size}",
                          device_ms(lambda: pointwise.pointwise_cuda(pl, wb_tables=t.tables,
                                                                     wb_nan=t.nan)),
                          device_ms(lambda: pointwise.pointwise_plain(*pl, wb_tables=t.tables,
                                                                      wb_nan=t.nan), n=n),
                          pointwise_work(b, h, w, ("table",)), library, "one torch.gather")
                del rec, hist, want, want_hist
                torch.cuda.empty_cache()
            del pl
            torch.cuda.empty_cache()

    # --- each wb_* chain's isp_white_balance range, profiled ---
    busy = {}
    for method, _ in WB_METHODS:
        ch = workloads.chains(tp)[f"wb_{method}"]
        pipe = tp.build_pipeline(ch.config(1080, 1920), ch.encoding, frame_hw=(1080, 1920),
                                 device="cuda")
        frames = workloads.card_frames(torch, "bayer", 64, 1080, 1920, seed + 20)
        pipe(frames)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        pipe(frames)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in kernels.ALL if k.launches}
        if any(counts.get(k, 0) != 1 for k in WB_KERNELS[method] + ("flip",)):
            raise AssertionError(f"wb_{method}: K, M (L) or the flip (N) not launched once a "
                                 f"call: {counts}")
        for attempt in range(1, 4):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                pipe(frames)
                torch.cuda.synchronize()
            path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"wb_{method}_trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
            os.remove(path)
            rng_ = device_time(trace)["stages"].get("isp_white_balance")
            if rng_ is not None and rng_["kernels"]:
                break
            print(f"wb_{method} isp_white_balance range, profile {attempt}: no device work seen")
        else:
            raise AssertionError(f"wb_{method}: no trace of 3 showed its isp_white_balance range")
        names = range_kernel_names(trace, "isp_white_balance")
        syncs = {a: n for a, (n, _) in rng_["host_api"].items()
                 if "Synchronize" in a or "Memcpy" in a or "Memset" in a}
        most = len(WB_KERNELS[method]) + 1
        forbidden = [n for n in names if any(s in n.lower() for s in ("bincount", "topk", "sort"))]
        busy[method] = rng_["busy_us"] / 1e3
        print(f"wb_{method} 1920x1080 B=64, isp_white_balance range: {rng_['kernels']} kernels "
              f"(at most {most}), {rng_['copies']} copies, {rng_['sets']} sets, busy "
              f"{rng_['busy_us'] / 1e3:.4f} ms a call of 64 frames, span "
              f"{rng_['span_us'] / 1e3:.4f} ms, host {rng_['host_us'] / 1e3:.4f} ms; "
              f"synchronising or copying API calls {syncs}; launches {counts}; kernels {names} "
              f"[{smi_line}]")
        if rng_["kernels"] > most or rng_["copies"] or rng_["sets"] or syncs or forbidden:
            raise AssertionError(f"wb_{method}: the isp_white_balance range runs more than "
                                 f"K, L, M and G: {names}, {rng_}")
        del pipe, frames
        torch.cuda.empty_cache()
    kernels.reset_launch_counts()  # the comparisons above are not the main path's
    # each row's main numbers at the wb_* chains' call (B=64 1920x1080): K in
    # simple's mode (torch.bincount of its bins beside it), M in learned's
    out = {"G_table": rows["G"], "O": lut_row, "wb_busy_ms_b64": busy}
    for name, label in (("K", "simple_b64"), ("L", "b64"), ("M", "learned_b64")):
        r = rows[name]
        out[name] = dict(max_abs_err=0.0, ms=r[f"ms_{label}"], plain_ms=r[f"plain_ms_{label}"],
                         bound_ms=r[f"bound_ms_{label}"], bound_by=r[f"bound_by_{label}"],
                         library_ms=r.get(f"library_ms_{label}"), **r)
    return out


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
                                      debayer.debayer_bilinear_cuda,
                                      debayer.debayer_bilinear_planar, phase)
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
    hist = ccc.log_chroma_histogram_planes(*small, *cuts)
    two_peak, gap, peaks = workloads.two_peak_histogram(model.filt_dft_re, model.filt_dft_im,
                                                        model.bias)
    err = 0.0
    # C's function as one library expression (timed beside C, used nowhere
    # in the port): real-input FFTs, the filter's half spectrum
    half = torch.complex(wr, wi)[:, :ccc.HIST_N // 2 + 1]

    def library(x):
        return torch.fft.irfft2(torch.fft.rfft2(x) * half, s=(ccc.HIST_N, ccc.HIST_N)) + bias

    library_argmax = {}
    for key, label, x in (("seeded", "B=4 seeded frames", hist),
                          ("two_peak", f"two-peak fixture (peaks {peaks}, relative gap "
                                       f"{gap:.3e})", torch.as_tensor(two_peak[None], device=dev))):
        got = ccc.ccc_response_cuda(x, wr, wi, bias)
        want = ccc.ccc_response_plain(x, wr, wi, bias)
        e = float((got - want).abs().max())
        scale = float(want.abs().max())
        same_argmax = bool(torch.equal(ccc.response_argmax(got), ccc.response_argmax(want)))
        lib = library(x)
        library_argmax[key] = bool(torch.equal(ccc.response_argmax(lib),
                                               ccc.response_argmax(got)))
        print(f"kernel C response {label}: max |diff| {e:.3e} (limit {1e-4 * scale:.3e}), "
              f"argmax equal: {same_argmax}; the rfft2/irfft2 expression: max |diff| "
              f"{float((lib - want).abs().max()):.3e}, argmax equal to C's: "
              f"{library_argmax[key]}")
        if not (e <= 1e-4 * scale and same_argmax):
            raise AssertionError(f"kernel C disagrees with its plain version on {label}")
        err = max(err, e)
    ms = device_ms(lambda: ccc.ccc_response_cuda(hist, wr, wi, bias))
    plain_ms = device_ms(lambda: ccc.ccc_response_plain(hist, wr, wi, bias))
    library_ms = device_ms(lambda: library(hist))
    # the bound of C's function (real-input FFTs: bytes bound it), and
    # beside it that of the twelve DFT products that C computes
    work = ccc_response_work(hist.shape[0], ccc.HIST_N)
    as_products = bound(bytes_=work["dft_bytes"], ops=work["dft_products_ops"])
    rows["C"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     library_argmax_equal=library_argmax,
                     **bound(bytes_=work["bytes"], ops=work["least_ops"]),
                     dft_products_bound_ms=as_products["bound_ms"])
    print(f"kernel C time B=4: {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.fft rfft2/irfft2 "
          f"{library_ms:.4f} ms; bound "
          f"{rows['C']['bound_ms']:.5f} ms ({rows['C']['bound_by']}), as twelve DFT products "
          f"{as_products['bound_ms']:.5f} ms")

    planes, rows["D"] = check_debayer(torch, rng, "D", "mht", debayer.debayer_mht_cuda,
                                      debayer.debayer_mht_planar, phase)
    planes = [planes[:, c].contiguous() for c in range(3)]  # no swap under MHT

    rows["E"] = check_remap(tp, torch, rng, planes)
    check_remap_cameras(tp, torch, rng, rows["E"])
    rows["F"] = check_remap_lerp(tp, torch, rng, planes)
    rows["G"] = check_pointwise(tp, torch, rng)
    rows["N"] = check_flip(torch, rng)
    # its own generator: the later phases' inputs stay what they were
    rows["P"] = check_debayer16(torch, np.random.default_rng(workloads.SEED + 4))
    for k in kernels.ALL:
        k.launches = 0  # the comparisons above are not the main path's
    return rows


# (label, B, H, W, angle) at which kernel N is timed: the flagship's mosaic
# (flip 180, hoisted) and the other angles at B=4, the wb_* chains' mosaic
# (flip 90, hoisted; 1920x1080 after it) and 180 at B=64
FLIP_TIMED = (("b4_90", 4, 1080, 1920, 90), ("b4_180", 4, 1080, 1920, 180),
              ("b4_270", 4, 1080, 1920, 270), ("b64_90", 64, 1080, 1920, 90),
              ("b64_270", 64, 1080, 1920, 270), ("b64_180", 64, 1080, 1920, 180))
FLIP_ODD = ((3, 1079, 1439), (3, 1081, 1920), (3, 17, 31), (2, 1, 5), (2, 5, 1))


def check_flip(torch, rng):
    """Kernel N against its plain version (torch.flip of torch.transpose,
    ops/flip.flip_rows_plain) on the card, bit for bit: B=4 1080x1920 u8
    mosaics at 90, 180 and 270, whole and in slabs of rows (the mesh's),
    B=64 1080x1920 at 90 (the wb_* chains' call), three planes of one set
    of strides in one launch, FLIP_ODD's sizes, a view 1 byte off a 16-byte
    boundary, u16 frames, [..., H, W, 3] u8 and f32 frames and f64 pairs
    (16 bytes a pixel), each call's launches counted; then N at FLIP_TIMED
    beside its bound (measure.flip_work), its plain version and torch.flip
    alone (one call on the transposed view for 90 and 270). Returns N's
    row, its main numbers at the wb_* chains' call (b64_90)."""
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.ops import flip
    from raw_image_pipeline_tpu_torch.tools.measure import bound, device_ms, flip_work

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(1 << 31)))

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8, device=dev)

    def held(label, tensors, angle, rows=None, axes=(1, 2)):
        before = kernels.FLIP.launches
        got = flip.flip_cuda(tensors, angle, rows, spatial_axes=axes)
        made = kernels.FLIP.launches - before
        bad = 0
        for a, t in zip(got, tensors):
            want = flip.flip_rows_plain(t, angle, rows, axes)
            if a.shape != want.shape or a.dtype != want.dtype:
                raise AssertionError(f"kernel N {label} {angle}: {tuple(a.shape)} {a.dtype}, "
                                     f"expected {tuple(want.shape)} {want.dtype}")
            bad += int((a.contiguous().view(torch.uint8)
                        != want.contiguous().view(torch.uint8)).sum())
        launches = 0 if rows is not None and rows[0] == rows[1] else 1  # no rows: no launch
        print(f"kernel N {label} {angle}{'' if rows is None else f' rows {rows}'}: {bad} "
              f"mismatching bytes against torch.flip, {made} launch")
        if bad or made != launches:
            raise AssertionError(f"kernel N {label} {angle} rows {rows}: {bad} mismatching "
                                 f"bytes, {made} launches")

    def slabs(n):
        return [None, (0, n // 4), (n // 4, n // 2 + 3), (n - 5, n)]

    for angle in (90, 180, 270):
        x = u8(4, 1080, 1920)
        n = flip.flipped_shape(1080, 1920, angle)[0]
        for rows in slabs(n):
            held("B=4 1080x1920", (x,), angle, rows)
        p = u8(4, 3, 1080, 1920)
        held("three planes B=4 1080x1920", tuple(p[:, c] for c in range(3)), angle)
        held("three planes B=4 1080x1920", tuple(p[:, c] for c in range(3)), angle, (8, 520))
        off = p.reshape(-1)[1:1 + 4 * 1080 * 1920].view(4, 1080, 1920)
        held("B=4 1080x1920, 1 byte off", (off,), angle)
        del x, p, off
        for b, h, w in FLIP_ODD:
            x = u8(b, h, w)
            for rows in slabs(flip.flipped_shape(h, w, angle)[0])[:2 if min(h, w) < 8 else 4]:
                held(f"B={b} {h}x{w}", (x,), angle, rows)
        x16 = torch.randint(-32768, 32768, (4, 1079, 1439), generator=g, dtype=torch.int32,
                            device=dev).to(torch.int16).view(torch.uint16)
        held("u16 B=4 1079x1439", (x16,), angle)
        held("u16 B=4 1079x1439", (x16,), angle, (3, 300))
        c3 = u8(4, 1080, 1920, 3)
        held("u8 [4, 1080, 1920, 3]", (c3,), angle, axes=(-3, -2))
        f32 = torch.randn((2, 1079, 1439, 3), generator=g, device=dev)
        held("f32 [2, 1079, 1439, 3]", (f32,), angle, axes=(-3, -2))
        held("f32 [2, 1079, 1439, 3]", (f32,), angle, (17, 301), axes=(-3, -2))
        f64 = torch.randn((2, 31, 45, 2), generator=g, dtype=torch.float64, device=dev)
        held("f64 [2, 31, 45, 2]", (f64,), angle, axes=(-3, -2))
        del x16, c3, f32, f64
    x = u8(64, 1080, 1920)
    held("B=64 1080x1920", (x,), 90)
    del x
    torch.cuda.empty_cache()

    row = {}
    for label, b, h, w, angle in FLIP_TIMED:
        x = u8(b, h, w)
        oh, ow = flip.flipped_shape(h, w, angle)
        ms = device_ms(lambda: flip.flip_cuda((x,), angle))
        plain_ms = device_ms(lambda: flip.flip_rows_plain(x, angle, None, (1, 2)))
        dims = (1, 2) if angle == 180 else (2,) if angle == 90 else (1,)
        view = x if angle == 180 else x.transpose(1, 2)
        library_ms = device_ms(lambda: torch.flip(view, dims=dims))
        work = flip_work(b, oh, ow)
        bd = bound(bytes_=work["bytes"], ops=work["ops"])
        row.update({f"ms_{label}": ms, f"plain_ms_{label}": plain_ms,
                    f"library_ms_{label}": library_ms, f"bound_ms_{label}": bd["bound_ms"],
                    f"bound_by_{label}": bd["bound_by"]})
        print(f"kernel N time {label} ({b}x{h}x{w} u8, flip {angle}): {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.flip alone {library_ms:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, {100 * bd['bound_ms'] / ms:.1f}%)")
        del x
        torch.cuda.empty_cache()
    main = "b64_90"
    return dict(max_abs_err=0.0, ms=row[f"ms_{main}"], plain_ms=row[f"plain_ms_{main}"],
                bound_ms=row[f"bound_ms_{main}"], bound_by=row[f"bound_by_{main}"],
                share=row[f"bound_ms_{main}"] / row[f"ms_{main}"],
                library_ms=row[f"library_ms_{main}"], **row)


OPS_CROP_LEAD = (2, 3)  # the ops phase's leading dims at its random odd crop


def check_ops_contract(torch, g, launches, remap_maps, filt, cuts, thr, smi_line):
    """The ops phase's second part: the calls the JAX package takes that the
    port's kernels once refused, each held against the same call with
    plain=True on the card (or, for the batch-minor remap, the batch-major
    call) at 0 mismatching bytes, f32 values for the histograms, with the
    kernel launches it must make and its device time:
    log_chroma_histogram and _rt over kernel B's 524160 pixels (1080x1920
    with leading dims (4,): runs of 518400 pixels, four a frame; 727x1001:
    seven a frame; 733x821: a run and a tail run; one launch of B where the
    runs tile the frame, two with a tail); lerp and fixed32
    remap_bilinear_u8 of 4 channels (F on a group of three planes and a
    single plane), float ones of 2 and 4 channels (E likewise) and
    batch_minor=True, each with one map and four per-camera maps at
    1080x1920, B=4; A, D, E and F at B = MAX_BATCH + 2 (4x8 frames: two
    launches each); B, C, E and F (two cameras) at B=20 with the launches'
    batch limit lowered to 7 (kernels.batch_runs), where the plain
    comparison past MAX_BATCH would need tens of GB. Adds the launches to
    `launches`."""
    import numpy as np

    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.ops import ccc, debayer, undistortion
    from raw_image_pipeline_tpu_torch.ops.resize import resize_linear_u8
    from raw_image_pipeline_tpu_torch.tools import workloads
    from raw_image_pipeline_tpu_torch.tools.measure import device_ms

    dev = torch.device("cuda")

    def rand(shape):
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)

    def case(label, call, want_call, expect, against="plain=True", exact=True):
        kernels.reset_launch_counts()
        got = call()
        torch.cuda.synchronize()
        made = {k.name: k.launches for k in kernels.ALL if k.launches}
        for k in kernels.ALL:
            launches[k.name] += k.launches
        want = want_call()
        if exact:
            bad, note = int((got != want).sum()), ""
        else:  # ccc_response: the argmax, and the values within 1e-4 of max |response|
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            bad = int((ccc.response_argmax(got) != ccc.response_argmax(want)).sum())
            bad += int(err > 1e-4 * scale)
            note = f" (argmax; max |diff| {err:.3e}, limit {1e-4 * scale:.3e})"
        ms = device_ms(call)
        print(f"ops {label}: {bad} mismatching against {against}{note}; launches {made}; "
              f"{ms:.4f} ms on the device [{smi_line}]")
        if bad or made != expect:
            raise AssertionError(f"ops {label}: {bad} mismatching, launches {made} "
                                 f"(expected {expect})")

    limit = ccc.HIST_KERNEL_MAX_PIXELS
    for lead, hw in (((4,), (1080, 1920)), ((2, 3), (727, 1001)), ((2,), (733, 821))):
        img = rand(lead + hw + (3,))
        run, k = ccc.pixel_runs(hw[0] * hw[1], limit)
        tail = run * k < hw[0] * hw[1]
        size = f"{'x'.join(map(str, lead))} x {hw[0]}x{hw[1]}"
        for name, fn, args in (("log_chroma_histogram", ccc.log_chroma_histogram, thr),
                               ("log_chroma_histogram_rt", ccc.log_chroma_histogram_rt, cuts)):
            case(f"{name} {size} (runs of {run} pixels, {k} a frame"
                 f"{' and a tail' if tail else ''})",
                 lambda: fn(img, *args), lambda: fn(img, *args, plain=True),
                 {"ccc_histogram": 2 if tail else 1})
        del img
    hw = (1080, 1920)
    for cameras in (1, 4):
        for mode, kernel in (("lerp", "remap_lerp"), ("fixed32", "remap_lerp")):
            mb, mw = remap_maps(hw, cameras, mode)
            img = rand((4,) + hw + (4,))
            case(f"remap_bilinear_u8 {mode} 4 x 1080x1920 x 4 channels, {cameras} map(s)",
                 lambda: undistortion.remap_bilinear_u8(img, mb, mw, hw, hw, n_cameras=cameras,
                                                        mode=mode),
                 lambda: undistortion.remap_bilinear_u8(img, mb, mw, hw, hw, n_cameras=cameras,
                                                        mode=mode, plain=True),
                 {kernel: 2})
        base, weights = remap_maps(hw, cameras)

        def remap(x, *args, **kw):
            return undistortion.remap_bilinear_u8(x, base, weights, hw, hw, *args, **kw)

        for c in (2, 4):
            img = rand((4,) + hw + (c,))
            case(f"remap_bilinear_u8 float 4 x 1080x1920 x {c} channels, {cameras} map(s)",
                 lambda: remap(img, n_cameras=cameras, mode="float"),
                 lambda: remap(img, n_cameras=cameras, mode="float", plain=True),
                 {"remap_float": 2})
        img = rand((4,) + hw + (3,))
        minor = img.movedim(0, 2).contiguous()  # [H, W, 4, 3]
        major = remap(img, n_cameras=cameras, mode="float")
        want = (major.movedim(0, 2) if cameras == 1 else
                major.reshape((cameras, -1) + major.shape[1:]).permute(0, 2, 3, 1, 4))
        # the JAX positions: src_hw, batch_minor, tuning, n_cameras, blend_impl, mode
        case(f"remap_bilinear_u8 float batch_minor [1080, 1920, 4, 3], {cameras} map(s)",
             lambda: remap(minor, True, None, cameras, None, "float"), lambda: want,
             {"remap_float": 1}, against="the batch-major call")
        del img, minor, major, want
    torch.cuda.empty_cache()

    nb = kernels.MAX_BATCH + 2
    tiny = rand((nb, 4, 8))
    for algorithm, name in (("bilinear", "debayer_bilinear"), ("mht", "debayer_mht")):
        case(f"debayer {algorithm} {nb} x 4x8", lambda: debayer.debayer(tiny, "bayer_gbrg8",
                                                                        algorithm),
             lambda: debayer.debayer(tiny, "bayer_gbrg8", algorithm, plain=True), {name: 2})
    tiny = rand((nb, 4, 8, 3))
    for mode, kernel in (("float", "remap_float"), ("lerp", "remap_lerp")):
        base, weights = undistortion.remap_precompute(
            *workloads.hostile_maps((4, 8), (4, 8), 5), (4, 8), mode=mode)
        case(f"remap_bilinear_u8 {mode} {nb} x 4x8",
             lambda: undistortion.remap_bilinear_u8(tiny, base, weights, (4, 8), mode=mode),
             lambda: undistortion.remap_bilinear_u8(tiny, base, weights, (4, 8), mode=mode,
                                                    plain=True),
             {kernel: 2})
    del tiny

    bgr = debayer.debayer(rand((20, 540, 720)), "bayer_gbrg8")
    planes = [p.contiguous() for p in
              resize_linear_u8(bgr, ccc.SMALL_H, ccc.SMALL_W).movedim(-1, 0)]
    case("log_chroma_histogram_cuda 20 x 270x360, batch_limit 7",
         lambda: ccc.log_chroma_histogram_cuda(*planes, *cuts, batch_limit=7),
         lambda: ccc.log_chroma_histogram_plain(*planes, *cuts), {"ccc_histogram": 3})
    hist = ccc.log_chroma_histogram_cuda(*planes, *cuts)
    case("ccc_response_cuda 20 x 256x256, batch_limit 7",
         lambda: ccc.ccc_response_cuda(hist, *filt, batch_limit=7),
         lambda: ccc.ccc_response_plain(hist, *filt), {"ccc_response": 3}, exact=False)
    planes = [rand((20, 91, 117)) for _ in range(3)]
    for mode in ("float", "lerp"):
        maps = [undistortion.remap_precompute(*workloads.hostile_maps((91, 117), (91, 117), s),
                                              (91, 117), mode=mode) for s in (3, 4)]
        base, weights = (torch.as_tensor(np.stack([m[i] for m in maps]), device=dev)
                         for i in (0, 1))
        if mode == "float":
            def call():
                return undistortion.remap_float_cuda(planes, base, weights, (91, 117),
                                                     batch_limit=7)
        else:
            def call():
                return undistortion.remap_lerp_cuda(planes, base, weights, (91, 117), mode=mode,
                                                    batch_limit=7)
        case(f"remap_{mode}_cuda 2 cameras x 10 x 91x117, batch_limit 7", call,
             lambda: undistortion.remap_planes(planes, base, weights, (91, 117), mode,
                                               plain=True),
             {f"remap_{mode}": 4})


def check_ops(tp, torch, rng, smi_line):
    """Phase ops: the reference package's entry points that reach a kernel,
    called as its users call them on [..., H, W(, 3)] CUDA frames, at
    1080x1920 with leading dims (4,) and at a random odd crop with leading
    dims OPS_CROP_LEAD: debayer bilinear (A) and MHT (D) in the four
    encodings and of the four 16-bit encodings (P; its planar path the
    chain's u8 planes, each value >> 8), resize_linear_u8 (H) to 270x360,
    log_chroma_histogram and log_chroma_histogram_rt (B) on that resize,
    ccc_response (C) on those histograms, response_argmax (I) of the responses, estimate_illuminant
    (H, B, C, I) and ccc_balance_white (and J; two calls, the state
    carried: bytes and state against plain=True), and
    remap_bilinear_u8 in float (E), lerp and fixed32 mode (F) with one map
    and with per-camera maps (four at 1080x1920, the multicamera chain's;
    two at the crop), and kernel G's steps one at a time:
    color_calibration.color_correct (a seeded matrix and bias),
    vignetting.correct (the frame's vignetting mask) and
    color_enhancer.enhance (gains 1.1, 1.2, 0.9); the statistical white
    balances (K, M, L for learned, then G's table step):
    white_balance.balance_white_simple (p 20), _grey_world (0.8), _pca and
    learned_wb.balance_white_learned_model (0.8); gamma.apply_lut (G's
    table step on one plane) with the 0.7 gamma table; and flip.flip (N)
    at 90, 180 and 270 (against flip_rows on the planes).
    Each is held against the same call with plain=True on the card and
    against the planar path the chain runs (debayer_planes, resize_planes,
    log_chroma_histogram_planes, ccc_response on [B, 256, 256],
    response_argmax_cuda on [B, 256, 256],
    remap_planes, pointwise_planes, white_balance.balance_white_planes):
    0 mismatching bytes (f32 values for the histograms; for
    ccc_response the argmax, and the values against the plain version
    within 1e-4 of max |response| as phase 1 holds kernel C). One line per
    function with its device time. Returns each kernel's launches in the
    entry points' calls (the comparisons not counted)."""
    import dataclasses
    import itertools

    import numpy as np

    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model
    from raw_image_pipeline_tpu_torch.ops import (
        ccc,
        color_calibration,
        color_enhancer,
        debayer,
        flip,
        gamma,
        learned_wb,
        pointwise,
        undistortion,
        vignetting,
        white_balance,
    )
    from raw_image_pipeline_tpu_torch.ops.resize import resize_linear_u8, resize_planes
    from raw_image_pipeline_tpu_torch.ops.vignetting import build_vignetting_mask
    from raw_image_pipeline_tpu_torch.parallel import build_multicamera_pipeline
    from raw_image_pipeline_tpu_torch.tools import workloads
    from raw_image_pipeline_tpu_torch.tools.measure import device_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(1 << 31)))
    g16 = torch.Generator(device=dev)
    g16.manual_seed(workloads.SEED + 16)
    cc = tuple(torch.as_tensor(a.astype("float32"), device=dev)
               for a in (rng.uniform(-0.6, 1.6, (3, 3)), rng.uniform(-20, 20, 3)))
    enh_gains = (1.1, 1.2, 0.9)
    crop = (2 * int(rng.integers(100, 540)) + 1, 2 * int(rng.integers(100, 960)) + 1)
    launches = {k.name: 0 for k in kernels.ALL}
    cfg = tp.flagship_config(1080, 1920).white_balance
    model = load_ccc_model(cfg.ccc_model_path)
    filt = tuple(torch.as_tensor(a, device=dev)
                 for a in (model.filt_dft_re, model.filt_dft_im, model.bias))
    cuts = tuple(float(np.float32(v)) for v in (255.0 * cfg.saturation_bright_thr,
                                                255.0 * cfg.saturation_dark_thr, cfg.ccc_uv0))

    def counted(call):
        kernels.reset_launch_counts()
        out = call()
        torch.cuda.synchronize()
        for k in kernels.ALL:
            launches[k.name] += k.launches
        return out

    def report(label, bad, ms, note=""):
        print(f"ops {label}: {bad} mismatching bytes against plain=True and the planar path"
              f"{note}; {ms:.4f} ms on the device [{smi_line}]")
        if bad:
            raise AssertionError(f"ops {label}: {bad} mismatching bytes")

    def planes_of(x):  # [..., H, W, 3] -> three contiguous [N, H, W] planes
        flat = x.reshape((-1,) + tuple(x.shape[-3:]))
        return [flat[..., c].contiguous() for c in range(3)]

    def remap_maps(hw, cameras, mode="float"):
        """(base, weights) in `mode`: the flagship's fisheye map remapping
        in that mode, or the multicamera chain's four per-camera maps, at
        1080x1920; hostile maps (one, or one per camera stacked) at the
        crop."""
        if hw == (1080, 1920):
            if cameras == 1:
                config = tp.flagship_config(*hw)
            else:
                config = workloads.multicam_chains(tp)["multicam4"].config(*hw)
            config = config.replace(undistortion=dataclasses.replace(config.undistortion,
                                                                     interpolation=mode))
            if cameras == 1:
                p = tp.make_params(config, hw, device=dev)
            else:
                p = build_multicamera_pipeline(
                    config, workloads.multicam_calibrations(config.calibration), "bayer_gbrg8",
                    hw, device="cuda").params
            return p.remap_base, p.remap_weights
        maps = [undistortion.remap_precompute(*workloads.hostile_maps(hw, hw, 7 + c), hw,
                                              mode=mode) for c in range(cameras)]
        stack = (lambda a: a[0]) if cameras == 1 else np.stack
        return (torch.as_tensor(stack([m[k] for m in maps]), device=dev) for k in (0, 1))

    for lead, hw in (((4,), (1080, 1920)), (OPS_CROP_LEAD, crop)):
        size = f"{'x'.join(map(str, lead))} x {hw[0]}x{hw[1]}"
        bayer = torch.randint(0, 256, lead + hw, generator=g, device=dev, dtype=torch.uint8)
        flat = bayer.reshape((-1,) + hw)
        for algorithm in ("bilinear", "mht"):
            bad = 0
            for enc in debayer.BAYER_ENCODINGS:
                got = counted(lambda: debayer.debayer(bayer, enc, algorithm))
                bad += int((got != debayer.debayer(bayer, enc, algorithm, plain=True)).sum())
                planar = torch.stack(debayer.debayer_planes(flat, enc, algorithm), dim=-1)
                bad += int((got != planar.reshape(got.shape)).sum())
            ms = device_ms(lambda: debayer.debayer(bayer, "bayer_gbrg8", algorithm))
            report(f"debayer {algorithm} {size} in 4 encodings", bad, ms)
        # the 16-bit encodings (P in u16 mode; the planar path, the chain's,
        # in u8 mode: the values >> 8), from a generator of their own
        bayer16 = torch.randint(0, 65536, lead + hw, generator=g16, device=dev,
                                dtype=torch.int32).to(torch.int16).view(torch.uint16)
        bad = 0
        for enc in debayer.BAYER16_ENCODINGS:
            got = counted(lambda: debayer.debayer(bayer16, enc))
            want = debayer.debayer(bayer16, enc, plain=True)
            bad += int((got.view(torch.int16) != want.view(torch.int16)).sum())
            planar = torch.stack(debayer.debayer16_planes(bayer16.reshape((-1,) + hw), enc), -1)
            high = (got.view(torch.int16).to(torch.int32) & 0xffff) >> 8
            bad += int((high != planar.reshape(got.shape)).sum())
        report(f"debayer bilinear16 {size} in 4 encodings", bad,
               device_ms(lambda: debayer.debayer(bayer16, "bayer_gbrg16")))
        del bayer16
        bgr = debayer.debayer(bayer, "bayer_gbrg8")
        small = counted(lambda: resize_linear_u8(bgr, ccc.SMALL_H, ccc.SMALL_W))
        bad = int((small != resize_linear_u8(bgr, ccc.SMALL_H, ccc.SMALL_W, plain=True)).sum())
        planar = torch.stack(resize_planes(planes_of(bgr), hw[0], ccc.SMALL_H, ccc.SMALL_W), -1)
        bad += int((small != planar.reshape(small.shape)).sum())
        report(f"resize_linear_u8 {size} -> {ccc.SMALL_H}x{ccc.SMALL_W}", bad,
               device_ms(lambda: resize_linear_u8(bgr, ccc.SMALL_H, ccc.SMALL_W)))
        planar_hist = ccc.log_chroma_histogram_planes(*planes_of(small), *cuts).reshape(
            lead + (ccc.HIST_N, ccc.HIST_N))
        thr = (cfg.saturation_bright_thr, cfg.saturation_dark_thr, cfg.ccc_uv0)
        for name, fn, args in (("log_chroma_histogram", ccc.log_chroma_histogram, thr),
                               ("log_chroma_histogram_rt", ccc.log_chroma_histogram_rt, cuts)):
            hist = counted(lambda: fn(small, *args))
            bad = int((hist != fn(small, *args, plain=True)).sum())
            bad += int((hist != planar_hist).sum())
            report(f"{name} {size} on the {ccc.SMALL_H}x{ccc.SMALL_W} resize", bad,
                   device_ms(lambda: fn(small, *args)))
        resp = counted(lambda: ccc.ccc_response(hist, *filt))
        want = ccc.ccc_response(hist, *filt, plain=True)
        err, scale = float((resp - want).abs().max()), float(want.abs().max())
        bad = int((ccc.response_argmax(resp) != ccc.response_argmax(want)).sum())
        flat_resp = ccc.ccc_response_cuda(hist.reshape(-1, ccc.HIST_N, ccc.HIST_N).contiguous(),
                                          *filt)
        bad += int((resp != flat_resp.reshape(resp.shape)).sum())
        report(f"ccc_response {size}", bad + int(err > 1e-4 * scale),
               device_ms(lambda: ccc.ccc_response(hist, *filt)),
               f" (argmax against plain=True; max |diff| {err:.3e}, limit {1e-4 * scale:.3e})")
        uv = counted(lambda: ccc.response_argmax(resp))
        bad = int((uv != ccc.response_argmax(resp, plain=True)).sum())
        bad += int((uv != ccc.response_argmax_cuda(flat_resp).reshape(uv.shape)).sum())
        report(f"response_argmax {size}", bad, device_ms(lambda: ccc.response_argmax(resp)))
        got = counted(lambda: ccc.estimate_illuminant(bgr, model))
        bad = int((got != ccc.estimate_illuminant(bgr, model, plain=True)).sum())
        bad += int((got != uv).sum())
        report(f"estimate_illuminant {size}", bad,
               device_ms(lambda: ccc.estimate_illuminant(bgr, model)))
        state = want_state = ccc.kalman_init(lead, device=dev)
        bad = 0
        for _ in range(2):  # the state carried
            img, state = counted(lambda: ccc.ccc_balance_white(bgr, model, state=state))
            want, want_state = ccc.ccc_balance_white(bgr, model, state=want_state, plain=True)
            bad += int((img != want).sum()) + sum(
                int((getattr(state, f) != getattr(want_state, f)).sum())
                for f in ("x", "p", "initialized"))
        report(f"ccc_balance_white {size}, two calls, the state carried", bad,
               device_ms(lambda: ccc.ccc_balance_white(bgr, model, state=state)))
        for mode, cameras in itertools.product(("float", "lerp", "fixed32"),
                                               (1, 4 if len(lead) == 1 else lead[0])):
            base, weights = remap_maps(hw, cameras, mode)
            img = bgr.reshape((-1,) + hw + (3,)) if cameras > 1 else bgr

            def remap(**kw):
                return undistortion.remap_bilinear_u8(img, base, weights, hw, hw,
                                                      n_cameras=cameras, mode=mode, **kw)

            got = counted(remap)
            bad = int((got != remap(plain=True)).sum())
            planar = undistortion.remap_planes(planes_of(img), base, weights, hw, mode)
            bad += int((got != planar.reshape(got.shape)).sum())
            report(f"remap_bilinear_u8 {mode} {size}, {cameras} map(s)", bad, device_ms(remap))
        # kernel G's steps one at a time, on NHWC frames
        mask = torch.as_tensor(build_vignetting_mask(*hw, 1.5, 1e-3, 1e-6), device=dev)
        for name, fn, args, steps in (
                ("color_calibration.color_correct", color_calibration.color_correct, cc,
                 dict(matrix=cc[0], bias=cc[1])),
                ("vignetting.correct", vignetting.correct, (mask,), dict(mask=mask)),
                ("color_enhancer.enhance", color_enhancer.enhance, (enh_gains,),
                 dict(enhancer_tables=torch.as_tensor(color_enhancer.gain_tables(enh_gains),
                                                      device=dev)))):
            got = counted(lambda: fn(bgr, *args))
            bad = int((got != fn(bgr, *args, plain=True)).sum())
            planar = torch.stack(pointwise.pointwise_planes(*planes_of(bgr), **steps), dim=-1)
            bad += int((got != planar.reshape(got.shape)).sum())
            report(f"{name} {size}", bad, device_ms(lambda: fn(bgr, *args)))
        # the statistical white balances (kernels K, M, L for learned, and G's
        # table step) and the LUT (G's table step on one plane)
        for name, fn, method, param in (
                ("white_balance.balance_white_simple", white_balance.balance_white_simple,
                 "simple", 20.0),
                ("white_balance.balance_white_grey_world",
                 white_balance.balance_white_grey_world, "grey_world", 0.8),
                ("white_balance.balance_white_pca", white_balance.balance_white_pca, "pca", None),
                ("learned_wb.balance_white_learned_model", learned_wb.balance_white_learned_model,
                 "learned", 0.8)):
            args = () if param is None else (param,)
            got = counted(lambda: fn(bgr, *args))
            bad = int((got != fn(bgr, *args, plain=True)).sum())
            planar = torch.stack(white_balance.balance_white_planes(planes_of(bgr), method, param),
                                 dim=-1)
            bad += int((got != planar.reshape(got.shape)).sum())
            report(f"{name} {size}", bad, device_ms(lambda: fn(bgr, *args)))
        lut = torch.as_tensor(gamma.build_gamma_lut(0.7), device=dev)
        got = counted(lambda: gamma.apply_lut(bgr, lut))
        bad = int((got != gamma.apply_lut(bgr, lut, plain=True)).sum())
        planar = torch.stack(pointwise.pointwise_planes(*planes_of(bgr), lut=lut), dim=-1)
        bad += int((got != planar.reshape(got.shape)).sum())
        report(f"gamma.apply_lut {size}", bad, device_ms(lambda: gamma.apply_lut(bgr, lut)))
        for angle in (90, 180, 270):
            got = counted(lambda: flip.flip(bgr, angle))
            bad = int((got != flip.flip(bgr, angle, plain=True)).sum())
            planar = torch.stack(flip.flip_rows(planes_of(bgr), angle), dim=-1)
            bad += int((got != planar.reshape(got.shape)).sum())
            report(f"flip.flip {angle} {size}", bad, device_ms(lambda: flip.flip(bgr, angle)))
        del bayer, flat, bgr, small
    torch.cuda.empty_cache()
    check_ops_contract(torch, g, launches, remap_maps, filt, cuts, thr, smi_line)
    torch.cuda.empty_cache()
    print(f"ops launches of the entry points' calls: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"ops: a kernel was not launched: {launches}")
    kernels.reset_launch_counts()
    return launches


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
            outs, state = _run_chain(pipe, frames, tp.init_state((), device="cuda"), ch.calls)
            torch.cuda.synchronize()
            if main_run:
                peak[name] = torch.cuda.max_memory_allocated()
                counts = {k.name: k.launches for k in kernels.ALL}
                print(f"{label} kernel launches: {counts}")
                if not all(counts[k] >= ch.calls for k in ch.kernels):
                    raise AssertionError(f"{label}: a kernel of the path was not launched in "
                                         f"each of its {ch.calls} calls: {counts}, expected "
                                         f"{ch.kernels}")
                for k in ch.kernels:
                    launches.setdefault(k, counts[k])
                if name == "flagship":  # grids on the device, per call
                    per_flagship_call = {k.name: k.launches * k.grids / ch.calls
                                         for k in kernels.ALL}
            ref, ref_state = _run_chain(plain, frames, tp.init_state((), device="cuda"), ch.calls)
            want = (ch.frames // ch.calls, *_out_hw(config, h, w)) + (
                () if ch.kind == "mono" else (3,))
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
                _run_chain(call, frames, tp.init_state((), device="cuda"), ch.calls)
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
    out, _ = pipe(frames[:n].cpu(), tp.init_state((), device="cpu"))
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
        out, st = pipe(frames, tp.init_state((), device="cuda"))
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
    all four cameras, F or E once with its four maps). Each run must equal
    (i) the plain-op multicamera chain and (ii) four single-camera chains
    (build_pipeline), each camera's block with its own calibration, bytes
    and Kalman state per camera; (iii) four equal calibrations must give
    one flat map, and F or E a launch with cameras=1, equal to the plain
    chain.
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
            state = (multicamera_state(cams, per, mode, device="cuda") if cameras > 1 else
                     tp.init_state(() if mode == "sequence" else (per,), device="cuda"))
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
        remap = kernels.REMAP_FLOAT if "remap_float" in ch.kernels else kernels.REMAP_LERP
        launch = remap.launch
        remap.launch = lambda *a: (cameras_arg.append(a[6]), launch(*a))[1]
        try:
            outs, state = run(shared.fn, shared.params, "sequence")
        finally:
            del remap.launch  # the class's method again
        plain_fn = make_isp_fn(config, enc, True, False, temporal_mode="sequence",
                               remap_src_hw=src, n_cameras=cams, plain=True)
        ref, ref_state = run(plain_fn, shared.params, "sequence")
        bad = sum(int((a != b).sum()) for a, b in zip(outs, ref))
        flat = shared.params.remap_base.dim() == 1
        print(f"multicamera {name} with four equal calibrations: one flat map {flat} "
              f"{tuple(shared.params.remap_base.shape)}, kernel {remap.name} launched with cameras="
              f"{cameras_arg}; {bad} mismatching bytes vs the plain-op chain, Kalman state equal: "
              f"{_same_state(torch, state, ref_state)}")
        if (not flat or bad or not _same_state(torch, state, ref_state) or not cameras_arg
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
    if count != n or any(counts[k] != batches for k in ("flip", "debayer_bilinear")
                         + workloads.CCC_KERNELS + ("pointwise", "remap_lerp")):
        raise AssertionError("stream: frames or launches wrong")
    pipe = tp.build_pipeline(config, "bayer_gbrg8", (h, w), with_state=True,
                             keep_intermediates=True, temporal_mode="sequence", device="cuda")
    state = tp.init_state((), device="cuda")
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
        st = tp.init_state((), device="cuda")
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
            out, st = pipe(torch.as_tensor(frames, device=dev), tp.init_state((), device=dev))
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
            p = make_params(config, (h, w), device="cuda")
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
            # G applies the CCC gains: the profile runs no other pointwise step
            path_kernels = ("flip", "debayer_bilinear") + workloads.CCC_KERNELS + ("pointwise",) + (
                ("remap_float",) if mode == "float" else ("remap_lerp",))
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
    timings = step("stage_timings", lambda: stage_timings(
        tp.flagship_config(1080, 1920), "bayer_gbrg8", px, None, 5, device="cuda"))
    out["stage_timings_ms"] = {k: v * 1e3 for k, v in timings.items()}
    print("tools stage_timings flagship 1920x1080 B=4, ms (least of 5 calls, cumulative "
          "differences): " + ", ".join(f"{k} {v:.3f}" for k, v in out["stage_timings_ms"].items()))
    return out


MESH_CARD = "cuda:0"
MESH_CHAINS = (  # (chain, [(data, space)], temporal modes) of the mesh phase
    ("flagship", ((2, 2), (1, 4)), ("sequence", "cameras")),
    ("float", ((1, 4),), ("sequence",)),
    ("gpu_parity", ((1, 4),), ("sequence",)),
)
MESH_STREAM_FRAMES = 12  # 3 batches of 4 through StreamRunner over (2, 1)


def _pod_bench(root, argv, ranks):
    """tools/pod_bench.py as `ranks` processes (gloo on one card when 2),
    each with its own timeout. Returns [(returncode, stdout, stderr)]."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    cmd = [sys.executable, "-m", "raw_image_pipeline_tpu_torch.tools.pod_bench", *argv]
    if ranks > 1:
        cmd += ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(ranks)]
    procs = [subprocess.Popen(cmd + (["--process-id", str(i)] if ranks > 1 else []), cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(ranks)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def check_mesh(tp, torch, np, root, smi_line):
    """Phase 5: the mesh (parallel/) on the one card, every shard a logical
    shard on cuda:0: the flagship at 1920x1080, B=4 a call, over (data 2,
    space 2) and (1, 4) in both temporal modes, 2 calls with the state
    carried; the float (E) and gpu_parity (D) chains over (1, 4); multicam4
    over data 2; StreamRunner over (2, 1). The launch counts are set to 0
    just before each sharded run and read just after: every kernel of the
    chain must have launched inside it (A/D and C once per shard and call,
    B once per shard and call, F or E once per shard and call). Each sharded
    output and state, and the unsharded call's on the card, must equal the
    plain-op unsharded chain on the card on the same frames byte for byte,
    so the kernels are held against their plain versions at the shards'
    shapes (halo'd slabs, per-slab counts, rebased windows). Then tools/pod_bench.py at 1920x1080, batch 4 a device, as one
    process and as two gloo processes on cuda:0 (and NCCL on two ranks of
    one card must refuse). Frames/s are logical shards on one card, not a
    scaling figure. Returns the numbers of the mesh JSON line."""
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.parallel import (
        build_multicamera_pipeline,
        make_mesh,
        multicamera_state,
    )
    from raw_image_pipeline_tpu_torch.pipeline import _post_flip_shape, make_isp_fn
    from raw_image_pipeline_tpu_torch.runtime.stream import StreamRunner
    from raw_image_pipeline_tpu_torch.tools import workloads

    h, w = 1080, 1920
    enc = "bayer_gbrg8"
    per, calls = workloads.FRAMES // workloads.CALLS, workloads.CALLS
    table = workloads.chains(tp)
    launches, fps, windows = {}, {}, {}
    label = f"logical shards on one card, not a scaling figure; {smi_line}"

    def run(pipe, frames, state, sharded):
        outs = []
        for c in range(calls):
            out, state = pipe(frames[c * per:(c + 1) * per], state)
            outs.append(out["processed"].gather(MESH_CARD) if sharded else out["processed"])
        return outs, state

    for name, layouts, modes in MESH_CHAINS:
        ch = table[name]
        config = ch.config(h, w)
        frames = workloads.card_frames(torch, "bayer", per * calls, h, w,
                                       workloads.SEED + 90 + len(name))
        for mode in modes:
            shape = () if mode == "sequence" else (per,)
            whole = tp.build_pipeline(config, enc, (h, w), with_state=True, temporal_mode=mode,
                                      device=MESH_CARD)
            plain_fn = make_isp_fn(config, enc, True, False, temporal_mode=mode, plain=True)
            ref, ref_state = run(lambda px, st: plain_fn(whole.params, px, st), frames,
                                 tp.init_state(shape, device=MESH_CARD), False)
            one, one_state = run(whole, frames, tp.init_state(shape, device=MESH_CARD), False)
            bad = sum(int((a != b).sum()) for a, b in zip(one, ref))
            same = _same_state(torch, one_state, ref_state)
            print(f"mesh {name} {mode} {w}x{h} B={per} x {calls} calls, unsharded: {bad} "
                  f"mismatching bytes vs the plain-op chain, Kalman state equal: {same}")
            if bad or not same:
                raise AssertionError(f"mesh {name} {mode}: the unsharded call differs")
            del one
            for data, space in layouts:
                mesh = make_mesh([MESH_CARD] * (data * space), space=space)
                pipe = tp.build_pipeline(config, enc, (h, w), with_state=True,
                                         temporal_mode=mode, mesh=mesh)
                if name == "flagship" and mode == "sequence":
                    windows[f"space{space}"] = [pipe.shard_params[(0, s)].remap_window
                                                for s in range(space)]
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                outs, state = run(pipe, frames, tp.init_state(shape, device=MESH_CARD), True)
                torch.cuda.synchronize()
                counts = {k.name: k.launches for k in kernels.ALL}
                key = f"{name} ({data}, {space}) {mode}"
                launches[key] = counts
                bad = sum(int((a != b).sum()) for a, b in zip(outs, ref))
                same = _same_state(torch, state, ref_state)
                print(f"mesh {key} {w}x{h} B={per} x {calls} calls: {bad} mismatching bytes "
                      f"vs the plain-op unsharded chain, Kalman state equal: {same}; launches "
                      f"{counts}")
                want = data * space * calls  # every shard holds frames and rows
                if bad or not same or any(counts[k] != want for k in ch.kernels):
                    raise AssertionError(f"mesh {key}: differs or a kernel of {ch.kernels} "
                                         f"did not launch {want} times")
                if name == "flagship" and mode == "sequence":
                    def timed(p, sharded):
                        st = tp.init_state((), device=MESH_CARD)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        run(p, frames, st, sharded)
                        torch.cuda.synchronize()
                        return per * calls / (time.perf_counter() - t0)

                    fps[f"({data}, {space})"] = statistics.median(timed(pipe, True)
                                                                  for _ in range(3))
                    fps["unsharded"] = statistics.median(timed(whole, False) for _ in range(3))
                    print(f"mesh flagship {w}x{h} frames/s ({data}, {space}): "
                          f"{fps[f'({data}, {space})']:.2f}, unsharded: {fps['unsharded']:.2f} "
                          f"(host clock over {per * calls} frames in {calls} calls, median of "
                          f"3; {label})")
            del whole, ref
        del frames
        torch.cuda.empty_cache()
    print(f"mesh flagship {w}x{h} remap windows (source rows [start, stop) per output slab): "
          f"{windows}")

    # multicam4: the four cameras over data 2
    ch = workloads.multicam_chains(tp)["multicam4"]
    config = ch.config(h, w)
    calibs = workloads.multicam_calibrations(config.calibration)
    cams = len(calibs)
    src = _post_flip_shape(h, w, config.flip.angle if config.flip.enabled else 0)
    frames = workloads.card_frames(torch, "bayer", cams * per, h, w,
                                   workloads.SEED + 95).view(cams, per, h, w)
    for mode in ("sequence", "cameras"):
        whole = build_multicamera_pipeline(config, calibs, enc, (h, w), True, mode,
                                           device=MESH_CARD)
        pipe = build_multicamera_pipeline(config, calibs, enc, (h, w), True, mode,
                                          mesh=make_mesh([MESH_CARD] * 2))
        plain_fn = make_isp_fn(config.replace(calibration=calibs[0]), enc, True, False,
                               temporal_mode=mode, remap_src_hw=src, n_cameras=cams, plain=True)
        ref, ref_state = plain_fn(whole.params, frames,
                                  multicamera_state(cams, per, mode, device=MESH_CARD))
        one, one_state = whole(frames, multicamera_state(cams, per, mode, device=MESH_CARD))
        bad_one = int((one["processed"] != ref["processed"]).sum())
        same_one = _same_state(torch, one_state, ref_state)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out, state = pipe(frames, multicamera_state(cams, per, mode, device=MESH_CARD))
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in kernels.ALL}
        launches[f"multicam4 (2, 1) {mode}"] = counts
        bad = int((out["processed"].gather(MESH_CARD) != ref["processed"]).sum())
        same = _same_state(torch, state, ref_state)
        print(f"mesh multicam4 {cams} cameras x B={per} over data 2 ({mode}): {bad} mismatching "
              f"bytes vs the plain-op unsharded chain, Kalman state equal: {same}; launches "
              f"{counts}; the unsharded call: {bad_one} mismatching bytes, state equal: "
              f"{same_one}")
        if (bad or not same or bad_one or not same_one
                or any(counts[k] != 2 for k in ch.kernels)):
            raise AssertionError(f"mesh multicam4 ({mode}) differs or a kernel did not launch")
    del frames, whole, pipe, out, ref, one
    torch.cuda.empty_cache()

    # StreamRunner over (2, 1) and on the card alone, against the plain-op
    # chain on the same batches, the state carried
    config = tp.flagship_config(h, w)
    n = MESH_STREAM_FRAMES
    frames = workloads.card_frames(torch, "bayer", n, h, w, workloads.SEED + 96).cpu().numpy()
    plain_fn = make_isp_fn(config, enc, True, True, temporal_mode="sequence", plain=True)
    params = tp.make_params(config, (h, w), device=MESH_CARD)
    want, want_state = {}, tp.init_state((), device=MESH_CARD)
    for s in range(0, n, per):
        out, want_state = plain_fn(params, torch.as_tensor(frames[s:s + per], device=MESH_CARD),
                                   want_state)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for i in range(out["processed"].shape[0]):
            for stream, key in (("color", "dist_color"), ("color_rect", "processed"),
                                ("debayered", "debayered")):
                want[(stream, s + i)] = out[key][i]
    got = {}
    for key, kw in (("one", {"device": MESH_CARD}),
                    ("mesh", {"mesh": make_mesh([MESH_CARD] * 2)})):
        runner = StreamRunner(config, enc, (h, w), batch_size=per, **kw)
        images = {}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        runner.run(iter(frames), lambda s, i, img: images.setdefault((s, i), img))
        torch.cuda.synchronize()
        got[key] = images, runner.state, {k.name: k.launches for k in kernels.ALL}
    launches["stream (2, 1)"] = counts = got["mesh"][2]
    res = {key: (sum(int((images[k] != want[k]).sum()) for k in want), set(images) == set(want),
                 _same_state(torch, st, want_state)) for key, (images, st, _) in got.items()}
    print(f"mesh StreamRunner(batch_size={per}) over (2, 1), {n} frames {w}x{h}: "
          f"{len(got['mesh'][0])} images; (mismatching bytes vs the plain-op chain, the same "
          f"images, Kalman state equal): over the mesh {res['mesh']}, without a mesh "
          f"{res['one']}; launches {counts}")
    if (any(bad or not images or not same for bad, images, same in res.values())
            or counts["debayer_bilinear"] != 2 * n // per):
        raise AssertionError("mesh StreamRunner differs")
    del got, want, frames
    torch.cuda.empty_cache()

    # pod_bench: one process, two gloo ranks on the card; NCCL must refuse
    bench = {}
    argv = ["--height", str(h), "--width", str(w), "--batch-per-device", "4",
            "--k-dispatch", "3", "--rounds", "3"]
    for ranks, extra in ((1, []), (2, ["--backend", "gloo"])):
        outs = _pod_bench(root, argv + extra, ranks)
        for rc, out, err in outs:
            if rc != 0:
                raise AssertionError(f"pod_bench ({ranks} ranks) failed rc={rc}: {err[-2000:]}")
        line = json.loads(outs[0][1].strip().splitlines()[-1])
        if line["processes"] != ranks or any("pod_scaling" in o for _, o, _ in outs[1:]):
            raise AssertionError(f"pod_bench ({ranks} ranks): {line}")
        bench[f"{ranks}_ranks"] = line
        print(f"mesh pod_bench {ranks} rank(s) on {MESH_CARD}: {json.dumps(line)} ({label})")
    refused = _pod_bench(root, argv + ["--backend", "nccl"], 2)
    msgs = [err for rc, _, err in refused if rc != 0 and "NCCL cannot run ranks" in err]
    print(f"mesh pod_bench 2 NCCL ranks on one card: refused by {len(msgs)} of 2 ranks")
    if len(msgs) != 2:
        raise AssertionError("NCCL on two ranks of one card did not refuse: "
                             + " | ".join(err[-500:] for _, _, err in refused))
    return {"launches": launches, "flagship_frames_per_s": fps, "remap_windows": windows,
            "pod_bench": bench}


# tools/bench.py's run in the bench phase: full sizes, fewer repeats
BENCH_ARGV = ("--repeats", "2", "--rounds", "1", "--cpu-iters", "3")
BENCH_CHECKS = ("kernel_debayer_check", "ccc_response_precision_check",
                "kernel_histogram_check", "colorcal_semantics_check")


def check_bench(torch, root):
    """Phase 6: the port's benchmark program (tools/bench.py, the root
    bench.py's counterpart) in a process of its own at its full sizes with
    BENCH_ARGV's cut repeats: it must exit 0, its four checks must read 0,
    its last line must carry every key of bench.py's headline plus cpu_fps,
    device and card, and the kernels of each chain it ran must have
    launched in that chain's run (its counts are set to 0 just before each
    and read just after). Prints the headline line."""
    import gc

    from raw_image_pipeline_tpu_torch.tools import bench, workloads

    gc.collect()
    torch.cuda.empty_cache()  # the card's memory for the child's 128-frame batches
    print(f"bench: this process holds {torch.cuda.memory_reserved()} bytes of the card")
    res = subprocess.run([sys.executable, "-m", "raw_image_pipeline_tpu_torch.tools.bench",
                          *BENCH_ARGV], cwd=root, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise AssertionError(f"tools/bench.py exited {res.returncode}: {res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    details, head = json.loads(lines[-2]), json.loads(lines[-1])
    missing = set(bench.HEADLINE_KEYS + ("cpu_fps", "device", "card")) - set(head)
    if missing:
        raise AssertionError(f"tools/bench.py's last line lacks {sorted(missing)}: {head}")
    if details["checks"] != dict.fromkeys(BENCH_CHECKS, 0):
        raise AssertionError(f"tools/bench.py's checks: {details['checks']}")
    flagship = ("debayer_bilinear",) + workloads.CCC_KERNELS + ("pointwise", "remap_lerp")
    runs = {"headline": (details["headline"]["launches"], flagship)}
    for key, row in details["configs"].items():
        # config 1 runs its gamma table through G, config 2 its grey-world
        # white balance through K, M and G's table step, config 4 is G alone
        want = flagship if key.startswith(("config3", "config5", "config6")) else {
            "config1": ("debayer_bilinear", "pointwise"), "config4": ("pointwise",),
            "config2": ("debayer_bilinear", "wb_stats", "wb_tables", "pointwise")}.get(
            key.split("_")[0], flagship[:1])
        runs[key] = (row["launches"], want)
    for run, (launches, want) in runs.items():
        idle = [k for k in want if not launches[k] > 0]
        if idle:
            raise AssertionError(f"tools/bench.py's {run}: {idle} not launched ({launches})")
    for key, row in details["configs"].items():
        print(f"bench {key}: peak {row['peak_device_bytes']} bytes, launches {row['launches']}")
    print(f"bench headline peak bytes {details['headline']['peak_device_bytes']}, "
          f"launches {details['headline']['launches']}")
    print(lines[-1])
    return head


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
        # its own generator: the later phases' inputs stay what they were
        rows.update(phase("ccc_range", check_ccc_range, tp, torch,
                          np.random.default_rng(workloads.SEED + 2), root, smi_line))
        wb = phase("wb_range", check_wb_range, tp, torch,
                   np.random.default_rng(workloads.SEED + 3), smi_line)
        rows.update({k: wb[k] for k in ("K", "L", "M", "O")})
        rows["G"].update(wb["G_table"])
        # its own generator: the later phases' inputs stay what they were
        ops_launches = phase("ops", check_ops, tp, torch,
                             np.random.default_rng(workloads.SEED + 1), smi_line)
        launches, per_flagship_call, fps, peak = phase("chains", check_chains, tp, torch, rng)
        phase("microbatch", check_microbatch, tp, torch, rng)
        multicam_fps = phase("multicamera", check_multicam, tp, torch)
        stream_fps = phase("stream", check_stream, tp, torch, np, root)
        phase("small", check_small, tp, torch, np)
        phase("api", check_api, tp, torch, np)
        tools = phase("tools", check_tools, tp, torch, np, root)
        mesh = phase("mesh", check_mesh, tp, torch, np, root, smi_line)
        phase("bench", check_bench, torch, root)
    except Exception as e:  # the smoke test's boundary: report and fail
        import traceback

        traceback.print_exc()
        return _fail(repr(e))

    names = {"A": kernels.DEBAYER_BILINEAR, "B": kernels.CCC_HISTOGRAM,
             "C": kernels.CCC_RESPONSE, "D": kernels.DEBAYER_MHT, "E": kernels.REMAP_FLOAT,
             "F": kernels.REMAP_LERP, "G": kernels.POINTWISE, "H": kernels.CCC_RESIZE,
             "I": kernels.CCC_ARGMAX, "J": kernels.CCC_TRACK, "K": kernels.WB_STATS,
             "L": kernels.WB_HIST64, "M": kernels.WB_TABLES, "N": kernels.FLIP,
             "O": kernels.LUT, "P": kernels.DEBAYER_BILINEAR16}
    print(json.dumps({"chain_frames_per_s": [
        {"chain": name, "size": size, "kernels": a, "plain": b}
        for (name, size), (a, b) in fps.items()],
        "peak_device_bytes_1920x1080": peak,
        "multicam_frames_per_s": [
            {"chain": name, "size": "1920x1080", "cameras": len(workloads.MULTICAM_SCALES),
             "kernels": a, "four_single_cameras": b} for name, (a, b) in multicam_fps.items()],
        "stream_frames_per_s": {"chain": "flagship", "size": "1920x1080",
                                "runner": stream_fps[0], "bare_calls": stream_fps[1]},
        "tools": tools,
        "wb_isp_white_balance_busy_ms_per_64_frames": wb["wb_busy_ms_b64"]}))
    print(json.dumps({"mesh": mesh, "card": smi_line,
                      "note": "logical shards on one card, not a scaling figure"}))
    # launches: the wrapper's count in the 1920x1080 run of the first chain
    # that runs the kernel (A, B, C, F-J: flagship; D: gpu_parity; E: float;
    # K, M: wb_simple; L: wb_learned; N: flagship; O: mono8; P: bayer16);
    # launches_per_flagship_call: the grids it put on the device per call
    print(f"bound_ms against the H100 SXM's published peaks "
          f"({measure.PEAK_BYTES_PER_S / 1e12} TB/s, {measure.PEAK_F32_FLOP_PER_S / 1e12} "
          f"TFLOP/s f32) on this card: {smi_line}")
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": launches[k.name], "grids_per_launch": k.grids,
         "launches_per_flagship_call": per_flagship_call[k.name],
         "launches_ops": ops_launches[k.name], **rows[key]}
        for key, k in names.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
