"""The chains and seeded inputs that chip_smoke.py and the port's tools run
on a CUDA card: the table of chains (each a configuration, its sizes, its
kernels and its batch), frames made on the card from a seed, hostile remap
maps for kernels E and F with a host model of their tiles, and the
two-peak CCC histogram that holds kernel C's argmax on a near-tie.

This module imports nothing of the package (a chain's configuration is
built from the package module it is given): compare_checkouts.py loads
it beside another checkout's package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SEED = 0
FRAMES, CALLS = 8, 2  # a flagship-family run: 8 frames in 2 calls of B=4
TWO_PEAK_GAP = 1e-5  # the two-peak fixture's relative gap between its peaks
# the reference's launch-file setup of the Alphasense 1.6 MP sensor, relative
# to the repository: pipeline params and calibration
LAUNCH_PROFILE = ("configs/alphasense_launch_profile.yaml",
                  "configs/alphasense_calib_1.6mp_example.yaml")
LAUNCH_PROFILE_HW = (1080, 1440)


# the kernels of the chain's CCC range, in their order: the working resize
# (H), the histogram (B), the response (C), the argmax (I), the track and
# the gains (J)
CCC_KERNELS = ("ccc_resize", "ccc_histogram", "ccc_response", "ccc_argmax", "ccc_track")


class Chain:
    """One chain: its config for (h, w), the full sizes, the kernels it
    runs, its encoding, its input ("bayer", "color", "mono" or "bayer16"),
    the frames and calls of a full-size run, its microbatch, how many timed
    runs give the median, whether it runs at a small size only, and how
    many of its first 1920x1080 frames chip_smoke.py also runs on the CPU."""

    def __init__(self, config, sizes, kernels, encoding="bayer_gbrg8", kind="bayer",
                 frames=FRAMES, calls=CALLS, microbatch=None, reps=5, small_only=False,
                 cpu_frames=0):
        self.config, self.sizes, self.kernels = config, sizes, kernels
        self.encoding, self.kind, self.frames, self.calls = encoding, kind, frames, calls
        self.microbatch, self.reps, self.small_only = microbatch, reps, small_only
        self.cpu_frames = cpu_frames


def chains(tp) -> dict:
    """name -> Chain, the configurations built from the package `tp`."""

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

    def config2(method):
        # BASELINE config 2 (tests/test_baseline_configs.py): debayer, flip
        # 90 and a statistical white balance
        def config(h, w):
            c = tp.PipelineConfig()
            return c.replace(
                flip=dataclasses.replace(c.flip, enabled=True, angle=90),
                white_balance=dataclasses.replace(c.white_balance, enabled=True, method=method,
                                                  clipping_percentile=20.0,
                                                  saturation_bright_thr=0.8),
            )
        return config

    def config4(h, w):
        # BASELINE config 4: colour calibration, vignetting and the HSV
        # enhancer on bgr8 frames
        c = tp.PipelineConfig()
        return c.replace(
            color_calibration=dataclasses.replace(
                c.color_calibration, enabled=True,
                matrix=(1.3, 0.1, -0.1, 0.05, 1.1, -0.05, -0.1, -0.1, 1.4),
                bias=(2.0, 0.0, -1.0)),
            vignetting_correction=dataclasses.replace(c.vignetting_correction, enabled=True,
                                                      scale=1.5, a2=1e-3, a4=1e-6),
            color_enhancer=dataclasses.replace(c.color_enhancer, enabled=True,
                                               saturation_gain=1.2),
        )

    def bayer16(h, w):
        c = tp.flagship_config(h, w)
        return c.replace(debayer=dataclasses.replace(c.debayer, bayer16="scale8"))

    full = ((1080, 1920), (1080, 1440))
    # the flip (N) before the debayer, the CCC range's kernels (H, B, C, I,
    # J), and the pointwise stretch (G) before the remap
    ccc = CCC_KERNELS + ("pointwise",)
    table = {
        "flagship": Chain(tp.flagship_config, full,
                          ("flip", "debayer_bilinear") + ccc + ("remap_lerp",)),
        "gpu_parity": Chain(gpu_parity, full, ("flip", "debayer_mht") + ccc + ("remap_lerp",)),
        "float": Chain(remap("float"), full[:1],
                       ("flip", "debayer_bilinear") + ccc + ("remap_float",)),
        "fixed32": Chain(remap("fixed32"), full[:1],
                         ("flip", "debayer_bilinear") + ccc + ("remap_lerp",)),
    }
    # the flip of the planes (N), the statistical white balances: the
    # statistics (K), learned's histogram (L), the tables (M), G's table step
    for method in ("simple", "grey_world", "pca", "learned"):
        wb = ("wb_stats",) + (("wb_hist64",) if method == "learned" else ()) + ("wb_tables",)
        table[f"wb_{method}"] = Chain(config2(method), full[:1],
                                      ("debayer_bilinear", "flip") + wb + ("pointwise",),
                                      frames=128, calls=2, reps=3, cpu_frames=3)
    table["pointwise_bgr8"] = Chain(config4, full[:1], ("pointwise",), encoding="bgr8",
                                    kind="color",
                                    frames=512, calls=1, microbatch=128, reps=3,
                                    cpu_frames=128)
    # the flagship configuration on mono frames (a mono camera head): its
    # flip (N, 180 of the one plane), the gamma table (O) and the lerp remap
    # (F, one plane); the white balance and the colour stages skip mono
    table["mono8"] = Chain(tp.flagship_config, full[:1], ("flip", "lut", "remap_lerp"),
                           encoding="mono8", kind="mono")
    # the flagship configuration on 16-bit Bayer frames: the debayer (P,
    # straight to the 8-bit planes), then the planes' flip (N), the CCC
    # range, G and the lerp remap
    table["bayer16"] = Chain(bayer16, full, ("debayer_bilinear16", "flip") + ccc
                             + ("remap_lerp",), encoding="bayer_gbrg16", kind="bayer16")
    # small size only: the other inputs on the flagship configuration (mono
    # frames through the float remap = E on one plane)
    table["mono8_float"] = Chain(remap("float"), (), (), encoding="mono8", kind="mono",
                                 small_only=True)
    table["rgb8_float"] = Chain(remap("float"), (), (), encoding="rgb8", kind="color",
                                small_only=True)
    return table


MULTICAM_SCALES = (1.0, 1.02, 0.98, 1.04)  # fx and fy per camera: bench.py's config 5
MULTICAM_BATCH, MULTICAM_CALLS = 4, 2  # frames per camera per call, calls of a run
STREAM_FRAMES, STREAM_BATCH = 42, 4  # a stream of 10 batches and a stateful tail of 2


def multicam_chains(tp) -> dict:
    """name -> Chain of the camera-blocked chains (BASELINE config 5 on one
    card): 4 cameras of bayer_gbrg8 1920x1080 frames, MULTICAM_BATCH a
    camera per call; "multicam4" the flagship (the lerp remap, kernel F
    with per-camera maps), "multicam4_float" the float remap (kernel E).
    Their calibrations: multicam_calibrations of the config's."""
    table = chains(tp)
    ccc = CCC_KERNELS + ("pointwise",)
    return {
        "multicam4": Chain(table["flagship"].config, ((1080, 1920),),
                           ("flip", "debayer_bilinear") + ccc + ("remap_lerp",),
                           frames=MULTICAM_BATCH * MULTICAM_CALLS, calls=MULTICAM_CALLS, reps=3),
        "multicam4_float": Chain(table["float"].config, ((1080, 1920),),
                                 ("flip", "debayer_bilinear") + ccc + ("remap_float",),
                                 frames=MULTICAM_BATCH * MULTICAM_CALLS, calls=MULTICAM_CALLS,
                                 reps=3),
    }


def multicam_calibrations(calibration, scales=MULTICAM_SCALES) -> list:
    """One calibration per camera: `calibration` with fx and fy scaled by
    each of `scales` (as bench.py perturbs config 5's cameras)."""
    out = []
    for s in scales:
        k = list(calibration.camera_matrix)
        k[0] *= s
        k[4] *= s
        out.append(dataclasses.replace(calibration, camera_matrix=tuple(k)))
    return out


def hostile_maps(out_hw, src_hw, seed: int):
    """A float32 (map_x, map_y) pair of shape out_hw whose taps scatter over
    a source of src_hw and 3 pixels past each of its borders: what
    remap_precompute makes of it straddles the border, points out of the
    image, and leaves the frame altogether for a source of height or width
    1."""
    rng = np.random.default_rng(seed)
    (h, w), (sh, sw) = out_hw, src_hw
    return ((rng.random((h, w)) * (sw + 6) - 3).astype(np.float32),
            (rng.random((h, w)) * (sh + 6) - 3).astype(np.float32))


def lerp_hostile_maps(out_hw, src_hw, seed: int):
    """A float32 (map_x, map_y) pair of shape out_hw whose coordinates sit
    where the lerp remap's arithmetic is hardest: on integers, on halves,
    within 2^-20 to 2^-24 of an integer, just above 0 (2^-17 and below, down
    to the smallest subnormal) and just below it (where x - floor(x) rounds
    to 1), and within two pixels past each border of a source of src_hw;
    the rest uniform over the source and its borders."""
    rng = np.random.default_rng(seed)
    h, w = out_hw

    def coords(n):
        i = rng.integers(-2, n + 2, (h, w)).astype(np.float64)
        eps = rng.choice([2.0**-20, 2.0**-22, 2.0**-24], (h, w)) * rng.choice([-1, 1], (h, w))
        tiny = rng.choice([2.0**-17, 2.0**-18, 2.0**-30, 2.0**-100, 2.0**-140, 2.0**-149], (h, w))
        kind = rng.integers(0, 7, (h, w))
        return np.select([kind == 0, kind == 1, kind == 2, kind == 3, kind == 4],
                         [i, i + 0.5, i + eps, tiny, -tiny],
                         i + rng.random((h, w))).astype(np.float32)

    return coords(src_hw[1]), coords(src_hw[0])


def border_maps(out_hw, src_hw, seed: int):
    """A float32 (map_x, map_y) pair of shape out_hw that zooms a source of
    src_hw out by 0.4% about its centre, with a seeded jitter of up to
    0.3 pixels: smooth, so that a tile's taps stay within a small box, and
    crossing every border of the source, so that the tiles along the
    borders hold pixels whose taps past the border are masked (the lerp's)
    or read 0 (the other modes'), beside pixels that leave it altogether."""
    rng = np.random.default_rng(seed)
    (h, w), (sh, sw) = out_hw, src_hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    jitter = rng.uniform(-0.3, 0.3, (2, h, w))
    mx = (sw - 1) / 2 + (xx * (sw - 1) / max(w - 1, 1) - (sw - 1) / 2) * 1.004 + jitter[0]
    my = (sh - 1) / 2 + (yy * (sh - 1) / max(h - 1, 1) - (sh - 1) / 2) * 1.004 + jitter[1]
    return mx.astype(np.float32), my.astype(np.float32)


REMAP_TILE = (8, 64)  # kTileH, kTileW in csrc/remap_tile.cuh: output pixels of a tile
REMAP_STAGE_BYTES = 4096  # kStage there: a plane's box in shared memory


def remap_tile_census(base, weights, src_hw, out_hw, mode: str) -> dict:
    """A host model of how kernels E and F treat the output tiles of one map
    (base [N], weights [k, N] of remap_precompute in `mode`; numpy or CPU
    tensors), by the staging rule of csrc/remap_tile.cuh (float, fixed32)
    and csrc/remap_lerp.cu (lerp), for planes whose width and addresses are
    multiples of 16: "tiles", "empty" (no live pixel: stores only), "staged"
    (the tile's source box copied into shared memory) and "global" (taps
    gathered from global memory). No kernel reports these counts.

    A tile is staged when the bounding box of its live pixels' taps fits
    REMAP_STAGE_BYTES as rows of 16-byte-aligned columns and no live pixel
    is unsafe. Float and fixed32: the four taps at base + {0, 1, w, w + 1}
    are all in the box, and a pixel is unsafe where one of them leaves the
    plane or tap 1 wraps past a row's end. Lerp: the box holds only the
    taps whose mask is 1 (tap 0 at base - (w + 1)), and a pixel is unsafe
    where a mask is neither 0 nor 1 or a mask-1 tap lies outside the
    frame."""
    h, w = src_hw
    ho, wo = out_hw
    base = np.asarray(base, np.int64).reshape(ho, wo)
    wt = np.asarray(weights, np.float32).reshape(-1, ho, wo)
    taps = wt[-4:]  # the lerp's masks, the other modes' weights
    live = (taps != 0).any(0)
    size = h * w
    if mode == "lerp":
        ones = taps == 1
        m = ones.astype(np.int64)
        k = np.argmax(ones, axis=0)  # the first mask-1 tap
        at = base - (w + 1) + (k >> 1) * w + (k & 1)
        unsafe = ((taps != 0) & ~ones).any(0) | ~ones.any(0) | (at < 0) | (at >= size)
        ry = np.floor_divide(at, w)
        ty, tx = ry - (k >> 1), at - ry * w - (k & 1)
        r0 = ty + 1 - (m[0] | m[1])
        r1 = ty + (m[2] | m[3])
        c0 = tx + 1 - (m[0] | m[2])
        c1 = tx + (m[1] | m[3])
        unsafe |= (r0 < 0) | (r1 >= h) | (c0 < 0) | (c1 >= w)
    else:
        r0 = np.floor_divide(base, w)
        c0 = base - r0 * w
        r1, c1 = r0 + 1, c0 + 1
        unsafe = (base < 0) | (base + w + 1 >= size) | (c0 == w - 1)
    th, tw = REMAP_TILE
    ny, nx = -(-ho // th), -(-wo // tw)

    def per_tile(x, fill, reduce):
        out = np.full((ny * th, nx * tw), fill, x.dtype)
        out[:ho, :wo] = x
        return reduce(reduce(out.reshape(ny, th, nx, tw), axis=3), axis=1)

    big = np.iinfo(np.int64).max
    any_live = per_tile(live, False, np.any)
    any_unsafe = per_tile(live & unsafe, False, np.any)
    ok = live & ~unsafe
    rmin = per_tile(np.where(ok, r0, big), big, np.min)
    rmax = per_tile(np.where(ok, r1, -1), -1, np.max)
    cmin = per_tile(np.where(ok, c0, big), big, np.min)
    cmax = per_tile(np.where(ok, c1, -1), -1, np.max)
    with np.errstate(over="ignore"):
        pitch = ((cmax + 16) & ~15) - (cmin & ~15)
        staged = any_live & ~any_unsafe & ((rmax - rmin + 1) * pitch <= REMAP_STAGE_BYTES)
    return {"tiles": ny * nx, "empty": int((~any_live).sum()), "staged": int(staged.sum()),
            "global": int((any_live & ~staged).sum())}


def card_frames(torch, kind: str, n: int, h: int, w: int, seed: int, device="cuda"):
    """n seeded [h, w] frames made on the card (or `device`), each with its
    own colour cast (a per-frame, per-channel gain), so that every
    white-balance method finds different gains per frame: "color"
    [n, h, w, 3] BGR, "bayer" (or "mono", the same bytes as mono8 frames)
    [n, h, w] bayer_gbrg8 mosaics of such frames, "bayer16" [n, h, w]
    uint16 bayer_gbrg16 mosaics: the "bayer" mosaic's values as the high
    byte, seeded low bytes."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    yy = torch.linspace(0, 1, h, device=device)[:, None]
    xx = torch.linspace(0, 1, w, device=device)[None, :] * (w / h)
    out = torch.empty((n, h, w, 3) if kind == "color" else (n, h, w), dtype=torch.uint8,
                      device=device)
    for s in range(0, n, 32):
        m = min(32, n - s)
        phase = torch.rand((m, 1, 1), generator=g, device=device) * 6
        base = 40 + 200 * (0.5 + 0.5 * torch.sin(7 * xx + 5 * yy + phase))
        cast = 0.4 + 1.3 * torch.rand((m, 1, 1, 3), generator=g, device=device)
        noise = 0.8 + 0.4 * torch.rand((m, h, w, 3), generator=g, device=device)
        img = (base[..., None] * cast * noise).clamp(0, 255).to(torch.uint8)
        out[s:s + m] = img if kind == "color" else mosaic_gbrg(img)
    if kind == "bayer16":  # made in int32 and cast through int16: the bits of uint16
        low = torch.randint(0, 256, out.shape, generator=g, device=device, dtype=torch.int32)
        return (out.to(torch.int32) * 256 + low).to(torch.int16).view(torch.uint16)
    return out


def fixture_colour(torch, bgr, n: int, h: int, w: int, device="cuda"):
    """n [h, w, 3] BGR frames of real content: the BGR image `bgr` (the
    repository's Alphasense fixture, 720x540) resized bilinearly to
    (h, w), frame k turned 8k pixels to the right (wrapping round) so that
    no two frames are equal."""
    img = torch.as_tensor(bgr, device=device).permute(2, 0, 1)[None].float()
    img = torch.nn.functional.interpolate(img, size=(h, w), mode="bilinear",
                                          align_corners=False)
    img = img.round().clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0)
    return torch.stack([torch.roll(img, 8 * k, dims=1) for k in range(n)])


def fixture_frames(torch, bgr, n: int, h: int, w: int, device="cuda"):
    """n [h, w] bayer_gbrg8 frames of real content: fixture_colour's frames,
    mosaicked."""
    return mosaic_gbrg(fixture_colour(torch, bgr, n, h, w, device))


# frames at the statistical white balances' hard cases (wb_frames): one
# colour; every one of learned's 64^3 bins kept (at a threshold of 1.0,
# t255 = 255); a smooth ramp; uniform noise; the fixture's content; one bin
# (and one value a channel) holding more than 65 535 pixels
WB_FAMILIES = ("constant", "all_bins", "ramp", "noise", "fixture", "big_bin")
WB_BIG_BIN = 65_600  # pixels of big_bin's one colour
WB_ALL_BINS = 64 ** 3 + 1  # all_bins' least pixels: every bin, and one pixel at 255


def _wb_frame(kind: str, h: int, w: int, rng) -> np.ndarray:
    n = h * w
    if kind == "constant":  # kept at learned's threshold of 0.8 (t255 = 204)
        return np.broadcast_to(rng.integers(0, 200, 3).astype(np.uint8), (h, w, 3)).copy()
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "ramp":
        yy, xx = np.mgrid[0:h, 0:w]
        return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                         (xx + yy) * 255 // max(h + w - 2, 1)], -1).astype(np.uint8)
    if kind == "big_bin":
        if n < WB_BIG_BIN:
            raise ValueError(f"big_bin needs {WB_BIG_BIN} pixels, got {h}x{w}")
        x = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        x[rng.choice(n, WB_BIG_BIN, replace=False)] = (90, 140, 60)
        return x.reshape(h, w, 3)
    if kind == "all_bins":
        if n < WB_ALL_BINS:
            raise ValueError(f"all_bins needs {WB_ALL_BINS} pixels, got {h}x{w}")
        # value ceil(255 i / 64) has index i at hi = 255 (floor(v * 64 / 255))
        v = -(-np.arange(64) * 255 // 64)
        i = np.arange(64 ** 3)
        x = rng.integers(0, 253, (n, 3)).astype(np.uint8)
        at = rng.permutation(n)
        x[at[:64 ** 3]] = np.stack([v[i >> 12], v[(i >> 6) & 63], v[i & 63]], -1)
        x[at[64 ** 3]] = 255  # hi = 255, a pixel not kept at t255 = 255
        return x.reshape(h, w, 3)
    raise ValueError(f"unknown frame family {kind!r}")


def wb_frames(torch, kind: str, n: int, h: int, w: int, seed: int, bgr=None, device="cuda"):
    """n [h, w, 3] u8 BGR frames of the family `kind` (WB_FAMILIES), made
    from numpy's generator seeded with `seed` (frame k from seed + k), so
    the CPU and the card see the same frames; "fixture" is fixture_colour
    of `bgr`."""
    if kind == "fixture":
        return fixture_colour(torch, bgr, n, h, w, device)
    x = np.stack([_wb_frame(kind, h, w, np.random.default_rng(seed + k)) for k in range(n)])
    return torch.as_tensor(x, device=device)


def mosaic_gbrg(bgr):
    """[..., H, W, 3] BGR -> [..., H, W] bayer_gbrg8 ((0,0)=G (0,1)=B (1,0)=R)."""
    out = bgr[..., 1].clone()
    out[..., 0::2, 1::2] = bgr[..., 0::2, 1::2, 0]
    out[..., 1::2, 0::2] = bgr[..., 1::2, 0::2, 2]
    return out


def two_peak_histogram(filt_re, filt_im, bias, gap: float = TWO_PEAK_GAP):
    """A [256, 256] f32 CCC histogram whose response has two separate local
    maxima that differ by `gap` of max |response|: all its mass in two bins,
    (100, 100) and (160, 150), split (1 - t, t), with t found by bisection on
    the f64 response (numpy's FFT). Returns (hist, the f64 relative gap,
    the two peaks (row, col), the higher first)."""
    w = np.asarray(filt_re, np.float64) + 1j * np.asarray(filt_im, np.float64)
    b = np.asarray(bias, np.float64)
    p1, p2 = (100, 100), (160, 150)

    def hist(t):
        h = np.zeros((256, 256), np.float32)
        h[p1], h[p2] = 1 - t, t
        return h

    def resp(h):
        return np.real(np.fft.ifft2(np.fft.fft2(h.astype(np.float64)) * w)) + b

    # each bin alone puts the peak at q1 or q2; the map splits into the
    # points nearer to each
    q1, q2 = (np.unravel_index(np.argmax(resp(hist(t))), (256, 256)) for t in (0.0, 1.0))
    yy, xx = np.mgrid[0:256, 0:256]
    near1 = (yy - q1[0]) ** 2 + (xx - q1[1]) ** 2 < (yy - q2[0]) ** 2 + (xx - q2[1]) ** 2

    def peaks(t):
        r = resp(hist(t))
        a1, a2 = (np.unravel_index(np.argmax(np.where(m, r, -np.inf)), r.shape)
                  for m in (near1, ~near1))
        return r, a1, a2, (r[a1] - r[a2]) / np.abs(r).max()

    lo, hi = 0.0, 1.0  # the gap falls from positive to negative over t
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if peaks(mid)[3] > gap else (lo, mid)
    r, a1, a2, rel = peaks(lo)
    for y, x in (a1, a2):
        if r[y, x] < r[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2].max():
            raise AssertionError(f"two-peak fixture: ({y}, {x}) is not a local maximum")
    return hist(lo), float(rel), (tuple(map(int, a1)), tuple(map(int, a2)))


ARGMAX_N = 256 * 256  # values of a CCC response
# kernel I's slice boundaries: every multiple of 4096 is one at cluster 16,
# every multiple of 32768 at every size from 2 up
ARGMAX_SLICES = (4096, 8192, 16384, 32768)


def argmax_across_slices(seed: int, batch: int) -> np.ndarray:
    """[batch, 256, 256] f32 responses (seeded noise) with first-occurrence
    traps planted across kernel I's slice boundaries: at each boundary s of
    ARGMAX_SLICES, equal maxima in the two slices, a -0.0/+0.0 pair and a
    +0.0/-0.0 pair across s (the first wins), NaNs in the two slices, a NaN
    after a huge number, and a maximum in the last slice only; then a frame
    of equal values (index 0). Frame i takes trap i modulo their count, so a
    batch of 25 or more holds every one."""
    rng = np.random.default_rng(seed)
    r = rng.normal(0, 1, (batch, ARGMAX_N)).astype(np.float32)
    traps = []
    for s in ARGMAX_SLICES:
        traps += [{s - 5: 50.0, s + 5: 50.0},
                  {"fill": -1.0, s - 1: -0.0, s: 0.0},
                  {"fill": -1.0, s - 1: 0.0, s: -0.0},
                  {s - 9: np.nan, s + 7: np.nan},
                  {0: 1e38, s: np.nan},
                  {ARGMAX_N - 1 - s // 2: 100.0}]
    traps.append({"fill": 5.0})
    for i in range(batch):
        trap = dict(traps[i % len(traps)])
        if "fill" in trap:
            r[i] = trap.pop("fill")
        for at, v in trap.items():
            r[i, at] = v
    return r.reshape(batch, 256, 256)


LEARNED_BINS = 64 ** 3  # learned's 64^3 histogram
M_BLOCK_BINS = 16384  # the bins a block of kernel M walks in a cluster of 16 (of 8: twice, ...)


def learned_histograms(torch, seed: int = SEED, device="cuda"):
    """(labels, record [B, 7] int64, hist [B, 64^3] int32): kernel M's
    learned cases as synthetic histograms, numpy-seeded: ties at T (the
    300th largest count) on both sides of every block boundary of every
    cluster size, T's bins only in the last block, 299, 300 and 301
    occupied bins (301 equal), one occupied bin, every count equal, a max
    count of 2^21 - 1 (two digit passes of the radix select), counts below
    2^11 (one pass), 400 bins at the max, dense small counts (ties spread
    over every block) and an empty histogram. The records are plausible
    (kept = the histogram's sum, seeded sums and brightest pixel)."""
    rng = np.random.default_rng(seed)
    n = LEARNED_BINS
    cases = {}

    def occupied(k, lo, hi, where=None):
        h = np.zeros(n, np.int64)
        at = rng.choice(n if where is None else where, k, replace=False)
        h[at] = rng.integers(lo, hi, k)
        return h

    h = occupied(250, 600, 5000)
    edges = np.concatenate([np.arange(k * M_BLOCK_BINS - 4, k * M_BLOCK_BINS + 4)
                            for k in range(1, n // M_BLOCK_BINS)])
    h[edges[h[edges] == 0]] = 500  # 250 above T = 500, the first 50 of its bins taken
    cases["ties_across_blocks"] = h
    h = occupied(100, 1000, 2000, n - M_BLOCK_BINS)
    h[n - M_BLOCK_BINS + rng.choice(M_BLOCK_BINS, 400, replace=False)] = 300
    cases["ties_in_the_last_block"] = h
    cases["nnz_299"] = occupied(299, 1, 100)
    cases["nnz_300"] = occupied(300, 1, 100)
    h = np.zeros(n, np.int64)
    h[rng.choice(n, 301, replace=False)] = 3
    cases["nnz_301_equal"] = h
    h = np.zeros(n, np.int64)
    h[123456] = 2_000_000
    cases["one_bin"] = h
    cases["all_equal"] = np.full(n, 7, np.int64)
    h = occupied(1000, 1, 1 << 20)
    h[200000] = (1 << 21) - 1
    cases["max_2e21"] = h
    cases["one_digit"] = occupied(2000, 1, 1 << 11)
    h = np.zeros(n, np.int64)
    h[rng.choice(n, 400, replace=False)] = (1 << 21) - 1
    cases["ties_at_the_max"] = h
    cases["dense"] = rng.poisson(1.5, n).astype(np.int64)
    cases["empty"] = np.zeros(n, np.int64)
    labels = list(cases)
    hist = np.stack([cases[k] for k in labels]).astype(np.int32)
    b = len(labels)
    record = np.zeros((b, 7), np.int64)
    record[:, 0] = hist.sum(1, dtype=np.int64)  # kept
    record[:, 1:4] = rng.integers(0, 200, (b, 3)) * np.maximum(record[:, :1], 1)  # sums
    record[:, 4] = 254  # the largest channel value
    record[:, 5] = rng.integers(1, 1 << 40, b)  # the brightest pixel's key
    record[:, 6] = rng.integers(0, 1 << 24, b)  # its b | g << 8 | r << 16
    return (labels, torch.as_tensor(record, device=device),
            torch.as_tensor(hist, device=device))
