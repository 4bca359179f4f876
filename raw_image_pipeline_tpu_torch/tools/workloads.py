"""The chains and seeded inputs that chip_smoke.py and the port's tools run
on a CUDA card: the table of chains (each a configuration, its sizes, its
kernels and its batch), frames made on the card from a seed, hostile remap
maps for kernel E, and the two-peak CCC histogram that holds kernel C's
argmax on a near-tie.

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
    ccc = ("ccc_histogram", "ccc_response")
    table = {
        "flagship": Chain(tp.flagship_config, full, ("debayer_bilinear",) + ccc),
        "gpu_parity": Chain(gpu_parity, full, ("debayer_mht",) + ccc),
        "float": Chain(remap("float"), full[:1], ("debayer_bilinear",) + ccc + ("remap_float",)),
        "fixed32": Chain(remap("fixed32"), full[:1], ("debayer_bilinear",) + ccc),
    }
    for method in ("simple", "grey_world", "pca", "learned"):
        table[f"wb_{method}"] = Chain(config2(method), full[:1], ("debayer_bilinear",),
                                      frames=128, calls=2, reps=3, cpu_frames=3)
    table["pointwise_bgr8"] = Chain(config4, full[:1], (), encoding="bgr8", kind="color",
                                    frames=512, calls=1, microbatch=128, reps=3,
                                    cpu_frames=128)
    # small size only: the other inputs on the flagship configuration (mono
    # frames run its flip, gamma and remap, here the float remap = E on one
    # plane), 16-bit Bayer
    table["mono8_float"] = Chain(remap("float"), (), (), encoding="mono8", kind="mono",
                                 small_only=True)
    table["rgb8_float"] = Chain(remap("float"), (), (), encoding="rgb8", kind="color",
                                small_only=True)
    table["bayer16"] = Chain(bayer16, (), (), encoding="bayer_gbrg16", kind="bayer16",
                             small_only=True)
    return table


MULTICAM_SCALES = (1.0, 1.02, 0.98, 1.04)  # fx and fy per camera: bench.py's config 5
MULTICAM_BATCH, MULTICAM_CALLS = 4, 2  # frames per camera per call, calls of a run
STREAM_FRAMES, STREAM_BATCH = 42, 4  # a stream of 10 batches and a stateful tail of 2


def multicam_chains(tp) -> dict:
    """name -> Chain of the camera-blocked chains (BASELINE config 5 on one
    card): 4 cameras of bayer_gbrg8 1920x1080 frames, MULTICAM_BATCH a
    camera per call; "multicam4" the flagship (lerp remap, plain ops),
    "multicam4_float" the float remap (kernel E with per-camera maps).
    Their calibrations: multicam_calibrations of the config's."""
    table = chains(tp)
    ccc = ("ccc_histogram", "ccc_response")
    return {
        "multicam4": Chain(table["flagship"].config, ((1080, 1920),), ("debayer_bilinear",) + ccc,
                           frames=MULTICAM_BATCH * MULTICAM_CALLS, calls=MULTICAM_CALLS, reps=3),
        "multicam4_float": Chain(table["float"].config, ((1080, 1920),),
                                 ("debayer_bilinear",) + ccc + ("remap_float",),
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


def card_frames(torch, kind: str, n: int, h: int, w: int, seed: int, device="cuda"):
    """n seeded [h, w] frames made on the card (or `device`), each with its
    own colour cast (a per-frame, per-channel gain), so that every
    white-balance method finds different gains per frame: "color"
    [n, h, w, 3] BGR, "bayer" [n, h, w] bayer_gbrg8 mosaics of such
    frames."""
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
    return out


def fixture_frames(torch, bgr, n: int, h: int, w: int, device="cuda"):
    """n [h, w] bayer_gbrg8 frames of real content: the BGR image `bgr` (the
    repository's Alphasense fixture, 720x540) resized bilinearly to
    (h, w), frame k turned 8k pixels to the right (wrapping round) so that
    no two frames are equal, then mosaicked."""
    img = torch.as_tensor(bgr, device=device).permute(2, 0, 1)[None].float()
    img = torch.nn.functional.interpolate(img, size=(h, w), mode="bilinear",
                                          align_corners=False)
    img = img.round().clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0)
    return mosaic_gbrg(torch.stack([torch.roll(img, 8 * k, dims=1) for k in range(n)]))


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
