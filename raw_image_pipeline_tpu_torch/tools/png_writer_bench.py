"""How fast PNG writers encode what run_pipeline writes: the three output
streams (color, color_rect, debayered) of one launch-profile frame at the
Alphasense 1.6 MP size, on two inputs: a seeded synthetic frame
(workloads.card_frames, the frames chip_smoke.py runs the tool on) and a
frame mosaicked from the repository's Alphasense fixture
(workloads.fixture_frames, real content).

It times, on one thread, image_io.encode_png (what every .png write of
the port runs), each of the five PNG row filters under four deflate
settings (zlib level and strategy), and cv2.imencode where cv2 imports
(libpng choosing each row's filter; the port does not use it). Each
variant's PNG of a small crop is decoded by image_io and held to the crop,
and every writer runs once untimed before --reps turns that time each
writer once. Prints one line per writer: ms for the three images (median
and range of the turns) and their bytes; returns the same numbers.

    python -m raw_image_pipeline_tpu_torch.tools.png_writer_bench [--device cuda]
        [--height 1080] [--width 1440] [--reps 5]
"""

from __future__ import annotations

import argparse
import os
import statistics
import struct
import time
import zlib

import numpy as np

FILTERS = ("none", "sub", "up", "average", "paeth")  # PNG filter types 0-4
DEFLATE = ((1, "rle"), (1, "default"), (1, "huffman"), (6, "default"))
_STRATEGY = {"rle": zlib.Z_RLE, "default": zlib.Z_DEFAULT_STRATEGY,
             "huffman": zlib.Z_HUFFMAN_ONLY}
STREAMS = ("dist_color", "processed", "debayered")  # color, color_rect, debayered


def filter_rows(img: np.ndarray, kind: str) -> np.ndarray:
    """[H, W, 3] uint8 BGR -> [H, 1 + 3W] uint8: the RGB rows filtered by
    `kind` for the whole image, each led by its filter type."""
    h = img.shape[0]
    x = np.ascontiguousarray(img[..., ::-1]).reshape(h, -1)
    out = np.empty((h, x.shape[1] + 1), np.uint8)
    out[:, 0] = FILTERS.index(kind)
    f = out[:, 1:]
    if kind == "none":
        f[...] = x
        return out
    a = np.zeros_like(x)  # left
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)  # up
    b[1:] = x[:-1]
    if kind == "sub":
        np.subtract(x, a, out=f)
    elif kind == "up":
        np.subtract(x, b, out=f)
    elif kind == "average":  # floor((a + b) / 2) in 8 bits
        np.subtract(x, (a >> 1) + (b >> 1) + (a & b & 1), out=f)
    else:  # paeth
        c = np.zeros_like(x)  # up-left
        c[1:, 3:] = x[:-1, :-3]
        a, b, c = (v.astype(np.int16) for v in (a, b, c))
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        np.subtract(x, pred.astype(np.uint8), out=f)
    return out


def encode(img: np.ndarray, kind: str, level: int, strategy: str) -> bytes:
    """[H, W, 3] uint8 BGR -> an 8-bit RGB PNG, every row filtered by `kind`
    and deflated at `level` with `strategy`."""
    from raw_image_pipeline_tpu_torch.utils.image_io import _SIGNATURE, _chunk

    h, w = img.shape[:2]
    z = zlib.compressobj(level, zlib.DEFLATED, 15, 8, _STRATEGY[strategy])
    idat = z.compress(filter_rows(img, kind)) + z.flush()
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))


def writers():
    """name -> fn(BGR image) -> PNG bytes."""
    from raw_image_pipeline_tpu_torch.utils import image_io

    out = {"image_io.encode_png": image_io.encode_png}
    for kind in FILTERS:
        for level, strategy in DEFLATE:
            out[f"{kind}, level {level}, {strategy}"] = (
                lambda img, k=kind, lv=level, st=strategy: encode(img, k, lv, st))
    cv2 = image_io.cv2_module()
    if cv2 is not None:
        out["cv2.imencode (libpng)"] = lambda img: cv2.imencode(".png", img)[1].tobytes()
    return out


def time_writers(images, reps: int) -> dict:
    """name -> {"ms": median, "ms_min", "ms_max" (the images encoded one
    after another, one thread), "bytes"}. Each writer's PNG of a 24x40
    crop is decoded and checked, and each writer encodes the images once
    untimed; then `reps` turns time every writer once each, so that a drift
    of the host's speed spreads over all writers alike."""
    from raw_image_pipeline_tpu_torch.utils.image_io import decode_png

    crop = np.ascontiguousarray(images[0][:24, :40])
    fns = writers()
    sizes, runs = {}, {name: [] for name in fns}
    for name, fn in fns.items():
        if not np.array_equal(decode_png(fn(crop)), crop):
            raise AssertionError(f"{name}: the PNG does not decode to its image")
        sizes[name] = sum(len(fn(img)) for img in images)
    for _ in range(reps):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for img in images:
                fn(img)
            runs[name].append((time.perf_counter() - t0) * 1e3)
    return {name: {"ms": statistics.median(r), "ms_min": min(r), "ms_max": max(r),
                   "bytes": sizes[name]} for name, r in runs.items()}


def launch_profile_images(device: str, h: int, w: int) -> dict:
    """content -> the three output streams of one launch-profile frame,
    [H, W, 3] uint8 BGR numpy arrays: "synthetic" and "fixture"."""
    import torch

    import raw_image_pipeline_tpu_torch as tp
    from raw_image_pipeline_tpu_torch.tools import run_pipeline, workloads
    from raw_image_pipeline_tpu_torch.utils import image_io

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    params, calib = (os.path.join(root, f) for f in workloads.LAUNCH_PROFILE)
    config = run_pipeline.pipeline_config(params, calib,
                                          tp.config.DEFAULT_COLOR_CALIBRATION_PATH)
    fixture = image_io.imread(os.path.join(root, "tests", "fixtures", "alphasense.png"),
                              image_io.IMREAD_COLOR)
    frames = {
        "synthetic": workloads.card_frames(torch, "bayer", 1, h, w, workloads.SEED + 80,
                                           device),
        "fixture": workloads.fixture_frames(torch, fixture, 1, h, w, device),
    }
    pipe = tp.build_pipeline(config, "bayer_gbrg8", (h, w), keep_intermediates=True,
                             device=device)
    out = {}
    for content, f in frames.items():
        res, _ = pipe(f, None)
        out[content] = [res[k][0].cpu().numpy() for k in STREAMS]
    return out


def main(argv=None):
    from raw_image_pipeline_tpu_torch.tools import workloads

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="where the chain runs: cuda or cpu")
    ap.add_argument("--height", type=int, default=workloads.LAUNCH_PROFILE_HW[0])
    ap.add_argument("--width", type=int, default=workloads.LAUNCH_PROFILE_HW[1])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    results = {}
    for content, images in launch_profile_images(args.device, args.height,
                                                 args.width).items():
        results[content] = time_writers(images, args.reps)
        for name, r in results[content].items():
            print(f"png_writer_bench {content} {args.width}x{args.height}, 3 images: "
                  f"{name}: {r['ms']:.1f} ms ({r['ms_min']:.1f}-{r['ms_max']:.1f}, "
                  f"median of {args.reps}), {r['bytes']} bytes", flush=True)
    return results


if __name__ == "__main__":
    main()
