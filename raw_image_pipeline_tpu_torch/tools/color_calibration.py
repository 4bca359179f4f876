"""Offline color-calibration tool (role of reference
scripts/color_calibration.py:201-304); a copy of
raw_image_pipeline_tpu/tools/color_calibration.py that writes its YAML
through the port's config module. It runs no device code (numpy, scipy and
cv2's ArUco detector), so it runs where cv2 is installed.

Workflow: photograph a 24-patch color checker board that carries four
4x4 ArUco markers (ids 0-3) at its corners, together with a reference
image of the same chart. For every input image:
  1. detect the markers (retrying on a sharpened copy if needed),
  2. warp to the canonical chart frame by homography,
  3. take the median BGR of each of the 24 patches,
then solve min ||M @ colors_in + 255*bias - colors_ref|| with
scipy.optimize.least_squares over the 12 parameters (robust losses:
linear | soft_l1 | huber | cauchy | arctan) and write the result in the
reference's color_calibration.yaml schema plus a before/after patch grid.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List, Optional, Tuple

import cv2
import numpy as np

from raw_image_pipeline_tpu_torch.config import ColorCalibrationConfig, save_color_calibration

# canonical chart frame: markers at the corners of a 600x400 board,
# 6x4 patch grid inset
CANVAS_W, CANVAS_H = 600, 400
GRID_COLS, GRID_ROWS = 6, 4
MARGIN = 40
LOSSES = ("linear", "soft_l1", "huber", "cauchy", "arctan")


def detect_markers(image: np.ndarray):
    """ArUco 4x4_50 ids 0..3 -> their centers, retrying with a sharpening
    kernel like the reference (scripts/color_calibration.py:103-113)."""
    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_50)
    det = cv2.aruco.ArucoDetector(d)
    for attempt in range(2):
        src = image
        if attempt == 1:
            kernel = np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]])
            src = cv2.filter2D(image, -1, kernel)
        corners, ids, _ = det.detectMarkers(src)
        if ids is not None and len(ids) >= 4 and set(ids.ravel()) >= {0, 1, 2, 3}:
            centers = {}
            for c, i in zip(corners, ids.ravel()):
                centers[int(i)] = c.reshape(-1, 2).mean(axis=0)
            return np.array([centers[i] for i in range(4)], np.float32)
    return None


def patch_centers() -> np.ndarray:
    xs = np.linspace(MARGIN, CANVAS_W - MARGIN, GRID_COLS * 2 + 1)[1::2]
    ys = np.linspace(MARGIN, CANVAS_H - MARGIN, GRID_ROWS * 2 + 1)[1::2]
    return np.array([(x, y) for y in ys for x in xs], np.float32)


def get_color_centroids(image: np.ndarray, patch_half: int = 12) -> Optional[np.ndarray]:
    """[24, 3] BGR medians in the canonical frame, or None if markers not
    found."""
    centers = detect_markers(image)
    if centers is None:
        return None
    dst = np.array(
        [[0, 0], [CANVAS_W, 0], [CANVAS_W, CANVAS_H], [0, CANVAS_H]], np.float32
    )
    H, _ = cv2.findHomography(centers, dst)
    warped = cv2.warpPerspective(image, H, (CANVAS_W, CANVAS_H))
    out = []
    for (x, y) in patch_centers():
        x, y = int(x), int(y)
        patch = warped[max(y - patch_half, 0): y + patch_half,
                       max(x - patch_half, 0): x + patch_half]
        out.append(np.median(patch.reshape(-1, 3), axis=0))
    return np.array(out)


def find_color_calibration(
    samples: np.ndarray, reference: np.ndarray, loss: str = "linear",
    use_bias: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Solve for M (3x3) [+ bias] minimizing robust residuals over patch
    colors. samples/reference: [N, 3] BGR in [0, 255]."""
    from scipy.optimize import least_squares

    def residuals(p):
        M = p[:9].reshape(3, 3)
        b = p[9:12] * 255.0 if use_bias else np.zeros(3)
        pred = samples @ M.T + b
        return (pred - reference).ravel()

    x0 = np.concatenate([np.eye(3).ravel(), np.zeros(3)]) if use_bias else np.eye(3).ravel().copy()
    x0 = x0[: 12 if use_bias else 9]
    res = least_squares(residuals, x0, loss=loss)
    M = res.x[:9].reshape(3, 3)
    bias = res.x[9:12] if use_bias else np.zeros(3)
    return M, bias


def comparison_grid(samples: np.ndarray, corrected: np.ndarray, reference: np.ndarray,
                    cell: int = 40) -> np.ndarray:
    """Three-row grid PNG: input | corrected | reference patch colors."""
    rows = []
    for colors in (samples, corrected, reference):
        row = np.zeros((cell, cell * len(colors), 3), np.uint8)
        for i, c in enumerate(colors):
            row[:, i * cell:(i + 1) * cell] = np.clip(c, 0, 255).astype(np.uint8)
        rows.append(row)
    return np.concatenate(rows, axis=0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", required=True,
                    help="input image or directory of images of the chart")
    ap.add_argument("-r", "--reference", required=True,
                    help="reference image of the chart (target colors)")
    ap.add_argument("-o", "--output-dir", default=".")
    ap.add_argument("-l", "--loss", default="linear", choices=LOSSES)
    ap.add_argument("-b", "--bias", action="store_true", help="also fit a bias term")
    args = ap.parse_args(argv)

    paths: List[str]
    if os.path.isdir(args.input):
        paths = sorted(
            p for ext in ("png", "jpg", "jpeg")
            for p in glob.glob(os.path.join(args.input, f"*.{ext}"))
        )
    else:
        paths = [args.input]

    ref_img = cv2.imread(args.reference)
    reference = get_color_centroids(ref_img)
    if reference is None:
        raise SystemExit("could not find ArUco markers in the reference image")

    all_samples = []
    for p in paths:
        img = cv2.imread(p)
        cents = get_color_centroids(img)
        if cents is None:
            print(f"warning: no markers found in {p}, skipping")
            continue
        all_samples.append(cents)
    if not all_samples:
        raise SystemExit("no usable input images")

    samples = np.concatenate(all_samples)
    target = np.tile(reference, (len(all_samples), 1))
    M, bias = find_color_calibration(samples, target, args.loss, args.bias)

    os.makedirs(args.output_dir, exist_ok=True)
    out_yaml = os.path.join(args.output_dir, "color_calibration.yaml")
    save_color_calibration(
        out_yaml,
        ColorCalibrationConfig(
            enabled=True, matrix=tuple(M.ravel()), bias=tuple(bias * 255.0)
        ),
    )
    corrected = samples @ M.T + bias * 255.0
    grid = comparison_grid(samples[:24], corrected[:24], reference)
    out_png = os.path.join(args.output_dir, "color_calibration_check.png")
    cv2.imwrite(out_png, grid)
    print("matrix:\n", M)
    print("bias:", bias * 255.0)
    print("wrote", out_yaml, "and", out_png)


if __name__ == "__main__":
    main()
