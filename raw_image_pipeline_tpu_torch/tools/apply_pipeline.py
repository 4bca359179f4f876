"""Smoke/demo driver (role of reference scripts/apply_pipeline.py:14-57;
the port of raw_image_pipeline_tpu/tools/apply_pipeline.py).

Loads an image + the three config YAMLs, prints the dist/rect calibrations,
runs both `process` and `apply` on `--device` (the card by default; "cpu"
runs the plain versions), and writes the outputs as PNGs. Images are read
and written through utils/image_io (cv2 where it is installed). The JAX
tool's persistent compilation cache has no counterpart: the port compiles
nothing per call, and its kernels are built once into build/kernels/.

Example:
    python -m raw_image_pipeline_tpu_torch.tools.apply_pipeline \
        -i tests/fixtures/alphasense.png -o out/
"""

from __future__ import annotations

import argparse
import os

from raw_image_pipeline_tpu_torch import RawImagePipeline
from raw_image_pipeline_tpu_torch.config import (
    DEFAULT_CALIBRATION_PATH,
    DEFAULT_COLOR_CALIBRATION_PATH,
    DEFAULT_PARAMS_PATH,
)
from raw_image_pipeline_tpu_torch.utils import image_io


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--image", default="tests/fixtures/alphasense.png")
    ap.add_argument("-e", "--encoding", default="bgr8")
    ap.add_argument("-p", "--params", default=DEFAULT_PARAMS_PATH)
    ap.add_argument("-c", "--calibration", default=DEFAULT_CALIBRATION_PATH)
    ap.add_argument("-cc", "--color-calibration", default=DEFAULT_COLOR_CALIBRATION_PATH)
    ap.add_argument("-o", "--output-dir", default=".")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    img = image_io.imread(args.image, image_io.IMREAD_UNCHANGED)
    if img is None:
        raise SystemExit(f"could not read {args.image}")

    pipe = RawImagePipeline(False, args.params, args.calibration, args.color_calibration,
                            device=args.device)

    print("Dist camera matrix:\n", pipe.get_dist_camera_matrix())
    print("Dist distortion:", pipe.get_dist_distortion_coefficients().ravel(),
          pipe.get_dist_distortion_model())
    print("Rect camera matrix:\n", pipe.get_rect_camera_matrix())
    print("Rect distortion:", pipe.get_rect_distortion_coefficients().ravel(),
          pipe.get_rect_distortion_model())

    out_process = pipe.process(img.copy(), args.encoding)
    img_apply = img.copy()
    pipe.apply(img_apply, args.encoding)

    os.makedirs(args.output_dir, exist_ok=True)
    p1 = os.path.join(args.output_dir, "output_process.png")
    p2 = os.path.join(args.output_dir, "output_apply.png")
    image_io.imwrite(p1, out_process)
    image_io.imwrite(p2, img_apply if img_apply.shape == out_process.shape else out_process)
    print("wrote", p1, "and", p2)


if __name__ == "__main__":
    main()
