"""Interactive-style CCC white-balance tuning tool (the port of
raw_image_pipeline_tpu/tools/ccc_tune.py).

Role of the reference's standalone debug node
(raw_image_pipeline_white_balance_node.cpp:23-118 with
cfg/RawImagePipelineWhiteBalance.cfg): load an image and an FFCC model, run
the white balance with adjustable `bright_thr`, `dark_thr`, `uv0`, and —
like the node's dynamic_reconfigure `Lu_offset`/`Lv_offset` debug mode
(setDebugUVOffset, ccc.cpp:454-459) — optionally bypass the argmax and
drive the gains from explicit offsets. Writes the original and balanced
images side by side and prints the illuminant estimate.

It runs on `--device` (the card by default: the histogram is kernel B, the
response kernel C; "cpu" runs their plain versions), through the
image-level functions of ops/ccc.py: the image is split into B, G, R
planes once, each resized to 360x270, and the gains take exp from libm's
table (ops/ccc.exp_table), as the chain does.

Example:
    python -m raw_image_pipeline_tpu_torch.tools.ccc_tune \
        -i tests/fixtures/alphasense.png --bright-thr 0.9 --dark-thr 0.1
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from raw_image_pipeline_tpu_torch.config import DEFAULT_CCC_MODEL_PATH
from raw_image_pipeline_tpu_torch.models.ccc_model import load_ccc_model
from raw_image_pipeline_tpu_torch.ops import ccc
from raw_image_pipeline_tpu_torch.ops.common import resolve_device
from raw_image_pipeline_tpu_torch.utils import image_io


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("-m", "--model", default=DEFAULT_CCC_MODEL_PATH)
    ap.add_argument("-o", "--output", default="ccc_tune_output.png")
    ap.add_argument("--bright-thr", type=float, default=0.9)
    ap.add_argument("--dark-thr", type=float, default=0.1)
    ap.add_argument("--uv0", type=float, default=ccc.UV0)
    ap.add_argument("--lu-offset", type=float, default=None,
                    help="debug mode: drive gains from this Lu offset (with --lv-offset)")
    ap.add_argument("--lv-offset", type=float, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    img = image_io.imread(args.image)
    if img is None:
        raise SystemExit(f"could not read {args.image}")
    dev = resolve_device(args.device)
    model = load_ccc_model(args.model)
    x_img = torch.as_tensor(img, device=dev)

    if args.lu_offset is not None and args.lv_offset is not None:
        gains = ccc.gains_from_offsets(args.lu_offset, args.lv_offset, args.uv0, device=dev)
        print(f"debug offsets Lu={args.lu_offset} Lv={args.lv_offset} uv0={args.uv0}")
    else:
        uv = ccc.estimate_illuminant(x_img, model, args.bright_thr, args.dark_thr, args.uv0)
        gains = ccc.gains_from_uv(uv, torch.as_tensor(ccc.exp_table(args.uv0), device=dev))
        x, y = uv.tolist()
        print(f"uv_pos=({x}, {y})  Lu={x/64 + args.uv0:.4f}  Lv={y/64 + args.uv0:.4f}")
    out = ccc.apply_gains(x_img, gains).cpu().numpy()

    print(f"gains (B,G,R) = {gains.cpu().numpy().round(4)}")
    image_io.imwrite(args.output, np.concatenate([img, out], axis=1))
    print("wrote", args.output)
    return gains.cpu().numpy()


if __name__ == "__main__":
    main()
