"""What limits kernels G and F on a CUDA card: their device times at B=64
1080x1920 by step, layout and input.

    python -m raw_image_pipeline_tpu_torch.tools.limiters [--out FILE]

Run from the root of a checkout on the machine with the card. Two inputs,
each 64 frames of 1080x1920 debayered by kernel A (the chain's views of a
[B, 3, H, W] tensor): "noise", uniform bytes made on the card from a seed
(what chip_smoke.py, compare_checkouts.py and bench.py feed G), and
"fixture", the Alphasense fixture resized and mosaicked
(workloads.fixture_frames), whose neighbouring pixels share table entries.

  * kernel G (ops/pointwise.pointwise_cuda) with no step (a copy: the byte
    path alone), each step alone, and the flagship's set (gains,
    calibration, gamma∘Lab vignetting, enhancer), on both inputs and in
    three layouts: "views" (the chain's), "planes" (three contiguous
    [B, H, W] planes) and "nhwc" ([B, H, W, 3] in and out, config 4's);
  * kernel F (ops/undistortion.remap_lerp_cuda) in lerp and fixed32 mode
    through the flagship's and fixed32 chain's maps, on both inputs.

Each time is measure.device_ms. Prints one line per time and, last, a JSON
line of them all with the card's name and power limit; --out writes that
JSON to a file as well.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

B, H, W = 64, 1080, 1920
G_SETS = {
    "copy": (),
    "gains": ("gains",),
    "calibration": ("calibration",),
    "lut": ("lut",),
    "vignetting": ("vignetting",),
    "gamma_vignetting": ("gamma_vignetting",),
    "enhancer": ("enhancer",),
    "flagship": ("gains", "calibration", "gamma_vignetting", "enhancer"),
}


def _inputs(torch, tp):
    """The seeded inputs: the two inputs' debayered views, G's steps'
    arguments and the maps of F (lerp, fixed32)."""
    from raw_image_pipeline_tpu_torch.ops import debayer
    from raw_image_pipeline_tpu_torch.tools import workloads
    from raw_image_pipeline_tpu_torch.utils import image_io

    g = torch.Generator(device="cuda")
    g.manual_seed(workloads.SEED)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    bgr = image_io.imread(os.path.join(root, "tests", "fixtures", "alphasense.png"))
    mosaics = {
        "noise": torch.randint(0, 256, (B, H, W), generator=g, device="cuda", dtype=torch.uint8),
        "fixture": workloads.fixture_frames(torch, bgr, B, H, W),
    }
    views = {k: debayer.debayer_planes(m, "bayer_grbg8") for k, m in mosaics.items()}
    p = tp.make_params(tp.flagship_config(H, W), (H, W), device="cuda")
    gains = 0.5 + 1.5 * torch.rand((B, 3), generator=g, device="cuda")
    step_args = {
        "gains": dict(gains=gains),
        "calibration": dict(matrix=p.color_matrix, bias=p.color_bias),
        "lut": dict(lut=p.gamma_lut),
        "vignetting": dict(mask=p.vignetting_mask),
        "gamma_vignetting": dict(mask=p.vignetting_mask, lab_tab=p.lab_gamma_tab),
        "enhancer": dict(enhancer_tables=p.enhancer_tables),
    }
    fixed32 = workloads.chains(tp)["fixed32"].config(H, W)
    maps = {"lerp": p, "fixed32": tp.make_params(fixed32, (H, W), device="cuda")}
    return views, step_args, maps


def _args(step_args, steps) -> dict:
    return {k: v for s in steps for k, v in step_args[s].items()}


def _table(torch, views, step_args, maps) -> dict:
    """Every G set in every layout, and F in both modes, on both inputs."""
    from raw_image_pipeline_tpu_torch.ops import undistortion
    from raw_image_pipeline_tpu_torch.ops.pointwise import pointwise_cuda
    from raw_image_pipeline_tpu_torch.tools import measure

    res = {"G": {}, "F": {}}
    for kind, vw in views.items():
        planes = tuple(v.contiguous() for v in vw)
        nhwc = torch.stack(planes, dim=-1)
        nhwc_out = torch.empty_like(nhwc)
        layouts = {"views": (vw, None), "planes": (planes, None),
                   "nhwc": (nhwc.unbind(-1), nhwc_out.unbind(-1))}
        for name, steps in G_SETS.items():
            kw = _args(step_args, steps)
            for layout, (src, out) in layouts.items():
                ms = measure.device_ms(lambda: pointwise_cuda(src, out=out, **kw))
                res["G"][f"{name} {layout} {kind}"] = ms
                print(f"G {name} {layout} {kind}: {ms:.5f} ms", flush=True)
        for mode in ("lerp", "fixed32"):
            mp = maps[mode]
            ms = measure.device_ms(lambda: undistortion.remap_lerp_cuda(
                planes, mp.remap_base, mp.remap_weights, (H, W), mode=mode))
            res["F"][f"{mode} {kind}"] = ms
            print(f"F {mode} {kind}: {ms:.5f} ms", flush=True)
        del planes, nhwc, nhwc_out, layouts
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    import torch

    import raw_image_pipeline_tpu_torch as tp

    if not torch.cuda.is_available():
        print("limiters: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    views, step_args, maps = _inputs(torch, tp)
    res = {"card": smi, "shape": [B, H, W]}
    res.update(_table(torch, views, step_args, maps))
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
