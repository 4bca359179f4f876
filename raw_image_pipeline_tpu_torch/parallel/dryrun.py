"""The dry run of a sharded step: the counterpart of the JAX package's
__graft_entry__.dryrun_multichip, on the port's mesh.

    python -m raw_image_pipeline_tpu_torch.parallel.dryrun 8 --device cpu
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

# the frame of the JAX dry run: the CCC working resize (360x270) is a real
# downsample and the fisheye remap's displacements are not trivial
DRYRUN_HW = (272, 368)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run the full flagship chain (flip 180, debayer A, CCC with the
    Kalman track, colour calibration, gamma, vignetting, HSV, fisheye
    remap) over a data x space mesh of n_devices (space 2 where n is even)
    at 272x368 with B = 2 * data, seed 0, in both temporal modes, and
    assert its outputs and Kalman x / initialized (and p) bit-equal to the
    unsharded build. devices: the mesh's devices (a device may repeat,
    e.g. ["cpu"] * 8); None takes the first n_devices cards and raises
    where there are fewer — it never falls back to the CPU. Returns
    {temporal mode: (processed on the CPU, the final state's x)}."""
    import raw_image_pipeline_tpu_torch as tp
    from raw_image_pipeline_tpu_torch.ops.common import resolve_device
    from raw_image_pipeline_tpu_torch.parallel.mesh import make_mesh

    if devices is None:
        resolve_device("cuda")
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip needs {n_devices} CUDA devices, "
                               f"{torch.cuda.device_count()} present")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = list(devices)[:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"dryrun_multichip: {n_devices} devices asked, {len(devices)} given")
    space = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(devices, space=space)
    data = n_devices // space
    h, w = DRYRUN_HW
    batch = 2 * data
    config = tp.flagship_config(h, w)
    pixels = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (batch, h, w), np.uint8))
    ref_dev = devices[0]
    results = {}
    for mode in ("cameras", "sequence"):
        shape = (batch,) if mode == "cameras" else ()
        sharded = tp.build_pipeline(config, "bayer_gbrg8", (h, w), with_state=True,
                                    temporal_mode=mode, mesh=mesh)
        whole = tp.build_pipeline(config, "bayer_gbrg8", (h, w), with_state=True,
                                  temporal_mode=mode, device=ref_dev)
        out, state = sharded(pixels, tp.init_state(shape, device=ref_dev))
        processed = out["processed"].gather("cpu")
        assert tuple(processed.shape) == (batch, h, w, 3), processed.shape
        ref, ref_state = whole(pixels.to(ref_dev), tp.init_state(shape, device=ref_dev))
        assert torch.equal(processed, ref["processed"].cpu()), f"{mode}: outputs differ"
        for f in ("x", "p", "initialized"):
            assert torch.equal(getattr(state, f).cpu(), getattr(ref_state, f).cpu()), \
                f"{mode}: Kalman {f} differs"
        results[mode] = (processed, state.x.cpu())
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None,
                    help="repeat this device n times (logical shards), e.g. cpu or cuda:0; "
                         "default: the first n cards")
    args = ap.parse_args(argv)
    devices = [args.device] * args.n_devices if args.device else None
    dryrun_multichip(args.n_devices, devices)
    print(f"dryrun_multichip({args.n_devices}): sharded == unsharded in both temporal modes")


if __name__ == "__main__":
    main()
