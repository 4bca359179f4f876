"""Data-parallel bench of the full ISP chain over processes and devices (the
PyTorch port of raw_image_pipeline_tpu/tools/pod_bench.py).

    # on every host (or as every rank on one host):
    python -m raw_image_pipeline_tpu_torch.tools.pod_bench \
        --coordinator HOST0:1234 --num-processes N --process-id I

It joins the process group (parallel/multihost.py), forms the global data
mesh over every process's devices, builds the flagship chain (flip 180,
debayer A, CCC + Kalman, colour calibration, gamma, vignetting, HSV,
fisheye remap) with that mesh, feeds each process its own frames
(distribute_batch), times back-to-back calls of the global step and prints
process 0's one JSON line: frames/s over every device and per process, the
single-device frames/s of the same per-device batch measured in the same
process, and their ratio, the scaling efficiency. Before timing, it holds
one "sequence" call with the Kalman track against the unsharded chain on
the global batch (check_exact) and exits non-zero where they differ.

--device cpu runs the plain versions on the CPU (the test's smoke);
--local-devices counts a process's shards, which may be logical shards of
one device. Ranks that share a card need --backend gloo (NCCL refuses
them). Timing: the host's clock around whole calls that end in a
synchronize of every local card, between barriers of all ranks: the time
of a call is t(k back-to-back calls) / k, the median over --rounds (a
steady rate that counts the host's work per call; the JAX tool's marginal
of k over 2 calls can come out negative on a busy host).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def call_seconds(call, sync, k: int, rounds: int) -> float:
    """Seconds of one call(): k back-to-back calls between barriers,
    ending in sync(), divided by k; the median of rounds."""
    from raw_image_pipeline_tpu_torch.parallel.multihost import barrier

    def run(n):
        barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        sync()
        barrier()
        return time.perf_counter() - t0

    return statistics.median(run(k) / k for _ in range(rounds))


def _frames(process: int, n: int, h: int, w: int):
    """The seeded raw frames a process ingests (every process can make
    every process's)."""
    return np.random.default_rng(1234 + process).integers(0, 256, (n, h, w), np.uint8)


def check_exact(tp, config, mesh, gbatch, every_local) -> None:
    """The sharded step equals the unsharded one: one "sequence" call with
    the Kalman track (its measurements all-gathered over the processes)
    against the chain on this process's first device over the global
    batch (every process's frames, `every_local`, in order), outputs
    all-gathered; raises on a mismatching byte or state."""
    import torch

    h, w = gbatch.shape[1:]
    dev = mesh.devices[0, 0]
    kw = dict(with_state=True, temporal_mode="sequence")
    sharded = tp.build_pipeline(config, "bayer_gbrg8", (h, w), mesh=mesh, **kw)
    whole = tp.build_pipeline(config, "bayer_gbrg8", (h, w), device=dev, **kw)
    out, state = sharded(gbatch, tp.init_state((), device=dev))
    got = out["processed"].gather(dev)
    ref, ref_state = whole(torch.as_tensor(np.concatenate(every_local)).to(dev),
                           tp.init_state((), device=dev))
    bad = int((got != ref["processed"]).sum())
    same = all(torch.equal(getattr(state, f), getattr(ref_state, f))
               for f in ("x", "p", "initialized"))
    log(f"[pod_bench] sharded vs unsharded, {tuple(got.shape)}: {bad} mismatching bytes, "
        f"Kalman state equal: {same}")
    if bad or not same:
        raise RuntimeError("pod_bench: the sharded step differs from the unsharded step")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port (process 0's host)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="torch.distributed backend (default: nccl with CUDA, else gloo)")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--batch-per-device", type=int, default=64)
    ap.add_argument("--k-dispatch", type=int, default=6,
                    help="back-to-back calls per timing round")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--local-devices", type=int, default=None,
                    help="shards of this process (logical shards of its device where "
                         "the process has one); default: every card of a lone process, "
                         "else the rank's card; 1 on the CPU")
    args = ap.parse_args(argv)
    if args.k_dispatch < 1:
        ap.error("--k-dispatch must be >= 1")

    import torch

    import raw_image_pipeline_tpu_torch as tp
    from raw_image_pipeline_tpu_torch.ops.common import resolve_device
    from raw_image_pipeline_tpu_torch.parallel.multihost import (
        distribute_batch,
        global_data_mesh,
        initialize_multihost,
    )

    resolve_device(args.device)
    n_proc = args.num_processes or 1
    if n_proc > 1:
        backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
        initialize_multihost(args.coordinator, n_proc, args.process_id, backend=backend)
    pid = args.process_id or 0
    if args.device == "cpu":
        devices = ["cpu"] * (args.local_devices or 1)
    else:
        card = torch.device("cuda", torch.cuda.current_device())
        if args.local_devices is None and n_proc == 1:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [card] * (args.local_devices or 1)
    mesh = global_data_mesh(devices=devices)
    n_dev = mesh.shape["data"]
    n_local = mesh.local_data
    log(f"[pod_bench] proc {pid}/{n_proc}, {n_local} local / {n_dev} global shards "
        f"({[str(d) for d in mesh.local_devices()]})")

    h, w = args.height, args.width
    config = tp.flagship_config(h, w)
    pipe = tp.build_pipeline(config, "bayer_gbrg8", (h, w), mesh=mesh)
    cards = sorted({d for d in mesh.local_devices() if d.type == "cuda"}, key=str)

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    # each process ingests its own frames only
    b_local = args.batch_per_device * n_local
    local = _frames(pid, b_local, h, w)
    gbatch = distribute_batch(local, mesh)
    b_global = args.batch_per_device * n_dev

    t0 = time.perf_counter()
    pipe(gbatch)
    sync()
    log(f"[pod_bench] first call: {time.perf_counter() - t0:.1f}s")
    check_exact(tp, config, mesh, gbatch, [_frames(p, b_local, h, w) for p in range(n_proc)])
    spf = call_seconds(lambda: pipe(gbatch), sync, args.k_dispatch,
                       args.rounds) / b_global
    global_fps = 1.0 / spf

    # the single-device arm, same process, same per-device batch: the
    # efficiency's denominator (an unsharded build on the first device)
    dev0 = mesh.devices[0, 0]
    pipe1 = tp.build_pipeline(config, "bayer_gbrg8", (h, w), device=dev0)
    one = torch.as_tensor(local[:args.batch_per_device]).to(dev0)
    pipe1(one)
    sync()
    spf1 = call_seconds(lambda: pipe1(one), sync, args.k_dispatch,
                        args.rounds) / args.batch_per_device
    chip_fps = 1.0 / spf1
    result = {
        "metric": "pod_scaling_full_isp",
        "frame": f"{w}x{h}",
        "processes": n_proc,
        "devices": n_dev,
        "batch_per_device": args.batch_per_device,
        "global_fps": global_fps,
        "per_host_fps": global_fps / n_proc,
        "single_chip_fps": chip_fps,
        "scaling_efficiency": global_fps / (chip_fps * n_dev),
    }
    log(f"[pod_bench] proc {pid}: {json.dumps(result)}")
    if pid == 0:
        print(json.dumps(result), flush=True)
    if n_proc > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
