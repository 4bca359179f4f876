"""Data parallelism across processes on torch.distributed (PyTorch port of
raw_image_pipeline_tpu/parallel/multihost.py).

    initialize_multihost("host0:1234", num_processes=N, process_id=i)
    mesh = global_data_mesh()              # data axis over every process
    batch = distribute_batch(local_frames, mesh)
    outputs, state = pipe(batch, state)    # build_pipeline(..., mesh=mesh)

The data axis spans the processes, each with the same number of local
shards; the space axis stays inside a process, as the JAX package keeps it
inside a host. The only collectives of a pipeline call are the all-gather
of the CCC measurements in "sequence" mode (B x 2 int32) and, where asked
for, ShardedBatch.gather of the outputs.

Backends: NCCL where each rank has its own card, gloo for CPU processes.
Ranks that share a card (two processes on one GPU) need gloo, named
explicitly: NCCL refuses them, and initialize_multihost says so before
the first collective. Under gloo the collectives of CUDA shards move their
tensors through the host; that runs only when gloo was asked for.
"""

from __future__ import annotations

import datetime
import socket
import sys
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from raw_image_pipeline_tpu_torch.ops.common import resolve_device
from raw_image_pipeline_tpu_torch.parallel.mesh import Mesh, ShardedBatch, as_tensor, shard_local

_GLOO_ASKED = False  # gloo named by the caller (may carry CUDA shards)


def _card_id(index: int) -> str:
    """This host's name and the card's UUID (or index): two ranks with the
    same id share a card."""
    props = torch.cuda.get_device_properties(index)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else index}"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout_s: float = 300.0,
) -> None:
    """Join the process group (a no-op for one process or none, as in the
    JAX package): init_process_group with init_method
    "tcp://<coordinator_address>". backend defaults to "nccl" where CUDA
    is available (each rank then takes card process_id % cards) and to
    "gloo" otherwise. NCCL with two ranks on one card raises
    RuntimeError before any collective; gloo with CUDA shards runs only
    when backend="gloo" is passed, and the backend in use is printed.
    timeout_s bounds every wait of the group (rendezvous, collectives)."""
    global _GLOO_ASKED

    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        resolve_device("cuda")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _GLOO_ASKED = backend == "gloo"
    if backend == "nccl":
        # the rendezvous store, not a collective: every rank names its card
        store = dist.distributed_c10d._get_default_store()
        store.set(f"isp_card/{process_id}", _card_id(torch.cuda.current_device()))
        cards = [store.get(f"isp_card/{r}").decode() for r in range(num_processes)]
        shared = [r for r, c in enumerate(cards) if c == cards[process_id] and r != process_id]
        if shared:
            dist.destroy_process_group()
            raise RuntimeError(
                f"NCCL cannot run ranks {sorted([process_id] + shared)} on one card "
                f"({cards[process_id]}); pass backend='gloo' for ranks that share a card")
    print(f"[multihost] rank {process_id}/{num_processes}: torch.distributed backend "
          f"{backend}" + (" (collectives of CUDA tensors go through the host)"
                          if backend == "gloo" and torch.cuda.is_available() else ""),
          file=sys.stderr, flush=True)


def _check_axis(axis: str) -> None:
    """The port's mesh names its axes ("data", "space"): the data axis is
    always "data"."""
    if axis != "data":
        raise ValueError(f"axis={axis!r}: the port's mesh runs frames over its axis 'data' "
                         f"(its axes are {Mesh.axis_names}); another name is not supported")


def global_data_mesh(axis: str = "data", *, devices: Optional[Sequence] = None,
                     space: int = 1) -> Mesh:
    """The mesh whose data axis runs over every process's local devices
    (this process's: `devices`, default every local card in one process
    and this rank's card where there are several, the CPU without CUDA
    under gloo), each process's rows [len(devices) // space, space].
    axis names the data axis as in the reference package; the port's mesh
    calls it "data", and any other name raises ValueError."""
    _check_axis(axis)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if devices is None:
        if world > 1 and not torch.cuda.is_available():
            devices = ["cpu"]
        elif world > 1:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            resolve_device("cuda")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if len(devices) % space:
        raise ValueError(f"space={space} must divide the {len(devices)} local devices")
    grid = np.array(devices, dtype=object).reshape(len(devices) // space, space)
    return Mesh(grid, process_count=world, process_index=rank)


def distribute_batch(local_batch, mesh: Optional[Mesh] = None, axis: str = "data", *,
                     spatial: bool = False, row_axis: int = 1) -> ShardedBatch:
    """The global batch of every process's [B_local, ...] frames (equal
    B_local on every process): a ShardedBatch of shape
    [B_local * processes, ...] whose local shards are this process's
    frames, split over its data rows (and rows over space with
    spatial=True). This is the ingestion point of each process's frame
    pump. axis: the data axis, "data" (see global_data_mesh)."""
    _check_axis(axis)
    if mesh is None:
        mesh = global_data_mesh(axis)
    local = as_tensor(local_batch)
    n = local.shape[0]
    return shard_local(local, mesh, n * mesh.process_count, n * mesh.process_index,
                       spatial, row_axis)


def _backend_device(t: torch.Tensor) -> torch.device:
    """Where a collective's tensor must lie for the group's backend."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if t.is_cuda and not _GLOO_ASKED:
        raise RuntimeError("a gloo process group with CUDA shards: pass backend='gloo' to "
                           "initialize_multihost to run their collectives through the host")
    return torch.device("cpu")


def all_gather_frames(local: torch.Tensor) -> torch.Tensor:
    """Every process's `local` [n, ...] (equal shapes), concatenated in
    rank order, on local's device."""
    dev = _backend_device(local)
    src = local.to(dev).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(local.device)


def barrier() -> None:
    """Wait for every process (no-op in one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
