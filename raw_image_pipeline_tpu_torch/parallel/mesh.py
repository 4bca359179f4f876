"""Device mesh and sharded batches (PyTorch port of
raw_image_pipeline_tpu/parallel/mesh.py).

A mesh is a [data, space] grid of torch devices:

  * axis "data"  — frames are independent; a batch splits over the data
    axis as torch.tensor_split splits it (the first shards take one frame
    more), and over processes first where the mesh spans several
    (parallel/multihost.py);
  * axis "space" — an optional split of each frame over its rows into
    slabs. Slabs start on even rows, so that every slab keeps the Bayer
    phase of the frame. The stencils, the CCC histogram and the remap read
    across slab boundaries; PyTorch has no partitioner, so the pipeline
    does that split itself with explicit halos, windows and integer sums
    (parallel/spatial.py), and runs its hand-written kernels on every
    shard.

A device may repeat in a mesh, as in make_mesh(["cpu"] * 8, space=2) or
make_mesh(["cuda:0"] * 4, space=4): each entry is a logical shard, so a
single card (or the CPU) carries several shards, and a sharded call must
equal the unsharded call byte for byte on any mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raw_image_pipeline_tpu_torch.ops.common import resolve_device

Range = Tuple[int, int]


class Mesh:
    """A [data, space] grid of devices, axis_names ("data", "space").

    `devices` holds this process's rows of the grid ([local data, space]);
    a mesh made by multihost.global_data_mesh spans `process_count`
    processes, each with as many data rows, so that its data axis is
    local data * process_count long."""

    axis_names = ("data", "space")

    def __init__(self, devices, process_count: int = 1, process_index: int = 0):
        grid = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError("a mesh needs a non-empty [data, space] grid of devices")
        self.devices = grid
        self.process_count = process_count
        self.process_index = process_index

    @property
    def local_data(self) -> int:
        return self.devices.shape[0]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.local_data * self.process_count, "space": self.devices.shape[1]}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["space"]

    def local_devices(self) -> List[torch.device]:
        """This process's devices in (data, space) row-major order."""
        return list(self.devices.reshape(-1))

    def __repr__(self):
        return (f"Mesh({self.shape}, local devices {[str(d) for d in self.local_devices()]}"
                f", process {self.process_index}/{self.process_count})")


def make_mesh(devices: Optional[Sequence] = None, space: int = 1) -> Mesh:
    """A [n // space, space] mesh over `devices` (default: every local CUDA
    device; RuntimeError without one, as every entry point of the port).
    A device may repeat (logical shards)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if space < 1 or n % space != 0:
        raise ValueError(f"space={space} must divide device count {n}")
    return Mesh(np.array(devices, dtype=object).reshape(n // space, space))


@dataclass(frozen=True)
class ShardingSpec:
    """Which axis of an ndim array each mesh axis splits (the counterpart
    of a jax NamedSharding): spec[i] is "data", "space" or None."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def batch_sharding(mesh: Mesh, ndim: int) -> ShardingSpec:
    """The leading batch axis over "data"; everything else replicated."""
    return ShardingSpec(mesh, ("data",) + (None,) * (ndim - 1))


def spatial_sharding(mesh: Mesh, ndim: int) -> ShardingSpec:
    """The batch over "data" and H (axis 1) over "space"."""
    return ShardingSpec(mesh, ("data", "space") + (None,) * (ndim - 2))


def split_frames(n: int, parts: int) -> List[Range]:
    """[start, stop) of each of `parts` shards of n frames, as
    torch.tensor_split splits them."""
    q, r = divmod(n, parts)
    bounds, start = [], 0
    for i in range(parts):
        stop = start + q + (1 if i < r else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


def split_rows(h: int, parts: int) -> List[Range]:
    """[start, stop) rows of each of `parts` slabs of an h-row frame: the
    frame's row pairs split as tensor_split splits them, so every slab
    starts on an even row (and keeps the Bayer phase)."""
    return [(min(h, 2 * a), min(h, 2 * b)) for a, b in split_frames((h + 1) // 2, parts)]


def check_rows(h: int, space: int, what: str) -> None:
    """Raise unless every one of `space` slabs of h rows holds a row."""
    if space > (h + 1) // 2:
        raise ValueError(f"{what}: {h} rows cannot split into {space} slabs of whole row "
                         f"pairs; use space <= {(h + 1) // 2}")


def _process_frames(n: int, mesh: Mesh) -> Range:
    """This process's frames of a global batch of n."""
    return split_frames(n, mesh.process_count)[mesh.process_index]


@dataclass
class ShardedBatch:
    """A batch split over a mesh: this process's shards, each at
    shards[(d, s)] (d a local data row) with its index
    ((frame start, stop), (row start, stop)) in the global array of shape
    `shape`. Frames lie on axis 0 and rows on `row_axis`. A shard of a
    batch that is not split over space holds every row (its replicas over
    space are views of one tensor). Data rows without frames hold no
    shard."""

    mesh: Mesh
    shape: Tuple[int, ...]
    dtype: torch.dtype
    shards: Dict[Tuple[int, int], torch.Tensor]
    index: Dict[Tuple[int, int], Tuple[Range, Range]]
    row_axis: int = 1
    spatial: bool = False

    def local_frames(self) -> Range:
        """The global frames this process holds."""
        return _process_frames(self.shape[0], self.mesh)

    def local(self, device=None) -> torch.Tensor:
        """This process's frames, whole, on `device` (default: the first
        shard's)."""
        f0, f1 = self.local_frames()
        dev = torch.device(device) if device is not None else self.mesh.devices[0, 0]
        out = torch.empty((f1 - f0,) + tuple(self.shape[1:]), dtype=self.dtype, device=dev)
        for key, t in self.shards.items():
            (a, b), (r0, r1) = self.index[key]
            if self.spatial or key[1] == 0:
                idx = [slice(a - f0, b - f0)] + [slice(None)] * (len(self.shape) - 1)
                idx[self.row_axis] = slice(r0, r1)
                out[tuple(idx)].copy_(t)
        return out

    def gather(self, device=None) -> torch.Tensor:
        """The whole global array on `device`; across processes an
        all-gather of every process's frames (torch.distributed)."""
        local = self.local(device)
        if self.mesh.process_count == 1:
            return local
        from raw_image_pipeline_tpu_torch.parallel import multihost

        return multihost.all_gather_frames(local)


def shard_batch(pixels, mesh: Mesh, spatial: bool = False, *,
                row_axis: int = 1) -> ShardedBatch:
    """Split a global batch (tensor or numpy array; frames on axis 0) over
    `mesh`: frames over "data", and with spatial=True rows (row_axis) over
    "space" in even-start slabs. Each shard is copied to its device (a
    view where it is already there). In a mesh over several processes
    every process passes the global batch and keeps its own frames: a
    batch that does not split into equal non-empty shares of the processes
    raises ValueError (the all-gathers over the processes need equal
    shapes on every rank)."""
    pixels = as_tensor(pixels)
    n, procs = pixels.shape[0], mesh.process_count
    if procs > 1 and (n == 0 or n % procs):
        raise ValueError(f"a global batch of {n} frames does not split evenly over "
                         f"{procs} processes; pass a positive multiple of {procs}")
    f0, f1 = _process_frames(n, mesh)
    return shard_local(pixels[f0:f1], mesh, pixels.shape[0], f0, spatial, row_axis)


def as_tensor(pixels) -> torch.Tensor:
    if isinstance(pixels, torch.Tensor):
        return pixels
    return torch.as_tensor(np.ascontiguousarray(pixels))


def shard_local(local: torch.Tensor, mesh: Mesh, n_global: int, f0: int,
                spatial: bool = False, row_axis: int = 1) -> ShardedBatch:
    """The ShardedBatch of a global batch of n_global frames whose frames
    [f0, f0 + len(local)) are this process's `local` frames."""
    shape = (n_global,) + tuple(local.shape[1:])
    space = mesh.shape["space"]
    if spatial:
        check_rows(shape[row_axis], space, "pixels")
    rows = split_rows(shape[row_axis], space) if spatial else [(0, shape[row_axis])] * space
    shards, index = {}, {}
    for d, (a, b) in enumerate(split_frames(local.shape[0], mesh.local_data)):
        if a == b:
            continue  # no frames: this data row holds no shard
        whole = {}
        for s, (r0, r1) in enumerate(rows):
            dev = mesh.devices[d, s]
            idx = [slice(a, b)] + [slice(None)] * (len(shape) - 1)
            idx[row_axis] = slice(r0, r1)
            if spatial:
                t = local[tuple(idx)].to(dev, non_blocking=True)
            else:  # replicas over space: one copy per device
                if dev not in whole:
                    whole[dev] = local[tuple(idx)].to(dev, non_blocking=True)
                t = whole[dev]
            shards[(d, s)] = t
            index[(d, s)] = ((f0 + a, f0 + b), (r0, r1))
    return ShardedBatch(mesh, shape, local.dtype, shards, index, row_axis, spatial)
