"""The spatial split: how each stage of the chain runs on a slab of rows,
and the executor that runs the chain over a mesh.

The JAX package leaves this work to GSPMD (halo exchanges, psums,
gathers). PyTorch has no partitioner, so the port does the split itself,
and in return keeps its hand-written kernels on every shard. Every rule is
exact by construction, so a sharded call equals the unsharded call byte
for byte, the Kalman state included:

  * flip 180 — slab s of the flipped frame is the frame's rows
    [H - r1, H - r0), reversed (on the raw mosaic where the flip is
    hoisted there, even H and W; on the three planes otherwise);
  * flip 90/270, the statistical white balances (grey-world's flattened
    scalar tail, PCA, learned; simple's percentiles) and every stage
    without a rule of its own — the gather rule: every shard gathers the
    frame's rows, computes, and keeps its own slab;
  * debayer (kernels A and D, the 16-bit stencil) — a 2-row halo from each
    neighbour, so that the halo'd slab starts on the frame's Bayer phase;
    the border replication (A) and clamp (D) of the halo'd slab fall on
    halo rows, except at the frame's true first and last rows;
  * CCC resize — each shard makes the resized rows whose source row sy
    (ops/resize._tables_y) lies in its slab, with row sy+1 from below as
    its halo;
  * CCC histogram — kernel B (or its plain version) with pixel weight 1
    gives integer counts; they are summed in int32 over the space axis
    and scaled once by f32(1/(270*360)), which equals the unsharded
    histogram bit for bit (a*w + b*w is not (a+b)*w in f32);
  * response (kernel C), argmax, Kalman and gains run identically on
    every space shard of a frame; in "sequence" mode over a data split
    the measurements (B x 2 integers) are all-gathered over data (and
    across processes) and every shard runs the same Kalman scan and keeps
    its own frames' gains;
  * vignetting — the mask's rows are sliced per slab; colour calibration,
    gamma and the HSV enhancer are pointwise;
  * remap (lerp, float = kernel E, fixed32) — each output slab reads a
    window of source rows computed at build time from its map
    (remap_window); the window's rows are exchanged, and the slab's map is
    rebased to the window.

A chain (pipeline.make_isp_chain) is a generator: it runs one shard's
stages and yields a request at each point where shards exchange rows or
numbers (Fetch, SumSpace, GatherData). `run_whole` answers them for a
single part (the unsharded call, no copy); `run_mesh` runs one generator
per shard and answers each request once every shard of the data row (or
of the mesh, for GatherData) has made it. Every operation it issues is
asynchronous: nothing waits on a device between shards, so shards on
distinct cards overlap. MeshFn is build_pipeline's call over a mesh: it
splits the batch, gives each shard its params (shard_params) and drives
run_mesh.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Generator, Optional, Tuple

import numpy as np
import torch

from raw_image_pipeline_tpu_torch.config import PipelineConfig
from raw_image_pipeline_tpu_torch.ops import ccc as ccc_ops
from raw_image_pipeline_tpu_torch.parallel.mesh import (
    Range,
    ShardedBatch,
    check_rows,
    shard_batch,
    split_rows,
)
from raw_image_pipeline_tpu_torch.pipeline import (
    IspParams,
    IspState,
    _map_state,
    _runs_undistortion,
    params_from_numpy,
    remap_code_of,
)

# rows a slab of the mosaic takes from each neighbour for the debayer: the
# 5x5 MHT stencil reads 2, bilinear 1; 2 keeps the halo'd slab's start on
# the frame's Bayer phase for both
DEBAYER_HALO = 2


@dataclass(frozen=True)
class Part:
    """Which slab of the frame a chain computes: slab `index` of `count`
    (parallel/mesh.split_rows in every row domain: the input, the
    post-flip frame, the remap's output), of an input `height` rows
    high."""

    index: int = 0
    count: int = 1
    height: Optional[int] = None

    def rows(self, h: int) -> Range:
        if self.count == 1:
            return (0, h)
        return split_rows(h, self.count)[self.index]


# ---------------------------------------------------------------------------
# The rules' host-side tables
# ---------------------------------------------------------------------------


def debayer_halo(h: int, r0: int, r1: int) -> Range:
    """The mosaic rows the debayer of slab [r0, r1) reads."""
    return max(0, r0 - DEBAYER_HALO), min(h, r1 + DEBAYER_HALO)


def flip180_rows(h: int, r0: int, r1: int) -> Range:
    """The rows of the frame whose 180-degree flip is rows [r0, r1)."""
    return h - r1, h - r0


def resize_slab(src_h: int, dst_h: int, r0: int, r1: int) -> Tuple[int, int, int, int]:
    """(y0, y1, a, b): the resized rows [y0, y1) whose source row sy lies
    in [r0, r1), and the source rows [a, b) they read (sy and sy+1)."""
    from raw_image_pipeline_tpu_torch.ops.resize import _tables_y

    sy0, sy1, _, _ = _tables_y(src_h, dst_h)
    ys = np.nonzero((sy0 >= r0) & (sy0 < r1))[0]
    if ys.size == 0:
        y = int(np.searchsorted(sy0, r0))
        return y, y, r0, r0
    y0, y1 = int(ys[0]), int(ys[-1]) + 1
    return y0, y1, int(sy0[y0]), int(sy1[y1 - 1]) + 1


def remap_live(weights: np.ndarray, mode: str) -> np.ndarray:
    """[..., n] bool: the output pixels with a tap in the image (fully
    out-of-image pixels carry base 0 and zero weights or masks)."""
    w = weights[..., 2:6, :] if mode == "lerp" else weights
    return (w != 0).any(axis=-2)


def remap_taps(base: np.ndarray, mode: str, src_hw: Tuple[int, int]) -> np.ndarray:
    """[..., 4, n] flat source positions the remap reads for each output
    pixel, in frame coordinates as the plain versions read them: the lerp
    clamps its taps into the frame; float and fixed32 read base + {0, 1,
    w, w+1} (a position outside the frame reads 0)."""
    h, w = src_hw
    b = base.astype(np.int64)
    if mode == "lerp":
        b = b - (w + 1)
    taps = np.stack([b + off for off in (0, 1, w, w + 1)], axis=-2)
    if mode == "lerp":
        taps = np.clip(taps, 0, h * w - 1)
    return taps


def remap_window(base: np.ndarray, weights: np.ndarray, mode: str,
                 src_hw: Tuple[int, int], out_w: int,
                 out_rows: Range) -> Tuple[np.ndarray, np.ndarray, Range]:
    """The map of output rows out_rows = [o0, o1) and the source rows
    [wa, wb) it reads: (base rebased to the window, weights, (wa, wb)).
    base [..., N] and weights [..., k, N] are remap_precompute's (flat, or
    stacked per camera); the window covers every in-frame tap of every
    pixel with a tap in the image, zero-weight taps included, over all
    cameras. Fully out-of-image pixels (base 0, zero weights) would widen
    every window to row 0: they are left out and rebased to 0, where
    their zero weights still read nothing. A slab without such a pixel
    gets the window [0, 1)."""
    h, w = src_hw
    n0, n1 = out_rows[0] * out_w, out_rows[1] * out_w
    b = base[..., n0:n1]
    wt = weights[..., n0:n1]
    live = remap_live(wt, mode)
    taps = remap_taps(b, mode, src_hw)
    inside = (taps >= 0) & (taps < h * w) & live[..., None, :]
    rows = taps[inside] // w
    wa, wb = (int(rows.min()), int(rows.max()) + 1) if rows.size else (0, 1)
    rebased = np.where(live, b.astype(np.int64) - wa * w, 0).astype(np.int32)
    return rebased, np.ascontiguousarray(wt), (wa, wb)


# ---------------------------------------------------------------------------
# Requests a chain yields, and their answers
# ---------------------------------------------------------------------------


@dataclass
class Fetch:
    """This shard's slab `tensors` (rows `have` of the frame, on axis 1)
    in, the frame's rows `want` out (a tuple like `tensors`, on this
    shard's device)."""

    tensors: Tuple[torch.Tensor, ...]
    have: Range
    want: Range

    def whole(self):
        if self.want == self.have:
            return self.tensors
        a, b = self.want[0] - self.have[0], self.want[1] - self.have[0]
        return tuple(t[:, a:b] for t in self.tensors)


@dataclass
class SumSpace:
    """Integer counts in, their sum over the space shards out (int32)."""

    counts: torch.Tensor

    def whole(self):
        return self.counts


@dataclass
class GatherData:
    """This shard's frames' measurements [n, ...] in; out (every frame's,
    concatenated in frame order over the data axis and the processes, the
    index of this shard's first frame in them)."""

    values: torch.Tensor

    def whole(self):
        return self.values, 0


def run_whole(chain):
    """Run a chain generator over the whole frame, answering its requests
    locally (views, no copies). Returns the chain's result."""
    try:
        request = next(chain)
        while True:
            request = chain.send(request.whole())
    except StopIteration as stop:
        return stop.value


def _fetch_answers(requests: Dict[int, Fetch], devices) -> Dict[int, tuple]:
    """Answer a data row's Fetch requests from its shards' slabs."""
    out = {}
    for s, req in requests.items():
        a, b = req.want
        own0, own1 = req.have
        if own0 <= a and b <= own1:  # all rows are this shard's own
            out[s] = req.whole()
            continue
        pieces = []  # per plane, the pieces of rows [a, b) in order
        for _, other in sorted(requests.items(), key=lambda kv: kv[1].have[0]):
            lo, hi = max(a, other.have[0]), min(b, other.have[1])
            if lo >= hi:
                continue
            pieces.append(tuple(x[:, lo - other.have[0]:hi - other.have[0]].to(
                devices[s], non_blocking=True) for x in other.tensors))
        if not pieces:  # an empty range
            out[s] = tuple(x[:, :0] for x in req.tensors)
        else:
            out[s] = tuple(torch.cat(p, dim=1) if len(p) > 1 else p[0].contiguous()
                           for p in zip(*pieces))
    return out


def _sum_answers(requests: Dict[int, SumSpace], devices) -> Dict[int, torch.Tensor]:
    """The space shards' counts summed in int32, in shard order, on each
    shard's device."""
    keys = sorted(requests)
    dev0 = devices[keys[0]]
    total = requests[keys[0]].counts.to(torch.int32)
    for s in keys[1:]:
        total = total + requests[s].counts.to(dev0, non_blocking=True).to(torch.int32)
    return {s: total.to(devices[s], non_blocking=True) for s in keys}


def run_mesh(rows: Dict[int, Dict[int, Generator]], devices, frame_starts: Dict[int, int],
             gather_processes: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
             ) -> Dict[Tuple[int, int], object]:
    """Run one chain generator per shard: rows[d][s] for data row d and
    space shard s on devices[d][s]. A data row's shards answer Fetch and
    SumSpace among themselves once all of them have made the request;
    GatherData waits for every row (frame_starts[d]: the global index of
    row d's first frame) and, with gather_processes, for the other
    processes. Returns {(d, s): the chain's result}."""
    pending = {d: {s: next(g) for s, g in gens.items()} for d, gens in rows.items()}
    results: Dict[Tuple[int, int], object] = {}

    def step(d, answers):
        nxt = {}
        for s, g in rows[d].items():
            try:
                nxt[s] = g.send(answers[s])
            except StopIteration as stop:
                results[(d, s)] = stop.value
        if nxt and len(nxt) != len(rows[d]):
            raise RuntimeError(f"data row {d}: its space shards' chains went out of step")
        pending[d] = nxt

    while any(pending.values()):
        waiting = {d: reqs for d, reqs in pending.items() if reqs}
        # every row's local requests first, until each row waits on a gather
        moved = False
        for d, reqs in waiting.items():
            kinds = {type(r) for r in reqs.values()}
            if len(kinds) != 1:
                raise RuntimeError(f"data row {d}: its shards made different requests {kinds}")
            kind = kinds.pop()
            if kind is Fetch:
                step(d, _fetch_answers(reqs, devices[d]))
                moved = True
            elif kind is SumSpace:
                step(d, _sum_answers(reqs, devices[d]))
                moved = True
        if moved:
            continue
        # every row with requests waits on GatherData: one all-gather
        order = sorted(waiting)
        if len(order) != len(rows):
            raise RuntimeError("data rows went out of step: some finished while others gather")
        firsts = [waiting[d][min(waiting[d])].values for d in order]
        dev0 = firsts[0].device
        local = torch.cat([v.to(dev0, non_blocking=True) for v in firsts])
        every = gather_processes(local) if gather_processes is not None else local
        for d in order:
            step(d, {s: (every.to(devices[d][s], non_blocking=True), frame_starts[d])
                     for s in waiting[d]})
    return results


# ---------------------------------------------------------------------------
# The chain over a mesh
# ---------------------------------------------------------------------------


class _Stop(Exception):
    """Ends a first pass at its all-gather (see MeshFn)."""


class MeshFn:
    """A chain over a mesh: fn(pixels, state) -> (outputs, state), pixels a
    ShardedBatch or a global batch (tensor or array), split here.

    Each shard (d, s) runs the chain (make_isp_chain) on its frames and its
    slab of rows with its own params (shard_params[(d, s)]), all shards
    driven together by run_mesh. Outputs come back as
    ShardedBatch per key. state_sharded: the state's leading axis is the
    frames (cameras) of this process, split like them; else the state is
    one track, replicated on every shard. microbatch: each shard runs its
    frames in chunks of that many; in "sequence" mode over more than one
    data shard (gathers), a first pass computes every chunk's CCC
    measurement, and the chunks then run with the measurements of all."""

    def __init__(self, chain, mesh, shard_params, state_sharded: bool, gathers: bool,
                 microbatch: Optional[int] = None, row_axis: int = 1):
        self.chain = chain
        self.mesh = mesh
        self.shard_params = shard_params
        self.state_sharded = state_sharded
        self.gathers = gathers
        self.microbatch = microbatch
        self.row_axis = row_axis

    def _gather_processes(self):
        if self.mesh.process_count == 1:
            return None
        from raw_image_pipeline_tpu_torch.parallel import multihost

        return multihost.all_gather_frames

    def __call__(self, pixels, state: Optional[IspState] = None):
        mesh, space = self.mesh, self.mesh.shape["space"]
        if not isinstance(pixels, ShardedBatch):
            pixels = shard_batch(pixels, mesh, spatial=space > 1, row_axis=self.row_axis)
        if pixels.shape[0] == 0:
            raise ValueError("an empty batch: a mesh call needs at least one frame")
        height = pixels.shape[self.row_axis]
        check_rows(height, space, "pixels")
        slab_rows = split_rows(height, space)
        l0 = pixels.local_frames()[0]
        # per data row: its global frames and, per space shard, its slab
        rows: Dict[int, Tuple[Tuple[int, int], Dict[int, torch.Tensor]]] = {}
        for (d, s), t in pixels.shards.items():
            frames, have = pixels.index[(d, s)]
            want = slab_rows[s]
            if have != want:  # a replica of every row: this shard's slab of it
                t = t.narrow(self.row_axis, want[0] - have[0], want[1] - want[0])
            rows.setdefault(d, (frames, {}))[1][s] = t
        devices = {d: {s: mesh.devices[d, s] for s in range(space)} for d in rows}
        states = {}
        for d, ((f0, f1), slabs) in rows.items():
            for s in slabs:
                pick = (lambda v: v[f0 - l0:f1 - l0]) if self.state_sharded else (lambda v: v)
                states[(d, s)] = None if state is None else _map_state(
                    lambda v: pick(v).to(mesh.devices[d, s], non_blocking=True), state)
        # each row's chunks of frames, relative to the row's first frame
        mb = self.microbatch
        chunks = {d: [(a, min(a + mb, f1 - f0)) for a in range(0, f1 - f0, mb)]
                  if mb and f1 - f0 > mb else [(0, f1 - f0)]
                  for d, ((f0, f1), _) in rows.items()}
        n_chunks = max(len(c) for c in chunks.values())

        def run(k, states, hook, starts):
            """Chunk k of every row that has one, each shard's chain."""
            gens = {}
            for d, (_, slabs) in rows.items():
                if k < len(chunks[d]):
                    a, b = chunks[d][k]
                    gens[d] = {s: self.chain(self.shard_params[(d, s)], t[a:b], states[(d, s)],
                                             Part(s, space, height)) for s, t in slabs.items()}
            return run_mesh(gens, devices, starts, hook)

        first = {d: f0 for d, ((f0, _), _) in rows.items()}
        results: Dict[Tuple[int, int], list] = {}

        def keep(out):
            for key, (outputs, st, heights) in out.items():
                results.setdefault(key, []).append((outputs, heights))
                states[key] = st

        if n_chunks == 1:
            keep(run(0, states, self._gather_processes(), first))
        elif self.gathers and state is not None and mesh.shape["data"] > 1:
            # pass 1: every chunk's measurements, then every frame's in
            # frame order (over the processes too)
            measured = {}
            for k in range(n_chunks):
                order = [d for d in sorted(rows) if k < len(chunks[d])]

                def record(local, k=k, order=order):
                    for d, piece in zip(order, torch.split(
                            local, [chunks[d][k][1] - chunks[d][k][0] for d in order])):
                        measured[(d, k)] = piece
                    raise _Stop
                try:
                    run(k, states, record, first)
                except _Stop:
                    pass
            local = torch.cat([measured[(d, k)] for d in sorted(rows)
                               for k in range(len(chunks[d]))])
            gather = self._gather_processes()
            every = gather(local) if gather is not None else local
            # pass 2: each chunk from the batch's first state, with every
            # frame's measurements
            initial = dict(states)
            for k in range(n_chunks):
                keep(run(k, initial, lambda _: every,
                         {d: first[d] + chunks[d][k][0] for d in rows if k < len(chunks[d])}))
        else:
            # chunks in order, the state carried (a measurement gather
            # spans one data row here: the chunk's own frames)
            for k in range(n_chunks):
                keep(run(k, states, None, {d: 0 for d in rows}))
        return self._assemble(pixels, results, states, state)

    def _assemble(self, pixels, results, states, state):
        """Each output's shards as one ShardedBatch (a shard's chunks
        concatenated), and the new state whole on the given state's
        device."""
        space = self.mesh.shape["space"]
        outputs: Dict[str, ShardedBatch] = {}
        heights = results[min(results)][0][1]
        for name, height in heights.items():
            shards, index = {}, {}
            for key, parts in results.items():
                shards[key] = torch.cat([o[name] for o, _ in parts]) if len(parts) > 1 \
                    else parts[0][0][name]
                index[key] = (pixels.index[key][0], split_rows(height, space)[key[1]])
            t = shards[min(shards)]
            shape = list((pixels.shape[0],) + tuple(t.shape[1:]))
            shape[self.row_axis] = height
            outputs[name] = ShardedBatch(self.mesh, tuple(shape), t.dtype, shards, index,
                                         self.row_axis, space > 1)
        if state is None:
            return outputs, None
        state_dev = state.x.device
        keys = sorted(k for k in results if k[1] == 0)
        if self.state_sharded:
            new = ccc_ops.KalmanState(*(
                torch.cat([getattr(states[k], f).to(state_dev) for k in keys])
                for f in ("x", "p", "initialized")))
        else:
            new = _map_state(lambda v: v.to(state_dev), states[keys[0]])
        return outputs, new



def shard_params(config: PipelineConfig, fields: Dict[str, np.ndarray], mesh,
                 src_hw: Tuple[int, int], rows=None) -> Dict[Tuple[int, int], IspParams]:
    """Each local shard's params: the host fields on its device (shared by
    the shards of a device), with the slab's rows of the vignetting mask
    and its remap map rebased to its window (remap_window).
    rows: {d: fields of data row d} where rows differ (the cameras of a
    multicamera mesh); else every row takes `fields`."""
    space = mesh.shape["space"]
    fh, fw = src_hw
    out_h = config.calibration.image_height
    cache: Dict = {}
    out = {}
    for d in range(mesh.local_data):
        row_fields = rows[d] if rows is not None else fields
        for s in range(space):
            dev = mesh.devices[d, s]
            key = (id(row_fields), dev, s)
            if key not in cache:
                base_key = (id(row_fields), dev)
                if base_key not in cache:
                    cache[base_key] = params_from_numpy(row_fields, config, dev)
                p = cache[base_key]
                if space > 1:
                    repl = {}
                    r0, r1 = split_rows(fh, space)[s]
                    if p.vignetting_mask is not None:
                        repl["vignetting_mask"] = torch.as_tensor(
                            np.ascontiguousarray(row_fields["vignetting_mask"][r0:r1]), device=dev)
                    if p.remap_base is not None:
                        base, weights, window = remap_window(
                            np.asarray(row_fields["remap_base"]),
                            np.asarray(row_fields["remap_weights"]),
                            config.undistortion.interpolation, src_hw,
                            config.calibration.image_width, split_rows(out_h, space)[s])
                        repl.update(remap_base=torch.as_tensor(base, device=dev),
                                    remap_weights=torch.as_tensor(weights, device=dev),
                                    remap_window=window,
                                    remap_code=remap_code_of(weights, config, dev))
                    p = dataclasses.replace(p, **repl)
                cache[key] = p
            out[(d, s)] = cache[key]
    return out



def check_mesh_rows(config: PipelineConfig, frame_hw, src_hw, mesh) -> None:
    """Raise unless every row domain (the input, the post-flip frame, the
    remap's output) splits into the mesh's slabs, each of whole row
    pairs."""
    space = mesh.shape["space"]
    check_rows(frame_hw[0], space, "frame")
    check_rows(src_hw[0], space, "frame after the flip")
    if _runs_undistortion(config):
        check_rows(config.calibration.image_height, space, "remap output")
