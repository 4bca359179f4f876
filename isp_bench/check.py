"""What decides `correct`: the outputs the timed path produced, held to
the plain reference (isp_bench/reference) on the same frames.

The harness keeps the outputs of two of the stream's batches (one drawn
from the seed among the window's first batches before the window starts,
and the last one) and the Kalman state the stream ends with. Once the
window has closed and the program is freed, the reference works out each
sampled frame again: the CCC peaks of the pool's frames, the Kalman track
through every frame the program was sent, in order, and the whole chain
of each sampled frame with the gains its track gave it. Every output the
configuration publishes is compared byte for byte, and the final state
value for value.

The chain is exact (bit-exact against OpenCV's arithmetic), so every
limit is 0: one byte or one state value off fails the run. PERF.md gives
the readings of sound runs and of the control (the reference in bf16 in
the program's place) that the limits sit between.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import torch

from isp_bench.reference.chain import ReferenceChain, Track, track

LIMITS = {"bytes_off": 0, "state_x_off": 0.0, "state_p_off": 0.0, "state_init_off": 0}
BLOCK = 16  # frames the reference processes at a time


def ccc_model_path(cfg: dict) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), cfg["ccc_model"])


def compare(cfg: dict, pool: torch.Tensor, n_batches: int,
            sampled: Sequence[Tuple[int, Dict[str, torch.Tensor]]], final_state,
            device, ft=torch.float32) -> Tuple[Dict[str, Tuple[float, float]], int, int]:
    """(checks {name: (reading, limit)}, frames compared, frames with any
    byte off) for the sampled batches (index in the stream, the program's
    outputs) of a stream of n_batches batches, batch k being pool[k %
    len(pool)], that ended in final_state."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the response's f32 products
    try:
        return _compare(cfg, pool, n_batches, sampled, final_state, device, ft)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _compare(cfg, pool, n_batches, sampled, final_state, device, ft):
    ref = ReferenceChain(cfg, ccc_model_path(cfg), device, ft)
    n_pool, batch = pool.shape[0], pool.shape[1]
    checks: Dict[str, Tuple[float, float]] = {}
    filtered = None
    if ref.kalman:
        pool_peaks: List[List[Tuple[int, int]]] = []
        for i in range(n_pool):
            peaks = [ref.measure(ref.planes(pool[i, s:s + BLOCK]))
                     for s in range(0, batch, BLOCK)]
            pool_peaks.append([tuple(p) for p in torch.cat(peaks).tolist()])
        stream = [pk for k in range(n_batches) for pk in pool_peaks[k % n_pool]]
        end, filtered = track(Track(), stream, ft)
        x = final_state.x.detach().float().cpu().reshape(-1).tolist()
        checks["state_x_off"] = (max(abs(a - b) for a, b in zip(x, end.x)),
                                 LIMITS["state_x_off"])
        checks["state_p_off"] = (abs(float(final_state.p.detach().float().cpu()) - end.p),
                                 LIMITS["state_p_off"])
        checks["state_init_off"] = (int(bool(final_state.initialized.cpu()) != end.initialized),
                                    LIMITS["state_init_off"])
    off: Dict[str, int] = {key: 0 for key in cfg["outputs"]}
    bad_frames = compared = 0
    for k, outputs in sampled:
        frames = pool[k % n_pool]
        for s in range(0, batch, BLOCK):
            e = min(s + BLOCK, batch)
            peaks = None
            if filtered is not None:
                peaks = torch.tensor(filtered[k * batch + s:k * batch + e])
            want = ref.process(frames[s:e], peaks)
            bad = torch.zeros(want["processed"].shape[0], dtype=torch.bool, device=ref.device)
            for key in cfg["outputs"]:
                diff = outputs[key][s:e].to(ref.device) != want[key]
                off[key] += int(diff.sum())
                bad |= diff.flatten(1).any(dim=1)
            bad_frames += int(bad.sum())
            compared += bad.numel()
    for key, n in off.items():
        checks[f"{key}_bytes_off"] = (n, LIMITS["bytes_off"])
    return checks, compared, bad_frames


def passes(checks: Dict[str, Tuple[float, float]]) -> bool:
    return all(value <= limit for value, limit in checks.values())
