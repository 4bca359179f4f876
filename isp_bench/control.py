"""The control of the comparison that decides `correct`: the plain
reference, its floating-point steps in bfloat16 (the precision below the
chain's float32), put in the program's place and driven through the
harness like the program. Every run of it must come out not correct;
its readings are the upper ends the limits sit below (PERF.md).

    python3 -m isp_bench.control --workload NAME --seconds S --seeds N [N ...]

Prints one JSON line a seed: the checks and `correct`. The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass

import torch

from isp_bench import check, run, spec
from isp_bench.reference.chain import ReferenceChain, Track, track


@dataclass
class TrackState:
    """A Track as the harness reads a program's state: x, p, initialized."""

    track: Track

    @property
    def x(self):
        return torch.tensor(self.track.x, dtype=torch.float32)

    @property
    def p(self):
        return torch.tensor(self.track.p, dtype=torch.float32)

    @property
    def initialized(self):
        return torch.tensor(self.track.initialized)


class ReferenceProgram:
    """The reference chain with the program's call: (outputs, state)."""

    def __init__(self, cfg: dict, device, ft=torch.bfloat16):
        self.ref = ReferenceChain(cfg, check.ccc_model_path(cfg), device, ft)
        self.outputs = cfg["outputs"]

    def init_state(self):
        return TrackState(Track())

    def __call__(self, pixels, state):
        outs = []
        for s in range(0, pixels.shape[0], check.BLOCK):
            frames = pixels[s:s + check.BLOCK]
            peaks = None
            if self.ref.kalman:
                measured = self.ref.measure(self.ref.planes(frames)).tolist()
                end, filtered = track(state.track, [tuple(p) for p in measured], self.ref.ft)
                state, peaks = TrackState(end), torch.tensor(filtered)
            outs.append(self.ref.process(frames, peaks))
        return {k: torch.cat([o[k] for o in outs]) for k in self.outputs}, state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("isp_bench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        t = time.time()
        r = run.run_cell(cell, seed, args.seconds, False, program_factory=ReferenceProgram,
                         t0=time.time())
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "failed": r["failed"], "checks": r["checks"],
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
