"""Instruction census of the built kernels, from their machine code.

    python -m raw_image_pipeline_tpu_torch.tools.sass_census [--match NAME]

Run from the root of a checkout, where nvcc and cuobjdump are (the machine
with the card): it builds the kernels' library if it is not built
(kernels.LIBRARY) and disassembles it with `cuobjdump -sass`. For each
kernel function whose name holds NAME (default "debayer"), it counts the
SASS instructions of the function's listing (static: every branch's
instructions once) by opcode and by class:

  memory (global/shared loads and stores), shuffle, int_alu (the integer
  ALU's adds, logic, shifts, byte permutes, compares, min/max, selects),
  imad (integer multiply-adds, which also serve as moves and adds),
  control (branches, exits, barriers, nops) and other.

For kernels A's and D's instantiations (`<KINDS, V>`) it also gives the
count per pixel: a thread's straight-line strip computes 2 x max(V, 2)
pixels. Beside the counts, each function's resources from `cuobjdump
-res-usage`: registers a thread, stack and local bytes (spills show
there) and static shared bytes. Prints one JSON line per function and
writes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from typing import Dict, Iterable, Optional

CLASSES = {
    "memory": ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDGSTS", "LDC"),
    "shuffle": ("SHFL",),
    "int_alu": ("IADD3", "LOP3", "SHF", "PRMT", "ISETP", "IMNMX", "VIMNMX", "SEL", "LEA",
                "IABS", "BMSK", "SGXT", "POPC", "FLO", "PLOP3", "IADD", "LOP", "VIADD",
                "VIADDMNMX"),
    "imad": ("IMAD", "IMUL"),
    "control": ("BRA", "EXIT", "BSSY", "BSYNC", "NOP", "RET", "CALL", "BAR", "WARPSYNC"),
}
_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
# "        /*0040*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;"
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
# "debayer_mht_kernel<78, 16>", or demangled "debayer_mht_kernel<(int)78, (int)16>"
# (kernel A's with a third argument, "(bool)0")
# " Function _Z...:" then "  REG:58 STACK:0 SHARED:26624 LOCAL:0 ..."
_RES_FUNCTION = re.compile(r"^\s*Function\s+(\S+):\s*$")
_RES_FIELD = re.compile(r"\b(REG|STACK|SHARED|LOCAL):(\d+)")
_STRIP = re.compile(r"debayer_(?:bilinear|mht)_kernel<(?:\(int\))?(\d+),\s*(?:\(int\))?(\d+)[,>]")


def opcode_class(opcode: str) -> str:
    for name, ops in CLASSES.items():
        if opcode in ops:
            return name
    return "other"


def census(listing: Iterable[str], names: Optional[Dict[str, str]] = None) -> Dict[str, dict]:
    """{function: {"instructions": n, "by_class": {...}, "by_opcode": {...}}}
    from a `cuobjdump -sass` listing; names maps mangled to demangled
    names where known."""
    out: Dict[str, dict] = {}
    current = None
    for line in listing:
        m = _FUNCTION.match(line)
        if m:
            current = (names or {}).get(m.group(1), m.group(1))
            out[current] = {"instructions": 0, "by_class": {}, "by_opcode": {}}
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            op = m.group(1)
            f = out[current]
            f["instructions"] += 1
            f["by_opcode"][op] = f["by_opcode"].get(op, 0) + 1
            cls = opcode_class(op)
            f["by_class"][cls] = f["by_class"].get(cls, 0) + 1
    return out


def resources(listing: Iterable[str]) -> Dict[str, dict]:
    """{mangled function: {"registers", "stack", "shared", "local"}} from a
    `cuobjdump -res-usage` listing."""
    keys = {"REG": "registers", "STACK": "stack", "SHARED": "shared", "LOCAL": "local"}
    out: Dict[str, dict] = {}
    current = None
    for line in listing:
        m = _RES_FUNCTION.match(line)
        if m:
            current = m.group(1)
            continue
        fields = _RES_FIELD.findall(line)
        if fields and current is not None:
            out[current] = {keys[k]: int(v) for k, v in fields}
            current = None
    return out


def pixels_per_thread(name: str) -> Optional[int]:
    """2 x max(V, 2) for an instantiation of kernel A or D, else None."""
    m = _STRIP.search(name)
    return 2 * max(int(m.group(2)), 2) if m else None


def _demangle(mangled: Iterable[str], tool: str) -> Dict[str, str]:
    mangled = list(mangled)
    if not os.path.exists(tool) or not mangled:
        return {}
    run = subprocess.run([tool], input="\n".join(mangled), capture_output=True, text=True)
    return dict(zip(mangled, run.stdout.splitlines())) if run.returncode == 0 else {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--match", default="debayer", help="substring of the functions to list")
    args = ap.parse_args(argv)
    from torch.utils.cpp_extension import CUDA_HOME

    from raw_image_pipeline_tpu_torch import kernels

    if CUDA_HOME is None:
        print("sass_census: no CUDA toolkit (cuobjdump) found", file=sys.stderr)
        return 1
    lib = kernels.LIBRARY.path()
    if not os.path.exists(lib):
        kernels.LIBRARY.get()
    run = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib],
                         capture_output=True, text=True, check=True)
    lines = run.stdout.splitlines()
    mangled = [m.group(1) for m in map(_FUNCTION.match, lines) if m]
    names = _demangle(mangled, os.path.join(CUDA_HOME, "bin", "cu++filt"))
    res = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-res-usage", lib],
                         capture_output=True, text=True, check=True)
    used = {names.get(k, k): v for k, v in resources(res.stdout.splitlines()).items()}
    for name, f in census(lines, names).items():
        if args.match not in name:
            continue
        px = pixels_per_thread(name)
        row = {"function": name, **f, **used.get(name, {})}
        if px:
            row["pixels_per_thread"] = px
            row["per_pixel"] = {"instructions": f["instructions"] / px,
                                **{k: v / px for k, v in f["by_class"].items()}}
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
