"""The benchmark's two import rules.

1. Nothing it runs loads JAX or the JAX package: after the window the
   harness looks at `sys.modules` and fails the run if a module's
   top-level name (the part before the first dot, compared whole) is one
   of FORBIDDEN. `raw_image_pipeline_tpu_torch` begins with
   `raw_image_pipeline_tpu` and is allowed.
2. The plain reference imports nothing of the program or of JAX: its
   sources' import statements name only the standard library, numpy,
   torch and the reference package itself.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "raw_image_pipeline_tpu")
PROGRAM = "raw_image_pipeline_tpu_torch"
REFERENCE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference")
REFERENCE_ALLOWED = ("numpy", "torch", "isp_bench.reference")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def _imported(path: str) -> List[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                raise ValueError(f"{path}: relative import")
            names.append(node.module or "")
    return names


def reference_violations() -> List[str]:
    """'file: module' for each import of a reference source outside the
    standard library, numpy, torch and the reference package."""
    bad = []
    for fname in sorted(os.listdir(REFERENCE_DIR)):
        if not fname.endswith(".py"):
            continue
        for name in _imported(os.path.join(REFERENCE_DIR, fname)):
            ok = (top_level(name) in sys.stdlib_module_names
                  or any(name == a or name.startswith(a + ".") for a in REFERENCE_ALLOWED))
            if not ok or top_level(name) in FORBIDDEN + (PROGRAM,):
                bad.append(f"{fname}: {name}")
    return bad
