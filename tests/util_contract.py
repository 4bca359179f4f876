"""The call contract of the port against the JAX package, read from the
source with `ast` (the JAX side) and `inspect` (the port's live functions):
a JAX-style call by position must mean the same in the port.

The rule, for every public def and class method of the JAX package:
- the port's positional parameters are the JAX ones in the JAX order, a
  prefix of them (a parameter the port takes in another form keeps its
  place under its new name: `replaced`);
- a JAX parameter may be absent only at the end of the positional list,
  and only with a recorded reason (`TAIL_REASONS`);
- the port's own parameters (device=, plain=, ...) are keyword-only.
"""

import ast
import inspect
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "raw_image_pipeline_tpu")

# JAX parameters the port leaves out at the end of a positional list: each
# selects or tunes the TPU implementation, and the port has one
TAIL_REASONS = {
    "impl": "TPU implementation selection (Pallas kernel or XLA); the port picks by the "
            "tensor's device",
    "precision": "XLA matmul precision on the TPU's MXU",
    "w_axis": "the TPU's batch-minor layout (which axis is W)",
    "corr": "per-backend LUT corrections (the port serves exact host tables)",
    "corr_idx": "per-backend LUT corrections (the port serves exact host tables)",
    "corr_val": "per-backend LUT corrections (the port serves exact host tables)",
}

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)


def public_defs(path):
    """{name: (positional names, keyword-only names)} of a module's public
    top-level defs and of its public classes' public methods, __init__ and
    __call__ ("Class.method", self included; properties are not calls)."""
    def sig(fn):
        a = fn.args
        return [x.arg for x in a.posonlyargs + a.args], [x.arg for x in a.kwonlyargs]

    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = sig(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                prop = any(isinstance(d, ast.Name) and d.id == "property"
                           for d in getattr(m, "decorator_list", ()))
                if isinstance(m, ast.FunctionDef) and not prop and (
                        not m.name.startswith("_") or m.name in ("__init__", "__call__")):
                    out[f"{node.name}.{m.name}"] = sig(m)
    return out


def port_object(module, name):
    """The port's function or class method `name` ("f" or "Class.method")
    in the imported module, or None."""
    obj = module
    for part in name.split("."):
        obj = getattr(obj, part, None)
    return obj if callable(obj) else None


def contract_problems(jax_sig, port_fn, replaced=None, port_positional=None):
    """What breaks the rule for one function: [] where a JAX-style call
    means the same in the port. replaced: {JAX name: port name} taken in
    another form at the same place; port_positional: the port's own
    positional parameters that a recorded reason allows."""
    jpos, jkw = jax_sig
    replaced = replaced or {}
    params = inspect.signature(port_fn).parameters.values()
    ppos = [p.name for p in params if p.kind in _POSITIONAL
            and p.name not in (port_positional or ())]
    pkw = [p.name for p in params if p.kind == inspect.Parameter.KEYWORD_ONLY]
    want = [replaced.get(n, n) for n in jpos]
    problems = []
    if ppos != want[:len(ppos)]:
        problems.append(f"positional {ppos} is not at the JAX positions {want}")
    else:
        problems += [f"{n} is left out without a recorded reason"
                     for n in want[len(ppos):] if n not in TAIL_REASONS]
    problems += [f"JAX keyword-only {n} is absent" for n in jkw if n not in pkw + ppos]
    return problems
