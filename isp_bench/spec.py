"""A cell of BENCHMARK.json and the files that belong to it, found by name:

  configs/<config>.json        the configuration as it is run
  traffic/<traffic>.json       the traffic mix's parameters
  metrics/<metric>.py          a metric's reader: read(readings) -> number or None

A configuration, a mix, a cell or a metric is added by adding its file
and its entry in BENCHMARK.json; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BENCHMARK = os.path.join(os.path.dirname(HERE), "BENCHMARK.json")


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable  # read(readings) -> float or None


@dataclass
class Cell:
    name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str, metrics_dir: str = os.path.join(HERE, "metrics")) -> Callable:
    """metrics/<name>.py's read function."""
    path = os.path.join(metrics_dir, name + ".py")
    spec = importlib.util.spec_from_file_location(
        "isp_bench.metrics." + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(workload: str, benchmark: Optional[dict] = None, root: str = HERE) -> Cell:
    """The cell named `workload` of BENCHMARK.json (or of `benchmark`),
    with its files under `root`."""
    bench = load_json(BENCHMARK) if benchmark is None else benchmark
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload [{workload}] in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    metrics_dir = os.path.join(root, "metrics")

    def metrics(kind: str) -> List[Metric]:
        return [Metric(m["name"], m["unit"], reader(m["name"], metrics_dir))
                for m in bench[kind] if _applies(m, workload)]

    return Cell(
        name=workload,
        config=load_json(os.path.join(root, "configs", w["config"] + ".json")),
        traffic=load_json(os.path.join(root, "traffic", w["traffic"] + ".json")),
        chips=w["chips"], end_to_end=metrics("end_to_end"), per_layer=metrics("per_layer"))
