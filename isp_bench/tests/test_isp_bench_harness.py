"""The harness on the CPU at a tiny size: each cell's files found by name,
a configuration, mix and metric added as files alone, BENCHMARK.json's
form, the import rules, and the run that finds no card."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from isp_bench import check, frames, imports, run, spec
from isp_bench.tests.small import small_cell

ROOT = os.path.dirname(spec.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 7  # wider than 32 signed bits, as the benchmark's seeds may be


def bench():
    return spec.load_json(spec.BENCHMARK)


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_each_cell_finds_its_files(workload):
    cell = spec.load_cell(workload)
    entry = next(w for w in bench()["workloads"] if w["name"] == workload)
    assert cell.config["name"] == entry["config"]
    assert {"batch", "in_flight", "pool_batches", "warmup_batches",
            "sample_within_batches"} <= set(cell.traffic)
    assert [m.name for m in cell.end_to_end] == [m["name"] for m in bench()["end_to_end"]]
    assert all(callable(m.read) for m in cell.end_to_end + cell.per_layer)
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    assert "setup_s" in [m.name for m in cell.end_to_end] and len(cell.end_to_end) > 1
    assert cell.per_layer


def test_benchmark_json_form():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["isp_bench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("isp_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert spec.load_json(os.path.join(ROOT, c["file"]))["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] == "frames_per_s" and UNIT.match(m["unit"])
        layers.add(m["layer"])
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    assert all(f"| {layer} |" in perf for layer in layers)
    assert len(json.dumps(b)) < 64 * 1024


def test_a_config_mix_and_metric_added_as_files_alone(tmp_path):
    """A throwaway configuration, traffic mix, cell and per-layer metric,
    each only a new file and a new BENCHMARK.json entry, run end to end."""
    root = tmp_path / "isp_bench"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = spec.load_json(os.path.join(spec.HERE, "configs", "alphasense_launch_1.6mp.json"))
    cfg["name"] = "extra_config"
    cfg["pipeline"]["flip"]["enabled"] = False
    (root / "configs" / "extra_config.json").write_text(json.dumps(cfg))
    mix = spec.load_json(os.path.join(spec.HERE, "traffic", "batch64-ahead2.json"))
    (root / "traffic" / "extra-mix.json").write_text(json.dumps(dict(mix, batch=16, in_flight=3)))
    (root / "metrics" / "extra_metric.py").write_text(
        "def read(r):\n    return float(len(r.enqueue_s))\n")
    b = bench()
    b["configs"].append(dict(b["configs"][0], name="extra_config",
                             file="isp_bench/configs/extra_config.json"))
    b["workloads"].append({"name": "extra-cell", "config": "extra_config",
                           "traffic": "extra-mix", "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "extra_metric", "unit": "calls", "better": "higher",
                            "bound": 0.1, "source": "host_clock", "workloads": ["extra-cell"]})
    cell = small_cell("extra-cell", benchmark=b, root=str(root))
    assert cell.traffic["in_flight"] == 3 and not cell.config["pipeline"]["flip"]["enabled"]
    torch.manual_seed(0)
    result = run.run_cell(cell, SEED, 0.5, False, device="cpu")
    assert result["correct"], result["checks"]
    assert result["metrics"]["extra_metric"]["value"] >= 1
    assert spec.load_cell("all-modules-1.6mp-b64", b).end_to_end[-1].name != "extra_metric"


def test_the_batch_drawn_from_the_seed_is_compared_besides_the_last():
    cell = small_cell("launch-1.6mp-b64")
    cfg, batch = cell.config, cell.traffic["batch"]
    pool = frames.make_pool(cell.traffic, cfg["encoding"], cfg["frame_hw"], SEED, "cpu")
    program = run.PortProgram(cfg, "cpu")
    stream = run.Stream(program, pool, program.init_state(), sample_at=1)
    stream.run(cell.traffic["in_flight"], batches=4)
    assert [k for k, _ in stream.sampled()] == [1, 3]
    checks, compared, bad = check.compare(cfg, pool, stream.k, stream.sampled(), stream.state,
                                          "cpu")
    assert check.passes(checks) and bad == 0 and compared == 2 * batch


def test_reference_imports_nothing_of_the_program():
    assert imports.reference_violations() == []


def test_a_run_loads_no_jax():
    """A whole run (tiny, CPU) in a fresh process, then sys.modules."""
    code = ("import sys; from isp_bench import run, imports; "
            "from isp_bench.tests.small import small_cell; "
            "r = run.run_cell(small_cell('all-modules-1.6mp-b64'), 5, 0.3, False, device='cpu'); "
            "assert r['correct']; print(imports.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole():
    assert imports.forbidden_loaded(["jax.numpy", "raw_image_pipeline_tpu.ops", "flax"]) == [
        "flax", "jax.numpy", "raw_image_pipeline_tpu.ops"]
    assert imports.forbidden_loaded(["raw_image_pipeline_tpu_torch.ops", "jaxtyping"]) == []


def test_no_card_no_result():
    """Without a CUDA card the run exits non-zero and prints no result; it
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "-m", "isp_bench.run", "--workload",
                          "all-modules-1.6mp-b64", "--seed", str(SEED), "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
