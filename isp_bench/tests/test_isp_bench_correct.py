"""What decides `correct`, on the CPU at a tiny size: the configuration
files load as the port's own functions build them, the plain reference
equals the port's plain path, and every fault the cells can have, and the
control (the reference in bfloat16 in the program's place), come out not
correct through the whole harness."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from isp_bench import check, run, spec
from isp_bench.control import ReferenceProgram
from isp_bench.reference.chain import ReferenceChain, Track, track
from isp_bench.tests.small import small_cell

ROOT = os.path.dirname(spec.HERE)
SEED = 2**31 + 11
CELLS = ["all-modules-1.6mp-b64", "launch-1.6mp-b64"]


def _cfg(name):
    return spec.load_json(os.path.join(spec.HERE, "configs", name + ".json"))


def _without_model(config):
    return config.replace(white_balance=dataclasses.replace(config.white_balance,
                                                            ccc_model_path=""))


def test_all_modules_file_is_the_launch_profile_with_every_module_on():
    """The launch profile's files as `tools/run_pipeline` loads them, with
    the switches of the groups in `reduced` turned on, and no other group
    changed."""
    from raw_image_pipeline_tpu_torch.tools.run_pipeline import pipeline_config

    cfg = _cfg("alphasense_all_modules_1.6mp")
    files = [os.path.join(spec.HERE, "configs", cfg["files"][k])
             for k in ("params", "calibration", "color_calibration")]
    launch = _without_model(pipeline_config(*files))
    want = launch.replace(
        white_balance=dataclasses.replace(launch.white_balance, temporal_consistency=True),
        **{k: dataclasses.replace(getattr(launch, k), enabled=True)
           for k in ("color_calibration", "gamma_correction", "vignetting_correction",
                     "color_enhancer")})
    got = _without_model(run.pipeline_config(cfg))
    assert got == want
    changed = [f.name for f in dataclasses.fields(got)
               if getattr(got, f.name) != getattr(launch, f.name)]
    assert sorted(changed) == sorted(cfg["reduced"]) == sorted(cfg["changed"])
    assert cfg["frame_hw"] == [1080, 1440] and cfg["files"] == _cfg(
        "alphasense_launch_1.6mp")["files"]


def test_launch_file_is_what_run_pipeline_builds():
    from raw_image_pipeline_tpu_torch.tools.run_pipeline import pipeline_config

    cfg = _cfg("alphasense_launch_1.6mp")
    for where in (os.path.join(ROOT, "configs"), os.path.join(spec.HERE, "configs")):
        files = [os.path.join(where, cfg["files"][k])
                 for k in ("params", "calibration", "color_calibration")]
        assert _without_model(run.pipeline_config(cfg)) == _without_model(
            pipeline_config(*files))
    assert cfg["frame_hw"] == [cfg["pipeline"]["calibration"]["image_height"],
                               cfg["pipeline"]["calibration"]["image_width"]]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_equals_the_ports_plain_path(workload):
    """Three batches through the port on the CPU (its plain versions) and
    through the reference: every published output equal, the Kalman
    track's state equal."""
    cell = small_cell(workload, h=40, w=56, batch=5)
    cfg = cell.config
    from isp_bench.frames import make_pool

    pool = make_pool(dict(cell.traffic, pool_batches=3), cfg["encoding"], cfg["frame_hw"],
                     SEED, "cpu")
    program = run.PortProgram(cfg, "cpu")
    ref = ReferenceChain(cfg, check.ccc_model_path(cfg), "cpu")
    state, ref_state = program.init_state(), Track()
    for frames in pool:
        outputs, state = program(frames, state)
        peaks = None
        if ref.kalman:
            measured = [tuple(p) for p in ref.measure(ref.planes(frames)).tolist()]
            ref_state, filtered = track(ref_state, measured)
            peaks = torch.tensor(filtered)
        want = ref.process(frames, peaks)
        for key in cfg["outputs"]:
            assert torch.equal(outputs[key], want[key]), key
    if ref.kalman:
        assert state.x.tolist() == list(ref_state.x) and float(state.p) == ref_state.p
        assert bool(state.initialized) and ref_state.initialized


class _Faulty:
    """The port's program with one fault planted where it produces."""

    def __init__(self, fault, cfg, device):
        self.program, self.fault = run.PortProgram(cfg, device), fault

    def init_state(self):
        return self.program.init_state()

    def __call__(self, pixels, state):
        if self.fault == "half_batch":  # the first half processed, copied over the rest
            half = pixels.shape[0] // 2
            out, new = self.program(pixels[:half], state)
            out = {k: torch.cat([v, v[:pixels.shape[0] - half]]) for k, v in out.items()}
            return out, new
        out, new = self.program(pixels, state)
        if self.fault == "state_unchanged":
            return out, state
        out = dict(out)
        altered = out["processed"].clone()
        altered.view(-1)[altered.numel() // 3] ^= 1  # one output byte off by one bit
        out["processed"] = altered
        return out, new


def _faults(workload):
    faults = ["half_batch", "answer_altered"]
    if spec.load_cell(workload).config["with_state"] and spec.load_cell(
            workload).config["pipeline"]["white_balance"]["temporal_consistency"]:
        faults.append("state_unchanged")
    return faults


@pytest.mark.parametrize("workload,fault", [(w, f) for w in CELLS for f in _faults(w)])
def test_a_fault_comes_out_not_correct(workload, fault):
    cell = small_cell(workload, batch=4)
    result = run.run_cell(cell, SEED + 1, 0.3, False, device="cpu",
                          program_factory=lambda cfg, dev: _Faulty(fault, cfg, dev))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_comes_out_not_correct(workload):
    """The reference in bfloat16 in the program's place."""
    cell = small_cell(workload, batch=4)
    result = run.run_cell(cell, SEED + 2, 0.3, False, device="cpu",
                          program_factory=ReferenceProgram)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values()
               if c["limit"] is not None)


@pytest.mark.cuda
def test_one_short_cell_on_the_card():
    """A whole run of the first cell for two seconds: exit 0, correct."""
    first = spec.load_json(spec.BENCHMARK)["workloads"][0]["name"]
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "isp_bench.run", "--workload",
                          first, "--seed", str(SEED), "--seconds", "2"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["metrics"]["frames_per_s"]["value"] > 0
