"""Two processes on torch.distributed (gloo, 127.0.0.1) run the port's
flagship chain over a mesh whose data axis spans both (the counterpart of
tests/test_multihost.py). Each process ingests only its own frames
(distribute_batch) and writes its local outputs and Kalman state; this
test holds them against the JAX package's unsharded chain on the whole
batch, byte for byte, and the state against the port's unsharded call
(equal) and the JAX package's (as assert_states_match holds it). The
workers import the port only, never jax."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_pipeline import _frames, _run_both, assert_states_match

import raw_image_pipeline_tpu_torch as tp

HW = (272, 368)
B, CALLS = 4, 2  # the global batch of a call, and calls with the state carried

WORKER = r"""
import os, sys
sys.modules["jax"] = None  # the workers run the port alone
import numpy as np
import torch
torch.set_num_threads(2)
sys.path.insert(0, os.getcwd())
import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu_torch.parallel.multihost import (
    distribute_batch, global_data_mesh, initialize_multihost,
)

addr, pid, out_dir, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
frames = np.load(os.path.join(out_dir, "frames.npy"))
initialize_multihost(addr, 2, pid, backend="gloo", timeout_s=240)
# "cameras": 2 data shards a process; "sequence": 2 data x 2 space
space = 1 if mode == "cameras" else 2
mesh = global_data_mesh(devices=["cpu"] * (2 * space), space=space)
assert mesh.shape == {"data": 4, "space": space}, mesh.shape
h, w = frames.shape[1:]
pipe = tp.build_pipeline(tp.flagship_config(h, w), "bayer_gbrg8", (h, w), with_state=True,
                         temporal_mode=mode, mesh=mesh)
per, calls, b_local = 4, 2, 2
state = tp.init_state((b_local,) if mode == "cameras" else (), device="cpu")
outs = []
for c in range(calls):
    chunk = frames[c * per:(c + 1) * per]
    batch = distribute_batch(chunk[pid * b_local:(pid + 1) * b_local], mesh,
                             spatial=space > 1)
    assert batch.shape == (per, h, w) and batch.local_frames() == (pid * 2, pid * 2 + 2)
    out, state = pipe(batch, state)
    outs.append(out["processed"].local("cpu").numpy())
    if c == 0:  # the all-gather of the outputs: every process's frames
        whole = out["processed"].gather("cpu")
        assert whole.shape == (per, h, w, 3)
        assert torch.equal(whole[pid * 2:pid * 2 + 2], out["processed"].local("cpu"))
np.savez(os.path.join(out_dir, f"{mode}_{pid}.npz"), processed=np.concatenate(outs),
         x=state.x.numpy(), p=state.p.numpy(), initialized=state.initialized.numpy())
print(f"proc {pid} OK", flush=True)
"""

REFUSER = r"""
import os, sys
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.getcwd())
import raw_image_pipeline_tpu_torch as tp
from raw_image_pipeline_tpu_torch.parallel.multihost import global_data_mesh, initialize_multihost
from raw_image_pipeline_tpu_torch.runtime.stream import StreamRunner

addr, pid = sys.argv[1], int(sys.argv[2])
initialize_multihost(addr, 2, pid, backend="gloo", timeout_s=60)
mesh = global_data_mesh(devices=["cpu"])
h, w = 24, 32
config = tp.flagship_config(h, w)
pipe = tp.build_pipeline(config, "bayer_gbrg8", (h, w), with_state=True,
                         temporal_mode="sequence", mesh=mesh)
frames = np.random.default_rng(5).integers(0, 256, (3, h, w), np.uint8)
refused = []
for n in (3, 0):  # an odd global batch, an empty one
    try:
        pipe(frames[:n], tp.init_state((), device="cpu"))
    except ValueError as e:
        refused.append(str(e))
try:  # a batch size the processes cannot share
    StreamRunner(config, "bayer_gbrg8", (h, w), batch_size=3, mesh=mesh)
except ValueError as e:
    refused.append(str(e))
runner = StreamRunner(config, "bayer_gbrg8", (h, w), batch_size=2, mesh=mesh)
try:  # a stateful tail of one frame
    runner.run(iter(frames), lambda s, i, img: None)
except ValueError as e:
    refused.append(str(e))
# the ranks are still in step: an even batch runs, its outputs all-gathered
out, _ = pipe(frames[:2], tp.init_state((), device="cpu"))
assert out["processed"].gather("cpu").shape == (2, h, w, 3)
for r in refused:
    print("REFUSED", r, flush=True)
print(f"proc {pid} OK", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(tmp_path, mode):
    outs = _spawn(WORKER, str(tmp_path), mode)
    # each rank prints the backend in use
    assert all("backend gloo" in err for _, _, err in outs)
    return [np.load(tmp_path / f"{mode}_{i}.npz") for i in range(2)]


def _spawn(script, *args):
    """Two ranks of `python -c script ADDRESS RANK args...`, each with its
    own timeout; returns [(rc, stdout, stderr)] once both have printed
    OK."""
    addr = f"127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", script, addr, str(i), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=root)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError("the two-process run timed out")
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-3000:]}"
        assert "OK" in out
    return outs


@pytest.mark.parametrize("temporal_mode", ["cameras", "sequence"])
def test_two_process_flagship_equals_reference(tmp_path, temporal_mode):
    frames = _frames(17, B * CALLS, *HW)
    np.save(tmp_path / "frames.npy", frames)
    parts = _run_workers(tmp_path, temporal_mode)
    jo, jstates, po, pstates, meas = _run_both(tp.flagship_config(*HW), HW, frames,
                                               temporal_mode, with_state=True, calls=CALLS)
    # each process's frames of each call, in the whole batch's order
    for pid, part in enumerate(parts):
        want = np.concatenate([jo["processed"][c * B + pid * 2:c * B + pid * 2 + 2]
                               for c in range(CALLS)])
        assert part["processed"].shape == want.shape
        assert int((part["processed"] != want).sum()) == 0  # 0 mismatching bytes
    if temporal_mode == "cameras":  # each process holds its frames' tracks
        got = {f: np.concatenate([p[f] for p in parts]) for f in ("x", "p", "initialized")}
    else:  # one track, the same on both
        for f in ("x", "p", "initialized"):
            np.testing.assert_array_equal(parts[0][f], parts[1][f])
        got = {f: parts[0][f] for f in ("x", "p", "initialized")}
    final = pstates[-1]
    for f in ("x", "p", "initialized"):
        np.testing.assert_array_equal(got[f], getattr(final, f).numpy())
    state = tp.state_from_numpy(got["x"], got["p"], got["initialized"], device="cpu")
    assert_states_match(jstates, pstates[:-1] + [state], temporal_mode, meas)
    assert torch.equal(state.x, final.x)


def test_two_process_mesh_refuses_uneven_batches():
    """A global batch that two processes cannot share evenly (3 frames, or
    none), a StreamRunner batch size of 3 and a stateful stream tail of 1
    frame raise ValueError on both ranks before any collective, instead of
    mismatching inside gloo or blocking a peer; an even batch then runs."""
    for _, out, _ in _spawn(REFUSER):
        refused = [line for line in out.splitlines() if line.startswith("REFUSED")]
        assert len(refused) == 4, out
        assert all("split evenly" in r or "empty batch" in r for r in refused), refused
