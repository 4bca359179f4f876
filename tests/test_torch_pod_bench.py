"""Two-process CPU smoke of the port's pod bench
(raw_image_pipeline_tpu_torch/tools/pod_bench.py; the counterpart of
tests/test_pod_bench.py): the command meant for several hosts or cards
runs end to end on gloo, with the same assertions on its JSON line."""

import json
import os
import socket
import subprocess
import sys


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_pod_bench_two_process_cpu_smoke():
    addr = f"127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m",
                "raw_image_pipeline_tpu_torch.tools.pod_bench",
                "--coordinator", addr, "--num-processes", "2",
                "--process-id", str(i), "--device", "cpu", "--local-devices", "2",
                "--height", "64", "--width", "48",
                "--batch-per-device", "1", "--k-dispatch", "3",
                "--rounds", "1",
            ],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=root,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError("pod_bench smoke timed out")
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, out, err in outs:
        assert rc == 0, f"pod_bench failed rc={rc}\nstdout:{out}\nstderr:{err[-2000:]}"
        # each rank held the sharded step to the unsharded one first
        assert "(4, 64, 48, 3): 0 mismatching bytes, Kalman state equal: True" in err
    # process 0 prints the one JSON result line
    line = outs[0][1].strip().splitlines()[-1]
    result = json.loads(line)
    assert result["metric"] == "pod_scaling_full_isp"
    assert result["processes"] == 2
    assert result["devices"] == 4
    assert result["frame"] == "48x64" and result["batch_per_device"] == 1
    assert result["global_fps"] > 0
    assert result["per_host_fps"] == result["global_fps"] / 2
    assert 0 < result["scaling_efficiency"]
    # only process 0 emits the result line
    assert "pod_scaling_full_isp" not in outs[1][1]
