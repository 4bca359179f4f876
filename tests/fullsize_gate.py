"""Full-size gate (not a test): the port's CPU chain against the JAX
package's CPU chain at the sensors' sizes, where the test suite runs small
frames only.

    JAX_PLATFORMS=cpu python tests/fullsize_gate.py [SEED] [CASE ...]

Runs build_pipeline of both packages ("sequence" mode, state, intermediates
kept) on the same seeded bayer_gbrg8 frame, B=1: the flagship and the
GPU-parity chain at 1080x1920 and 1080x1440, and the float chain at a
random odd crop drawn from SEED (default 2026). A CASE such as
"flagship1080x1920" runs that case only. Prints one JSON line per case:
the mismatching bytes of every output and both Kalman x. About 1.8 GiB of
memory and 2-3 minutes for all five on 4 threads.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_torch_gpu_path import _chain_config  # noqa: E402
from test_torch_pipeline import _frames  # noqa: E402

import raw_image_pipeline_tpu_torch as tp  # noqa: E402
from raw_image_pipeline_tpu.pipeline import build_pipeline as jax_build_pipeline  # noqa: E402
from raw_image_pipeline_tpu.pipeline import init_state as jax_init_state  # noqa: E402


def main(argv) -> int:
    torch.set_num_threads(4)
    rng = np.random.default_rng(int(argv[0]) if argv else 2026)
    crop = (2 * int(rng.integers(200, 540)) + 1, 2 * int(rng.integers(300, 960)) + 1)
    cases = [(n, hw) for n in ("flagship", "gpu_parity") for hw in ((1080, 1920), (1080, 1440))]
    cases.append(("float", crop))
    only = argv[1:]
    bad_total = 0
    for name, hw in cases:
        if only and f"{name}{hw[0]}x{hw[1]}" not in only:
            continue
        config = tp.flagship_config(*hw) if name == "flagship" else _chain_config(name, hw)
        seed = sum(hw) + len(name)
        frames = _frames(seed, 1, *hw)
        t0 = time.perf_counter()
        jp = jax_build_pipeline(config, "bayer_gbrg8", frame_hw=hw, with_state=True,
                                keep_intermediates=True, temporal_mode="sequence")
        jo, js = jp(frames, jax_init_state(()))
        pp = tp.build_pipeline(config, "bayer_gbrg8", hw, with_state=True,
                               keep_intermediates=True, temporal_mode="sequence", device="cpu")
        po, ps = pp(torch.as_tensor(frames), tp.init_state((), device="cpu"))
        bad = {k: int((po[k].numpy() != np.asarray(v)).sum()) for k, v in jo.items()}
        bad_total += sum(bad.values())
        print(json.dumps({"chain": name, "hw": hw, "seed": seed, "mismatching_bytes": bad,
                          "bytes": {k: int(np.asarray(v).size) for k, v in jo.items()},
                          "x_port": ps.x.tolist(), "x_jax": np.asarray(js.x).tolist(),
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 1 if bad_total else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
