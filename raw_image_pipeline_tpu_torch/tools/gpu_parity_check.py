"""Hold the card's numerics to the CPU's where the port claims exactness
(the counterpart of raw_image_pipeline_tpu/tools/tpu_parity_check.py).

    python -m raw_image_pipeline_tpu_torch.tools.gpu_parity_check

It needs a CUDA card and refuses to run without one; it reads the fixtures
under tests/fixtures/ of the checkout it is part of. Three checks, each on the card:

  1. every one of the 2^24 u8 triples through the exact colour-space
     conversions (ops/colorspace.py): BGR->Lab, Lab->BGR, BGR->HSV, and
     HSV->BGR in both of cv2's row kernels (the SIMD one and
     hsv_to_bgr_planes_scalar), each with h in [0, 180) and with every h
     (h >= 180 wraps by sector % 6). The card's machine has neither cv2
     nor jax, so the reference is DIGESTS: the SHA-256 of each 2^22-triple
     chunk's output planes, concatenated in output order, as the port
     computes them on the CPU. tests/test_torch_ops.py holds the CPU's
     outputs equal to the JAX package's on the same chunks and asserts
     these digests, so card = digest = port CPU = JAX. Where a digest
     differs, the chunk is computed on the CPU and its mismatch count and
     largest difference are printed;
  2. the statistical white balance (simple, grey_world, pca, learned) of
     the native-oracle inputs against every golden in
     tests/fixtures/wb_oracle/ that tests/test_torch_wb.py holds the CPU
     to, read with utils/image_io: 0 mismatching bytes;
  3. the flagship chain on tests/fixtures/alphasense.png mosaicked to
     bayer_gbrg8 at 540x720, B=4, on the card against the CPU: 0
     mismatching bytes.

It prints one line per check and, last, "OK"; any mismatch exits non-zero.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np
import torch

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURES = os.path.join(REPO_DIR, "tests", "fixtures")
CHUNK = 1 << 22
N_CHUNKS = (1 << 24) // CHUNK


def all_triples(index: int, device, chunk: int = CHUNK):
    """Chunk `index` of all 2^24 (b, g, r) u8 triples as three planes: the
    triple v = index * chunk + i has b = v & 255, g = (v >> 8) & 255,
    r = v >> 16 (the order tests/test_torch_ops._all_triples uses)."""
    v = torch.arange(index * chunk, (index + 1) * chunk, dtype=torch.int32, device=device)
    return tuple(((v >> s) & 255).to(torch.uint8) for s in (0, 8, 16))


def _h180(b):
    """h spanning [0, 180): b * 180 // 256."""
    return (b.to(torch.int32) * 180 // 256).to(torch.uint8)


def _conversions():
    from raw_image_pipeline_tpu_torch.ops import colorspace as cs

    return {
        "bgr_to_lab": lambda b, g, r: cs.bgr_to_lab_planes(b, g, r),
        "lab_to_bgr": lambda b, g, r: cs.lab_to_bgr_planes(b, g, r),
        "bgr_to_hsv": lambda b, g, r: cs.bgr_to_hsv_planes(b, g, r),
        "hsv_to_bgr": lambda b, g, r: cs.hsv_to_bgr_planes(_h180(b), g, r),
        "hsv_to_bgr_any_h": lambda b, g, r: cs.hsv_to_bgr_planes(b, g, r),
        "hsv_to_bgr_scalar": lambda b, g, r: cs.hsv_to_bgr_planes_scalar(_h180(b), g, r),
        "hsv_to_bgr_scalar_any_h": lambda b, g, r: cs.hsv_to_bgr_planes_scalar(b, g, r),
    }


CONVERSIONS = ("bgr_to_lab", "lab_to_bgr", "bgr_to_hsv", "hsv_to_bgr", "hsv_to_bgr_any_h",
               "hsv_to_bgr_scalar", "hsv_to_bgr_scalar_any_h")

# SHA-256 of each chunk's output planes as the port computes them on the
# CPU (chunk_outputs(name, index, "cpu")); tests/test_torch_ops.py asserts
# them beside the JAX package's outputs
DIGESTS = {
    "bgr_to_lab": (
        "1821b216b20efb6ffca3ab1c83fb1cfe2ff3732f29a4192cfde2fa979598c0cc",
        "a5c1b3abab792dbcf0798a0f57b5551b1c2a3c0e99ad20077a6345a681a21762",
        "33549d1796328b7b57f9c7b94718092630250b86023f669e2900c93d5bcc0b54",
        "c945673ccb73ea35c3fd61e38517ed4b1fb551f991ffb673c3070729d2fbb396",
    ),
    "lab_to_bgr": (
        "7911783b1b8d402d2bf5500ca2689c542da547d1f8f9afa97d13bffcb501ee21",
        "bde96ad5c6d8901a01274fa4cd110753b39ac39df45d731e73266158157d7d82",
        "02ae7197fd900ea6728914aeca2e63c9c1a1cb952ebe7b8f81d696abde95f77b",
        "f172e824e310e55cc548c4c3efdd4b5d28427c7c19e4b75905a16f3e8020f4ba",
    ),
    "bgr_to_hsv": (
        "1566556b83490a5339d191aa10c63046bb0443465cd7b245061a7f94d62b57de",
        "8b3a358a4d47efa01eedcf72cc94903a09d687bfde33afce909ecfcbe800201d",
        "be29074c78ed6a56941f869efed5cf58c0355230f81303f0412d546b1007ce17",
        "43963381e7988582d896891a79af078a116def4d34bbd14c36d2bb6ba1ab577d",
    ),
    "hsv_to_bgr": (
        "c0c20eb8c83955dedd6cbbd8cf149c9f40a7fbe2cc229517398563fe83d71d58",
        "556c9838ff7e14890cab590c58ddfb88fbf71263674ed59b5dd908c3c3969138",
        "dccfcf4d1e6ac62fbfeee2a46927086a90ffbb15a494909f4dc12383a6984ffc",
        "7af0195ec9622b3e258ea543f579e8972cf8159bb66769e22a2dbc894e3be7bb",
    ),
    "hsv_to_bgr_any_h": (
        "2c9ccbd64bc9234d46862dd20f08399b40799abaf218606d3d63f965b4f9e384",
        "7af40c54d63ea240728bc6519ce04e75778b975ec0e0e5eb2bd3c1d0569320e3",
        "dec727d479f0a0d39ff91634e1b9a0875c591dff38c8b680deff0d5f0503dc9f",
        "8b2befb42f1b704e929bb4400315091eb7bf55a7e46f8812c254a654fd8d1e40",
    ),
    "hsv_to_bgr_scalar": (
        "4d9bf5a41dc5e72176949014496930fdc7fc407b70328679fc14b23d0c5304a6",
        "ea075cb0ab95654c3ba9df06fd2b51c984b7169234cdd5b2bd132583b1d4e417",
        "0041b66428befa40f778d0d0b6d1a4d35da5dfdc2b463a7d8b4e6dddca2d9685",
        "c4e320feeb69d4d595630c2bf929b22d72a6e69adceb34bf61adf00057cb5ca5",
    ),
    "hsv_to_bgr_scalar_any_h": (
        "ca1f743c19bf625b4d6d8aba0438e72b915bfb2c620df7704fb41298a785fe84",
        "05d83e200f495528621329a2b486f59cf80472621327644c2dc8731d2e1ce5f0",
        "bfc79b3c174413e67d8a74100db0576cd1b71d54b8d78add94f4dd0540a3acc1",
        "23e316033f164b6da5f8f2ade1268fb93f70afb108b9c3b5cedd8732a8b5d1b5",
    ),
}


def planes_bytes(planes) -> np.ndarray:
    """Output planes of one chunk, copied to the host once: [3, N] u8."""
    out = torch.stack(tuple(planes))
    if out.dtype != torch.uint8:
        raise TypeError(f"expected u8 planes, got {out.dtype}")
    return out.cpu().numpy()


def planes_digest(planes) -> str:
    return hashlib.sha256(planes_bytes(planes).tobytes()).hexdigest()


def chunk_outputs(name: str, index: int, device) -> np.ndarray:
    """Conversion `name` of chunk `index` on `device`: [3, CHUNK] u8."""
    return planes_bytes(_conversions()[name](*all_triples(index, device)))


def chunk_digest(name: str, index: int, device="cuda") -> str:
    """SHA-256 of chunk_outputs(name, index, device)."""
    return hashlib.sha256(chunk_outputs(name, index, device).tobytes()).hexdigest()


def check_colorspace(log, device="cuda") -> int:
    """Every conversion over all 2^24 triples on `device` against DIGESTS;
    returns the number of mismatching bytes (0 where every digest agrees)."""
    bad = 0
    for name in CONVERSIONS:
        t0 = time.perf_counter()
        worst = 0
        for index in range(N_CHUNKS):
            got = chunk_outputs(name, index, device)
            if hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name][index]:
                continue
            ref = chunk_outputs(name, index, "cpu")
            diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
            n = int((diff != 0).sum())
            bad += n
            worst = max(worst, int(diff.max()))
            log(f"  {name} chunk {index}: digest differs: {n} mismatching bytes "
                f"against the CPU, largest difference {int(diff.max())}")
        log(f"{device} {name} exhaustive (2^24 triples, {N_CHUNKS} digests): "
            f"{'all digests equal' if not worst else f'largest difference {worst}'} "
            f"({time.perf_counter() - t0:.1f} s)")
    return bad


def oracle_cases():
    """(input png, method, parameter, golden png) of every native-oracle
    golden tests/test_torch_wb.py holds the plain versions to."""
    here = FIXTURES
    fix = os.path.join(here, "wb_oracle")
    inputs = {
        "alphasense": os.path.join(here, "alphasense.png"),
        "gehler": os.path.join(here, "gehler_shi.png"),
        "noise": os.path.join(fix, "noise.png"),
        "gauss": os.path.join(fix, "gauss.png"),
    }
    cases = []
    for name, path in inputs.items():
        cases += [(path, "simple", p, f"{name}_simple_{p}.png") for p in (2.0, 10.0, 20.0, 35.0)]
        cases += [(path, "grey", t, f"{name}_grey_{t}.png") for t in (0.5, 0.8, 0.95)]
        cases += [(path, "pca", None, f"{name}_pca.png")]
        if name != "noise":  # its learned golden is held to an envelope only
            cases += [(path, "learned", 0.8, f"{name}_learned_0.8.png")]
    cases.append((inputs["alphasense"], "learned_crop", 0.9,
                  "alphasense_crop49x550_learned_0.9.png"))
    return [(src, m, p, os.path.join(fix, g)) for src, m, p, g in cases]


def white_balance(img: np.ndarray, method: str, param, device) -> np.ndarray:
    """One statistical method on a [H, W, 3] u8 BGR image on `device`."""
    from raw_image_pipeline_tpu_torch.ops import learned_wb, white_balance as wb

    if method == "learned_crop":  # a crop with two brightest pixels
        img, method = np.ascontiguousarray(img[:49, :550]), "learned"
    t = torch.as_tensor(img[None], device=device)
    planes = (t[..., 0], t[..., 1], t[..., 2])
    out = {"simple": lambda: wb.balance_white_simple(planes, param),
           "grey": lambda: wb.balance_white_grey_world(planes, param),
           "pca": lambda: wb.balance_white_pca(planes),
           "learned": lambda: learned_wb.balance_white_learned(planes, param)}[method]()
    return torch.stack(out, dim=-1)[0].cpu().numpy()


def check_white_balance(log, device="cuda") -> int:
    """Every oracle case on `device`; returns the mismatching bytes."""
    from raw_image_pipeline_tpu_torch.utils import image_io

    t0 = time.perf_counter()
    bad, worst = 0, []
    for src, method, param, gold in oracle_cases():
        got = white_balance(image_io.imread(src), method, param, device)
        ref = image_io.imread(gold)
        n = int((got != ref).sum()) if got.shape == ref.shape else got.size
        if n:
            worst.append(f"{os.path.basename(gold)}: {n}")
        bad += n
    log(f"{device} statistical WB vs {len(oracle_cases())} oracle goldens: {bad} mismatching "
        f"bytes {worst or ''}({time.perf_counter() - t0:.1f} s)")
    return bad


def fixture_mosaic() -> np.ndarray:
    """tests/fixtures/alphasense.png mosaicked as the reference package's
    TPU parity check does (540x720)."""
    from raw_image_pipeline_tpu_torch.utils import image_io

    img = image_io.imread(os.path.join(FIXTURES, "alphasense.png"))
    ch = {"g": 1, "b": 0, "r": 2}
    bay = np.zeros(img.shape[:2], np.uint8)
    for i in range(2):
        for j in range(2):
            bay[i::2, j::2] = img[i::2, j::2, ch["grbg"[i * 2 + j]]]
    return bay


def check_chain(log, device="cuda") -> int:
    """The flagship on the fixture's mosaic on `device` and on the CPU;
    returns the mismatching bytes."""
    import raw_image_pipeline_tpu_torch as tp

    bay = fixture_mosaic()
    h, w = bay.shape
    x = np.stack([bay] * 4)
    t0 = time.perf_counter()
    outs = {}
    for dev in (device, "cpu"):
        pipe = tp.build_pipeline(tp.flagship_config(h, w), "bayer_gbrg8", frame_hw=(h, w),
                                 device=dev)
        out, _ = pipe(torch.as_tensor(x, device=dev), None)
        outs[dev] = out["processed"].cpu().numpy()
    bad = int((outs[device] != outs["cpu"]).sum())
    log(f"{device} flagship chain {w}x{h} B=4 vs the CPU: {bad} mismatching bytes, shape "
        f"{outs[device].shape}, checksum {int(outs[device].astype(np.int64).sum())} "
        f"({time.perf_counter() - t0:.1f} s)")
    return bad


def main(argv=None, log=None) -> int:
    log = log or (lambda *a: print(*a, flush=True))
    if not torch.cuda.is_available():
        raise SystemExit("gpu_parity_check holds the card to the CPU: no CUDA device here")
    bad = check_colorspace(log) + check_white_balance(log) + check_chain(log)
    if bad:
        raise SystemExit(f"gpu_parity_check: {bad} mismatching bytes")
    log("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
