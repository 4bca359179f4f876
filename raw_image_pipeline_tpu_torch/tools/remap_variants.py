"""What limits kernel F's fixed32 mode on a CUDA card: variants of its
sources, built apart and timed in turns beside the kernel as it is, and
beside its first form.

    python -m raw_image_pipeline_tpu_torch.tools.remap_variants [--out FILE]

Run from the root of a checkout on the machine with the card. Each variant
(VARIANTS) is a copy of csrc/remap_lerp.cu and csrc/remap_tile.cuh with
named text replacements, built by nvcc into build/remap_variants/<name>/
and called through the port's own wrapper (ops/undistortion
.remap_lerp_cuda(..., mode="fixed32", code=)) with the kernel's C entry
swapped for the variant's:

  * "F32" (as built: remap_fixed32_kernel, the compact map, the integer
    blend, the whole box copied, two staged frames, 8 blocks an SM),
    "F32_stages3" (three staged frames), "F32_blocks9" (9 blocks an SM),
    "F32_blocks7" (7), and, not exact, its limiters: "F32_loads" (the box
    copies and the map: no blend, no stores), "F32_stores" (the stores of
    bytes made of the box offsets: no copies, no blend), "F32_fixedmap" (no
    map read: an identity map, every pixel one table row), "F32_mapread" (the
    map read and the box reduction: no copies, no blend, no stores);
  * "F32_first" (the first form, rebuilt from these sources: remap_tile.cuh's
    remap_kernel with the f32 blend of the [4, N] weights, Fixed32Mode, 7
    blocks an SM; it ignores the code) and its limiters "F32_first_loads",
    "F32_first_stores", "F32_first_fixedmap", "F32_first_mapread" (as
    above; the fixed map's weights are four constants).

Inputs: three planes of seeded noise, B = 4, 16 and 64 1080x1920, through the
fixed32 chain's 1080x1920 map (workloads.chains "fixed32", its params'
remap_base, remap_weights and remap_code); "F32" also without the code
("wide": every pixel's weights read from [4, N], as an op-layer call).
Every exact variant is held to the plain version at B=4 and to "F32" at
B = 16 and 64 first. Each time is measure.device_ms, in TURNS rounds over the
variants, forwards then backwards, beside the bound of
measure.remap_lerp_work with the compact map (and, "bound_ms_wide", with
20 bytes a pixel). Prints one line per number and, last, a JSON line with
the card's name and power limit; --out writes that JSON to a file as well.
Exits 1 if an exact variant differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

TURNS = 2
SIZES = ((4, 1080, 1920), (16, 1080, 1920), (64, 1080, 1920))
FILES = ("remap_lerp.cu", "remap_tile.cuh")
ENTRY = "isp_remap_lerp"

# the first form's fixed32 mode: remap_tile.cuh's remap_kernel with this blend
_FIRST_MODE = '''// fixed32 mode: weights [4, N] integers scaled by 2^15, the taps at
// base + {0, 1, w, w+1}, a tap outside the frame reads 0
struct Fixed32Mode : isp_remap::AnchorTaps<Fixed32Mode> {
  __device__ __forceinline__ static uint32_t blend(uint32_t u0, uint32_t u1, uint32_t u2,
                                                   uint32_t u3, const float (&wt)[kRows][kRun],
                                                   int j) {
    float acc = __fadd_rn(__fmul_rn(u8_to_f32(u0), wt[0][j]), __fmul_rn(u8_to_f32(u1), wt[1][j]));
    acc = __fadd_rn(acc, __fmul_rn(u8_to_f32(u2), wt[2][j]));
    acc = __fadd_rn(acc, __fmul_rn(u8_to_f32(u3), wt[3][j]));
    return to_u8_bits(floorf(__fmul_rn(__fadd_rn(acc, 16384.0f), 0x1p-15f)));
  }
};

// remap_fixed32_kernel, as isp_remap::dispatch takes it'''
_FIRST = [
    ("remap_lerp.cu", "// remap_fixed32_kernel, as isp_remap::dispatch takes it", _FIRST_MODE),
    ("remap_lerp.cu", """    return isp_remap::dispatch<Fixed32Tiles>(p0, p1, p2, base, weights, out, cameras, batch, h,
                                             w, ho, wo, channels, v, chunk, planes16, stream,
                                             (const int16_t*)code);""",
     """    return isp_remap::dispatch<isp_remap::Tiles<Fixed32Mode>>(
        p0, p1, p2, base, weights, out, cameras, batch, h, w, ho, wo, channels, v, chunk,
        planes16, stream);"""),
]
# no box copies (either kernel)
_NOCOPY = [("remap_tile.cuh", "          if (has[k]) cp_async16(",
            "          if (has[k] && f < 0) cp_async16(")]
# remap_fixed32_kernel: no blend (a byte of the box offset), no stores
_NOBLEND = [("remap_lerp.cu", """        put_byte(words, j * C + c,
                 blend_integer(tap_pair(t, k), tap_pair(t + box.pitch, k), lo[j], hi[j]));""",
             "        put_byte(words, j * C + c, (uint32_t)s[j] + c);")]
_NOSTORE = [("remap_lerp.cu", """    if (u.stores) store_words<C, WORDS>(dst, words, wo - u.c0);
    dst += frame_out;
  });
}

// remap_fixed32_kernel, as""", """    if (u.stores && words[0] == 0x9E3779B9u) dst[0] = 1;
    dst += frame_out;
  });
}

// remap_fixed32_kernel, as""")]
_FIXEDMAP = [("remap_lerp.cu", """  uint32_t lo[kRun], hi[kRun], live = 0, odd = 0;""", """#pragma unroll
  for (int j = 0; j < kRun; ++j) {  // an identity map, one table row: the map's loads are dead
    b[j] = min(u.r, h - 2) * w + min(u.c0 + j, w - 2);
    cd[j] = u.r < ho && u.c0 + j < wo ? 16 * 32 + 8 : kCodeDead;
  }
  uint32_t lo[kRun], hi[kRun], live = 0, odd = 0;""")]
# remap_kernel (the first form): the same limiters
_FIRST_NOBLEND = [("remap_tile.cuh", """        put_byte(words, j * C + c,
                 Mode::blend(top[c * kStage], top[c * kStage + 1], bottom[c * kStage],
                             bottom[c * kStage + 1], wt, j));""",
                   "        put_byte(words, j * C + c, (uint32_t)s[j] + c);")]
_FIRST_NOSTORE = [("remap_tile.cuh", """    if (u.stores) store_words<C, WORDS>(dst, words, wo - u.c0);
    dst += frame_out;
  });
}

// a kernel of remap_kernel's signature""", """    if (u.stores && words[0] == 0x9E3779B9u) dst[0] = 1;
    dst += frame_out;
  });
}

// a kernel of remap_kernel's signature""")]
_FIRST_FIXEDMAP = [("remap_tile.cuh", """  // live pixels and the bounding box of their taps in the source""", """#pragma unroll
  for (int j = 0; j < kRun; ++j) {  // an identity map, fixed weights: the map's loads are dead
    const bool in = u.r < ho && u.c0 + j < wo;
    b[j] = min(u.r, h - 2) * w + min(u.c0 + j, w - 2);
#pragma unroll
    for (int k = 0; k < R; ++k) wt[k][j] = in ? 8192.0f : 0.0f;
  }
  // live pixels and the bounding box of their taps in the source""")]


def _const(name, old, new, file="remap_lerp.cu"):
    return [(file, f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")]


# name -> ([(file, old, new)], exact)
VARIANTS = {
    "F32": ([], True),
    "F32_stages3": (_const("kStages", 2, 3, "remap_tile.cuh"), True),
    "F32_blocks9": (_const("kFixedMinBlocks", 8, 9), True),
    "F32_blocks7": (_const("kFixedMinBlocks", 8, 7), True),
    "F32_loads": (_NOBLEND + _NOSTORE, False),
    "F32_stores": (_NOBLEND + _NOCOPY, False),
    "F32_fixedmap": (_FIXEDMAP, False),
    "F32_mapread": (_NOBLEND + _NOSTORE + _NOCOPY, False),
    "F32_first": (_FIRST, True),
    "F32_first_loads": (_FIRST + _FIRST_NOBLEND + _FIRST_NOSTORE, False),
    "F32_first_stores": (_FIRST + _FIRST_NOBLEND + _NOCOPY, False),
    "F32_first_fixedmap": (_FIRST + _FIRST_FIXEDMAP, False),
    "F32_first_mapread": (_FIRST + _FIRST_NOBLEND + _FIRST_NOSTORE + _NOCOPY, False),
}


def variant_files(name: str, csrc: str) -> dict:
    """{file name: text} of variant `name` from the sources in `csrc`."""
    texts = {}
    for f in FILES:
        with open(os.path.join(csrc, f)) as fh:
            texts[f] = fh.read()
    for f, old, new in VARIANTS[name][0]:
        if texts[f].count(old) != 1:
            raise ValueError(f"variant {name}: {texts[f].count(old)} of {old[:60]!r} in {f}")
        texts[f] = texts[f].replace(old, new)
    return texts


def _build(names, csrc: str, out_dir: str, kernels) -> dict:
    """Each variant built by nvcc into out_dir/<name>/lib.so, in parallel;
    name -> ctypes library with the C entry bound."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    procs = {}
    for name in names:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for f, text in variant_files(name, csrc).items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "remap_lerp.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        fn = getattr(lib, ENTRY)
        fn.argtypes = kernels._SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def measure_all(torch, tp, libs, smi: str) -> dict:
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.ops import undistortion
    from raw_image_pipeline_tpu_torch.tools import measure, workloads
    from raw_image_pipeline_tpu_torch.tools.lut_flip_variants import swapped

    hw = SIZES[0][1:]
    p = tp.make_params(workloads.chains(tp)["fixed32"].config(*hw), hw, device="cuda")
    base, weights, code = p.remap_base, p.remap_weights, p.remap_code
    n = base.numel()
    live = int((weights != 0).any(0).sum())
    explicit = int((code == undistortion.FIXED32_EXPLICIT).sum())
    g = torch.Generator(device="cuda")
    g.manual_seed(workloads.SEED + 23)
    planes = {b: [torch.randint(0, 256, (b, h, w), generator=g, device="cuda",
                                dtype=torch.uint8) for _ in range(3)] for b, h, w in SIZES}
    res = {"card": smi, "explicit": explicit, "live": live, "pixels": n, "ms": {},
           "bound_ms": {}, "bound_ms_wide": {}, "differs": []}
    cases = {f"B={b}": (b, code) for b, _, _ in SIZES}
    cases.update({f"B={b} wide": (b, None) for b, _, _ in SIZES})
    for label, (b, _) in cases.items():
        work = measure.remap_lerp_work(b, *hw, n, 3, "fixed32", live, explicit=explicit)
        wide = measure.remap_lerp_work(b, *hw, n, 3, "fixed32", live)
        res["bound_ms"][label] = measure.bound(work["bytes"], work["ops"])["bound_ms"]
        res["bound_ms_wide"][label] = measure.bound(wide["bytes"], wide["ops"])["bound_ms"]

    def call(label):
        b, c = cases[label]
        return lambda: undistortion.remap_lerp_cuda(planes[b], base, weights, hw, mode="fixed32",
                                                    code=c)

    def labels(name):
        return [k for k in cases if name == "F32" or not k.endswith("wide")]

    names = [v for v in VARIANTS if v in libs]
    want = {4: undistortion.remap_fixed32_planes(planes[4], base, weights, hw)}
    with swapped(kernels, libs["F32"], ENTRY):
        want.update({b: call(f"B={b}")() for b, _, _ in SIZES[1:]})
    for name in names:  # exactness first
        if not VARIANTS[name][1]:
            continue
        with swapped(kernels, libs[name], ENTRY):
            for label in labels(name):
                if not torch.equal(call(label)(), want[cases[label][0]]):
                    res["differs"].append(f"{name} {label}")
    del want
    for turn in range(TURNS):
        for name in names if turn % 2 == 0 else names[::-1]:
            with swapped(kernels, libs[name], ENTRY):
                for label in labels(name):
                    ms = measure.device_ms(call(label))
                    res["ms"].setdefault(name, {}).setdefault(label, []).append(ms)
                    bd = res["bound_ms"][label]
                    print(f"turn {turn} {name} {label}: {ms:.5f} ms, bound {bd:.5f} "
                          f"({100 * bd / ms:.1f}%) [{smi}]", flush=True)
    for name, by in res["ms"].items():
        print(f"{name}, median of {TURNS} turns: " + ", ".join(
            f"{label} {statistics.median(v):.5f} ms "
            f"({100 * res['bound_ms'][label] / statistics.median(v):.1f}%)"
            for label, v in by.items()), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    import torch

    import raw_image_pipeline_tpu_torch as tp
    from raw_image_pipeline_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("remap_variants: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kernels.LIBRARY.get()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    libs = _build(list(VARIANTS), kernels.CSRC_DIR, os.path.join(root, "build", "remap_variants"),
                  kernels)
    res = measure_all(torch, tp, libs, smi)
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if res["differs"]:
        print(f"remap_variants: differ: {res['differs']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
