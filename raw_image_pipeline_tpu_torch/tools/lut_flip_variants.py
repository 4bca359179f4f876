"""What limits kernel O (the LUT) and kernel N's route 2 (the 90 / 270 flip)
on a CUDA card: variants of their sources, built apart and timed in turns
beside the kernels as they are.

    python -m raw_image_pipeline_tpu_torch.tools.lut_flip_variants [--out FILE]

Run from the root of a checkout on the machine with the card. Each variant
(VARIANTS) is a copy of csrc/lut.cu (O) or csrc/flip.cu (N) with named
text replacements, built by nvcc into build/lut_flip_variants/<name>/ and
called through the port's own wrappers (ops/gamma.apply_lut,
ops/flip.flip_cuda) with the kernel's C entry swapped for the variant's:

  * O ("O", as built: the table replicated a lane, 4 chunks a thread at
    once), "O_unroll2" and "O_unroll8" (2 and 8 chunks), "O_shared256"
    (one copy of the table, 256 words: the banks the bytes pick collide),
    "O_copy" (no lookup: the loads and stores alone; not exact);
  * N ("N", as built: tiles on the output's 32-byte sectors, 16-byte
    loads, the next tile's loads after this tile's stores, 3 blocks an SM
    at a large batch), "N_prefetch" (the next tile's loads before this
    tile's stores), "N_word4" (4-byte loads), "N_skew16" (rows placed on
    16-byte boundaries only, so 32-byte sectors are shared between tiles),
    "N_rows128" (tiles of 128 output rows: 128 bytes of an input row, two
    load units a thread), "N_cols480" (tiles 480 output bytes wide),
    "N_rows128_cols96" (tiles of 128 x 96), "N_stream" (loads and stores
    with the streaming cache hints, __ldcs / __stcs), "N_contiguous" (a
    block walks a contiguous range of tiles), "N_reverse" (a frame's tile
    columns walked from the last), "N_blocks2", "N_blocks4", "N_blocks8"
    (2, 4 or 8 (as many as fit) blocks an SM at a large batch, not 3), and,
    not exact, "N_noload" (no input read: the stores alone) and
    "N_nostore" (no output written: the loads alone).

Inputs: O on mono planes, B=4 1080x1920 and B=64 1920x1080, seeded noise
and card_frames' mono frames; N on seeded u8 mosaics, B=4 and B=64
1080x1920, at 90 and 270. Every variant is held to the plain version first
(but "O_copy"). Each time is measure.device_ms, in TURNS rounds over the
variants, forwards then backwards. Prints one line per number and, last, a
JSON line with the card's name and power limit; --out writes that JSON to
a file as well. Exits 1 if an exact variant differs.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import types

TURNS = 2
O_SIZES = ((4, 1080, 1920), (64, 1920, 1080))
N_CASES = ((4, 90), (4, 270), (16, 90), (64, 90), (64, 270))

_LOOKUP = (("(((w << 7) & 0x7F80u) | lane4)", "((w << 2) & 0x3FCu)"),
           ("(((w >> 1) & 0x7F80u) | lane4)", "((w >> 6) & 0x3FCu)"),
           ("(((w >> 9) & 0x7F80u) | lane4)", "((w >> 14) & 0x3FCu)"),
           ("(((w >> 17) & 0x7F80u) | lane4)", "((w >> 22) & 0x3FCu)"),
           ("((b << 7) | lane4)", "(b << 2)"),
           ("""  for (int i = t; i < 256 * kLanes / 4; i += kThreads) {  // 8 words of 4 lanes an entry
    const uint32_t e = __ldg(p.lut + (i >> 3));
    reinterpret_cast<uint4*>(tab)[i] = make_uint4(e, e, e, e);
  }""", """  for (int i = t; i < 256; i += kThreads) tab[i] = __ldg(p.lut + i);"""))
_BUSY = "constexpr int R2_BUSY_BLOCKS = 3;"
_PREFETCH = [("""    const long long next = item + gridDim.x;
""", """    const long long next = item + gridDim.x;
    if (next < items) load(next);
"""), ("""    __syncthreads();
    if (next < items) load(next);
    item = next;""", """    __syncthreads();
    item = next;""")]
_CONTIGUOUS = [("""  long long item = blockIdx.x;""", """  const long long per = (items + gridDim.x - 1) / gridDim.x;
  long long item = blockIdx.x * per;
  const long long end = item + per < items ? item + per : items;"""),
               ("while (item < items) {", "while (item < end) {"),
               ("const long long next = item + gridDim.x;", "const long long next = item + 1;"),
               ("if (next < items) load(next);\n    item = next;",
                "if (next < end) load(next);\n    item = next;")]
_ROWS128 = [("constexpr int R2_ROWS = 64;", "constexpr int R2_ROWS = 128;")]
_COLS480 = [("constexpr int R2_COLS = 224;", "constexpr int R2_COLS = 480;")]
_COLS96 = [("constexpr int R2_COLS = 224;", "constexpr int R2_COLS = 96;")]
_STREAM = [("a[j] = __ldg(reinterpret_cast<const uint4*>(src));",
            "a[j] = __ldcs(reinterpret_cast<const uint4*>(src));"),
           ("*reinterpret_cast<uint4*>(row + x) = make_uint4(v[0], v[1], v[2], v[3]);",
            "__stcs(reinterpret_cast<uint4*>(row + x), make_uint4(v[0], v[1], v[2], v[3]));")]


def _blocks(n):  # n blocks an SM at a large batch
    return [(_BUSY, f"constexpr int R2_BUSY_BLOCKS = {n};")]


# name -> (kernel, source, [(old, new)], exact)
VARIANTS = {
    "O": ("O", "lut.cu", [], True),
    "O_unroll2": ("O", "lut.cu", [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
                  True),
    "O_unroll8": ("O", "lut.cu", [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
                  True),
    "O_shared256": ("O", "lut.cu", list(_LOOKUP), True),
    "O_copy": ("O", "lut.cu", [("""        const uint4 o = make_uint4(lookup4(cur[k].x, lane4), lookup4(cur[k].y, lane4),
                                   lookup4(cur[k].z, lane4), lookup4(cur[k].w, lane4));""",
                                """        const uint4 o = cur[k];""")], False),
    "N": ("N", "flip.cu", [], True),
    "N_prefetch": ("N", "flip.cu", _PREFETCH, True),
    "N_word4": ("N", "flip.cu", [("return word == 16 ? launch_tiles16<true, 16>",
                                  "return false ? launch_tiles16<true, 16>"),
                                 ("return word == 16 ? launch_tiles16<false, 16>",
                                  "return false ? launch_tiles16<false, 16>")], True),
    "N_skew16": ("N", "flip.cu", [("(uintptr_t)(row + tl.c0) & 31", "(uintptr_t)(row + tl.c0) & 15")],
                 True),
    "N_rows128": ("N", "flip.cu", _ROWS128, True),
    "N_cols480": ("N", "flip.cu", _COLS480, True),
    "N_rows128_cols96": ("N", "flip.cu", _ROWS128 + _COLS96, True),
    "N_stream": ("N", "flip.cu", _STREAM, True),
    "N_contiguous": ("N", "flip.cu", _CONTIGUOUS, True),
    "N_reverse": ("N", "flip.cu", [("t.c0 = (int)(q % across) * R2_COLS;",
                                    "t.c0 = (int)(across - 1 - q % across) * R2_COLS;")], True),
    **{f"N_blocks{n}": ("N", "flip.cu", _blocks(n), True) for n in (2, 4, 8)},
    # staged rows no output row reads (below the least 32 - skew) not loaded:
    # with 32-byte aligned bases a row's skew is a multiple of gcd(ow, 32)
    "N_trim": ("N", "flip.cu", [("if (ox < 0 || ox >= p.h) continue;  // ow == h",
                                 "if (ox < 0 || ox >= p.h || 4 * g + j < trim) continue;"),
                                ("  const int x = ix0 + 16 * cq;\n", """  const int x = ix0 + 16 * cq;
  const int trim = p.ow & 31 ? (p.ow & -p.ow) : R2_MARGIN;  // bases 32-byte aligned here
""")], True),
    "N_noload": ("N", "flip.cu", [("a[j] = __ldg(reinterpret_cast<const uint4*>(src));",
                                   "a[j] = make_uint4((uint32_t)y, (uint32_t)x, 0u, 0u);")],
                 False),
    "N_nostore": ("N", "flip.cu", [(
        "*reinterpret_cast<uint4*>(row + x) = make_uint4(v[0], v[1], v[2], v[3]);",
        "if ((v[0] ^ v[1] ^ v[2] ^ v[3]) == 0x9E3779B9u) row[x] = 1;")], False),
}
ENTRIES = {"O": "isp_lut", "N": "isp_flip"}


def variant_source(name: str, csrc: str) -> str:
    """The source text of variant `name` from the sources in `csrc`."""
    _, src, repl, _ = VARIANTS[name]
    with open(os.path.join(csrc, src)) as f:
        text = f.read()
    for old, new in repl:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {text.count(old)} of {old[:60]!r} in {src}")
        text = text.replace(old, new)
    return text


def _build(names, csrc: str, out_dir: str, kernels) -> dict:
    """Each variant built by nvcc into out_dir/<name>/lib.so, in parallel;
    name -> ctypes library with the kernel's C entry bound."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    procs = {}
    for name in names:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "variant.cu"), "w") as f:
            f.write(variant_source(name, csrc))
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "variant.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        entry = ENTRIES[VARIANTS[name][0]]
        fn = getattr(lib, entry)
        fn.argtypes = kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


@contextlib.contextmanager
def swapped(kernels, lib, entry: str):
    """The port's wrappers launch `lib`'s `entry` in place of the built
    library's while the block runs."""
    main = kernels.LIBRARY.get()
    kernels.LIBRARY._lib = types.SimpleNamespace(
        **{entry: getattr(lib, entry), "isp_error_string": main.isp_error_string})
    try:
        yield
    finally:
        kernels.LIBRARY._lib = main


def measure_all(torch, libs, smi: str) -> dict:
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.ops import flip, gamma
    from raw_image_pipeline_tpu_torch.tools import measure, workloads

    g = torch.Generator(device="cuda")
    g.manual_seed(workloads.SEED + 22)
    lut = torch.as_tensor(gamma.build_gamma_lut(0.9), device="cuda")
    cases = {}
    for b, h, w in O_SIZES:
        cases[f"O noise B={b}"] = ("O", torch.randint(0, 256, (b, h, w), generator=g,
                                                      dtype=torch.uint8, device="cuda"), None)
        cases[f"O card B={b}"] = ("O", workloads.card_frames(torch, "mono", b, h, w,
                                                             workloads.SEED + b), None)
    for b, angle in N_CASES:
        cases[f"N {angle} B={b}"] = ("N", torch.randint(0, 256, (b, 1080, 1920), generator=g,
                                                        dtype=torch.uint8, device="cuda"), angle)

    def call(kern, x, angle):
        if kern == "O":
            return lambda: gamma.apply_lut(x, lut)
        return lambda: flip.flip_cuda((x,), angle)[0]

    def plain(kern, x, angle):
        if kern == "O":
            return gamma.apply_lut(x, lut, plain=True)
        return flip.flip_rows_plain(x, angle, None, (1, 2))

    res = {"card": smi, "ms": {}, "bound_ms": {}, "differs": []}
    for label, (kern, x, angle) in cases.items():
        work = (measure.lut_work(x.numel()) if kern == "O"
                else measure.flip_work(x.shape[0], *flip.flipped_shape(1080, 1920, angle)))
        res["bound_ms"][label] = measure.bound(bytes_=work["bytes"], ops=work["ops"])["bound_ms"]
    names = [n for n in VARIANTS if n in libs]
    for name in names:  # exactness first
        kern, _, _, exact = VARIANTS[name]
        if not exact:
            continue
        with swapped(kernels, libs[name], ENTRIES[kern]):
            for label, (k, x, angle) in cases.items():
                if k == kern and not torch.equal(call(k, x, angle)(), plain(k, x, angle)):
                    res["differs"].append(f"{name} {label}")
    for turn in range(TURNS):
        for name in names if turn % 2 == 0 else names[::-1]:
            kern = VARIANTS[name][0]
            with swapped(kernels, libs[name], ENTRIES[kern]):
                for label, (k, x, angle) in cases.items():
                    if k != kern:
                        continue
                    ms = measure.device_ms(call(k, x, angle))
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
    ap.add_argument("--kernels", default="ON", help="the kernels whose variants run, of O and N")
    args = ap.parse_args(argv)
    import torch

    from raw_image_pipeline_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("lut_flip_variants: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kernels.LIBRARY.get()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    names = [n for n, v in VARIANTS.items() if v[0] in args.kernels]
    libs = _build(names, kernels.CSRC_DIR, os.path.join(root, "build", "lut_flip_variants"),
                  kernels)
    res = measure_all(torch, libs, smi)
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if res["differs"]:
        print(f"lut_flip_variants: differ from the plain versions: {res['differs']}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
