"""What limits kernels K, L and M on a CUDA card: variants of their sources,
built apart and timed beside the kernels as they are.

    python -m raw_image_pipeline_tpu_torch.tools.wb_variants [--out FILE]

Run from the root of a checkout on the machine with the card. Each variant
(VARIANTS) is a copy of csrc/wb_stats.cu (K), csrc/wb_hist64.cu (L) or
csrc/wb_tables.cu (M: learned's mode, and S, its small modes) with
named text replacements, or a source of its own, built by nvcc into
build/wb_variants/<name>/ and called through ctypes by the kernel's own C
entry. Inputs: card_frames' colour frames ("card", seeded) and the
Alphasense fixture's ("fixture", workloads.fixture_colour), B = 1, 4, 16 at
1080x1920 and 64 at 1920x1080.

  * K ("K", as built) in each method's mode; simple's limiters:
    "K_loads" (its count replaced by an xor of the loaded words: the loads
    alone), "K_runs" (an add a run of equal values in a chunk, the earlier
    form), "K_copies8" (a private histogram a pair of warps); and K's
    grid forced to other (cluster, groups) at B = 1, 4 and 16 on card;
  * L ("L", as built, 8192 slots) and "L_4096" (the earlier table),
    "L_16384", "L_2way" (a pair of slots a bin), "L_split" (the add and
    the key's read at once, an add to another bin taken back), "L_u64" (a
    64-bit (key, count) slot added before its key is checked), "L_strips"
    (a strip of consecutive chunks a thread), "L_more" (eight blocks an
    SM in all, not four), "L_sms4" (four blocks an SM, with no floor of a
    block every 2^17 pixels: the earlier rule), "L_walk" (no add: the
    pixel walk alone) and "L_dsmem" (the frame's whole histogram in the
    distributed shared memory of a cluster of 8 blocks of 1024 threads,
    adds through map_shared_rank);
    "L_count" and "L_4096_count" count the runs added in the block, those
    spilled to device memory, the slots flushed and the kept pixels
    (__device__ counters read back by an added C function).

  * M ("M", as built: a thread-block cluster a frame) at wb_tables_cluster's
    size and at each size forced (M_CLUSTERS; 1 is a block a frame),
    "M_loads1" (one int4 load in flight a thread in each pass, not four),
    "M_first_walk" (the radix select's first digit counted in a walk of
    its own, not in pass 1),
    on the record and histogram of each learned input above; "M_stamps"
    reads %globaltimer at the phases of frame 0's rank-0 block (M_PHASES)
    back through an added C function, in microseconds.
  * M's small modes ("S", as built: simple, grey-world and PCA a plain
    launch, simple's alpha and beta computed in f64, blocks of 96 / 256 /
    512 threads), "S_threads512" (simple's and grey-world's blocks of
    512), "S_table" (alpha and beta read from
    the host's tables in device memory), "S_ex" (cudaLaunchKernelEx with
    no attribute set), "S_pdl" (each a programmatic dependent of the
    kernel before it: cudaLaunchKernelEx with programmatic stream
    serialization, griddepcontrol.wait before K's record), "S_trigger"
    ("S_pdl", and M lets G launch at its start,
    griddepcontrol.launch_dependents), "S_first" (512 threads, the tables:
    the first form), each alone on K's record at SMALL_SIZES, beside M's
    floor (the empty launch of "S"; of "S_pdl" for the PDL form); the
    chains KMG of K ("K", or "K_trigger": K lets M launch at its start),
    an S variant and G's table step (the port's pointwise_cuda), as config
    2's white balance runs them; the host's cost of each launch form
    (measure_launch_host: host-clock microseconds a call of the empty
    launch and of each small mode, "S", "S_ex", "S_pdl"); and the wb_*
    chains whole (measure_chains) with M's small modes and G's table step
    launched as built or as programmatic dependents ("S_pdl", "G_pdl", a
    copy of csrc/pointwise.cu).

Each time is measure.device_ms (L's adds pile up over the timed calls, as
they do in chip_smoke.py). A variant that computes the kernel's function
is first held to the plain version (record, or histogram from zero);
"K_loads" and "L_walk" do not. Prints one line per number and, last, a
JSON line of them all with the card's name and power limit; --out writes
that JSON to a file as well. Exits 1 if a variant that should be exact
differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

SIZES = ((1, 1080, 1920), (4, 1080, 1920), (16, 1080, 1920), (64, 1920, 1080))
PARAMS = {"simple": 20.0, "grey_world": 0.8, "pca": None, "learned": 0.8}
GRIDS = ((8, 1), (16, 1), (16, 2), (16, 4), (8, 8), (16, 8), (16, 15))

_SIMPLE = """  if constexpr (MODE == kSimple) {  // an add a value: no branch on the data
#pragma unroll
    for (int k = 0; k < wbp::kChunk; ++k) {
      if (!((ch.valid >> k) & 1u)) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(hist + c * 256 + wbp::byte_at(ch, c, k), 1u);
    }
  } else"""
_SIMPLE_LOADS = """  if constexpr (MODE == kSimple) {  // the loads alone
    uint32_t x = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) x ^= ch.v[c][0] ^ ch.v[c][1] ^ ch.v[c][2] ^ ch.v[c][3];
    if (x == 0x9E3779B9u) atomicAdd(hist, 1u);  // keeps the loads
  } else"""
_SIMPLE_RUNS = """  if constexpr (MODE == kSimple) {  // an add a run of equal values
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      int cur = -1;
      unsigned cnt = 0;
#pragma unroll
      for (int k = 0; k < wbp::kChunk; ++k) {
        if (!((ch.valid >> k) & 1u)) continue;
        const int v = wbp::byte_at(ch, c, k);
        if (v != cur) {
          if (cnt) atomicAdd(hist + c * 256 + cur, cnt);
          cur = v, cnt = 0;
        }
        ++cnt;
      }
      if (cnt) atomicAdd(hist + c * 256 + cur, cnt);
    }
  } else"""

_ADD_RUN = """  const unsigned s = slot_of(bin);
  unsigned k = reinterpret_cast<volatile unsigned*>(keys)[s];
  if (k == EMPTY) {
    k = atomicCAS(keys + s, EMPTY, bin);
    if (k == EMPTY) k = bin;  // claimed
  }
  if (k == bin) {
    atomicAdd(cnts + s, cnt);
  } else {
    atomicAdd(frame_hist + bin, (int)cnt);
  }"""
_ADD_RUN_2WAY = """  unsigned s = slot_of(bin);
#pragma unroll
  for (int way = 0; way < 2; ++way, s ^= 1u) {
    unsigned k = reinterpret_cast<volatile unsigned*>(keys)[s];
    if (k == EMPTY) {
      k = atomicCAS(keys + s, EMPTY, bin);
      if (k == EMPTY) k = bin;
    }
    if (k == bin) {
      atomicAdd(cnts + s, cnt);
      return;
    }
  }
  atomicAdd(frame_hist + bin, (int)cnt);"""
_ADD_RUN_SPLIT = """  const unsigned s = slot_of(bin);
  atomicAdd(cnts + s, cnt);
  unsigned k = reinterpret_cast<volatile unsigned*>(keys)[s];
  if (k == EMPTY) {
    k = atomicCAS(keys + s, EMPTY, bin);
    if (k == EMPTY) k = bin;
  }
  if (k == bin) return;
  atomicSub(cnts + s, cnt);
  atomicAdd(frame_hist + bin, (int)cnt);"""
_ADD_RUN_U64 = """  // slot s is words (2s, 2s + 1) of the table: count, key
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(keys);
  const unsigned s = slot_of(bin);
  const unsigned long long old = atomicAdd(slots + s, (unsigned long long)cnt);
  if ((unsigned)(old >> 32) == bin) return;
  if ((unsigned)(old >> 32) == EMPTY) {
    unsigned long long v = old + cnt;
    while ((unsigned)(v >> 32) == EMPTY) {
      const unsigned long long w =
          atomicCAS(slots + s, v, ((unsigned long long)bin << 32) | (v & 0xFFFFFFFFull));
      if (w == v) return;
      v = w;
    }
    if ((unsigned)(v >> 32) == bin) return;
  }
  atomicAdd(slots + s, 0ull - cnt);
  atomicAdd(frame_hist + bin, (int)cnt);"""
_INIT = "  for (int i = t; i < SLOTS; i += THREADS) keys[i] = EMPTY, cnts[i] = 0u;"
_INIT_U64 = ("  for (int i = t; i < SLOTS; i += THREADS) {\n"
             "    reinterpret_cast<unsigned long long*>(keys)[i] = (unsigned long long)EMPTY << 32;\n"
             "  }")
_FLUSH = "    if (cnts[i]) atomicAdd(frame_hist + keys[i], (int)cnts[i]);"
_FLUSH_U64 = ("    const unsigned long long v = reinterpret_cast<unsigned long long*>(keys)[i];\n"
              "    if ((unsigned)v) atomicAdd(frame_hist + (unsigned)(v >> 32), (int)(unsigned)v);")
_RUN = """      if (bin != cur) {
        if (cnt) add_run(cur, cnt, keys, cnts, frame_hist);
        cur = bin, cnt = 0;
      }
      ++cnt;"""
_LAST = "  if (cnt) add_run(cur, cnt, keys, cnts, frame_hist);\n  __syncthreads();"
_WALK = """  const long long per = (fr.chunks + gridDim.x - 1) / gridDim.x;
  const long long c1 = min(fr.chunks, (blockIdx.x + 1) * per);
  long long c = blockIdx.x * per + t;"""
_WALK_STRIPS = """  const long long per = (fr.chunks + gridDim.x - 1) / gridDim.x;
  const long long b0 = blockIdx.x * per, b1 = min(fr.chunks, b0 + per);
  const long long strip = (b1 - b0 + THREADS - 1) / THREADS;
  long long c = b0 + t * strip;
  const long long c1 = min(b1, c + strip);"""
_COUNTERS = ("__device__ unsigned long long g_counts[4];  // runs in the block, spilled, "
             "flushed, kept pixels\n\nnamespace {")
_COUNTS_READ = """
extern "C" int wb_variant_counts(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_counts, sizeof(g_counts));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_counts, zero, sizeof(zero));
  return (int)e;
}
"""


def _stamp(k: int) -> str:
    return ("  if (t == 0 && f == 0 && rank == 0) {\n"
            "    unsigned long long g;\n"
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g));\n"
            f"    g_stamps[{k}] = g;\n"
            "  }\n")


# M's phases for frame 0's rank-0 block: %globaltimer at its start (0),
# after pass 1 (1), after the radix select (2), after the blocks' counts
# above T and at T are summed (3), after the collection (4), after the
# sort and the cluster's density rows (5) and at its end (6), read back by
# an added C function
M_PHASES = ("pass 1", "radix select", "counts above and at T", "collection",
            "sort and density", "trees and tables")
_H4 = "  const int4* h4 = reinterpret_cast<const int4*>(p.hist + (long long)f * HIST64 + base);\n"
_STAMPS = [
    ("namespace {\n\nconstexpr int THREADS", "__device__ unsigned long long g_stamps[7];\n\n"
                                            "namespace {\n\nconstexpr int THREADS"),
    (_H4, _H4 + _stamp(0)),
    ("  __syncthreads();\n\n  // the radix select of T",
     "  __syncthreads();\n" + _stamp(1) + "\n  // the radix select of T"),
    ("  cluster.sync();  // every block's bins above T and at T are in",
     _stamp(2) + "  cluster.sync();  // every block's bins above T and at T are in"),
    ("  const unsigned T = s.prefix, need = s.need, n_gt = s.n_gt, gt_before = s.gt_before;",
     _stamp(3) + "  const unsigned T = s.prefix, need = s.need, n_gt = s.n_gt, "
                 "gt_before = s.gt_before;"),
    ("  cluster.sync();  // the palette is whole in rank 0's shared memory\n",
     "  cluster.sync();  // the palette is whole in rank 0's shared memory\n" + _stamp(4)),
    ("  if (rank != 0) return;\n", "  if (rank != 0) return;\n" + _stamp(5)),
    ("  gains_table(p.tables + (long long)f * 768, gain, t, THREADS);\n}\n",
     "  gains_table(p.tables + (long long)f * 768, gain, t, THREADS);\n" + _stamp(6) + "}\n"),
]
_STAMPS_READ = """
extern "C" int wb_variant_stamps(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
"""


def _counting(slots_repl=()):
    return list(slots_repl) + [
        ("namespace {", _COUNTERS),
        ("  if (k == bin) {\n    atomicAdd(cnts + s, cnt);\n  } else {",
         "  if (k == bin) {\n    atomicAdd(cnts + s, cnt);\n    atomicAdd(&g_counts[0], 1ull);\n"
         "  } else {\n    atomicAdd(&g_counts[1], 1ull);"),
        (_FLUSH, "    if (cnts[i]) {\n      atomicAdd(frame_hist + keys[i], (int)cnts[i]);\n"
                 "      atomicAdd(&g_counts[2], 1ull);\n    }"),
        ("      ++cnt;\n    }\n    c = cn;",
         "      ++cnt;\n      atomicAdd(&g_counts[3], 1ull);\n    }\n    c = cn;"),
    ]


_SLOTS_4096 = [("constexpr int SLOTS = 8192; ", "constexpr int SLOTS = 4096; "),
               ("constexpr int LOG_SLOTS = 13;", "constexpr int LOG_SLOTS = 12;")]
_SLOTS_16384 = [("constexpr int SLOTS = 8192; ", "constexpr int SLOTS = 16384;"),
                ("constexpr int LOG_SLOTS = 13;", "constexpr int LOG_SLOTS = 14;")]

# the frame's whole 64^3 histogram in the distributed shared memory of a
# cluster of 8 blocks: block o owns the bins whose bits 3-5 read o (runs of
# 8 bins), adds go through map_shared_rank, each block writes its bins once
DSMEM_SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wb_planes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8, LOG_CLUSTER = 3, THREADS = 1024;
constexpr int HIST64 = 64 * 64 * 64, OWN = HIST64 / CLUSTER, SMEM = OWN * 4;
constexpr int RECORD = 7, HI = 4;

struct Params {
  const uint8_t* b;
  const uint8_t* g;
  const uint8_t* r;
  long long sb, sy, sx;
  int h, w, t255;
  const long long* record;
  int* hist;
};

__device__ __forceinline__ void add_run(cg::cluster_group& cluster, unsigned* own, unsigned bin,
                                        unsigned cnt) {
  const unsigned owner = (bin >> 3) & (CLUSTER - 1);
  const unsigned local = ((bin >> (3 + LOG_CLUSTER)) << 3) | (bin & 7u);
  atomicAdd(cluster.map_shared_rank(own + local, owner), cnt);
}

__global__ void __launch_bounds__(THREADS, 1) dsmem_kernel(const Params p) {
  extern __shared__ uint4 smem[];
  unsigned* own = reinterpret_cast<unsigned*>(smem);
  __shared__ unsigned idx[256];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int f = blockIdx.y, t = threadIdx.x;
  const wbp::Frame fr = wbp::frame_of(p.b, p.g, p.r, p.sb, p.sy, p.sx, p.h, p.w, f);
  const long long per = (fr.chunks + CLUSTER - 1) / CLUSTER;
  const long long c1 = min(fr.chunks, (rank + 1) * per);
  long long c = rank * per + t;
  wbp::Chunk next;
  if (c < c1) wbp::load_chunk(fr, c, next);
  for (int i = t; i < OWN / 4; i += THREADS) smem[i] = make_uint4(0u, 0u, 0u, 0u);
  if (t < 256) {
    const float hi = (float)max(p.record[(long long)f * RECORD + HI], 64LL);
    const float q = floorf(__fdiv_rn(__fmul_rn((float)t, 64.0f), hi));
    idx[t] = (unsigned)fminf(fmaxf(q, 0.0f), 63.0f);
  }
  cluster.sync();
  unsigned cur = 0xFFFFFFFFu, cnt = 0;
  while (c < c1) {
    const wbp::Chunk ch = next;
    const long long cn = c + THREADS;
    if (cn < c1) wbp::load_chunk(fr, cn, next);
#pragma unroll
    for (int k = 0; k < wbp::kChunk; ++k) {
      int b, g, r;
      wbp::pixel_at(ch, k, b, g, r);
      if (!((ch.valid >> k) & 1u) || max(max(b, g), r) >= p.t255) continue;
      const unsigned bin = (idx[b] << 12) | (idx[g] << 6) | idx[r];
      if (bin != cur) {
        if (cnt) add_run(cluster, own, cur, cnt);
        cur = bin, cnt = 0;
      }
      ++cnt;
    }
    c = cn;
  }
  if (cnt) add_run(cluster, own, cur, cnt);
  cluster.sync();
  int* frame_hist = p.hist + (long long)f * HIST64;
  for (int i = t; i < OWN / 8; i += THREADS) {
    int4* d = reinterpret_cast<int4*>(frame_hist + ((long long)i << (3 + LOG_CLUSTER)) +
                                      (rank << 3));
    const int4* s = reinterpret_cast<const int4*>(smem + 2 * i);
    d[0] = s[0], d[1] = s[1];
  }
}

}  // namespace

extern "C" int isp_wb_hist64(const void* b, const void* g, const void* r, long long sb,
                             long long sy, long long sx, int batch, int h, int w, int t255,
                             const void* record, void* hist, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(dsmem_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.b = (const uint8_t*)b, p.g = (const uint8_t*)g, p.r = (const uint8_t*)r;
  p.sb = sb, p.sy = sy, p.sx = sx, p.h = h, p.w = w, p.t255 = t255;
  p.record = (const long long*)record, p.hist = (int*)hist;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, batch, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dsmem_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
"""

# kernel M's small modes (simple, grey-world, PCA): the first form's pieces
_SMALL_THREADS512 = [("constexpr int SIMPLE_THREADS = 96;", "constexpr int SIMPLE_THREADS = 512;"),
                     ("constexpr int GREY_THREADS = 256;", "constexpr int GREY_THREADS = 512;")]

def _small_launch(pdl: bool):
    """M's small modes (and their empty floor) launched by cudaLaunchKernelEx,
    as programmatic dependents of the kernel before them (pdl: waiting with
    griddepcontrol.wait before K's record) or with no attribute set."""
    return [("""  kernel<<<batch, threads, 0, stream>>>(args...);
  return cudaSuccess;""", f"""  cudaLaunchConfig_t cfg = {{}};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = {int(pdl)};
  cfg.gridDim = dim3((unsigned)batch, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);""")] + ([
        ("""  const int f = blockIdx.x, t = threadIdx.x;
  if constexpr (MODE == kSimple) {""", """  const int f = blockIdx.x, t = threadIdx.x;
  asm volatile("griddepcontrol.wait;\\n" ::: "memory");  // K's record from here on
  if constexpr (MODE == kSimple) {"""),
        ("wb_tables_empty_kernel() {}",
         'wb_tables_empty_kernel() { asm volatile("griddepcontrol.wait;\\n" ::: "memory"); }'),
    ] if pdl else [])


_SMALL_EX = _small_launch(False)
_SMALL_PDL = _small_launch(True)
_SMALL_TRIGGER = [("""  asm volatile("griddepcontrol.wait;\\n" ::: "memory");  // K's record from here on""",
                   """  asm volatile("griddepcontrol.launch_dependents;\\n" ::);  // G may launch now
  asm volatile("griddepcontrol.wait;\\n" ::: "memory");  // K's record from here on""")]
# simple's alpha and beta read from the host's tables in device memory
# (filled once by the C entry, from the same f64 formulas), not computed
_SMALL_TABLE = [
    ("namespace {\n\nconstexpr int THREADS",
     "__device__ float g_alpha[257];\n__device__ float g_beta[256 * 257];\n\n"
     "namespace {\n\nconstexpr int THREADS"),
    ("""  const double alpha64 = __ddiv_rn(255.0, (double)span);
  const float alpha = __double2float_rn(alpha64);
  const float beta = __double2float_rn(__dmul_rn(-(double)p1, alpha64));""",
     "  const float alpha = __ldg(g_alpha + span), beta = __ldg(g_beta + p1 * 257 + span);"),
    ("""  cudaError_t err = cudaSuccess;
  switch (mode) {""", """  static bool filled = false;
  if (!filled) {
    static float a[257], bt[256 * 257];
    for (int sp = 0; sp < 257; ++sp) {
      const double a64 = 255.0 / (double)(sp ? sp : 1);
      a[sp] = (float)a64;
      for (int p1 = 0; p1 < 256; ++p1) bt[p1 * 257 + sp] = (float)(-(double)p1 * a64);
    }
    cudaMemcpyToSymbol(g_alpha, a, sizeof(a));
    cudaMemcpyToSymbol(g_beta, bt, sizeof(bt));
    filled = true;
  }
  cudaError_t err = cudaSuccess;
  switch (mode) {"""),
]
# G's table step launched as a programmatic dependent of M, waiting for
# M's tables
_G_PDL = [("  const bool table = STEPS ? (STEPS & kTable) != 0 : p.wb != nullptr;\n",
           "  const bool table = STEPS ? (STEPS & kTable) != 0 : p.wb != nullptr;\n"
           '  if (table) asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n'),
          ("  pointwise_kernel<IN, OUT, STEPS><<<blocks, kThreads, 0, stream>>>(q);", """  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = p.wb != nullptr;
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pointwise_kernel<IN, OUT, STEPS>, q);
  if (err != cudaSuccess) return (int)err;""")]
# kernel K lets its dependent (M) launch at its start
_K_TRIGGER = [("""  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const wbp::Frame fr""", """  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  asm volatile("griddepcontrol.launch_dependents;\\n" ::);
  const wbp::Frame fr""")]

# name -> (kernel "K", "L", "M" (learned), "S" (M's small modes) or "G"
# (G's table step), source file or a source of its own, replacements, exact)
VARIANTS = {
    "K": ("K", "wb_stats.cu", [], True),
    "K_loads": ("K", "wb_stats.cu", [(_SIMPLE, _SIMPLE_LOADS)], False),
    "K_runs": ("K", "wb_stats.cu", [(_SIMPLE, _SIMPLE_RUNS)], True),
    "K_copies8": ("K", "wb_stats.cu", [("constexpr int COPIES = 16;",
                                        "constexpr int COPIES = 8;")], True),
    "K_trigger": ("K", "wb_stats.cu", _K_TRIGGER, True),
    "L": ("L", "wb_hist64.cu", [], True),
    "L_4096": ("L", "wb_hist64.cu", _SLOTS_4096, True),
    "L_16384": ("L", "wb_hist64.cu", _SLOTS_16384, True),
    "L_2way": ("L", "wb_hist64.cu", [(_ADD_RUN, _ADD_RUN_2WAY)], True),
    "L_split": ("L", "wb_hist64.cu", [(_ADD_RUN, _ADD_RUN_SPLIT)], True),
    "L_u64": ("L", "wb_hist64.cu", [(_ADD_RUN, _ADD_RUN_U64), (_INIT, _INIT_U64),
                                    (_FLUSH, _FLUSH_U64)], True),
    "L_strips": ("L", "wb_hist64.cu", [(_WALK, _WALK_STRIPS),
                                       ("const long long cn = c + THREADS;",
                                        "const long long cn = c + 1;")], True),
    "L_more": ("L", "wb_hist64.cu", [("(4LL * sms[dev] + batch - 1) / batch",
                                      "(8LL * sms[dev] + batch - 1) / batch")], True),
    "L_sms4": ("L", "wb_hist64.cu", [("((long long)h * w + (1 << 17) - 1) >> 17", "1LL")], True),
    "L_walk": ("L", "wb_hist64.cu", [(_RUN, "      cnt += bin;"),
                                     (_LAST, "  if (cnt == 0x9E3779B9u) atomicAdd(frame_hist, 1);"
                                             "\n  __syncthreads();")], False),
    "L_dsmem": ("L", DSMEM_SOURCE, [], True),
    "L_count": ("L", "wb_hist64.cu", _counting(), True),
    "L_4096_count": ("L", "wb_hist64.cu", _counting(_SLOTS_4096), True),
    "M": ("M", "wb_tables.cu", [], True),
    "M_loads1": ("M", "wb_tables.cu", [("constexpr int LOADS = 4;", "constexpr int LOADS = 1;")],
                 True),
    "M_stamps": ("M", "wb_tables.cu", _STAMPS, True),
    "M_first_walk": ("M", "wb_tables.cu", [
        ("      if (c4[j] > 0 && c4[j] < (1 << FIRST_HI)) {",
         "      if (false) {"),
        ("      s.counted = bits > DIGIT_BITS && bits <= FIRST_HI;", "      s.counted = false;"),
        ("      s.shift = s.counted ? FIRST_SHIFT : bits > DIGIT_BITS ? bits - DIGIT_BITS : 0;",
         "      s.shift = bits > DIGIT_BITS ? bits - DIGIT_BITS : 0;")], True),
    "S": ("S", "wb_tables.cu", [], True),
    "S_threads512": ("S", "wb_tables.cu", _SMALL_THREADS512, True),
    "S_table": ("S", "wb_tables.cu", _SMALL_TABLE, True),
    "S_ex": ("S", "wb_tables.cu", _SMALL_EX, True),
    "S_pdl": ("S", "wb_tables.cu", _SMALL_PDL, True),
    "S_trigger": ("S", "wb_tables.cu", _SMALL_PDL + _SMALL_TRIGGER, True),
    "S_first": ("S", "wb_tables.cu", _SMALL_THREADS512 + _SMALL_TABLE, True),
    "G_pdl": ("G", "pointwise.cu", _G_PDL, True),
}
ENTRIES = {"K": ("isp_wb_stats", "isp_wb_stats_limits"), "L": ("isp_wb_hist64",),
           "M": ("isp_wb_tables", "isp_wb_tables_limits"),
           "S": ("isp_wb_tables", "isp_wb_tables_limits", "isp_wb_tables_empty"),
           "G": ("isp_pointwise",)}
# the wb_* chains' launch forms timed whole (measure_chains): the library's
# entries replaced by these variants' (M's small modes, G's table step)
CHAIN_FORMS = {"built": (), "M_pdl": ("S_pdl",), "G_pdl": ("G_pdl",),
               "both_pdl": ("S_pdl", "G_pdl")}
WB_CHAINS = ("wb_simple", "wb_grey_world", "wb_pca", "wb_learned")
SMALL = ("simple", "grey_world", "pca")  # kernel M's small modes
SMALL_SIZES = ((4, 1080, 1920), (64, 1080, 1920))
# (K's library, M's library) of the chains K -> M -> G's table step timed
KMG = (("K", "S"), ("K", "S_first"), ("K", "S_threads512"), ("K", "S_table"),
       ("K", "S_ex"), ("K", "S_pdl"), ("K", "S_trigger"), ("K_trigger", "S_pdl"))
M_CLUSTERS = (1, 2, 4, 8, 16)  # kernel M's learned cluster sizes, each forced on "M"


def variant_source(name: str, csrc: str) -> str:
    """The source text of variant `name` from the sources in `csrc`."""
    _, src, repl, _ = VARIANTS[name]
    if src.endswith(".cu"):
        with open(os.path.join(csrc, src)) as f:
            text = f.read()
    else:
        text = src
    for old, new in repl:
        if old not in text:
            raise ValueError(f"variant {name}: no {old[:60]!r} in its source")
        text = text.replace(old, new)
    return (text + (_COUNTS_READ if name.endswith("_count") else "")
            + (_STAMPS_READ if name.endswith("_stamps") else ""))


def _build(names, csrc: str, out_dir: str, kernels) -> dict:
    """Each variant built by nvcc into out_dir/<name>/lib.so, in parallel;
    name -> ctypes library with the kernel's C entry bound."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    procs = {}
    for name in names:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(csrc, "wb_planes.cuh"), d)
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
        for entry in ENTRIES[VARIANTS[name][0]]:
            getattr(lib, entry).argtypes = kernels._SIGNATURES[entry]
        libs[name] = lib
    return libs


def _k_call(torch, wb, learned_wb, lib, pl, method, param, sms, grid=None):
    """(fn, record) of a K variant on planes pl on its default grid, or `grid`."""
    b, h, w = pl[0].shape
    mode = wb.METHODS.index(method)
    shape, dtype = wb.RECORD[method]
    rec = torch.empty((b,) + shape, dtype=dtype, device="cuda")
    hist = (torch.empty((b, learned_wb.N_BINS), dtype=torch.int32, device="cuda")
            if method == "learned" else None)
    t255 = (learned_wb.learned_t255(param) if method == "learned"
            else wb.grey_world_t255(param) if method == "grey_world" else 0)
    resident, largest = ctypes.c_int(0), ctypes.c_int(0)
    if lib.isp_wb_stats_limits(mode, ctypes.byref(resident), ctypes.byref(largest)):
        raise RuntimeError("isp_wb_stats_limits failed")
    cluster, groups = grid or wb.wb_stats_grid(b, h * w, sms, resident.value, largest.value)
    ws = tickets = None
    if groups > 1:
        size, ws_dtype = wb.WB_PARTIAL[method]
        ws = torch.empty((b, groups, size), dtype=ws_dtype, device="cuda")
        tickets = torch.zeros(b, dtype=torch.int32, device="cuda")
    args = (mode, *(p.data_ptr() for p in pl), *pl[0].stride(), b, h, w, t255, rec.data_ptr(),
            None if hist is None else hist.data_ptr(), cluster, groups,
            None if ws is None else ws.data_ptr(), None if tickets is None else tickets.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    def fn():
        err = lib.isp_wb_stats(*args)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return (rec, hist, ws, tickets)  # the buffers live as long as fn

    return fn, rec


def _l_call(torch, lib, pl, record, t255):
    b, h, w = pl[0].shape
    hist = torch.zeros((b, 64 ** 3), dtype=torch.int32, device="cuda")
    args = (*(p.data_ptr() for p in pl), *pl[0].stride(), b, h, w, t255, record.data_ptr(),
            hist.data_ptr(), torch.cuda.current_stream().cuda_stream)

    def fn():
        err = lib.isp_wb_hist64(*args)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return hist

    return fn, hist


def _m_call(torch, wb, learned_wb, lib, record, hist, npix, sms, cluster=None):
    """(fn, tables) of an M variant in learned's mode on the card's record
    and histogram, at wb_tables_cluster's size or `cluster`."""
    b = record.shape[0]
    largest = ctypes.c_int(0)
    if lib.isp_wb_tables_limits(ctypes.byref(largest)):
        raise RuntimeError("isp_wb_tables_limits failed")
    c = cluster or wb.wb_tables_cluster(b, sms, largest.value)
    tables = torch.empty((b, 3, 256), dtype=torch.uint8, device="cuda")
    fi, tv, lv = learned_wb.model_tensors_card(record.device)
    args = (wb.METHODS.index("learned"), record.data_ptr(), hist.data_ptr(), b, npix, 0.0,
            fi.data_ptr(), tv.data_ptr(), lv.data_ptr(), tables.data_ptr(), None, None, c,
            torch.cuda.current_stream().cuda_stream)

    def fn():
        err = lib.isp_wb_tables(*args)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return tables

    return fn, tables


def _s_call(torch, wb, lib, record, method, param, npix):
    """(fn, tables, nan) of an M variant in a small mode on a record."""
    b = record.shape[0]
    tables = torch.empty((b, 3, 256), dtype=torch.uint8, device="cuda")
    nan = torch.empty((b, 3), dtype=torch.uint8, device="cuda") if method == "pca" else None
    target = wb.simple_target(param, npix) if method == "simple" else 0.0
    args = (wb.METHODS.index(method), record.data_ptr(), None, b, npix, target, None, None, None,
            tables.data_ptr(), None if nan is None else nan.data_ptr(), None, 1,
            torch.cuda.current_stream().cuda_stream)

    def fn():
        err = lib.isp_wb_tables(*args)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return tables

    return fn, tables, nan


def _empty_call(torch, wb, lib, method, b):
    """fn of the empty launch of an S variant: b blocks of method's threads."""
    args = (wb.METHODS.index(method), b, torch.cuda.current_stream().cuda_stream)

    def fn():
        if lib.isp_wb_tables_empty(*args):
            raise RuntimeError("isp_wb_tables_empty failed")

    return fn


def measure_launch_host(torch, libs, smi: str, res: dict, calls: int = 500,
                        turns: int = 6) -> None:
    """The host's cost of M's launch forms: host-clock microseconds a call of
    `calls` back-to-back calls (through ctypes, not synchronised; fewer than
    the launch queue holds, so the host never waits for the device) of the
    empty launch and of each small mode on a seeded K record at B=4, for
    "S" (<<<>>>), "S_ex" (cudaLaunchKernelEx, no
    attribute) and "S_pdl" (with programmatic stream serialization), in
    `turns` turns forwards then backwards; the median into
    res["launch_host_us"]."""
    import statistics
    import time

    from raw_image_pipeline_tpu_torch.ops import white_balance as wb
    from raw_image_pipeline_tpu_torch.tools import workloads

    names = [n for n in ("S", "S_ex", "S_pdl") if n in libs]
    b, h, w = SMALL_SIZES[0]
    x = workloads.card_frames(torch, "color", b, h, w, workloads.SEED + 23)
    pl = tuple(x[..., c].contiguous() for c in range(3))
    del x
    recs = {m: wb.wb_stats_plain(pl, m, PARAMS[m]) for m in SMALL}
    del pl
    fns = {}
    for name in names:
        for m in SMALL:
            fns[f"{name} empty {m}"] = _empty_call(torch, wb, libs[name], m, b)
            fns[f"{name} {m}"] = _s_call(torch, wb, libs[name], recs[m], m, PARAMS[m], h * w)[0]
    got = {}
    for turn in range(turns):
        for key in fns if turn % 2 == 0 else list(fns)[::-1]:
            fn = fns[key]
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            got.setdefault(key, []).append((t1 - t0) / calls * 1e6)
    res["launch_host_us"] = {k: statistics.median(v) for k, v in got.items()}
    for k, v in got.items():
        print(f"launch_host {k}: {statistics.median(v):.3f} us a call, median of {turns} "
              f"({min(v):.3f}-{max(v):.3f}) [{smi}]", flush=True)


def measure_small(torch, libs, smi: str, res: dict) -> None:
    """M's small modes: each S variant alone on K's record (held to
    wb_tables_plain first), their floors (the empty launch of "S" and of
    "S_pdl"), and the chains KMG (K, M, then G's table step on the planes)
    on card_frames' colour frames at SMALL_SIZES, into res["S"],
    res["S_floor"] and res["KMG"]."""
    from raw_image_pipeline_tpu_torch.ops import learned_wb
    from raw_image_pipeline_tpu_torch.ops import white_balance as wb
    from raw_image_pipeline_tpu_torch.ops.pointwise import pointwise_cuda
    from raw_image_pipeline_tpu_torch.tools import measure, workloads

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key in ("S", "S_floor", "KMG"):
        res.setdefault(key, {})

    def record(table, key, ms):
        res[table][key] = ms
        print(f"{table} {key}: {ms:.5f} ms [{smi}]", flush=True)

    for b, h, w in SMALL_SIZES:
        x = workloads.card_frames(torch, "color", b, h, w, workloads.SEED + 23 + b)
        pl = tuple(x[..., c].contiguous() for c in range(3))
        out = tuple(torch.empty_like(p) for p in pl)
        del x
        for method in SMALL:
            param = PARAMS[method]
            rec = wb.wb_stats_plain(pl, method, param)
            want = wb.wb_tables_plain(rec, method, param, h * w)
            for name in (n for n in libs if VARIANTS[n][0] == "S"):
                fn, tables, nan = _s_call(torch, wb, libs[name], rec, method, param, h * w)
                fn()
                torch.cuda.synchronize()
                if not (torch.equal(tables, want.tables)
                        and (nan is None or torch.equal(nan, want.nan))):
                    res["differs"].append(f"{name} {method} B={b}")
                record("S", f"{name} {method} B={b}", measure.device_ms(fn))
            for name in (n for n in ("S", "S_pdl") if n in libs):
                empty = _empty_call(torch, wb, libs[name], method, b)
                record("S_floor", f"{name} {method} B={b}", measure.device_ms(empty))
            for kname, mname in KMG:
                if kname not in libs or mname not in libs:
                    continue
                kfn, krec = _k_call(torch, wb, learned_wb, libs[kname], pl, method, param, sms)
                mfn, tables, nan = _s_call(torch, wb, libs[mname], krec, method, param, h * w)

                def chain():
                    kfn()
                    mfn()
                    pointwise_cuda(pl, wb_tables=tables, wb_nan=nan, out=out)

                chain()
                torch.cuda.synchronize()
                if not torch.equal(tables, want.tables):
                    res["differs"].append(f"KMG {kname} {mname} {method} B={b}")
                record("KMG", f"{kname} {mname} {method} B={b}", measure.device_ms(chain))
        del pl, out
        torch.cuda.empty_cache()


def measure_chains(torch, libs, smi: str, res: dict) -> None:
    """The wb_* chains (BASELINE config 2, B=64 1920x1080, 2 calls) whole,
    in each of CHAIN_FORMS (the built library with M's small modes' and G's
    table step's entries replaced by their programmatic-dependent
    variants), in 2 turns forwards then backwards: device ms of one call
    (measure.device_ms) and frames/s (host clock around both calls and a
    synchronize, the median of 9), into res["chains"]."""
    import statistics
    import time
    import types

    import raw_image_pipeline_tpu_torch as tp
    from raw_image_pipeline_tpu_torch import kernels
    from raw_image_pipeline_tpu_torch.tools import measure, workloads

    main = kernels.LIBRARY.get()

    def library(names):  # the built library, these variants' entries swapped in
        over = {}
        for n in names:
            entry = ENTRIES[VARIANTS[n][0]][0]
            over[entry] = getattr(libs[n], entry)
        return types.SimpleNamespace(**{e: over.get(e) or getattr(main, e)
                                        for e in kernels._SIGNATURES},
                                     isp_error_string=main.isp_error_string)

    pipes = {}
    for name in WB_CHAINS:
        ch = workloads.chains(tp)[name]
        pipe = tp.build_pipeline(ch.config(1080, 1920), ch.encoding, frame_hw=(1080, 1920),
                                 with_state=True, temporal_mode="sequence", device="cuda")
        frames = workloads.card_frames(torch, ch.kind, ch.frames, 1080, 1920,
                                       workloads.SEED + len(name))
        pipes[name] = (pipe, frames, ch)
    res.setdefault("chains", {})
    forms = [f for f, need in CHAIN_FORMS.items() if all(n in libs for n in need)]
    try:
        for turn in range(2):
            for form in forms if turn == 0 else forms[::-1]:
                kernels.LIBRARY._lib = library(CHAIN_FORMS[form])
                for name, (pipe, frames, ch) in pipes.items():
                    per = ch.frames // ch.calls

                    def run():
                        state = tp.init_state((), device="cuda")
                        for c in range(ch.calls):
                            _, state = pipe(frames[c * per:(c + 1) * per], state)
                        torch.cuda.synchronize()

                    run()
                    walls = []
                    for _ in range(9):
                        t0 = time.perf_counter()
                        run()
                        walls.append(time.perf_counter() - t0)
                    state0 = tp.init_state((), device="cuda")
                    r = res["chains"].setdefault(f"{name} {form}", {"fps": [], "device_ms": []})
                    r["fps"].append(ch.frames / statistics.median(walls))
                    r["device_ms"].append(measure.device_ms(lambda: pipe(frames[:per], state0)))
                    print(f"chains turn {turn} {name} {form}: {r['fps'][-1]:.1f} frames/s, "
                          f"{r['device_ms'][-1]:.5f} device ms a call [{smi}]", flush=True)
    finally:
        kernels.LIBRARY._lib = main


def measure_all(torch, libs, smi: str) -> dict:
    from raw_image_pipeline_tpu_torch.ops import learned_wb
    from raw_image_pipeline_tpu_torch.ops import white_balance as wb
    from raw_image_pipeline_tpu_torch.tools import measure, workloads
    from raw_image_pipeline_tpu_torch.utils import image_io

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    bgr = image_io.imread(os.path.join(root, "tests", "fixtures", "alphasense.png"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"card": smi, "K": {}, "L": {}, "M": {}, "M_phases": {}, "grid": {}, "spill": {},
           "differs": []}

    def record(table, key, ms):
        res[table][key] = ms
        print(f"{table} {key}: {ms:.4f} ms [{smi}]", flush=True)

    for family in ("card", "fixture"):
        for b, h, w in SIZES:
            x = (workloads.card_frames(torch, "color", b, h, w, workloads.SEED + b)
                 if family == "card" else workloads.fixture_colour(torch, bgr, b, h, w))
            pl = tuple(x[..., c].contiguous() for c in range(3))
            del x
            for method, param in PARAMS.items():
                want = wb.wb_stats_plain(pl, method, param)
                for name, (kern, _, _, exact) in VARIANTS.items():
                    if name not in libs or kern != "K" or (name != "K" and method != "simple"):
                        continue
                    fn, rec = _k_call(torch, wb, learned_wb, libs[name], pl, method, param, sms)
                    fn()
                    if exact and not torch.equal(rec, want):
                        res["differs"].append(f"{name} {method} {family} B={b}")
                    record("K", f"{name} {method} {family} B={b}", measure.device_ms(fn))
                if family == "card" and b < 64 and "K" in libs:
                    for grid in GRIDS:
                        if grid[0] * grid[1] * b <= 4 * sms and method in ("simple", "grey_world"):
                            fn, _ = _k_call(torch, wb, learned_wb, libs["K"], pl, method, param,
                                            sms, grid)
                            record("grid", f"K {grid[0]}x{grid[1]} {method} B={b}",
                                   measure.device_ms(fn))
                if method != "learned":
                    continue
                t255 = learned_wb.learned_t255(param)
                want_hist = learned_wb.hist64_plain(pl, want, t255)
                for name, (kern, _, _, exact) in VARIANTS.items():
                    if name not in libs or kern != "L":
                        continue
                    fn, hist = _l_call(torch, libs[name], pl, want, t255)
                    fn()
                    torch.cuda.synchronize()
                    if exact and not torch.equal(hist, want_hist):
                        res["differs"].append(f"{name} {family} B={b}")
                    if name.endswith("_count"):
                        counts = (ctypes.c_ulonglong * 4)()
                        libs[name].wb_variant_counts(counts)  # the counts of the call above
                        in_block, spilled, flushed, kept = list(counts)
                        runs = in_block + spilled
                        res["spill"][f"{name} {family} B={b}"] = dict(
                            runs=runs, spilled=spilled, flushed=flushed, kept_pixels=kept,
                            spilled_share=spilled / max(runs, 1))
                        print(f"spill {name} {family} B={b}: {runs} runs of {kept} kept pixels, "
                              f"{spilled} spilled ({100 * spilled / max(runs, 1):.2f}%), "
                              f"{flushed} slots flushed", flush=True)
                        continue
                    record("L", f"{name} {family} B={b}", measure.device_ms(fn))
                want_tables = learned_wb.learned_tables_plain(want, want_hist)
                for name, (kern, _, _, exact) in VARIANTS.items():
                    if name not in libs or kern != "M":
                        continue
                    for cluster in (None,) + (M_CLUSTERS if name == "M" else ()):
                        fn, tables = _m_call(torch, wb, learned_wb, libs[name], want, want_hist,
                                             h * w, sms, cluster)
                        fn()
                        torch.cuda.synchronize()
                        key = f"{name}{'' if cluster is None else f' cluster {cluster}'}"
                        if exact and not torch.equal(tables, want_tables):
                            res["differs"].append(f"{key} {family} B={b}")
                        if name.endswith("_stamps"):  # frame 0's phases in one call
                            stamps = (ctypes.c_ulonglong * (len(M_PHASES) + 1))()
                            libs[name].wb_variant_stamps(stamps)
                            us = {ph: (stamps[i + 1] - stamps[i]) / 1e3
                                  for i, ph in enumerate(M_PHASES)}
                            res["M_phases"][f"{family} B={b}"] = us
                            print(f"M phases {family} B={b} (frame 0's rank-0 block, us): "
                                  + ", ".join(f"{k} {v:.2f}" for k, v in us.items()), flush=True)
                            continue
                        record("M", f"{key} {family} B={b}", measure.device_ms(fn))
                del want_hist, want_tables
            del pl
            torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    ap.add_argument("--kernels", default="KLMS",
                    help="the kernels whose variants run, of K, L, M (learned) and S (M's small "
                         "modes; with K, also the chains K -> M -> G) (default all)")
    args = ap.parse_args(argv)
    import torch

    from raw_image_pipeline_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("wb_variants: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kernels.LIBRARY.get()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    # G's variant (its table step as a programmatic dependent) goes with M's small modes
    names = [n for n, v in VARIANTS.items()
             if v[0] in args.kernels or (v[0] == "G" and "S" in args.kernels)]
    libs = _build(names, kernels.CSRC_DIR, os.path.join(root, "build", "wb_variants"), kernels)
    res = measure_all(torch, libs, smi)
    if "S" in args.kernels:
        measure_small(torch, libs, smi, res)
        measure_launch_host(torch, libs, smi, res)
        measure_chains(torch, libs, smi, res)
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if res["differs"]:
        print(f"wb_variants: differ from the plain versions: {res['differs']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
