// Kernel K: the statistical white balances' one pass over the planes. Three
// [B, h, w] u8 planes in, a per-frame record out, one launch a call, the
// method a mode; equal to ops/white_balance.wb_stats_plain:
//
//   simple      [B, 3, 256] int32 counts of each channel's values;
//   grey_world  [B, 3] int64 channel sums over the unsaturated pixels,
//               (mx - mn) * 255 <= t255 * mx, the u16 wrap of t255 * mx in
//               the library's 16-pixel SIMD body where t255 > 257, by the
//               pixel's flat position (ops/white_balance._grey_world_stats);
//   pca         [B, 3, 3] int64 a channel's sum, sum of squares and max;
//   learned     [B, 7] int64 (ops/learned_wb.learned_stats_plain): the kept
//               count (max(b, g, r) < t255), the kept channel sums, the
//               frame's max of max(b, g, r), the brightest kept pixel's key
//               (s + 1) << 32 | ~rank under the library's 8-lane first-wins
//               rank, and that pixel's b | g << 8 | r << 16; it also zeroes
//               kernel L's [B, 64^3] int32 histogram.
//
// Replaces: the JAX package leaves these to XLA, with no Pallas kernel:
// raw_image_pipeline_tpu/ops/white_balance.py `_channel_hists` (line 43,
// simple), `balance_white_grey_world` (109) and `balance_white_pca` (425)
// up to their sums, and ops/learned_wb.py `_extract_features` (152) up to
// its histogram. The port's plain versions run them as eager passes over
// int32 and int64 copies of the planes and a torch.bincount.
//
// What bounds it on the H100: bytes, three read a pixel (398 MB at B=64
// 1920x1080, 0.119 ms at 3.35 TB/s); the record is a few bytes a frame
// (3 KB for simple; learned's zeroing writes 1 MB a frame more).
//
// Design: a thread-block cluster of CLUSTER blocks a frame (grid (CLUSTER,
// B)), block r taking the r-th of CLUSTER equal runs of the frame's
// 16-pixel chunks (wb_planes.cuh: one 16-byte load a plane where the rows
// are contiguous), a thread a chunk at a time with the next chunk's loads
// issued before it counts the current one. Each thread keeps its sums in
// registers (u32 a chunk, u64 across chunks: 255^2 * 2 M passes 32 bits),
// reduced by shuffles, then across the block's warps in shared memory.
// simple counts in shared memory instead, in COPIES private histograms (a
// pair of warps each), one shared-memory atomicAdd per run of equal values
// in a chunk. After cluster.sync() the cluster merges through distributed
// shared memory, as kernel B does: for simple, block r sums bins
// [96r, 96r + 96) over the cluster and writes them; for the others rank 0
// combines the blocks' partials and writes the record. Every record element
// is written once, so no memset runs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wb_planes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;   // blocks a frame, the portable maximum
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int COPIES = 8;    // simple's private histograms a block
constexpr int BINS = 3 * 256;
constexpr int HIST64 = 64 * 64 * 64;  // kernel L's bins a frame
enum Mode { kSimple = 0, kGreyWorld = 1, kPca = 2, kLearned = 3 };

// values a thread carries, and whether each combines by max (else sum)
template <int MODE>
struct Slots;
template <>
struct Slots<kSimple> {
  static constexpr int n = 1;
  __device__ static bool is_max(int) { return false; }
};
template <>
struct Slots<kGreyWorld> {
  static constexpr int n = 3;  // sums b, g, r
  __device__ static bool is_max(int) { return false; }
};
template <>
struct Slots<kPca> {
  static constexpr int n = 9;  // (sum, sum of squares, max) b, g, r
  __device__ static bool is_max(int i) { return i % 3 == 2; }
};
template <>
struct Slots<kLearned> {
  static constexpr int n = 6;  // kept, sums b, g, r, hi, key
  __device__ static bool is_max(int i) { return i >= 4; }
};

struct Params {
  const uint8_t* b;
  const uint8_t* g;
  const uint8_t* r;
  long long sb, sy, sx;
  int h, w;
  int param;   // grey-world's and learned's t255
  void* record;
  int* hist;   // learned: kernel L's histogram, zeroed here
};

__device__ __forceinline__ unsigned long long combine(bool is_max, unsigned long long a,
                                                      unsigned long long b) {
  return is_max ? (a > b ? a : b) : a + b;
}

template <int MODE>
__device__ __forceinline__ void count_chunk(const wbp::Chunk& ch, unsigned long long (&acc)[9],
                                            unsigned* hist, const Params& p, long long body16,
                                            unsigned body8, unsigned per8) {
  if constexpr (MODE == kSimple) {
    // one shared-memory add per run of equal values
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
  } else if constexpr (MODE == kGreyWorld) {
    const bool wrap = p.param > 257;
    unsigned s[3] = {0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < wbp::kChunk; ++k) {
      int b, g, r;
      wbp::pixel_at(ch, k, b, g, r);
      const int mx = max(max(b, g), r), mn = min(min(b, g), r);
      int rhs = (int)((unsigned)p.param * (unsigned)mx);  // int32, wrapping as torch's
      if (wrap && ch.pos0 + k < body16) rhs &= 0xFFFF;    // the u16 SIMD lanes
      if (((ch.valid >> k) & 1u) && (mx - mn) * 255 <= rhs) {
        s[0] += b, s[1] += g, s[2] += r;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += s[c];
  } else if constexpr (MODE == kPca) {
    unsigned s[3] = {0u, 0u, 0u}, q[3] = {0u, 0u, 0u}, m[3] = {0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < wbp::kChunk; ++k) {
      const unsigned in = (ch.valid >> k) & 1u;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const unsigned v = in * (unsigned)wbp::byte_at(ch, c, k);
        s[c] += v, q[c] += v * v, m[c] = max(m[c], v);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[3 * c] += s[c], acc[3 * c + 1] += q[c];
      acc[3 * c + 2] = max(acc[3 * c + 2], (unsigned long long)m[c]);
    }
  } else {
    unsigned kept = 0, s[3] = {0u, 0u, 0u}, hi = 0;
    unsigned best = (unsigned)(acc[5] >> 32);  // the best key's sum + 1 so far
#pragma unroll
    for (int k = 0; k < wbp::kChunk; ++k) {
      if (!((ch.valid >> k) & 1u)) continue;
      int b, g, r;
      wbp::pixel_at(ch, k, b, g, r);
      const int mx = max(max(b, g), r);
      hi = max(hi, (unsigned)mx);
      if (mx < p.param) {
        ++kept, s[0] += b, s[1] += g, s[2] += r;
        const unsigned sum1 = (unsigned)(b + g + r) + 1u;
        if (sum1 >= best) {
          const unsigned pos = (unsigned)(ch.pos0 + k);
          const unsigned rank = pos < body8 ? (pos & 7u) * per8 + (pos >> 3) : pos;
          const unsigned long long key =
              ((unsigned long long)sum1 << 32) | (unsigned long long)(0xFFFFFFFFu - rank);
          if (key > acc[5]) acc[5] = key, best = sum1;
        }
      }
    }
    acc[0] += kept, acc[1] += s[0], acc[2] += s[1], acc[3] += s[2];
    acc[4] = max(acc[4], (unsigned long long)hi);
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) wb_stats_kernel(const Params p) {
  constexpr int NV = Slots<MODE>::n;
  __shared__ unsigned hist[MODE == kSimple ? COPIES * BINS : 1];
  __shared__ unsigned long long red[WARPS][NV];
  __shared__ unsigned long long part[NV];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int f = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const wbp::Frame fr = wbp::frame_of(p.b, p.g, p.r, p.sb, p.sy, p.sx, p.h, p.w, f);
  const long long per = (fr.chunks + CLUSTER - 1) / CLUSTER;
  const long long c1 = min(fr.chunks, (rank + 1) * per);
  long long c = rank * per + t;
  wbp::Chunk next;
  if (c < c1) wbp::load_chunk(fr, c, next);

  if constexpr (MODE == kSimple) {
    for (int i = t; i < COPIES * BINS; i += THREADS) hist[i] = 0u;
    __syncthreads();
  }
  if constexpr (MODE == kLearned) {  // kernel L's histogram, this block's share
    int4* z = reinterpret_cast<int4*>(p.hist + (long long)f * HIST64 + rank * (HIST64 / CLUSTER));
    for (int i = t; i < HIST64 / CLUSTER / 4; i += THREADS) z[i] = make_int4(0, 0, 0, 0);
  }
  unsigned long long acc[9] = {};
  const long long body16 = fr.n / 16 * 16;
  const unsigned body8 = (unsigned)(fr.n / 8 * 8), per8 = body8 / 8;
  unsigned* my_hist = hist + (MODE == kSimple ? (warp % COPIES) * BINS : 0);
  while (c < c1) {
    const wbp::Chunk ch = next;
    const long long cn = c + THREADS;
    if (cn < c1) wbp::load_chunk(fr, cn, next);
    count_chunk<MODE>(ch, acc, my_hist, p, body16, body8, per8);
    c = cn;
  }

  if constexpr (MODE == kSimple) {
    __syncthreads();
    for (int i = t; i < BINS; i += THREADS) {
      unsigned s = 0;
#pragma unroll
      for (int q = 0; q < COPIES; ++q) s += hist[q * BINS + i];
      hist[i] = s;
    }
    cluster.sync();  // every block's histogram is merged into its copy 0
    constexpr int SHARE = BINS / CLUSTER;
    int* out = reinterpret_cast<int*>(p.record) + (long long)f * BINS;
    for (int i = rank * SHARE + t; i < (rank + 1) * SHARE; i += THREADS) {
      unsigned s = 0;
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) s += *cluster.map_shared_rank(hist + i, q);
      out[i] = (int)s;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      unsigned long long v = acc[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        v = combine(Slots<MODE>::is_max(i), v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
      }
      if (lane == 0) red[warp][i] = v;
    }
    __syncthreads();
    if (t < NV) {
      unsigned long long v = red[0][t];
      for (int q = 1; q < WARPS; ++q) v = combine(Slots<MODE>::is_max(t), v, red[q][t]);
      part[t] = v;
    }
    cluster.sync();  // every block's partials are in its `part`
    if (rank == 0) {
      if (t < NV) {
        unsigned long long v = part[t];
        for (int q = 1; q < CLUSTER; ++q) {
          v = combine(Slots<MODE>::is_max(t), v, *cluster.map_shared_rank(part + t, q));
        }
        red[0][t] = v;
      }
      __syncthreads();
      constexpr int STRIDE = NV + (MODE == kLearned ? 1 : 0);  // learned adds the pixel
      long long* out = reinterpret_cast<long long*>(p.record) + (long long)f * STRIDE;
      if (t < NV) out[t] = (long long)red[0][t];
      if (MODE == kLearned && t == 0) {  // the brightest kept pixel's values
        const unsigned long long key = red[0][5];
        long long px = 0;
        if (key) {
          const unsigned rk = 0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull);
          const long long pos = rk < body8 ? (long long)(rk % per8) * 8 + rk / per8 : rk;
          const long long y = pos / p.w, x = pos - y * p.w;
          const long long off = y * p.sy + x * p.sx;
          px = (long long)fr.p[0][off] | ((long long)fr.p[1][off] << 8) |
               ((long long)fr.p[2][off] << 16);
        }
        out[6] = px;
      }
    }
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

template <int MODE>
int launch(const Params& p, int batch, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, batch, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, wb_stats_kernel<MODE>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 simple, 1 grey_world, 2 pca, 3 learned (ops/white_balance.METHODS).
// b, g, r: [batch, h, w] u8 planes of shared strides (frame, row, column, in
// bytes); param: grey-world's or learned's t255; record: the mode's record
// (int32 [batch, 768] for simple, int64 [batch, 3 | 9 | 7]); hist: learned's
// [batch, 64^3] int32 histogram, which this launch zeroes (else null). A
// frame's h * w and its last byte's offset must fit an int (the wrapper
// checks). Launches on `stream` and returns the launch's error.
extern "C" int isp_wb_stats(int mode, const void* b, const void* g, const void* r,
                            long long sb, long long sy, long long sx, int batch, int h, int w,
                            int param, void* record, void* hist, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (h <= 0 || w <= 0 || (long long)h * w >= (1LL << 31) || batch > 65535 || !record ||
      (mode == kLearned && !hist)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.b = (const uint8_t*)b, p.g = (const uint8_t*)g, p.r = (const uint8_t*)r;
  p.sb = sb, p.sy = sy, p.sx = sx, p.h = h, p.w = w, p.param = param;
  p.record = record, p.hist = (int*)hist;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kSimple: return launch<kSimple>(p, batch, s);
    case kGreyWorld: return launch<kGreyWorld>(p, batch, s);
    case kPca: return launch<kPca>(p, batch, s);
    case kLearned: return launch<kLearned>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
