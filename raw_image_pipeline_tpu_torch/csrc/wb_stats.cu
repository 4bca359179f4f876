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
// (3 KB for simple; learned's zeroing writes 1 MB a frame more). simple's
// counting is three shared-memory adds a pixel, which cost more than the
// loads; adding a run of equal values at once cost more still, its
// branches on every value (0.60 against 0.21 ms at B=64, PERF.md).
//
// Design: grid (P blocks a frame, B), P = cluster x groups chosen by the
// caller from the batch and the card (ops/white_balance.wb_stats_grid):
// about two waves of resident blocks over the batch, at least 4 chunks a
// thread, so that at B=1-16 a frame spreads over the card and at B=64
// eight blocks take a frame. A
// block takes the q-th of P equal runs of the frame's 16-pixel chunks
// (wb_planes.cuh: one 16-byte load a plane where the rows are contiguous),
// a thread a chunk at a time with the next chunk's loads issued before it
// counts the current one. Each thread keeps its sums in registers (u32 a
// chunk, u64 across chunks: 255^2 * 2 M passes 32 bits), pca's by byte dot
// products (__dp4a) and byte maxima, reduced by shuffles, then across the
// block's warps in shared memory. simple counts in shared memory instead,
// in COPIES private histograms (one a warp), one atomicAdd a value with no
// branch on the data.
// A thread-block cluster (up to 16 blocks, the non-portable size) merges
// its blocks through distributed shared memory: for simple, block r sums
// its 768 / cluster bins over the cluster; for the others rank 0 combines
// the blocks' partials. With one cluster a frame that is the record. With
// more (groups > 1), each cluster writes its partial into the workspace
// `ws` and takes a ticket from the frame's counter (atomicInc, which leaves
// the counter at 0 after the last arrival): the last one to arrive sums the
// groups' partials and writes the record. Every record element is written
// once, so no memset runs; the counters stay at 0 between launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wb_planes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 16;  // blocks of a cluster (above 8 non-portable)
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int COPIES = 16;       // simple's private histograms a block (one a warp)
constexpr int BINS = 3 * 256;
constexpr int HIST64 = 64 * 64 * 64;  // kernel L's bins a frame
constexpr int SIMPLE_SMEM = COPIES * BINS * 4;
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
  int param;       // grey-world's and learned's t255
  int groups;      // clusters a frame
  void* record;
  int* hist;       // learned: kernel L's histogram, zeroed here
  void* ws;        // groups > 1: [B, groups, 768] u32 (simple) or [B, groups, n] u64
  unsigned* tickets;  // groups > 1: a counter a frame, 0 between launches
};

__device__ __forceinline__ unsigned long long combine(bool is_max, unsigned long long a,
                                                      unsigned long long b) {
  return is_max ? (a > b ? a : b) : a + b;
}

// 0xFF in byte i of the result where bit i of `bits` (4 bits) is set
__device__ __forceinline__ uint32_t byte_mask(uint32_t bits) {
  return ((bits * 0x00204081u) & 0x01010101u) * 0xFFu;
}

template <int MODE>
__device__ __forceinline__ void count_chunk(const wbp::Chunk& ch, unsigned long long (&acc)[9],
                                            unsigned* hist, const Params& p, long long body16,
                                            unsigned body8, unsigned per8) {
  if constexpr (MODE == kSimple) {  // an add a value: no branch on the data
#pragma unroll
    for (int k = 0; k < wbp::kChunk; ++k) {
      if (!((ch.valid >> k) & 1u)) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(hist + c * 256 + wbp::byte_at(ch, c, k), 1u);
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
    // four bytes at a time: the bytes outside the frame masked to 0, which
    // adds nothing to a sum and is no maximum
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      unsigned s = 0u, q = 0u, m = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t v = ch.v[c][j] & byte_mask((ch.valid >> (4 * j)) & 15u);
        s = __dp4a(v, 0x01010101u, s);
        q = __dp4a(v, v, q);
        m = __vmaxu4(m, v);
      }
      m = max(max(m & 255u, (m >> 8) & 255u), max((m >> 16) & 255u, m >> 24));
      acc[3 * c] += s, acc[3 * c + 1] += q;
      acc[3 * c + 2] = max(acc[3 * c + 2], (unsigned long long)m);
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

// whether this block arrives last of `arrivals` at frame f's counter; the
// block's writes before it are visible to the last one
__device__ __forceinline__ bool arrive(unsigned* tickets, int f, unsigned arrivals, int t) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicInc(tickets + f, arrivals - 1u) == arrivals - 1u;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) wb_stats_kernel(const Params p) {
  constexpr int NV = Slots<MODE>::n;
  extern __shared__ unsigned hist[];  // simple: COPIES private histograms
  __shared__ unsigned long long red[WARPS][NV];
  __shared__ unsigned long long part[NV];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int f = blockIdx.y, q = blockIdx.x, group = q / csize;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const wbp::Frame fr = wbp::frame_of(p.b, p.g, p.r, p.sb, p.sy, p.sx, p.h, p.w, f);
  const long long per = (fr.chunks + gridDim.x - 1) / gridDim.x;
  const long long c1 = min(fr.chunks, (q + 1) * per);
  long long c = q * per + t;
  wbp::Chunk next;
  if (c < c1) wbp::load_chunk(fr, c, next);

  if constexpr (MODE == kSimple) {
    uint4* z = reinterpret_cast<uint4*>(hist);
    for (int i = t; i < COPIES * BINS / 4; i += THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  if constexpr (MODE == kLearned) {  // kernel L's histogram, this block's share
    constexpr int QUADS = HIST64 / 4;
    const int share = (QUADS + gridDim.x - 1) / gridDim.x;
    int4* z = reinterpret_cast<int4*>(p.hist + (long long)f * HIST64);
    for (int i = q * share + t; i < min(QUADS, (q + 1) * share); i += THREADS) {
      z[i] = make_int4(0, 0, 0, 0);
    }
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
      for (int k = 0; k < COPIES; ++k) s += hist[k * BINS + i];
      hist[i] = s;
    }
    cluster.sync();  // every block's histogram is merged into its copy 0
    const int share = BINS / csize;
    int* out = reinterpret_cast<int*>(p.record) + (long long)f * BINS;
    unsigned* ws = reinterpret_cast<unsigned*>(p.ws) + ((long long)f * p.groups + group) * BINS;
    for (int i = rank * share + t; i < (rank + 1) * share; i += THREADS) {
      unsigned s = 0;
      for (int k = 0; k < csize; ++k) s += *cluster.map_shared_rank(hist + i, k);
      if (p.groups == 1) {
        out[i] = (int)s;
      } else {
        ws[i] = s;
      }
    }
    if (p.groups > 1 && arrive(p.tickets, f, (unsigned)gridDim.x, t)) {
      const unsigned* all = reinterpret_cast<const unsigned*>(p.ws) + (long long)f * p.groups * BINS;
      for (int i = t; i < BINS; i += THREADS) {
        unsigned s = 0;
        for (int k = 0; k < p.groups; ++k) s += __ldcg(all + k * BINS + i);
        out[i] = (int)s;
      }
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
      for (int k = 1; k < WARPS; ++k) v = combine(Slots<MODE>::is_max(t), v, red[k][t]);
      part[t] = v;
    }
    cluster.sync();  // every block's partials are in its `part`
    if (rank == 0) {
      if (t < NV) {
        unsigned long long v = part[t];
        for (int k = 1; k < csize; ++k) {
          v = combine(Slots<MODE>::is_max(t), v, *cluster.map_shared_rank(part + t, k));
        }
        red[0][t] = v;
      }
      bool write = true;
      if (p.groups > 1) {  // the cluster's partial into the workspace; the last sums them
        unsigned long long* ws = reinterpret_cast<unsigned long long*>(p.ws);
        if (t < NV) ws[((long long)f * p.groups + group) * NV + t] = red[0][t];
        write = arrive(p.tickets, f, (unsigned)p.groups, t);
        if (write && t < NV) {
          const unsigned long long* all = ws + (long long)f * p.groups * NV;
          unsigned long long v = __ldcg(all + t);
          for (int k = 1; k < p.groups; ++k) {
            v = combine(Slots<MODE>::is_max(t), v, __ldcg(all + k * NV + t));
          }
          red[0][t] = v;
        }
      }
      __syncthreads();
      if (write) {
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
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

template <int MODE>
constexpr int smem_bytes() {
  return MODE == kSimple ? SIMPLE_SMEM : 0;
}

// the kernel's attributes, set once per device: simple's dynamic shared
// memory above 48 KB and clusters above 8 blocks
template <int MODE>
cudaError_t configure() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(wb_stats_kernel<MODE>, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err == cudaSuccess && smem_bytes<MODE>() > 0) {
    err = cudaFuncSetAttribute(wb_stats_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<MODE>());
  }
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

cudaLaunchConfig_t config(int cluster, int groups, int batch, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * groups, batch, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int MODE>
int launch(const Params& p, int cluster, int batch, cudaStream_t stream) {
  cudaError_t err = configure<MODE>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, p.groups, batch, smem_bytes<MODE>(), stream, attr);
  err = cudaLaunchKernelEx(&cfg, wb_stats_kernel<MODE>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the mode's resident blocks an SM and the largest cluster size of 16, 8,
// ... 1 of which one cluster can be resident
template <int MODE>
int limits(int* resident, int* largest) {
  cudaError_t err = configure<MODE>();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, wb_stats_kernel<MODE>, THREADS,
                                                        smem_bytes<MODE>());
  }
  for (int c = MAX_CLUSTER; err == cudaSuccess && c > 1; c /= 2) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(c, 1, 1, smem_bytes<MODE>(), 0, attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, wb_stats_kernel<MODE>, &cfg);
    if (err == cudaSuccess && clusters > 0) {
      *largest = c;
      return (int)cudaSuccess;
    }
  }
  *largest = 1;
  return (int)err;
}

}  // namespace

// mode: 0 simple, 1 grey_world, 2 pca, 3 learned (ops/white_balance.METHODS).
// b, g, r: [batch, h, w] u8 planes of shared strides (frame, row, column, in
// bytes); param: grey-world's or learned's t255; record: the mode's record
// (int32 [batch, 768] for simple, int64 [batch, 3 | 9 | 7]); cluster (1, 2,
// 4, 8 or 16) and groups: the grid, cluster x groups blocks a frame
// (ops/white_balance.wb_stats_grid); hist: learned's [batch, 64^3] int32
// histogram, 16-byte aligned, which this launch zeroes (else null); ws: with groups > 1, a workspace of
// [batch, groups, 768] u32 (simple) or [batch, groups, 3 | 9 | 6] u64, and
// tickets, batch u32 counters that are 0 and are left at 0 (else both
// null). A frame's h * w and its last byte's offset must fit an int (the
// wrapper checks). Launches on `stream` and returns the launch's error.
extern "C" int isp_wb_stats(int mode, const void* b, const void* g, const void* r,
                            long long sb, long long sy, long long sx, int batch, int h, int w,
                            int param, void* record, void* hist, int cluster, int groups,
                            void* ws, void* tickets, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (h <= 0 || w <= 0 || (long long)h * w >= (1LL << 31) || batch > 65535 || !record ||
      cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) || groups < 1 ||
      (long long)cluster * groups > 65535 || (groups > 1 && (!ws || !tickets)) ||
      (mode == kLearned && (!hist || (uintptr_t)hist % 16))) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.b = (const uint8_t*)b, p.g = (const uint8_t*)g, p.r = (const uint8_t*)r;
  p.sb = sb, p.sy = sy, p.sx = sx, p.h = h, p.w = w, p.param = param, p.groups = groups;
  p.record = record, p.hist = (int*)hist, p.ws = ws, p.tickets = (unsigned*)tickets;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kSimple: return launch<kSimple>(p, cluster, batch, s);
    case kGreyWorld: return launch<kGreyWorld>(p, cluster, batch, s);
    case kPca: return launch<kPca>(p, cluster, batch, s);
    case kLearned: return launch<kLearned>(p, cluster, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The current device's limits for `mode`: *resident, the blocks an SM can
// hold, and *largest, the largest cluster size (16, 8, ... 1) of which one
// cluster can be resident. Returns the error.
extern "C" int isp_wb_stats_limits(int mode, int* resident, int* largest) {
  switch (mode) {
    case kSimple: return limits<kSimple>(resident, largest);
    case kGreyWorld: return limits<kGreyWorld>(resident, largest);
    case kPca: return limits<kPca>(resident, largest);
    case kLearned: return limits<kLearned>(resident, largest);
    default: return (int)cudaErrorInvalidValue;
  }
}
