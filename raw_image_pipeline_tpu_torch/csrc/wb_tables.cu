// Kernel M: the statistical white balances' per-frame finish, record ->
// tables: kernel K's record (and, for learned, kernel L's 64^3 histogram)
// in, [B, 3, 256] u8 tables out (channel c's value v becomes table[c][v]),
// with PCA's [B, 3] NaN flags and learned's [B, 4, 2] f32 features; equal
// to ops/white_balance.wb_tables_plain and ops/learned_wb.features_plain:
//
//   simple      each channel's two walks of the cumulative counts, as f32,
//               against the f32 target (p * n) / 100, alpha = f32(255 /
//               span) and beta = f32(-p1 * (255 / span)) in f64 (the
//               host's tables ops/white_balance._SIMPLE_ALPHA32, _BETA32,
//               computed as they are) and cvRound(fma(v, alpha, beta)) with
//               one rounding;
//   grey_world  rint(f32(smin) / f32(s) * 256), 0 for a zero sum, as
//               (v * gain) >> 8 saturated;
//   pca         Eigen's 2x2 inverse op for op in f32, then the exact table
//               cvRound(min(rn_f32(x0 * c^2 + x1 * c), 255)) by TwoSum in
//               f64, round to odd and narrowing (ops/white_balance
//               .pca_exact_lut); a NaN coefficient sets the channel's flag;
//   learned     the features f0-f3 (learned_wb.features_plain: f0 in f64,
//               f1 from K's brightest pixel, f2 the first maximal bin, f3
//               the mode of the top-300 palette's Epanechnikov density
//               summed in the recorded order), the 160 trees, the
//               consensus, the upper median and the 8.8 gains.
//
// Replaces: the JAX package leaves these to XLA, with no Pallas kernel:
// raw_image_pipeline_tpu/ops/white_balance.py `balance_white_simple`
// (line 75), `balance_white_grey_world` (109) and `_pca_exact_lut` (355)
// after their sums, ops/learned_wb.py `_predict_illuminant` (114) and
// `balance_white_learned_model` (364) after the histogram. The port's plain
// versions run them as dozens of small eager launches a method (about 300
// for learned, with a torch.topk over the 64^3 keys).
//
// What bounds it on the H100: latency. A frame's work is a few thousand
// operations, but for learned, 1 MB of counts a frame read in a few
// dependent passes (the first maximal bin and the occupied count, the
// radix select of the 300th count, the ordered collection), then the
// palette's density, 300 x 300 f32 divisions. Simple, grey-world and PCA
// read a few hundred bytes a frame: their time is a launch and a chain of
// dependent reads (kernel K's record, then, in the first form, simple's
// alpha and beta from a [256, 257] table at the walk's result), and the
// table step of kernel G that follows them waits for their end.
//
// Design: simple, grey-world and PCA a block a frame (small_threads: a
// warp a channel for simple, 256 threads for grey-world, 512 for PCA's
// tables), a plain launch. Simple computes alpha and beta from its walk in
// two f64 operations, with no table read. Timed as variants
// (tools/wb_variants.py, PERF.md): launched as programmatic dependents of
// K (and G's table step of M), they took about 1 us less device time a
// call, but cudaLaunchKernelEx costs the host more than <<<>>> and the
// wb_* chains' frames/s fell, so they launch plainly; the table read cost
// 0.1 us.
// Every f32 and f64 chain is written in __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn (and
// their f64 forms), so nvcc contracts nothing into an fma; counts narrow
// with __ll2float_rn and __ll2double_rn, as the plain version's casts do.
// Learned: a thread-block cluster a frame (grid (cluster, B); the size from
// the batch and the card, ops/white_balance.wb_tables_cluster), block r
// walking the r-th contiguous 1/cluster of the counts in every pass, four
// int4 loads in flight a thread. The blocks meet through distributed
// shared memory: a value every block needs from the others (the first
// maximal key and the occupied count, a share's sum, the bins above and at
// T before a block) is read by warp 0's lanes at once, a lane a block.
// The palette is the counts above T, the 300th largest count (found by a
// radix select of 11-bit digits over the occupied bins, skipping the
// digits above the largest count: each block counts its bins' digits,
// block r sums the cluster's counts of the r-th share of the 2048 digits,
// every block finds the share and the digit; pass 1 counts the first digit
// where the largest count has 12-21 bits), and then the first bins of
// count T in bin order up to 300 (ranked by the counts at T of the blocks
// before, then by block-wide prefix sums over each round of the walk, one
// barrier for four rounds), so the palette does not depend on the
// cluster's size; below 300 occupied bins, all of them. Every block writes
// its entries into rank 0's shared memory, reads the palette back, sorts
// it by (count desc, bin asc) by rank counting, and sums the density of
// the rows rank, rank + cluster, ...: the sum, in order, of ten windows of
// 32 of its padded row (10 zeros at each end), each window summed in order
// (a thread a window), as the plain version sums; meanwhile a spare thread
// of rank 0 computes f0-f2. Rank 0 takes the first maximal density and
// finishes f3, the trees and the tables. The semantics of the ties (f1's
// rank, f2's first maximum, f3's order) are the library's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;  // learned's threads a block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;  // learned's blocks a frame (above 8 a non-portable size)
constexpr int LOADS = 4;         // int4 loads a thread issues at once in learned's passes
enum Mode { kSimple = 0, kGreyWorld = 1, kPca = 2, kLearned = 3 };
// simple's, grey-world's and PCA's threads a block: a warp a channel for
// simple's walks, 256 for grey-world's gains table, a thread a table
// entry for PCA's f64 tail, THREADS (the fastest of 96 / 256 / 512 timed)
constexpr int SIMPLE_THREADS = 96;
constexpr int GREY_THREADS = 256;
__host__ __device__ constexpr int small_threads(int mode) {
  return mode == kSimple ? SIMPLE_THREADS : mode == kGreyWorld ? GREY_THREADS : THREADS;
}

// ops/learned_wb's constants
constexpr int HIST64 = 64 * 64 * 64;
constexpr int PALETTE = 300;
constexpr int SUM_WIN = 32, SUM_PAD = 10, WINDOWS = (PALETTE + 2 * SUM_PAD) / SUM_WIN;
constexpr float EPS = 0x1.4f8b58p-17f;  // f32(1e-5)
constexpr float BW2 = 0x1.47ae14p-7f;   // f32(0.1 ** 2)
constexpr float PRED_THRESH = 0.025f;
constexpr float ILLUM_MIN = 0x1.0c6f7ap-20f;  // f32(1e-6)
constexpr int TREES = 160, NODES = 15, LEAVES = 16, DEPTH = 4, SETS = 20;
constexpr int KEPT = 0, SUM_B = 1, HI = 4, KEY = 5, PIXEL = 6, RECORD = 7;
constexpr int DIGIT_BITS = 11, DIGITS = 1 << DIGIT_BITS;
// pass 1 also counts the digit [10, 21) of every count below 2^21: the radix
// select's first digit wherever the largest count has 12 to 21 bits (a
// 1080p frame's counts stay below 2^21), which saves it a walk
constexpr int FIRST_HI = 21, FIRST_SHIFT = FIRST_HI - DIGIT_BITS;
static_assert(WINDOWS * SUM_WIN == PALETTE + 2 * SUM_PAD, "whole windows");
static_assert(HIST64 / MAX_CLUSTER % (4 * LOADS * THREADS) == 0, "whole walks a block");
static_assert(DIGITS / MAX_CLUSTER % 32 == 0, "whole lanes a share of the digits");

struct Params {
  const void* record;
  const int* hist;
  long long npix;
  float target;
  const int* fi;       // learned: the trees' feature index [160, 15]
  const float* tv;     // thresholds [160, 15]
  const float* lv;     // leaves [160, 16]
  uint8_t* tables;     // [B, 3, 256]
  uint8_t* nan;        // pca: [B, 3]
  float* features;     // learned: [B, 4, 2], or null
};

__device__ __forceinline__ uint8_t round_u8(float x) {  // cvRound, saturated
  return (uint8_t)fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

// (v * gain) >> 8 saturated; thread t of `threads` writes entries t,
// t + threads, ... (entry i: channel i / 256's v = i % 256)
__device__ __forceinline__ void gains_table(uint8_t* tab, const int (&gain)[3], int t,
                                            int threads) {
  for (int i = t; i < 768; i += threads) {
    const int v = i & 255;
    tab[i] = (uint8_t)min(max((v * gain[i >> 8]) >> 8, 0), 255);
  }
}

// --- simple -------------------------------------------------------------------

__device__ void simple_tables(const Params& p, int f, int t) {
  const int lane = t & 31, c = t >> 5;
  if (c >= 3) return;
  const int* counts = reinterpret_cast<const int*>(p.record) + (long long)f * 768 + c * 256;
  long long v[8], s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = counts[8 * lane + j], s += v[j];
  long long incl = s;  // the lanes' inclusive prefix of their 8 bins' sums
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += u;
  }
  const long long total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  long long cum = incl - s;  // the bins before this lane's
  int below = 0, below_top = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // the walk from the bottom: cum through bin k; from the top: the bins k..255
    const long long top = total - cum;
    cum += v[j];
    below += __ll2float_rn(cum) < p.target;
    below_top += __ll2float_rn(top) < p.target;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    below += __shfl_xor_sync(0xFFFFFFFFu, below, o);
    below_top += __shfl_xor_sync(0xFFFFFFFFu, below_top, o);
  }
  const int p1 = min(max(below, 0), 255), p2 = min(max(255 - below_top, 0), 255);
  const int span = max(p2 + 1 - p1, 1);
  const double alpha64 = __ddiv_rn(255.0, (double)span);
  const float alpha = __double2float_rn(alpha64);
  const float beta = __double2float_rn(__dmul_rn(-(double)p1, alpha64));
  uint8_t* tab = p.tables + (long long)f * 768 + c * 256;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int x = 8 * lane + j;
    tab[x] = round_u8(__fmaf_rn((float)x, alpha, beta));
  }
}

// --- grey_world ---------------------------------------------------------------

__device__ void grey_world_tables(const Params& p, int f, int t) {
  const long long* sums = reinterpret_cast<const long long*>(p.record) + (long long)f * 3;
  long long smin = LLONG_MAX;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (sums[c] > 0) smin = min(smin, sums[c]);
  }
  int gain[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gain[c] = sums[c] > 0 ? (int)rintf(__fmul_rn(__fdiv_rn(__ll2float_rn(smin),
                                                           __ll2float_rn(sums[c])), 256.0f))
                          : 0;
  }
  gains_table(p.tables + (long long)f * 768, gain, t, small_threads(kGreyWorld));
}

// --- pca ----------------------------------------------------------------------

__device__ void pca_tables(const Params& p, int f, int t) {
  __shared__ float coef[2][2];  // (x0, x1) of b and of r
  __shared__ bool bad[2];       // their NaN flags
  const long long* st = reinterpret_cast<const long long*>(p.record) + (long long)f * 9;
  uint8_t* tab = p.tables + (long long)f * 768;
  if (t < 2) {  // Eigen compute_inverse_size2, op for op
    const int c = 2 * t;  // b, r
    const float sg = __ll2float_rn(st[3]), mg = __ll2float_rn(st[5]);
    const float s = __ll2float_rn(st[3 * c]), s2 = __ll2float_rn(st[3 * c + 1]);
    const float m = __ll2float_rn(st[3 * c + 2]);
    const float m2 = __fmul_rn(m, m);
    const float det = __fsub_rn(__fmul_rn(s2, m), __fmul_rn(s, m2));
    const float invdet = __fdiv_rn(1.0f, det);
    const float i00 = __fmul_rn(m, invdet), i01 = -__fmul_rn(s, invdet);
    const float i10 = -__fmul_rn(m2, invdet), i11 = __fmul_rn(s2, invdet);
    const float x0 = __fadd_rn(__fmul_rn(i00, sg), __fmul_rn(i01, mg));
    const float x1 = __fadd_rn(__fmul_rn(i10, sg), __fmul_rn(i11, mg));
    coef[t][0] = x0, coef[t][1] = x1;
    bad[t] = isnan(x0) || isnan(x1);
    p.nan[f * 3 + c] = bad[t] ? 1 : 0;
  }
  if (t == 2) p.nan[f * 3 + 1] = 0;
  __syncthreads();
  if (t < 512) {
    const int k = t >> 8, v = t & 255;  // k: b (0) or r (1)
    const double x0 = coef[k][0], x1 = coef[k][1];
    const double a = __dmul_rn(x0, (double)(v * v)), b = __dmul_rn(x1, (double)v);
    const double s = __dadd_rn(a, b);
    const double bb = __dsub_rn(s, a);
    const double e = __dadd_rn(__dsub_rn(a, __dsub_rn(s, bb)), __dsub_rn(b, bb));
    long long bits = __double_as_longlong(s);
    const long long toward = ((e > 0) == (s > 0)) ? 1 : -1;  // +1 grows |s|
    if (e != 0 && (bits & 1) == 0) bits += toward;           // round to odd
    const float val = __double2float_rn(__longlong_as_double(bits));
    // a NaN channel has no table (G writes its pattern): zeros
    tab[(2 * k) * 256 + v] = bad[k] ? 0 : round_u8(val < 255.0f ? val : 255.0f);
  }
  if (t < 256) tab[256 + t] = (uint8_t)t;  // g passes through
}

// --- learned ------------------------------------------------------------------

__device__ __forceinline__ void chroma(float r, float g, float b, float* out) {
  const float s = __fadd_rn(__fadd_rn(__fadd_rn(r, g), b), EPS);
  out[0] = __fdiv_rn(r, s), out[1] = __fdiv_rn(g, s);
}

// a bin's (b, g, r) indices
__device__ __forceinline__ void bin_channels(int bin, float& b, float& g, float& r) {
  b = (float)(bin >> 12), g = (float)((bin >> 6) & 63), r = (float)(bin & 63);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xFFFFFFFFu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

struct LearnedShared {
  unsigned long long red[WARPS];
  unsigned cnt[WARPS];
  unsigned digit[DIGITS];   // this block's digit counts
  unsigned merged[DIGITS];  // its share of the cluster's: DIGITS / cluster digits
  unsigned wsum[2][LOADS][WARPS];  // the collection's warp sums of a round, by batch parity
  int pal_bin[PALETTE];     // rank 0: the palette, written by every block
  unsigned pal_cnt[PALETTE];
  unsigned long long pal_key[PALETTE];  // every block: the palette's keys
  int sorted_bin[PALETTE];
  float pu[PALETTE], pv[PALETTE];
  float part[PALETTE][WINDOWS];  // this block's density rows
  unsigned long long best[MAX_CLUSTER];  // rank 0: each block's first maximal density
  float feat[8];
  float pred[TREES];
  int cons[SETS];
  float med[2];
  // read by the cluster's other blocks: this block's first maximal key and
  // occupied bins, its share's sum, its bins above T and at T
  unsigned long long top_part;
  unsigned nnz_part, share_total, gt_part, eq_part;
  // the radix select's state, the same in every block of the cluster
  unsigned prefix, need, n_gt, hi_shift, shift, n_pal;
  bool counted;  // pass 1 counted the select's first digit
  unsigned long long top;  // the first maximal bin's key
  unsigned nnz;
  // this block's: bins above the prefix so far, the entries above T it has
  // written, and the bins above T and at T in the blocks before it
  unsigned above, gt_local, gt_before, eq_before;
};

// f(i, q) for each int4 q = h4[i], i in [0, n4) (a multiple of LOADS *
// THREADS), in rounds of THREADS consecutive int4 in order, LOADS rounds'
// loads issued before their calls; every thread calls f equally often
template <typename F>
__device__ __forceinline__ void walk(const int4* h4, int n4, int t, F&& f) {
  for (int i0 = t; i0 < n4; i0 += LOADS * THREADS) {
    int4 q[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) q[u] = __ldg(h4 + i0 + u * THREADS);
#pragma unroll
    for (int u = 0; u < LOADS; ++u) f(i0 + u * THREADS, q[u]);
  }
}

// learned's features, trees and tables for frame f, by a cluster of
// `csize` blocks: block `rank` walks the bins [rank, rank + 1) * HIST64 /
// csize and takes the palette's density rows rank, rank + csize, ...;
// rank 0 finishes. A value every block needs from the others is read by
// warp 0's lanes at once, a lane a block.
__device__ void learned_tables(const Params& p, int f, int t, LearnedShared& s) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int lane = t & 31, warp = t >> 5;
  const long long* rec = reinterpret_cast<const long long*>(p.record) + (long long)f * RECORD;
  const int span = HIST64 / csize, base = rank * span, n4 = span / 4;
  const int4* h4 = reinterpret_cast<const int4*>(p.hist + (long long)f * HIST64 + base);

  // pass 1: the first maximal bin (key count << 18 | (2^18 - 1 - bin)) and
  // the occupied bins, the block's then the cluster's, and the digit
  // [FIRST_SHIFT, FIRST_HI) of the counts below 2^FIRST_HI
  for (int i = t; i < DIGITS; i += THREADS) s.digit[i] = 0u;
  __syncthreads();
  unsigned long long top = 0;
  unsigned nnz = 0;
  walk(h4, n4, t, [&](int i, const int4& q) {
    const int c4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned long long key =
          ((unsigned long long)(unsigned)c4[j] << 18) | (unsigned)(HIST64 - 1 - (base + 4 * i + j));
      top = key > top ? key : top;
      nnz += c4[j] > 0;
      if (c4[j] > 0 && c4[j] < (1 << FIRST_HI)) {
        atomicAdd(s.digit + (c4[j] >> FIRST_SHIFT), 1u);
      }
    }
  });
  top = warp_max(top);
  nnz = warp_sum(nnz);
  if (lane == 0) s.red[warp] = top, s.cnt[warp] = nnz;
  __syncthreads();
  if (t == 0) {
    unsigned long long m = 0;
    unsigned n = 0;
    for (int w = 0; w < WARPS; ++w) m = s.red[w] > m ? s.red[w] : m, n += s.cnt[w];
    s.top_part = m, s.nnz_part = n, s.above = 0, s.gt_local = 0;
  }
  cluster.sync();
  if (warp == 0) {
    unsigned long long m = 0;
    unsigned n = 0;
    if (lane < csize) {
      m = *cluster.map_shared_rank(&s.top_part, lane);
      n = *cluster.map_shared_rank(&s.nnz_part, lane);
    }
    m = warp_max(m);
    n = warp_sum(n);
    if (lane == 0) {
      s.top = m, s.nnz = n;
      const unsigned maxc = (unsigned)(m >> 18);
      // the palette: counts above T, then the first `need` bins of count T
      s.prefix = 0, s.need = n > PALETTE ? PALETTE : 0, s.n_gt = n;
      s.n_pal = n < PALETTE ? n : PALETTE;
      const int bits = maxc ? 32 - __clz(maxc) : 0;
      s.counted = bits > DIGIT_BITS && bits <= FIRST_HI;
      s.hi_shift = s.counted ? FIRST_HI : bits;
      s.shift = s.counted ? FIRST_SHIFT : bits > DIGIT_BITS ? bits - DIGIT_BITS : 0;
    }
  }
  __syncthreads();

  // the radix select of T, the PALETTE-th largest count, over the occupied
  // bins: each pass fixes the digit [shift, hi_shift) of T. A block counts
  // its bins' digits; block r sums the cluster's counts of the r-th share
  // of the digits; every block then finds the share and the digit itself.
  if (s.nnz > PALETTE) {
    const int share = DIGITS / csize, per = share / 32;
    bool counted = s.counted;  // the first digit's counts, from pass 1
    while (true) {
      const unsigned hs = s.hi_shift, sh = s.shift, prefix = s.prefix;
      const unsigned width = hs - sh, mask = (1u << width) - 1u;
      if (!counted) {
        for (int i = t; i < DIGITS; i += THREADS) s.digit[i] = 0u;
        __syncthreads();
        walk(h4, n4, t, [&](int, const int4& q) {
          const int c4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const unsigned cnt = (unsigned)c4[j];
            if (cnt && (unsigned)((unsigned long long)cnt >> hs) == prefix) {
              atomicAdd(s.digit + ((cnt >> sh) & mask), 1u);
            }
          }
        });
      }
      counted = false;
      cluster.sync();  // every block's digit counts are in; every share read
      for (int i = t; i < share; i += THREADS) s.merged[i] = 0u;
      __syncthreads();
      // the share's counts: the cluster's DIGITS (digit, block) pairs of it,
      // DIGITS / THREADS a thread, their loads issued together
      unsigned v[DIGITS / THREADS], own = 0;
#pragma unroll
      for (int j = 0; j < DIGITS / THREADS; ++j) {
        const int pair = t + j * THREADS;
        v[j] = *cluster.map_shared_rank(&s.digit[rank * share + pair % share], pair / share);
      }
#pragma unroll
      for (int j = 0; j < DIGITS / THREADS; ++j) {
        if (v[j]) atomicAdd(&s.merged[(t + j * THREADS) % share], v[j]);
        own += v[j];
      }
      own = warp_sum(own);
      if (lane == 0) s.cnt[warp] = own;
      __syncthreads();
      if (t == 0) {
        unsigned total = 0;
        for (int w = 0; w < WARPS; ++w) total += s.cnt[w];
        s.share_total = total;
      }
      cluster.sync();  // every share is summed
      if (warp == 0) {
        const unsigned need = s.need;
        // the highest share z whose suffix of sums reaches need
        const unsigned e = lane < csize ? *cluster.map_shared_rank(&s.share_total, lane) : 0u;
        unsigned suffix = e;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned u = __shfl_down_sync(0xFFFFFFFFu, suffix, o);
          if (lane + o < 32) suffix += u;
        }
        const int z = 31 - __clz(__ballot_sync(0xFFFFFFFFu, suffix >= need));
        const unsigned share_need = need - __shfl_sync(0xFFFFFFFFu, suffix - e, z);
        // in it, the largest digit d with (counts of digit >= d) >= share_need
        const unsigned* m = cluster.map_shared_rank(&s.merged[0], z);
        unsigned mine = 0;
        for (int j = 0; j < per; ++j) mine += m[lane * per + j];
        unsigned above = mine;  // this lane's and the higher lanes' counts
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned u = __shfl_down_sync(0xFFFFFFFFu, above, o);
          if (lane + o < 32) above += u;
        }
        const int at = 31 - __clz(__ballot_sync(0xFFFFFFFFu, above >= share_need));
        if (lane == at) {
          above -= mine;
          int d = lane * per;
          for (int j = per - 1; j >= 0; --j) {
            const unsigned c = m[lane * per + j];
            if (above + c >= share_need) {
              d = lane * per + j;
              break;
            }
            above += c;
          }
          s.prefix = (prefix << width) | ((unsigned)(z * share) + (unsigned)d);
          s.need = share_need - above;
        }
      }
      __syncthreads();
      // this block's bins above the prefix: its digits above d
      const unsigned d = s.prefix & mask;
      unsigned mine = 0;
      for (int i = t; i < DIGITS; i += THREADS) mine += (unsigned)i > d ? s.digit[i] : 0u;
      mine = warp_sum(mine);
      if (lane == 0) s.cnt[warp] = mine;
      __syncthreads();
      if (t == 0) {
        for (int w = 0; w < WARPS; ++w) s.above += s.cnt[w];
        if (sh == 0) {
          s.eq_part = s.digit[d];
        } else {
          s.hi_shift = sh, s.shift = sh > DIGIT_BITS ? sh - DIGIT_BITS : 0;
        }
      }
      __syncthreads();
      if (sh == 0) break;
    }
    if (t == 0) s.n_gt = PALETTE - s.need, s.gt_part = s.above;
  } else if (t == 0) {  // T = 0: every occupied bin
    s.gt_part = s.nnz_part, s.eq_part = 0;
  }
  cluster.sync();  // every block's bins above T and at T are in
  if (warp == 0) {
    unsigned gt = 0, eq = 0;
    if (lane < rank) {
      gt = *cluster.map_shared_rank(&s.gt_part, lane);
      eq = *cluster.map_shared_rank(&s.eq_part, lane);
    }
    gt = warp_sum(gt);
    eq = warp_sum(eq);
    if (lane == 0) s.gt_before = gt, s.eq_before = eq;
  }
  __syncthreads();
  const unsigned T = s.prefix, need = s.need, n_gt = s.n_gt, gt_before = s.gt_before;

  // the ordered collection into rank 0's palette: counts above T at
  // gt_before on, in any order (sorted below); the first `need` bins of
  // count T in bin order at n_gt on, ranked by the blocks before this one,
  // then by block-wide prefix sums over each round of THREADS int4 (one
  // barrier for LOADS rounds)
  int* pal_bin = cluster.map_shared_rank(&s.pal_bin[0], 0);
  unsigned* pal_cnt = cluster.map_shared_rank(&s.pal_cnt[0], 0);
  unsigned eq_base = s.eq_before;  // the bins of count T before this batch of rounds
  for (int i0 = t, parity = 0; i0 < n4; i0 += LOADS * THREADS, parity ^= 1) {
    int4 q[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) q[u] = __ldg(h4 + i0 + u * THREADS);
    unsigned eq[LOADS], incl[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int c4[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
      eq[u] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned cnt = (unsigned)c4[j];
        if (cnt > T) {
          const unsigned at = gt_before + atomicAdd(&s.gt_local, 1u);
          pal_bin[at] = base + 4 * (i0 + u * THREADS) + j, pal_cnt[at] = cnt;
        }
        eq[u] += need && cnt == T;
      }
    }
    if (!need) continue;
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {  // the lanes' inclusive prefix, in bin order
      incl[u] = eq[u];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(0xFFFFFFFFu, incl[u], o);
        if (lane >= o) incl[u] += v;
      }
      if (lane == 31) s.wsum[parity][u][warp] = incl[u];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      unsigned before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const unsigned v = s.wsum[parity][u][w];
        before += w < warp ? v : 0u;
        total += v;
      }
      unsigned r = eq_base + before + incl[u] - eq[u];
      const int c4[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((unsigned)c4[j] == T) {
          if (r < need) {
            pal_bin[n_gt + r] = base + 4 * (i0 + u * THREADS) + j, pal_cnt[n_gt + r] = T;
          }
          ++r;
        }
      }
      eq_base += total;
    }
  }
  cluster.sync();  // the palette is whole in rank 0's shared memory

  // every block: the palette by (count desc, bin asc), rank counting over
  // unique keys read from rank 0
  const int n = (int)s.n_pal;
  if (t < n) {
    s.pal_key[t] = ((unsigned long long)pal_cnt[t] << 18) | (unsigned)(HIST64 - 1 - pal_bin[t]);
  }
  __syncthreads();
  if (t < n) {
    const unsigned long long key = s.pal_key[t];
    int r = 0;
    for (int j = 0; j < n; ++j) r += s.pal_key[j] > key;
    s.sorted_bin[r] = HIST64 - 1 - (int)(key & (HIST64 - 1));
  }
  __syncthreads();
  if (t < n) {
    float pb, pg, pr;
    bin_channels(s.sorted_bin[t], pb, pg, pr);
    const float ps = __fadd_rn(__fadd_rn(__fadd_rn(pb, pg), pr), EPS);
    s.pu[t] = __fdiv_rn(pr, ps), s.pv[t] = __fdiv_rn(pg, ps);
  }
  __syncthreads();
  if (rank == 0 && t == THREADS - 1) {  // f0-f2, beside the density rows (a thread past them)
    float* ft = s.feat;
    // f0: the kept pixels' means in f64, over the largest mean
    const long long kept = rec[KEPT] > 1 ? rec[KEPT] : 1;
    double means[3], mm;
    for (int c = 0; c < 3; ++c) {
      means[c] = __ddiv_rn(__ll2double_rn(rec[SUM_B + c]), __ll2double_rn(kept));
    }
    mm = fmax(fmax(means[0], means[1]), means[2]);
    if (mm <= 0) mm = 1.0;
    chroma(__double2float_rn(__ddiv_rn(means[2], mm)), __double2float_rn(__ddiv_rn(means[1], mm)),
           __double2float_rn(__ddiv_rn(means[0], mm)), ft);
    // f1: the brightest kept pixel (K's record; 0 where none)
    const long long px = rec[PIXEL];
    chroma((float)((px >> 16) & 255), (float)((px >> 8) & 255), (float)(px & 255), ft + 2);
    // f2: the first maximal bin
    float db, dg, dr;
    bin_channels(HIST64 - 1 - (int)(s.top & (HIST64 - 1)), db, dg, dr);
    chroma(dr, dg, db, ft + 4);
  }
  // this block's density rows i = rank + csize * r: window k of row i sums
  // padded columns [32k, 32k + 32) in order (column j of the palette at
  // padded j + 10; padding and entries past n are zeros)
  const int rows = n > rank ? (n - rank + csize - 1) / csize : 0;
  for (int task = t; task < rows * WINDOWS; task += THREADS) {
    const int r = task / WINDOWS, k = task - r * WINDOWS, i = rank + csize * r;
    const float ui = s.pu[i], vi = s.pv[i];
    float acc = 0.0f;
    for (int q = 0; q < SUM_WIN; ++q) {
      const int j = k * SUM_WIN + q - SUM_PAD;
      if (j < 0 || j >= n) continue;  // + 0.0f: the sum is unchanged
      const float du = __fsub_rn(ui, s.pu[j]), dv = __fsub_rn(vi, s.pv[j]);
      const float d2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
      acc = __fadd_rn(acc, fmaxf(__fsub_rn(1.0f, __fdiv_rn(d2, BW2)), 0.0f));
    }
    s.part[r][k] = acc;
  }
  __syncthreads();
  // the first maximal density (densities are >= +0, so their bits order
  // them), this block's into rank 0's shared memory
  unsigned long long best = 0;
  for (int r = t; r < rows; r += THREADS) {
    float d = 0.0f;
#pragma unroll
    for (int k = 0; k < WINDOWS; ++k) d = __fadd_rn(d, s.part[r][k]);
    const unsigned long long key = ((unsigned long long)__float_as_uint(d) << 32) |
                                   (0xFFFFFFFFu - (unsigned)(rank + csize * r));
    best = key > best ? key : best;
  }
  best = warp_max(best);
  if (lane == 0) s.red[warp] = best;
  __syncthreads();
  if (t == 0) {
    unsigned long long m = 0;
    for (int w = 0; w < WARPS; ++w) m = s.red[w] > m ? s.red[w] : m;
    *cluster.map_shared_rank(&s.best[rank], 0) = m;
  }
  cluster.sync();  // every block's density is in rank 0's shared memory
  if (rank != 0) return;

  if (t == 0) {
    unsigned long long m = 0;
    for (int k = 0; k < csize; ++k) m = s.best[k] > m ? s.best[k] : m;
    float* ft = s.feat;
    // f3: the palette's mode ((0, 0) where no pixel is kept)
    const int mi = 0xFFFFFFFFu - (unsigned)(m & 0xFFFFFFFFull);
    ft[6] = n ? s.pu[mi] : 0.0f, ft[7] = n ? s.pv[mi] : 0.0f;
    if (p.features) {
      for (int j = 0; j < 8; ++j) p.features[f * 8 + j] = ft[j];
    }
  }
  __syncthreads();

  // the trees: tree t = set * 8 + feature * 2 + component
  if (t < TREES) {
    const int fe = (t % 8) / 2;
    const float x0 = s.feat[2 * fe], x1 = s.feat[2 * fe + 1];
    int node = 0;
    for (int d = 0; d < DEPTH; ++d) {
      const float val = __ldg(p.fi + t * NODES + node) == 0 ? x0 : x1;
      node = val <= __ldg(p.tv + t * NODES + node) ? 2 * node + 1 : 2 * node + 2;
    }
    s.pred[t] = __ldg(p.lv + t * LEAVES + node - NODES);
  }
  __syncthreads();
  // a set agrees when more than 2 of its 6 distances are below the threshold
  if (t < SETS) {
    const float* q = s.pred + 8 * t;  // q[2i + k]: prediction i, component k
    int agree = 0;
    for (int i = 0; i < 4; ++i) {
      for (int j = i + 1; j < 4; ++j) {
        const float dx = __fsub_rn(q[2 * i], q[2 * j]), dy = __fsub_rn(q[2 * i + 1], q[2 * j + 1]);
        agree += __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))) < PRED_THRESH;
      }
    }
    s.cons[t] = agree > 2;
  }
  __syncthreads();
  // the upper median a component over the agreeing sets' predictions (all
  // 80 where none agrees): the value of rank count / 2
  if (t < TREES) {
    int sets = 0;
    for (int q = 0; q < SETS; ++q) sets += s.cons[q];
    const bool all = sets == 0;
    const int count = all ? 80 : 4 * sets, k = t & 1;
    if (all || s.cons[t >> 3]) {
      const float v = s.pred[t];
      int rank = 0;
      for (int u = k; u < TREES; u += 2) {
        if (!(all || s.cons[u >> 3])) continue;
        const float w = s.pred[u];
        rank += w < v || (w == v && u < t);
      }
      if (rank == count / 2) s.med[k] = v;
    }
  }
  __syncthreads();
  // the gains: min(illum) / illum, illum = ((1 - u) - v, v, u) from 1e-6
  const float u = s.med[0], v = s.med[1];
  float illum[3] = {__fsub_rn(__fsub_rn(1.0f, u), v), v, u};
  for (int c = 0; c < 3; ++c) illum[c] = fmaxf(illum[c], ILLUM_MIN);
  const float lo = fminf(fminf(illum[0], illum[1]), illum[2]);
  int gain[3];
  for (int c = 0; c < 3; ++c) gain[c] = (int)rintf(__fmul_rn(__fdiv_rn(lo, illum[c]), 256.0f));
  gains_table(p.tables + (long long)f * 768, gain, t, THREADS);
}

// simple, grey-world and PCA: a block of small_threads(MODE) a frame
template <int MODE>
__global__ void __launch_bounds__(small_threads(MODE)) wb_tables_kernel(const Params p) {
  const int f = blockIdx.x, t = threadIdx.x;
  if constexpr (MODE == kSimple) {
    simple_tables(p, f, t);
  } else if constexpr (MODE == kGreyWorld) {
    grey_world_tables(p, f, t);
  } else {
    pca_tables(p, f, t);
  }
}

// learned: grid (cluster, B), a thread-block cluster a frame
__global__ void __launch_bounds__(THREADS) wb_learned_kernel(const Params p) {
  __shared__ LearnedShared s;
  learned_tables(p, blockIdx.y, threadIdx.x, s);
}

// the learned kernel's clusters above 8 blocks, allowed once per device
cudaError_t configure_learned() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(wb_learned_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// simple's, grey-world's or PCA's kernel (or, empty, the floor's) on
// `batch` blocks of `threads`: one launch form for the modes and their floor
template <class... Args>
cudaError_t launch_small(void (*kernel)(Args...), int threads, int batch, cudaStream_t stream,
                         Args... args) {
  kernel<<<batch, threads, 0, stream>>>(args...);
  return cudaSuccess;
}

// an empty block of simple's, grey-world's or PCA's threads
__global__ void __launch_bounds__(THREADS) wb_tables_empty_kernel() {}

cudaLaunchConfig_t learned_config(int cluster, int batch, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// mode: 0 simple, 1 grey_world, 2 pca, 3 learned (ops/white_balance.METHODS);
// record: kernel K's [batch, ...] record; hist: learned's [batch, 64^3]
// int32 histogram (kernel L's), 16-byte aligned; npix: a frame's pixels;
// target: simple's f32 walk target; fi, tv, lv: learned's model on the card (int32 [2400], f32 [2400],
// f32 [2560]); tables: [batch, 3, 256] u8 out; nan: pca's [batch, 3] u8
// out; features: learned's [batch, 4, 2] f32 out, or null; cluster:
// learned's blocks a frame (1, 2, 4, 8 or 16; ops/white_balance
// .wb_tables_cluster), ignored by the other modes. Launches on `stream` and
// returns the launch's error.
extern "C" int isp_wb_tables(int mode, const void* record, const void* hist, int batch,
                             long long npix, float target, const void* fi, const void* tv,
                             const void* lv, void* tables, void* nan, void* features, int cluster,
                             void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (!record || !tables || (mode == kPca && !nan) ||
      (mode == kLearned && (!hist || (uintptr_t)hist % 16 || !fi || !tv || !lv || cluster < 1 ||
                            cluster > MAX_CLUSTER || (cluster & (cluster - 1)) ||
                            batch > 65535))) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.record = record, p.hist = (const int*)hist, p.npix = npix, p.target = target;
  p.fi = (const int*)fi, p.tv = (const float*)tv, p.lv = (const float*)lv;
  p.tables = (uint8_t*)tables, p.nan = (uint8_t*)nan, p.features = (float*)features;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  switch (mode) {
    case kSimple:
      err = launch_small(wb_tables_kernel<kSimple>, small_threads(kSimple), batch, s, p);
      break;
    case kGreyWorld:
      err = launch_small(wb_tables_kernel<kGreyWorld>, small_threads(kGreyWorld), batch, s, p);
      break;
    case kPca: err = launch_small(wb_tables_kernel<kPca>, small_threads(kPca), batch, s, p); break;
    case kLearned: {
      err = configure_learned();
      if (err != cudaSuccess) return (int)err;
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg = learned_config(cluster, batch, s, attr);
      err = cudaLaunchKernelEx(&cfg, wb_learned_kernel, p);
      break;
    }
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `batch` empty blocks of mode's (0 simple, 1 grey_world, 2 pca) threads,
// launched as isp_wb_tables launches that mode: their device time is the
// latency floor of kernel M's small modes (tools/wb_variants.py,
// chip_smoke.py).
// It is not kernel M and no launch of it. Returns the launch's error.
extern "C" int isp_wb_tables_empty(int mode, int batch, void* stream) {
  if (mode < kSimple || mode > kPca || batch <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_small(wb_tables_empty_kernel, small_threads(mode), batch,
                                       (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The current device's largest cluster size (16, 8, ... 1) of the learned
// kernel of which one cluster can be resident, in *largest. Returns the
// error.
extern "C" int isp_wb_tables_limits(int* largest) {
  cudaError_t err = configure_learned();
  for (int c = MAX_CLUSTER; err == cudaSuccess && c > 1; c /= 2) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = learned_config(c, 1, 0, attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, wb_learned_kernel, &cfg);
    if (err == cudaSuccess && clusters > 0) {
      *largest = c;
      return (int)cudaSuccess;
    }
  }
  *largest = 1;
  return (int)err;
}
