// Kernel G: the chain's pointwise stretch in one pass over the planes, equal
// byte for byte to ops/pointwise.pointwise_plain, the composition of the
// stage functions it replaces, each step optional and in the chain's order:
//
//   -. a per-frame table a channel: [B, 3, 256] u8, v -> table[f, c, v],
//      the statistical white balances' last step (ops/white_balance
//      .apply_tables_plain), with PCA's NaN channels, which become 255
//      before a flat position of the frame and 0 from it;
//   0. the CCC gains: cv::multiply by per-frame [B, 3] gains, one f32
//      product, round half to even, saturate (ops/ccc.apply_gains_planes);
//   1. colour calibration: rn(rn(rn(b*m0) + rn(g*m1)) + rn(r*m2)), then
//      + bias, round, saturate (ops/color_calibration.color_correct_planes);
//   2. a u8 LUT (the BT.709 table, or the k table without vignetting);
//   3. vignetting: BGR2Lab through a linearize table passed in (the gamma
//      table composed in, or OpenCV's own), L = round_u8(f32(L) * mask[y, x]),
//      Lab2BGR (ops/vignetting.correct_planes, ops/colorspace);
//   4. the HSV enhancer: BGR2HSV, three u8 gain tables, HSV2BGR with cv2's
//      SIMD row kernel (final *255 floored) before column W - W % 32 and its
//      scalar kernel (rounded) from there (ops/color_enhancer.enhance_planes).
//
// Replaces: the JAX package leaves this stage to XLA, with no Pallas kernel:
// raw_image_pipeline_tpu/ops/ccc.py `apply_gains_planes` (line 447),
// ops/color_calibration.py `color_correct_planes` (line 22),
// ops/vignetting.py `correct_planes` (line 44) with `composed_gamma_lab_fn`
// (line 122), ops/color_enhancer.py `enhance_planes` (line 119), and the
// statistical white balances' per-pixel maps, ops/white_balance.py
// `balance_white_simple` (line 75), `balance_white_grey_world` (109),
// `balance_white_pca` (425) and ops/learned_wb.py
// `balance_white_learned_model` (364), whose per-frame tables kernel M
// makes (csrc/wb_tables.cu). The port's
// plain versions run it as a few hundred eager passes over [B, H, W] tensors,
// with int32 and f32 temporaries of every intermediate.
//
// What bounds it on the H100: instructions. Three bytes in and three out a
// pixel, but about 190 integer and f32 operations a pixel with every step
// on (tools/measure.POINTWISE_OPS) and 14 table gathers. The first form (a
// pixel a thread step, byte loads and stores, 64-bit addresses, every
// int/float conversion on the conversion unit) spent 0.70 of its 1.98 ms at
// B=64 1080x1920 on moving the bytes alone, and the same time on noise as
// on natural frames but for the enhancer's branches: neither HBM nor
// shared-memory bank conflicts limited it (tools/limiters.py, PERF.md).
//
// Design:
// - A thread owns a group of kPx = 4 consecutive pixels of a row, and walks
//   the frames of its task against one load of the group's mask values
//   (one 16-byte load). Blocks are persistent; a task is a group and a
//   range of frames, the ranges cut only where the groups of a frame
//   cannot fill the card.
// - A group is read and written as words: one 32-bit word a plane for
//   planes of column stride 1 (the chain's views of [B, 3, H, W]), three
//   words for the interleaved [..., H, W, 3] layout (config 4, the op
//   layer's NHWC frames), with offsets inside a frame in 32 bits. Any other
//   strides or alignments take the byte path of the same kernel (IN and OUT
//   kBytes). Layouts in and out are chosen apart.
// - No conversion instruction: a byte becomes an exact f32 as
//   (2^23 + v) - 2^23 (its bits built by one logic op), a rounding to u8 is
//   the clamp then + 2^23, whose low byte is the result (round half to
//   even, as rintf), and a floor is + 1.5 * 2^23 rounded down
//   (__fadd_rd), whose low byte is floor(x) & 255 for |x| < 2^22.
// - Tables in shared memory, in the narrowest type that holds their values
//   (ops/pointwise.const_tables checks each): Lab2BGR's y and ify share one
//   32-bit entry (one gather), the cbrt table is u16, and sdiv shares its
//   entry with the enhancer's V gain (both read at v; sdiv < 2^24). The
//   HSV2BGR sector choice is one byte permute, its selector read from a
//   9-entry table (floor(h * 6/180) in [0, 8], the % 6 folded in).
// - The Lab coefficients are immediates (kLabCoef, kLab2Coef; ops/colorspace
//   _LAB_COEF and _LAB2_COEF, held equal by tests/test_torch_pointwise.py).
// - The chains' step sets (the flagship's, config 4's, the table step
//   alone: config 2's white balance) have instantiations of their own in
//   the word layouts, whose steps are known at compile time: no step's
//   branch splits a pixel's code. A thread loads the next frame's words
//   before it computes a frame. Every set takes three planes (the mono
//   chain's LUT is kernel O, csrc/lut.cu).
// - The table step reads its frame's tables through the read-only cache
//   (768 bytes a frame; a warp's 32 lookups fall in two 128-byte lines a
//   plane), and a frame's NaN flags once a frame.
//
// Exactness: every f32 chain is written in __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc contracts nothing into an fma. HSV2BGR's two
// fma(-s, f, 1) are single-rounding fmas in the plain version too (Dekker's
// emulation, ops/common.fma_f32, equal to a true fma on all 2 x 65 536 of
// their operand pairs: tests/test_torch_pointwise.py), so they are
// __fmaf_rn here. Integer sums that could wrap are formed in unsigned
// arithmetic (int32 wrap, as torch's), `>>` on a negative int is arithmetic
// as torch's, `/` truncates as torch.div(rounding_mode="trunc"). The
// enhancer's HSV2BGR products lie in [0, 256) and are finite (every input
// is a table byte), so the floor by the 1.5 * 2^23 add equals (int)floorf.
// The enhancer's SIMD/scalar split is taken per group: W - W % 32 is a
// multiple of kPx, so a group's pixels all lie on one side of it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 5;  // resident blocks an SM: measured faster than 3, 4 and 6
// the table step alone: 4 (its planar instantiation then takes 56 registers)
// measured faster than 5 at B=4 and B=64 1080p, planar and interleaved out
constexpr int kTableMinBlocks = 4;
constexpr int kPx = 4;  // consecutive pixels of a thread

// ops/pointwise.const_tables' layout, in bytes: [kYIfy, kSdiv) is staged as
// it is (Shared's first four members)
constexpr int kYIfy = 0, kCbrt = 1024, kInvGamma = 7168, kHdiv = 15360, kSdiv = 16384,
              kConstBytes = 17408;
constexpr int kCbrtSize = 3072, kInvGammaSize = 8192;
constexpr int kVignettingBytes = kHdiv;  // yify, cbrt, inv_gamma
static_assert(kCbrt == kYIfy + 4 * 256 && kInvGamma == kCbrt + 2 * kCbrtSize &&
                  kHdiv == kInvGamma + kInvGammaSize && kSdiv == kHdiv + 4 * 256 &&
                  kConstBytes == kSdiv + 4 * 256,
              "const_tables' layout");

// ops/colorspace's Lab constants
constexpr int kLabShift = 12, kLabShift2 = 15;
constexpr int kLScale = (116 * 255 + 50) / 100;
constexpr int kLShift = -((16 * 255 * (1 << kLabShift2) + 50) / 100);
constexpr int kLab2Base = 1 << 14;
constexpr int kLab2MinAB = -8145;
constexpr int kLab2ABMax = kLab2Base * 9 / 4 + kLab2MinAB - 1;
constexpr int kADivShift = 128 * kLab2Base / 500;
constexpr int kBDivShift = 128 * kLab2Base / 200;
// BGR2Lab's (R, G, B weights of X, Y, Z) and Lab2BGR's (X, Y, Z weights of
// R, G, B) fixed-point coefficients: ops/colorspace._LAB_COEF, _LAB2_COEF
__constant__ const uint32_t kLabCoef[9] = {1777, 1541, 778, 871, 2929, 296, 73, 448, 3575};
__constant__ const int kLab2Coef[9] = {12615, -6296, -2223, -3773, 7684, 185, 217, -836, 4715};
constexpr float kInv255 = 0x1.010102p-8f;   // f32(1/255)
constexpr float kSixBy180 = 0x1.111112p-5f;  // f32(6/180)
constexpr int kSimdPx = 32;  // ops/color_enhancer.CV_SIMD_PX
constexpr float kMagic = 8388608.0f;         // 2^23
constexpr float kMagicFloor = 12582912.0f;   // 1.5 * 2^23
// HSV2BGR's byte selectors by floor(h * 6/180) in [0, 8]: ops/colorspace
// _SECTOR_DATA[k % 6], the (B, G, R) choice among (v, t1, t2, t3) as nibbles
__constant__ const uint32_t kSectorSel[9] = {0x031, 0x201, 0x103, 0x120, 0x310, 0x012,
                                    0x031, 0x201, 0x103};

enum Layout { kBytes = 0, kPlanar = 1, kInterleaved = 2 };

// step sets: a kernel instantiated for one knows its steps at compile time,
// so no step's branch splits the pixels' code and nvcc schedules across
// steps; kAnySteps reads them from the pointers
enum Step { kGains = 1, kMatrix = 2, kLut = 4, kMask = 8, kEnh = 16, kTable = 32 };
constexpr int kAnySteps = 0;
constexpr int kTableSteps = kTable;  // config 2's white balance
constexpr int kFlagshipSteps = kGains | kMatrix | kMask | kEnh;  // the chains' call
constexpr int kConfig4Steps = kMatrix | kMask | kEnh;            // config 4's

struct Params {
  const uint8_t* in[3];
  uint8_t* out[3];
  long long in_sb, out_sb;          // frame strides in bytes
  int in_sy, in_sx, out_sy, out_sx;  // row and column strides in bytes
  int batch, h, w, chunk;            // chunk: frames a task
  bool mask16;                       // the mask's rows load as 16-byte words
  const float* gains;   // [batch, 3] or null
  const float* matrix;  // [3, 3] row by row, or null
  const float* bias;    // [3], with matrix
  const uint8_t* lut;   // [256] or null
  const float* mask;    // [h, w] or null (no vignetting)
  const int* lab;       // [256] linearize table, with mask
  const uint8_t* enh;   // [3, 256] (H, S, V) gain tables, or null
  const uint8_t* wb;    // the table step's [batch, 3, 256] tables, or null
  const uint8_t* wb_nan;  // [batch, 3] NaN flags, or null
  long long nan_limit;  // a NaN channel's pixels before this flat position are 255, else 0
  const uint8_t* tables;  // const_tables
};

struct __align__(16) Shared {
  uint32_t yify[256];               // y | ify << 16
  uint16_t cbrt[kCbrtSize];
  uint8_t inv_gamma[kInvGammaSize];
  int hdiv[256];
  uint32_t sv[256];                 // sdiv | V gain << 24
  int lab[256];
  uint32_t sector_sel[9];
  uint8_t lut[256], enh_h[256], enh_s[256];
};
static_assert(offsetof(Shared, hdiv) == kHdiv && offsetof(Shared, sv) == kSdiv,
              "Shared mirrors const_tables up to sdiv");

// the low byte of v as an exact f32: (2^23 + v) - 2^23
__device__ __forceinline__ float u8f(uint32_t v) {
  return __fsub_rn(__uint_as_float((v & 255u) | 0x4B000000u), kMagic);
}

// the exact f32 of to_u8's result (2^23 + v), v in its low byte
__device__ __forceinline__ float u8f_biased(uint32_t bits) {
  return __fsub_rn(__uint_as_float(bits), kMagic);
}

// round_u8(x) in the low byte: clamp, then + 2^23 (ulp 1) rounds half to even
__device__ __forceinline__ uint32_t to_u8(float x) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(x, 0.0f), 255.0f), kMagic));
}

// (int)floorf(x) & 255 in the low byte, for finite |x| < 2^22
__device__ __forceinline__ uint32_t floor_u8(float x) {
  return __float_as_uint(__fadd_rd(x, kMagicFloor));
}

__device__ __forceinline__ int clamp_i(int x, int lo, int hi) { return min(max(x, lo), hi); }

__device__ __forceinline__ int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

// ops/colorspace._lab2_ab_to_xz
__device__ __forceinline__ int ab_to_xz(int i) {
  i = clamp_i(i, kLab2MinAB, kLab2ABMax);
  if (i <= 3390) return (i * 108) / 841 - 290;
  const int q = (i * i) >> 14;
  return (q * i) >> 14;
}

// the low bytes of a, b, c, d as one word, a lowest
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Pixel values travel as uint32 with the byte in the low 8 bits (the upper
// bits may hold a rounding's bias; every reader masks or permutes them).
struct Px {
  uint32_t b[kPx], g[kPx], r[kPx];
};

// a group's bytes as three words: one a plane (kPlanar, and kBytes
// assembled so, pixel j in byte j) or the interleaved layout's three
template <int L>
__device__ __forceinline__ void load_words(uint32_t (&wd)[3], const uint8_t* const (&src)[3],
                                           int off, int sx, int left) {
  if constexpr (L == kPlanar) {
#pragma unroll
    for (int k = 0; k < 3; ++k) wd[k] = *reinterpret_cast<const uint32_t*>(src[k] + off);
  } else if constexpr (L == kInterleaved) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(src[0] + off);
    wd[0] = q[0], wd[1] = q[1], wd[2] = q[2];
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      wd[k] = 0;
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        if (j < left) wd[k] |= (uint32_t)src[k][off + j * sx] << (8 * j);
      }
    }
  }
}

template <int L>
__device__ __forceinline__ void unpack_words(Px& px, const uint32_t (&wd)[3]) {
  if constexpr (L == kInterleaved) {
    // b0 g0 r0 b1 | g1 r1 b2 g2 | r2 b3 g3 r3
    const uint32_t w0 = wd[0], w1 = wd[1], w2 = wd[2];
    px.b[0] = w0, px.g[0] = w0 >> 8, px.r[0] = w0 >> 16, px.b[1] = w0 >> 24;
    px.g[1] = w1, px.r[1] = w1 >> 8, px.b[2] = w1 >> 16, px.g[2] = w1 >> 24;
    px.r[2] = w2, px.b[3] = w2 >> 8, px.g[3] = w2 >> 16, px.r[3] = w2 >> 24;
  } else {
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      px.b[j] = wd[0] >> (8 * j), px.g[j] = wd[1] >> (8 * j), px.r[j] = wd[2] >> (8 * j);
    }
  }
}

template <int L>
__device__ __forceinline__ void store_group(const Px& px, uint8_t* const (&dst)[3], int off,
                                            int sx, int left) {
  if constexpr (L == kPlanar) {
    *reinterpret_cast<uint32_t*>(dst[0] + off) = pack4(px.b[0], px.b[1], px.b[2], px.b[3]);
    *reinterpret_cast<uint32_t*>(dst[1] + off) = pack4(px.g[0], px.g[1], px.g[2], px.g[3]);
    *reinterpret_cast<uint32_t*>(dst[2] + off) = pack4(px.r[0], px.r[1], px.r[2], px.r[3]);
  } else if constexpr (L == kInterleaved) {
    uint32_t* q = reinterpret_cast<uint32_t*>(dst[0] + off);
    q[0] = pack4(px.b[0], px.g[0], px.r[0], px.b[1]);
    q[1] = pack4(px.g[1], px.r[1], px.b[2], px.g[2]);
    q[2] = pack4(px.r[2], px.b[3], px.g[3], px.r[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      if (j < left) {
        dst[0][off + j * sx] = (uint8_t)px.b[j];
        dst[1][off + j * sx] = (uint8_t)px.g[j];
        dst[2][off + j * sx] = (uint8_t)px.r[j];
      }
    }
  }
}

template <int IN, int OUT, int STEPS>
__global__ void __launch_bounds__(kThreads, STEPS == kTableSteps ? kTableMinBlocks : kMinBlocks)
    pointwise_kernel(const Params p) {
  __shared__ Shared s;
  const int t0 = threadIdx.x;
  const bool gains = STEPS ? (STEPS & kGains) != 0 : p.gains != nullptr;
  const bool matrix = STEPS ? (STEPS & kMatrix) != 0 : p.matrix != nullptr;
  const bool lut = STEPS ? (STEPS & kLut) != 0 : p.lut != nullptr;
  const bool mask = STEPS ? (STEPS & kMask) != 0 : p.mask != nullptr;
  const bool enh = STEPS ? (STEPS & kEnh) != 0 : p.enh != nullptr;
  const bool table = STEPS ? (STEPS & kTable) != 0 : p.wb != nullptr;
  // the constant tables the steps read, as 16-byte words
  const int4* ct = reinterpret_cast<const int4*>(p.tables);
  int4* st = reinterpret_cast<int4*>(&s);
  if (mask) {
    for (int i = t0; i < kVignettingBytes / 16; i += kThreads) st[i] = __ldg(ct + i);
    for (int i = t0; i < 256; i += kThreads) s.lab[i] = __ldg(p.lab + i);
  }
  if (enh) {
    for (int i = kHdiv / 16 + t0; i < kSdiv / 16; i += kThreads) st[i] = __ldg(ct + i);
    const uint32_t* sdiv = reinterpret_cast<const uint32_t*>(p.tables + kSdiv);
    for (int i = t0; i < 256; i += kThreads) {
      s.sv[i] = __ldg(sdiv + i) | ((uint32_t)p.enh[512 + i] << 24);
      s.enh_h[i] = p.enh[i];
      s.enh_s[i] = p.enh[256 + i];
    }
    if (t0 < 9) s.sector_sel[t0] = kSectorSel[t0];
  }
  if (lut) {
    for (int i = t0; i < 256; i += kThreads) s.lut[i] = p.lut[i];
  }
  __syncthreads();

  float cc[12];  // the matrix row by row, then the bias
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    cc[i] = matrix ? __ldg(i < 9 ? p.matrix + i : p.bias + i - 9) : 0.0f;
  }

  const int groups = (p.w + kPx - 1) / kPx;  // a row's groups
  const int positions = p.h * groups;
  const int tasks = positions * ((p.batch + p.chunk - 1) / p.chunk);
  const int simd_end = p.w - p.w % kSimdPx;
  for (int task = blockIdx.x * kThreads + t0; task < tasks; task += gridDim.x * kThreads) {
    const int c = task / positions;
    const int pos = task - c * positions;
    const int y = pos / groups;
    const int x = (pos - y * groups) * kPx;
    const int left = p.w - x;  // pixels of the group inside the row
    float m[kPx];
    if (mask) {
      const float* mrow = p.mask + (long long)y * p.w + x;
      if (IN != kBytes && p.mask16) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(mrow));
        m[0] = v.x, m[1] = v.y, m[2] = v.z, m[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < kPx; ++j) m[j] = j < left ? __ldg(mrow + j) : 0.0f;
      }
    }
    const bool simd = x < simd_end;
    const int f0 = c * p.chunk, f1 = min(p.batch, f0 + p.chunk);
    const int io = y * p.in_sy + x * p.in_sx, oo = y * p.out_sy + x * p.out_sx;
    const uint8_t* src[3];
    uint8_t* dst[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) src[k] = p.in[k] + f0 * p.in_sb, dst[k] = p.out[k] + f0 * p.out_sb;
    uint32_t next[3];  // the next frame's words, loaded a frame ahead
    load_words<IN>(next, src, io, p.in_sx, left);
#pragma unroll 1
    for (int f = f0; f < f1; ++f) {
      Px px;
      unpack_words<IN>(px, next);
#pragma unroll
      for (int k = 0; k < 3; ++k) src[k] += p.in_sb;
      if (f + 1 < f1) load_words<IN>(next, src, io, p.in_sx, left);
      const uint8_t* tab = nullptr;  // frame f's tables
      uint32_t nanc = 0;             // its NaN channels' bits (b 1, g 2, r 4)
      if (table) {
        tab = p.wb + 768LL * f;
        if (p.wb_nan) {
          nanc = (__ldg(p.wb_nan + 3 * f) ? 1u : 0u) | (__ldg(p.wb_nan + 3 * f + 1) ? 2u : 0u) |
                (__ldg(p.wb_nan + 3 * f + 2) ? 4u : 0u);
        }
      }
      float gb = 0.0f, gg = 0.0f, gr = 0.0f;
      if (gains) {
        gb = __ldg(p.gains + 3 * f), gg = __ldg(p.gains + 3 * f + 1);
        gr = __ldg(p.gains + 3 * f + 2);
      }
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        uint32_t b = px.b[j], g = px.g[j], r = px.r[j];
        if (table) {
          b = __ldg(tab + (b & 255u));
          g = __ldg(tab + 256 + (g & 255u));
          r = __ldg(tab + 512 + (r & 255u));
          if (nanc) {  // PCA's constant channels: by the pixel's flat position
            const uint32_t pat = (long long)y * p.w + x + j < p.nan_limit ? 255u : 0u;
            if (nanc & 1u) b = pat;
            if (nanc & 2u) g = pat;
            if (nanc & 4u) r = pat;
          }
        }
        if (gains) {
          b = to_u8(__fmul_rn(u8f(b), gb));
          g = to_u8(__fmul_rn(u8f(g), gg));
          r = to_u8(__fmul_rn(u8f(r), gr));
        }
        if (matrix) {  // after the gains, the bytes are already 2^23's bits
          const float bf = gains ? u8f_biased(b) : u8f(b), gf = gains ? u8f_biased(g) : u8f(g),
                      rf = gains ? u8f_biased(r) : u8f(r);
          uint32_t o[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float v = __fadd_rn(__fmul_rn(bf, cc[3 * k]), __fmul_rn(gf, cc[3 * k + 1]));
            o[k] = to_u8(__fadd_rn(__fadd_rn(v, __fmul_rn(rf, cc[3 * k + 2])), cc[9 + k]));
          }
          b = o[0], g = o[1], r = o[2];
        }
        if (lut) {
          b = s.lut[b & 255u], g = s.lut[g & 255u], r = s.lut[r & 255u];
        }
        if (mask) {
          const uint32_t lb = s.lab[b & 255u], lg = s.lab[g & 255u], lr = s.lab[r & 255u];
          int fxyz[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {  // int32 dot products with torch's wrap
            const int d = (int)(lr * kLabCoef[3 * k] + lg * kLabCoef[3 * k + 1] +
                                lb * kLabCoef[3 * k + 2]);
            fxyz[k] = s.cbrt[clamp_i(descale(d, kLabShift), 0, kCbrtSize - 1)];
          }
          const int fx = fxyz[0], fy = fxyz[1], fz = fxyz[2];
          const int L = clamp_i(descale(kLScale * fy + kLShift, kLabShift2), 0, 255);
          const int A = clamp_i(descale(500 * (fx - fy) + 128 * (1 << kLabShift2), kLabShift2),
                                0, 255);
          const int Bb = clamp_i(descale(200 * (fy - fz) + 128 * (1 << kLabShift2), kLabShift2),
                                 0, 255);
          const uint32_t yi = s.yify[to_u8(__fmul_rn(u8f(L), m[j])) & 255u];
          const int yy = (int)(yi & 0xFFFFu), ify = (int)(yi >> 16);
          const int adiv = ((5 * A * 53687 + (1 << 7)) >> 13) - kADivShift;
          const int bdiv = ((Bb * 41943 + (1 << 4)) >> 9) - kBDivShift + 1;
          const uint32_t X = ab_to_xz(ify + adiv), Z = ab_to_xz(ify - bdiv);
          uint32_t o[3];
#pragma unroll
          for (int row = 0; row < 3; ++row) {
            const int sum = (int)(X * (uint32_t)kLab2Coef[3 * row] +
                                  (uint32_t)yy * (uint32_t)kLab2Coef[3 * row + 1] +
                                  Z * (uint32_t)kLab2Coef[3 * row + 2] + 8192u);
            o[row] = s.inv_gamma[clamp_i(sum >> 14, 0, kInvGammaSize - 1)];
          }
          b = o[2], g = o[1], r = o[0];
        }
        if (enh) {
          const int ib = (int)(b & 255u), ig = (int)(g & 255u), ir = (int)(r & 255u);
          const int v = max(max(ib, ig), ir);
          const int diff = v - min(min(ib, ig), ir);
          const uint32_t sv = s.sv[v];
          const int sat = (diff * (int)(sv & 0xFFFFFFu) + (1 << 11)) >> 12;
          const int hnum = v == ir ? ig - ib : (v == ig ? ib - ir + 2 * diff : ir - ig + 4 * diff);
          int hue = (hnum * s.hdiv[diff] + (1 << 11)) >> 12;
          hue += hue < 0 ? 180 : 0;
          // hue in [0, 180) and sat in [0, 255] for every triple
          // (tests/test_torch_pointwise.py), as the plain version's indexing needs
          const float hh = u8f(s.enh_h[hue]);
          const float ss = __fmul_rn(u8f(s.enh_s[sat]), kInv255);
          const float vv = __fmul_rn(u8f(sv >> 24), kInv255);
          const float hf = __fmul_rn(hh, kSixBy180);
          const uint32_t fl = __float_as_uint(__fadd_rd(hf, kMagic));  // 2^23 + floor(hf)
          const float ff = __fsub_rn(hf, __fsub_rn(__uint_as_float(fl), kMagic));
          const uint32_t sel = s.sector_sel[fl & 15u];  // floor(hf) <= 255 * 6/180 < 9
          const float t1 = __fmul_rn(vv, __fsub_rn(1.0f, ss));
          const float t2 = __fmul_rn(vv, __fmaf_rn(-ss, ff, 1.0f));
          const float t3 = __fmul_rn(vv, __fmaf_rn(-ss, __fsub_rn(1.0f, ff), 1.0f));
          const float pv = __fmul_rn(vv, 255.0f), p1 = __fmul_rn(t1, 255.0f),
                      p2 = __fmul_rn(t2, 255.0f), p3 = __fmul_rn(t3, 255.0f);
          // the candidates (v, t1, t2, t3) as bytes, then the sector's pick
          const uint32_t cand = simd ? pack4(floor_u8(pv), floor_u8(p1), floor_u8(p2), floor_u8(p3))
                                     : pack4(to_u8(pv), to_u8(p1), to_u8(p2), to_u8(p3));
          const uint32_t bgr = __byte_perm(cand, 0u, sel);
          b = bgr, g = bgr >> 8, r = bgr >> 16;
        }
        px.b[j] = b, px.g[j] = g, px.r[j] = r;
      }
      store_group<OUT>(px, dst, oo, p.out_sx, left);
#pragma unroll
      for (int k = 0; k < 3; ++k) dst[k] += p.out_sb;
    }
  }
}

template <int IN, int OUT, int STEPS>
int launch_steps(const Params& p, int positions, cudaStream_t stream) {
  static int cached[64] = {0};  // resident blocks of this instantiation, by device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pointwise_kernel<IN, OUT, STEPS>,
                                                  kThreads, 0);
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  // frames a task: all of them where the groups of a frame fill the
  // resident threads (the mask is then read once), else split
  Params q = p;
  const long long threads = (long long)cached[dev] * kThreads;
  const long long ranges = std::min<long long>(p.batch, std::max<long long>(1, threads / positions));
  q.chunk = (int)((p.batch + ranges - 1) / ranges);
  const long long tasks = (long long)positions * ((p.batch + q.chunk - 1) / q.chunk);
  if (tasks + threads >= (1LL << 31)) return (int)cudaErrorInvalidValue;  // task's int
  const long long want = (tasks + kThreads - 1) / kThreads;
  const int blocks = (int)std::min<long long>(want, cached[dev]);
  pointwise_kernel<IN, OUT, STEPS><<<blocks, kThreads, 0, stream>>>(q);
  return (int)cudaGetLastError();
}

// the instantiation for the call's steps: the chains' and config 4's sets
// in the word layouts have their own
template <int IN, int OUT>
int launch(const Params& p, int positions, cudaStream_t stream) {
  const int steps = (p.gains ? kGains : 0) | (p.matrix ? kMatrix : 0) | (p.lut ? kLut : 0) |
                    (p.mask ? kMask : 0) | (p.enh ? kEnh : 0) | (p.wb ? kTable : 0);
  if constexpr (IN != kBytes) {
    if (steps == kFlagshipSteps) return launch_steps<IN, OUT, kFlagshipSteps>(p, positions, stream);
    if (steps == kConfig4Steps) return launch_steps<IN, OUT, kConfig4Steps>(p, positions, stream);
    if (steps == kTableSteps) return launch_steps<IN, OUT, kTableSteps>(p, positions, stream);
  }
  return launch_steps<IN, OUT, kAnySteps>(p, positions, stream);
}

// the word layout three planes at these addresses and strides allow
int layout_of(const void* const (&ptr)[3], long long sb, long long sy, long long sx, int w) {
  const uintptr_t a = (uintptr_t)ptr[0];
  const bool rows4 = w % kPx == 0 && sb % 4 == 0 && sy % 4 == 0;
  if (rows4 && sx == 1 && a % 4 == 0 && (uintptr_t)ptr[1] % 4 == 0 && (uintptr_t)ptr[2] % 4 == 0) {
    return kPlanar;
  }
  if (rows4 && sx == 3 && a % 4 == 0 && (uintptr_t)ptr[1] == a + 1 && (uintptr_t)ptr[2] == a + 2) {
    return kInterleaved;
  }
  return kBytes;
}

}  // namespace

// Three [batch, h, w] u8 planes (in0..2, shared strides in bytes: frame,
// row, column) to three (out0..2, likewise); gains, matrix (with bias),
// lut, mask, enh and wb switch their steps on (null: off); lab is the
// linearize table of the vignetting step; wb the table step's [batch, 3,
// 256] tables, wb_nan their [batch, 3] NaN flags (or null) and nan_limit
// their flat position; tables is ops/pointwise.const_tables. A
// frame's offsets, (h - 1) * sy + (w - 1) * sx + 3 for in and out, must fit
// an int and so must h * ceil(w / 4) (the wrapper checks). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int isp_pointwise(const void* in0, const void* in1, const void* in2, void* out0,
                             void* out1, void* out2, long long in_sb, long long in_sy,
                             long long in_sx, long long out_sb, long long out_sy,
                             long long out_sx, int batch, int h, int w, const void* gains,
                             const void* matrix, const void* bias, const void* lut,
                             const void* mask, const void* lab, const void* enh,
                             const void* wb, const void* wb_nan, long long nan_limit,
                             const void* tables, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (!tables || (mask && !lab) || (matrix && !bias) || (wb_nan && !wb)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long groups = (w + kPx - 1) / kPx;
  if ((long long)h * groups >= (1LL << 31) || (h - 1) * in_sy + (w - 1) * in_sx + 3 >= (1LL << 31) ||
      (h - 1) * out_sy + (w - 1) * out_sx + 3 >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.in[0] = (const uint8_t*)in0, p.in[1] = (const uint8_t*)in1, p.in[2] = (const uint8_t*)in2;
  p.out[0] = (uint8_t*)out0, p.out[1] = (uint8_t*)out1, p.out[2] = (uint8_t*)out2;
  p.in_sb = in_sb, p.in_sy = (int)in_sy, p.in_sx = (int)in_sx;
  p.out_sb = out_sb, p.out_sy = (int)out_sy, p.out_sx = (int)out_sx;
  p.batch = batch, p.h = h, p.w = w, p.chunk = batch;
  p.gains = (const float*)gains, p.matrix = (const float*)matrix, p.bias = (const float*)bias;
  p.lut = (const uint8_t*)lut;
  p.mask = (const float*)mask, p.lab = (const int*)lab, p.enh = (const uint8_t*)enh;
  p.wb = (const uint8_t*)wb;
  p.wb_nan = (const uint8_t*)wb_nan, p.nan_limit = nan_limit;
  p.tables = (const uint8_t*)tables;
  p.mask16 = w % kPx == 0 && (uintptr_t)mask % 16 == 0;
  const void* ins[3] = {in0, in1, in2};
  const void* outs[3] = {out0, out1, out2};
  const int li = layout_of(ins, in_sb, in_sy, in_sx, w);
  const int lo = layout_of(outs, out_sb, out_sy, out_sx, w);
  const int positions = (int)((long long)h * groups);
  const cudaStream_t s = (cudaStream_t)stream;
  if (li == kBytes || lo == kBytes) return launch<kBytes, kBytes>(p, positions, s);
  if (li == kPlanar) {
    return lo == kPlanar ? launch<kPlanar, kPlanar>(p, positions, s)
                         : launch<kPlanar, kInterleaved>(p, positions, s);
  }
  return lo == kPlanar ? launch<kInterleaved, kPlanar>(p, positions, s)
                       : launch<kInterleaved, kInterleaved>(p, positions, s);
}
