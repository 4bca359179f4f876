// Kernel F: the fisheye remap in "lerp" mode (the x86/IPP arithmetic, the
// chains' default) and in "fixed32" mode (OpenCV's non-IPP integer blend,
// that of ARM builds: a Jetson's output, bit for bit),
// cv::remap(INTER_LINEAR, BORDER_CONSTANT=0), equal to
// ops/undistortion.remap_lerp_planes and remap_fixed32_planes.
//
// Replaces: raw_image_pipeline_tpu/ops/undistortion.py `_remap_rows` (line
// 478; lerp branch line 607, fixed32 line 643), one XLA program over a
// gather pack written for the TPU (no Pallas kernel). The port's plain
// versions run it as about 35 eager f32 passes over [B, Ho*Wo, C] tensors;
// here each thread gathers its pixels' four taps and blends them in
// registers.
//
// What bounds it on the H100: instructions, in lerp mode. The first form
// (lerp through remap_tile.cuh's template, as a mode beside kernel E's)
// held six weights a pixel in registers (72 registers, 88 bytes of stack
// spilled at C = 3), spent about 25 f32 operations on an output byte (four
// mask products, the blend, a six-operation half-integer test), and
// gathered every border tile from global memory: 32% of its byte bound at
// B=64 1080x1920, against 45% for fixed32 through the same template.
//
// What bounds it, fixed32: the first form (a mode of remap_tile.cuh's
// remap_kernel, as kernel E's float mode) read a 4-byte anchor and four f32
// weights a pixel (20 bytes, 41.5 MB a 1080p map: more than the 24.9 MB of
// planes read and of bytes written at B=4), held 16 registers of weights a
// run, and blended each output byte in about 20 f32 operations on four
// byte loads from shared memory: 45% of its byte bound at B=64 1080x1920,
// 56% at B=4 (PERF.md, kernel F).
//
// Design: remap_tile.cuh's tiles (8 x 64 output pixels, a run of 4 a
// thread, the map loaded once for all frames, the tile's source box staged
// by cp.async one frame ahead, word stores), and for each mode a kernel of
// its own over those pieces. Lerp (remap_lerp_kernel)
// - holds a pixel's map as fx, fy and four mask bits;
// - selects a tap or 0 by its mask bit, which equals the plain product
//   tap * mask for masks 0 and 1, and reads no masked tap;
// - stages border tiles: the box covers the mask-1 taps only, which lie
//   inside the frame, so a tap past the border (mask 0) needs no byte;
// - forms the x-lerps' differences between taps biased by 2^23, and tests
//   for a half-integer in four operations (lerp_native).
// Fixed32 (remap_fixed32_kernel)
// - reads a compact map: the int32 anchor and an int16 code a pixel (6
//   bytes, 12.4 MB a 1080p map; ops/undistortion.remap_fixed32_code makes
//   it on the host from remap_precompute's weights). Code r < 1024 is row r
//   = 32 * ay + ax of cv::remap's 32 x 32 weight table, whose entries are
//   exact products, (32 - ay) * (32 - ax) * 32 and so on (the table's
//   rounding residual is 0 at 5 interpolation bits), so the kernel computes
//   the row and stages no table; FIXED32_DEAD (1024) a pixel whose weights
//   are all 0 (output 0, nothing read); FIXED32_EXPLICIT (1025) any other
//   pixel (the anchors clipped at the border: 3264 pixels, 0.16%, of the
//   fixed32 chain's 1080p map), whose four f32 weights are read from the
//   [4, N] array as before.
//   Without a code (the op layer's callers pass only base and weights)
//   every pixel is explicit (20 bytes a pixel, as the first form);
// - blends in integers: a pixel's weights as two u16 pairs, a channel's 2 x
//   2 taps as two words of two bytes (one aligned 4-byte load from shared
//   memory a tap row, a second only where the pair straddles a word, and a
//   byte permute), two __dp2a_lo and (acc + 2^14) >> 15: the three
//   channels share the pixel's weights;
// - holds 12 registers of map a run (an anchor and two weight words a
//   pixel) in place of 20: 8 blocks resident an SM (kFixedMinBlocks), in
//   place of 7 (8 measured faster than 9 at B = 16 and 64, as fast at B=4);
// - without a code, reads the run's [4, N] weights as four 16-byte rows, as
//   the first form did.
// What bounds it now (tools/remap_variants.py, PERF.md section 6): at B=64
// the box copies (the copies, map and loop alone take two thirds of its
// time) and the per-frame loop (a frame's barrier and the run's
// bookkeeping, a quarter with no copy, blend or store); at B=4 each
// block's chain of latencies before its first blend (map, box, first
// copies: half its time).
// Exactness, lerp: weights [6, N] = (fx, fy, m00, m01, m10, m11); tap 0 sits
// at base - (W+1) (the reference package's pack margin), each tap is read
// at its place clamped into [0, H*W) and multiplied by its mask. Then
// t = fma(fx, v01 - v00, v00), b = fma(fx, v11 - v10, v10) and
// out = sat_u8(rint(fma(fy, b - t, t))), each fma rounded once. The plain
// version emulates those fmas in plain f32 operations (Dekker's product and
// Knuth's sum, ops/common.fma_f32), and the emulation is not a true fma
// everywhere (tests/test_torch_remap_lerp.py holds both to exact
// arithmetic). This kernel uses __fmaf_rn where the two provably give the
// same byte and the emulation, operation for operation, elsewhere:
// - an x-lerp over u8 taps equals its emulation when fx is 0 or in
//   [2^-17, 1): both error terms of the emulation are then multiples of
//   ulp(fx) >= 2^-40 below 2^-16 in magnitude, so their sum is exact and
//   the one rounding left is the fma's;
// - the y-lerp's emulation, with t, b in [0, 255] and fy in [0, 1), lies
//   within 2^-40 of the exact value before its last rounding, so it and the
//   fma differ by at most one ulp and give the same byte unless a
//   half-integer lies within an ulp of the fma's result y; an ulp of y <
//   256 is at most 2^-16, so outside 2^-14 of a half-integer the bytes are
//   equal, and within it, about one value in four thousand, the
//   emulation's result is taken.
// A pixel outside that domain (fx in (0, 2^-17), fy outside [0, 1), or a
// mask other than 0 or 1: no map of remap_precompute's but one with x in
// (0, 2^-17)), and every pixel of a tile that gathers from global memory,
// is blended by the emulation throughout. Every operation of the emulation
// is an __f*_rn intrinsic, so nvcc cannot contract it.
//
// Exactness, fixed32: weights [4, N] are integers scaled by 2^15, the taps
// at base + {0, 1, W, W+1}, a tap outside [0, H*W) reads 0 (as kernel E);
// the plain version forms acc = ((t0*w0 + t1*w1) + t2*w2) + t3*w3 in f32,
// then sat_u8(floor((acc + 2^14) * 2^-15)). Where each weight is an integer
// in [0, 2^15] and their sum is at most 2^15 (every pixel of
// remap_precompute's maps), every product, partial sum and acc + 2^14 is an
// integer below 2^23 + 2^14, exact in f32, and (acc + 2^14) >> 15 is at
// most 255, so the integer blend (acc + 2^14) >> 15 gives the same byte. A pixel whose
// weights are not so (only an op-layer caller's map) is blended as the plain
// version, in __fmul_rn / __fadd_rn (exact integers for such weights: nvcc
// contracts nothing), with its weights read again each frame.

#include "remap_tile.cuh"

namespace {

using isp_remap::kRun;
using isp_remap::to_u8_bits;
using isp_remap::u8_to_f32;

constexpr float kSplit = 4097.0f;  // Dekker's split constant 2^12 + 1

// ops/common.fma_f32, operation for operation: rnd(a*b + c) emulated
__device__ __forceinline__ float fma_emulated(float a, float b, float c) {
  const float ca = __fmul_rn(a, kSplit);
  const float ahi = __fsub_rn(ca, __fsub_rn(ca, a));
  const float alo = __fsub_rn(a, ahi);
  const float cb = __fmul_rn(b, kSplit);
  const float bhi = __fsub_rn(cb, __fsub_rn(cb, b));
  const float blo = __fsub_rn(b, bhi);
  const float p = __fmul_rn(a, b);
  float err = __fadd_rn(__fsub_rn(__fmul_rn(ahi, bhi), p), __fmul_rn(ahi, blo));
  err = __fadd_rn(__fadd_rn(err, __fmul_rn(alo, bhi)), __fmul_rn(alo, blo));
  const float s = __fadd_rn(p, c);
  const float bb = __fsub_rn(s, p);
  const float e2 = __fadd_rn(__fsub_rn(p, __fsub_rn(s, bb)), __fsub_rn(c, bb));
  return __fadd_rn(s, __fadd_rn(e2, err));
}

// ops/undistortion.remap_lerp_planes's lerp_x, operation for operation
__device__ __forceinline__ float lerp_x_emulated(float fx, float v0, float v1) {
  const float ca = __fmul_rn(fx, kSplit);
  const float fxh = __fsub_rn(ca, __fsub_rn(ca, fx));
  const float fxl = __fsub_rn(fx, fxh);
  const float d = __fsub_rn(v1, v0);
  const float pp = __fmul_rn(fx, d);
  const float err = __fadd_rn(__fsub_rn(__fmul_rn(fxh, d), pp), __fmul_rn(fxl, d));
  const float ss = __fadd_rn(pp, v0);
  const float bb = __fsub_rn(ss, pp);
  const float e2 = __fadd_rn(__fsub_rn(pp, __fsub_rn(ss, bb)), __fsub_rn(v0, bb));
  return __fadd_rn(ss, __fadd_rn(e2, err));
}

constexpr int kLerpMinBlocks = 9;  // lerp blocks resident an SM: measured faster than 7 and 8

// the lerp's byte by the plain version's emulation, operation for operation,
// from the taps already multiplied by their masks
__device__ __forceinline__ uint32_t lerp_emulated(float v00, float v01, float v10, float v11,
                                                  float fx, float fy) {
  const float t = lerp_x_emulated(fx, v00, v01);
  const float b = lerp_x_emulated(fx, v10, v11);
  return to_u8_bits(fma_emulated(fy, __fsub_rn(b, t), t));
}

// the lerp's byte of a pixel in F's fma domain (fx 0 or in [2^-17, 1), fy
// in [0, 1), masks 0 or 1) from its four taps, a masked tap given as 0:
// t = fma(fx, v01 - v00, v00), b = fma(fx, v11 - v10, v10), y = fma(fy,
// b - t, t). The differences are taken between the taps biased by 2^23 (one
// logic op each; exact, as integers of at most 9 bits). t, b and y are
// convex combinations of taps in [0, 255], and the ends of [0, 255] are
// f32 values, so the roundings keep them there: y + 2^23 is the byte
// (round half to even) with no clamp, and y - rint(y) is exact. The byte is
// the emulation's unless y lies within 2^-14 of a half-integer (the
// emulation is within one ulp of y, and four ulps of y < 256 are at most
// 2^-14; see the file's head), where the emulation's result is taken.
__device__ __forceinline__ uint32_t lerp_native(uint32_t u00, uint32_t u01, uint32_t u10,
                                                uint32_t u11, float fx, float fy) {
  const float b00 = __uint_as_float(0x4B000000u | u00), b01 = __uint_as_float(0x4B000000u | u01);
  const float b10 = __uint_as_float(0x4B000000u | u10), b11 = __uint_as_float(0x4B000000u | u11);
  const float t = __fmaf_rn(fx, __fsub_rn(b01, b00), __fsub_rn(b00, isp_remap::kMagic));
  const float b = __fmaf_rn(fx, __fsub_rn(b11, b10), __fsub_rn(b10, isp_remap::kMagic));
  const float d = __fsub_rn(b, t);
  const float y = __fmaf_rn(fy, d, t);
  const float s = __fadd_rn(y, isp_remap::kMagic);
  if (fabsf(__fsub_rn(y, __fsub_rn(s, isp_remap::kMagic))) >= 0.5f - 0x1p-14f) {
    return to_u8_bits(fma_emulated(fy, d, t));
  }
  return __float_as_uint(s);
}

// Lerp mode, weights [6, N] = (fx, fy, m00, m01, m10, m11), tap 0 at base -
// (w + 1): remap_tile.cuh's tiles, runs, cameras, frame ranges, box copies
// and stores, with the run's map held as fx, fy and four mask bits a pixel
// (the template would hold all six weight rows of a run, 24 floats), and
// the border rule that lets border tiles stay staged:
// a tap whose mask is 0 adds exactly +0.0 (tap * 0, the tap a finite u8),
// so the box covers only the taps whose mask is 1, which lie inside the
// frame, and a masked tap is not read. A tile gathers from global memory
// (taps clamped into the frame and multiplied by their masks, as the plain
// version) where its box exceeds the buffer, the planes are not 16-byte
// aligned, or a live pixel has a mask other than 0 and 1 or a mask-1 tap
// outside the frame (no map of remap_precompute's).
template <int C, bool WORDS>
__global__ void __launch_bounds__(isp_remap::kBlock, kLerpMinBlocks)
    remap_lerp_kernel(const uint8_t* __restrict__ p0, const uint8_t* __restrict__ p1,
                      const uint8_t* __restrict__ p2, const int32_t* __restrict__ base,
                      const float* __restrict__ weights, uint8_t* __restrict__ out, int batch,
                      int h, int w, int ho, int wo, int chunk, bool planes16) {
  using namespace isp_remap;
  __shared__ __align__(16) uint8_t stage[kStages][C][kStage];
  __shared__ int part[4][kBlock / 32];

  const Run u = run_of(ho, wo, batch, chunk);
  const long long n = u.n, q0 = u.q0;
  const long long size = (long long)h * w;
  base += blockIdx.z * n;  // this camera's map
  weights += blockIdx.z * 6 * n;

  // the run's map, once for all frames: bit 4j + k of `ones` is mask k of
  // pixel j being 1, bit j of `odd` a mask of pixel j other than 0 and 1
  int b[kRun];
  float fx[kRun], fy[kRun];
  uint32_t ones = 0, odd = 0, live = 0;
  auto masks = [&](int j, float m0, float m1, float m2, float m3) {
    const float m[4] = {m0, m1, m2, m3};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ones |= (uint32_t)(m[k] == 1.0f) << (4 * j + k);
      odd |= (uint32_t)(m[k] != 0.0f && m[k] != 1.0f) << j;
      live |= (uint32_t)(m[k] != 0.0f) << j;
    }
  };
  if (WORDS && u.stores) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(base + q0));
    b[0] = q.x, b[1] = q.y, b[2] = q.z, b[3] = q.w;
    const float4 x = __ldg(reinterpret_cast<const float4*>(weights + q0));
    const float4 y = __ldg(reinterpret_cast<const float4*>(weights + n + q0));
    fx[0] = x.x, fx[1] = x.y, fx[2] = x.z, fx[3] = x.w;
    fy[0] = y.x, fy[1] = y.y, fy[2] = y.z, fy[3] = y.w;
    float4 m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      m[k] = __ldg(reinterpret_cast<const float4*>(weights + (2 + k) * n + q0));
    }
    masks(0, m[0].x, m[1].x, m[2].x, m[3].x);
    masks(1, m[0].y, m[1].y, m[2].y, m[3].y);
    masks(2, m[0].z, m[1].z, m[2].z, m[3].z);
    masks(3, m[0].w, m[1].w, m[2].w, m[3].w);
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const bool in = u.r < ho && u.c0 + j < wo;
      auto at = [&](int row) { return in ? __ldg(weights + row * n + q0 + j) : 0.0f; };
      b[j] = in ? __ldg(base + q0 + j) : 0;
      fx[j] = at(0), fy[j] = at(1);
      masks(j, at(2), at(3), at(4), at(5));
    }
  }

  // each live pixel's flag and tap 0's place (ty, tx) in the frame, which
  // lies one row above or one column left of it where those taps are
  // masked; the bounding box of the mask-1 taps
  uint32_t special = 0;
  bool unsafe = false;
  int ty[kRun], tx[kRun];
  int rmin = INT_MAX, rmax = -1, cmin = INT_MAX, cmax = -1;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    ty[j] = tx[j] = 0;
    if (!((live >> j) & 1)) continue;
    const uint32_t m = (ones >> (4 * j)) & 15u;
    const bool native = (fx[j] == 0.0f || (fx[j] >= 0x1p-17f && fx[j] < 1.0f)) && fy[j] >= 0.0f &&
                        fy[j] < 1.0f && !((odd >> j) & 1);
    special |= (uint32_t)!native << j;
    if (((odd >> j) & 1) || !m) {
      unsafe = true;
      continue;
    }
    const int k = __ffs(m) - 1;  // the first mask-1 tap, at a + (k >> 1) * w + (k & 1)
    const long long at = (long long)b[j] - (w + 1) + (k >> 1) * (long long)w + (k & 1);
    if (at < 0 || at >= size) {
      unsafe = true;
      continue;
    }
    const int ry = (int)(at / w);
    ty[j] = ry - (k >> 1);
    tx[j] = (int)(at - (long long)ry * w) - (k & 1);
    const int r0 = ty[j] + ((m & 3u) ? 0 : 1), r1 = ty[j] + ((m & 12u) ? 1 : 0);
    const int cl = tx[j] + ((m & 5u) ? 0 : 1), cr = tx[j] + ((m & 10u) ? 1 : 0);
    unsafe = unsafe || r0 < 0 || r1 >= h || cl < 0 || cr >= w;
    rmin = min(rmin, r0), rmax = max(rmax, r1), cmin = min(cmin, cl), cmax = max(cmax, cr);
  }
  const Box box = block_box(rmin, rmax, cmin, cmax, live != 0, unsafe, planes16, part);

  const uint8_t* planes[3] = {p0, p1, p2};
  uint8_t* dst = out + ((size_t)u.f0 * n + q0) * C;
  const size_t frame_out = (size_t)n * C;

  if (!box.staged) {
#pragma unroll 1
    for (int f = u.f0; f < u.f1; ++f, dst += frame_out) {
      uint32_t words[C] = {};  // the run's output bytes (put_byte)
      if (box.any_live) {
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          if (!((live >> j) & 1)) continue;
          const long long a = (long long)b[j] - (w + 1);
          float m[4];  // the masks: from the bits, or read again where odd
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            m[k] = ((odd >> j) & 1) ? __ldg(weights + (2 + k) * n + q0 + j)
                                    : (float)((ones >> (4 * j + k)) & 1u);
          }
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const uint8_t* src = planes[c] + (size_t)f * size;
            auto tap = [&](long long i) {
              return u8_to_f32(__ldg(src + (i < 0 ? 0 : (i >= size ? size - 1 : i))));
            };
            const float v00 = __fmul_rn(tap(a), m[0]), v01 = __fmul_rn(tap(a + 1), m[1]);
            const float v10 = __fmul_rn(tap(a + w), m[2]), v11 = __fmul_rn(tap(a + w + 1), m[3]);
            put_byte(words, j * C + c, lerp_emulated(v00, v01, v10, v11, fx[j], fy[j]));
          }
        }
      }
      if (u.stores) store_words<C, WORDS>(dst, words, wo - u.c0);
    }
    return;
  }

  int s[kRun];  // tap 0's place in the box (outside it where its taps are masked)
#pragma unroll
  for (int j = 0; j < kRun; ++j) s[j] = (ty[j] - box.rmin) * box.pitch + tx[j] - box.xa;
  staged_frames<C>(stage, planes, size, w, box, u.f0, u.f1, [&](int, const uint8_t* sb) {
    uint32_t words[C] = {};
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (!((live >> j) & 1)) continue;
      const uint32_t m = ones >> (4 * j);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint8_t* top = sb + c * kStage;
        const int o = s[j];
        uint32_t u00 = 0, u01 = 0, u10 = 0, u11 = 0;  // a masked tap: 0, not read
        if (m & 1u) u00 = top[o];
        if (m & 2u) u01 = top[o + 1];
        if (m & 4u) u10 = top[o + box.pitch];
        if (m & 8u) u11 = top[o + box.pitch + 1];
        put_byte(words, j * C + c,
                 ((special >> j) & 1) ? lerp_emulated(u8_to_f32(u00), u8_to_f32(u01),
                                                      u8_to_f32(u10), u8_to_f32(u11), fx[j], fy[j])
                                      : lerp_native(u00, u01, u10, u11, fx[j], fy[j]));
      }
    }
    if (u.stores) store_words<C, WORDS>(dst, words, wo - u.c0);
    dst += frame_out;
  });
}

// remap_lerp_kernel, as isp_remap::dispatch takes it
struct LerpTiles {
  template <int C, bool WORDS>
  static isp_remap::Kernel kernel() {
    return remap_lerp_kernel<C, WORDS>;
  }
};

constexpr int kFixedMinBlocks = 8;  // fixed32 blocks resident an SM
// ops/undistortion.FIXED32_DEAD, FIXED32_EXPLICIT: the codes past the 1024 rows
constexpr int kCodeDead = 1024, kCodeExplicit = 1025;

// row r = 32 * ay + ax of cv::remap's fixed-point bilinear table
// (ops/undistortion._bilinear_fixed_wtab) as u16 pairs: lo = w00 | w01 << 16,
// hi = w10 | w11 << 16, each weight an exact product times 32
__device__ __forceinline__ void row_weights(uint32_t r, uint32_t& lo, uint32_t& hi) {
  const uint32_t ay = r >> 5, ax = r & 31u;
  const uint32_t top = (32u - ay) << 5, bottom = ay << 5;
  lo = top * (32u - ax) | (top * ax) << 16;
  hi = bottom * (32u - ax) | (bottom * ax) << 16;
}

// four f32 weights as row_weights' u16 pairs where the integer blend is
// exact for them (each an integer in [0, 2^15], the sum at most 2^15; see
// the file's head); false otherwise (a NaN fails every compare)
__device__ __forceinline__ bool integer_weights(float w0, float w1, float w2, float w3,
                                                uint32_t& lo, uint32_t& hi) {
  auto whole = [](float x) { return x >= 0.0f && x <= 32768.0f && x == truncf(x); };
  if (!(whole(w0) && whole(w1) && whole(w2) && whole(w3))) return false;
  const uint32_t a = (uint32_t)w0, b = (uint32_t)w1, c = (uint32_t)w2, d = (uint32_t)w3;
  lo = a | b << 16, hi = c | d << 16;
  return a + b + c + d <= 32768u;
}

// the integer blend: taps 0, 1 in bytes 0, 1 of `top`, taps 2, 3 in bytes
// 0, 1 of `bottom`, the weights as row_weights' pairs (summing to at most
// 2^15, so that the result is at most 255)
__device__ __forceinline__ uint32_t blend_integer(uint32_t top, uint32_t bottom, uint32_t lo,
                                                  uint32_t hi) {
  return __dp2a_lo(lo, top, __dp2a_lo(hi, bottom, 16384u)) >> 15;
}

// the plain version's f32 blend, operation for operation
__device__ __forceinline__ uint32_t blend_f32(uint32_t u0, uint32_t u1, uint32_t u2, uint32_t u3,
                                              const float (&wt)[4]) {
  float acc = __fadd_rn(__fmul_rn(u8_to_f32(u0), wt[0]), __fmul_rn(u8_to_f32(u1), wt[1]));
  acc = __fadd_rn(acc, __fmul_rn(u8_to_f32(u2), wt[2]));
  acc = __fadd_rn(acc, __fmul_rn(u8_to_f32(u3), wt[3]));
  return to_u8_bits(floorf(__fmul_rn(__fadd_rn(acc, 16384.0f), 0x1p-15f)));
}

// the shared-memory bytes at p and p + 1 in bytes 0 and 1, from the aligned
// word at p - k (k = p & 3) and, where the pair straddles it (k = 3), the next
__device__ __forceinline__ uint32_t tap_pair(const uint8_t* p, uint32_t k) {
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p - k);
  return __byte_perm(q[0], k == 3u ? q[1] : 0u, k | (k + 1u) << 4);
}

// Fixed32 mode: the anchor base [N] and, where `code` is given, its compact
// code [N] (int16, see the file's head) with weights [4, N] read for the
// explicit pixels only; without a code, weights [4, N] for every pixel. The
// taps at base + {0, 1, w, w+1}, a tap outside the frame reading 0, and
// remap_tile.cuh's tiles, runs, cameras (code offset by blockIdx.z * N as
// base), frame ranges, box copies, fallback and stores.
template <int C, bool WORDS>
__global__ void __launch_bounds__(isp_remap::kBlock, kFixedMinBlocks)
    remap_fixed32_kernel(const uint8_t* __restrict__ p0, const uint8_t* __restrict__ p1,
                         const uint8_t* __restrict__ p2, const int32_t* __restrict__ base,
                         const float* __restrict__ weights, uint8_t* __restrict__ out, int batch,
                         int h, int w, int ho, int wo, int chunk, bool planes16,
                         const int16_t* __restrict__ code) {
  using namespace isp_remap;
  __shared__ __align__(16) uint8_t stage[kStages][C][kStage];
  __shared__ int part[4][kBlock / 32];

  const Run u = run_of(ho, wo, batch, chunk);
  const long long n = u.n, q0 = u.q0;
  const long long size = (long long)h * w;
  base += blockIdx.z * n;  // this camera's map
  weights += blockIdx.z * 4 * n;
  if (code) code += blockIdx.z * n;

  // the run's map, once for all frames: anchors, codes, then each pixel's
  // weights as u16 pairs (lo, hi); bit j of `live`: a nonzero weight, of
  // `odd`: weights the integer blend does not take (blended in f32, read
  // again each frame)
  int b[kRun], cd[kRun];
  float ew[4][kRun] = {};  // the explicit pixels' f32 weights
  if (WORDS && u.stores) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(base + q0));
    b[0] = q.x, b[1] = q.y, b[2] = q.z, b[3] = q.w;
    if (code) {
      const uint2 k = __ldg(reinterpret_cast<const uint2*>(code + q0));
      cd[0] = (int)(k.x & 0xFFFFu), cd[1] = (int)(k.x >> 16);
      cd[2] = (int)(k.y & 0xFFFFu), cd[3] = (int)(k.y >> 16);
    } else {  // every pixel explicit: the weights as four 16-byte rows
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(weights + k * n + q0));
        ew[k][0] = x.x, ew[k][1] = x.y, ew[k][2] = x.z, ew[k][3] = x.w;
      }
      cd[0] = cd[1] = cd[2] = cd[3] = kCodeExplicit;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const bool in = u.r < ho && u.c0 + j < wo;
      b[j] = in ? __ldg(base + q0 + j) : 0;
      cd[j] = !in ? kCodeDead : code ? (int)__ldg(code + q0 + j) : kCodeExplicit;
    }
  }
  uint32_t lo[kRun], hi[kRun], live = 0, odd = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    lo[j] = hi[j] = 0;
    if (cd[j] < 1024) {
      row_weights((uint32_t)cd[j], lo[j], hi[j]);
      live |= 1u << j;
    } else if (cd[j] == kCodeExplicit) {
      if (code || !(WORDS && u.stores)) {
#pragma unroll
        for (int k = 0; k < 4; ++k) ew[k][j] = __ldg(weights + k * n + q0 + j);
      }
      const float w0 = ew[0][j], w1 = ew[1][j], w2 = ew[2][j], w3 = ew[3][j];
      live |= (uint32_t)(w0 != 0.0f || w1 != 0.0f || w2 != 0.0f || w3 != 0.0f) << j;
      odd |= (uint32_t)!integer_weights(w0, w1, w2, w3, lo[j], hi[j]) << j;
    }
  }
  odd &= live;
  // an odd pixel's f32 weights, read again each frame
  auto wide = [&](int j, float (&wt)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) wt[k] = __ldg(weights + k * n + q0 + j);
  };

  // the bounding box of the live pixels' taps in the source
  bool unsafe = false;
  int by[kRun], bx[kRun];
  int rmin = INT_MAX, rmax = -1, cmin = INT_MAX, cmax = -1;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    by[j] = bx[j] = 0;
    if (!((live >> j) & 1)) continue;
    const long long a = b[j];  // tap 0
    if (a < 0 || a + w + 1 >= size) {
      unsafe = true;
      continue;
    }
    const int ai = (int)a;
    by[j] = ai / w;
    bx[j] = ai - by[j] * w;
    unsafe = unsafe || bx[j] == w - 1;  // tap a+1 wraps to the next row
    rmin = min(rmin, by[j]), rmax = max(rmax, by[j] + 1);
    cmin = min(cmin, bx[j]), cmax = max(cmax, bx[j] + 1);
  }
  const Box box = block_box(rmin, rmax, cmin, cmax, live != 0, unsafe, planes16, part);

  const uint8_t* planes[3] = {p0, p1, p2};
  uint8_t* dst = out + ((size_t)u.f0 * n + q0) * C;
  const size_t frame_out = (size_t)n * C;

  if (!box.staged) {
#pragma unroll 1
    for (int f = u.f0; f < u.f1; ++f, dst += frame_out) {
      uint32_t words[C] = {};  // the run's output bytes (put_byte)
      if (box.any_live) {
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          if (!((live >> j) & 1)) continue;
          const long long a = b[j];
          float wt[4];
          if ((odd >> j) & 1) wide(j, wt);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const uint8_t* src = planes[c] + (size_t)f * size;
            const uint32_t t0 = tap(src, a, size), t1 = tap(src, a + 1, size);
            const uint32_t t2 = tap(src, a + w, size), t3 = tap(src, a + w + 1, size);
            put_byte(words, j * C + c,
                     ((odd >> j) & 1) ? blend_f32(t0, t1, t2, t3, wt)
                                      : blend_integer(t0 | t1 << 8, t2 | t3 << 8, lo[j], hi[j]));
          }
        }
      }
      if (u.stores) store_words<C, WORDS>(dst, words, wo - u.c0);
    }
    return;
  }

  int s[kRun];  // tap 0's place in the box
#pragma unroll
  for (int j = 0; j < kRun; ++j) s[j] = (by[j] - box.rmin) * box.pitch + bx[j] - box.xa;
  staged_frames<C>(stage, planes, size, w, box, u.f0, u.f1, [&](int, const uint8_t* sb) {
    uint32_t words[C] = {};
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (!((live >> j) & 1)) continue;
      const uint8_t* top = sb + s[j];
      if ((odd >> j) & 1) {
        float wt[4];
        wide(j, wt);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const uint8_t* t = top + c * kStage;
          put_byte(words, j * C + c, blend_f32(t[0], t[1], t[box.pitch], t[box.pitch + 1], wt));
        }
        continue;
      }
      // pitch and kStage are multiples of 16: every tap row of the pixel
      // sits at the same place k in its word
      const uint32_t k = (uint32_t)s[j] & 3u;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint8_t* t = top + c * kStage;
        put_byte(words, j * C + c,
                 blend_integer(tap_pair(t, k), tap_pair(t + box.pitch, k), lo[j], hi[j]));
      }
    }
    if (u.stores) store_words<C, WORDS>(dst, words, wo - u.c0);
    dst += frame_out;
  });
}

// remap_fixed32_kernel, as isp_remap::dispatch takes it (the code last)
struct Fixed32Tiles {
  template <int C, bool WORDS>
  static isp_remap::KernelOf<const int16_t*> kernel() {
    return remap_fixed32_kernel<C, WORDS>;
  }
};

}  // namespace

// As isp_remap_float (remap_float.cu), with mode 0 (lerp: weights
// [cameras,] 6, N; code null) or 1 (fixed32: weights [cameras,] 4, N, and
// code [cameras,] N int16, ops/undistortion.remap_fixed32_code, or null:
// every pixel's weights read from `weights`). With v = 4 and a code, the
// code must be 8-byte aligned.
extern "C" int isp_remap_lerp(const void* p0, const void* p1, const void* p2, const void* base,
                              const void* weights, void* out, int cameras, int batch, int h,
                              int w, int ho, int wo, int channels, int v, int chunk, int planes16,
                              int mode, const void* code, void* stream) {
  if (mode == 1) {
    if (v == 4 && (uintptr_t)code % 8 != 0) return (int)cudaErrorInvalidValue;
    return isp_remap::dispatch<Fixed32Tiles>(p0, p1, p2, base, weights, out, cameras, batch, h,
                                             w, ho, wo, channels, v, chunk, planes16, stream,
                                             (const int16_t*)code);
  }
  if (mode != 0 || code) return (int)cudaErrorInvalidValue;
  return isp_remap::dispatch<LerpTiles>(p0, p1, p2, base, weights, out, cameras, batch, h, w, ho,
                                        wo, channels, v, chunk, planes16, stream);
}
