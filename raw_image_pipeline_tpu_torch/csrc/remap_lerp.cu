// Kernel F: the fisheye remap in "lerp" mode (the x86/IPP arithmetic, the
// chains' default) and in "fixed32" mode (OpenCV's non-IPP integer blend),
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
// Design: remap_tile.cuh's tiles (8 x 64 output pixels, a run of 4 a
// thread, the map loaded once for all frames, the tile's source box staged
// by cp.async one frame ahead, word stores). Fixed32 is a mode of that
// template, as kernel E; lerp has its own kernel over the same pieces
// (remap_lerp_kernel), which
// - holds a pixel's map as fx, fy and four mask bits;
// - selects a tap or 0 by its mask bit, which equals the plain product
//   tap * mask for masks 0 and 1, and reads no masked tap;
// - stages border tiles: the box covers the mask-1 taps only, which lie
//   inside the frame, so a tap past the border (mask 0) needs no byte;
// - forms the x-lerps' differences between taps biased by 2^23, and tests
//   for a half-integer in four operations (lerp_native).
//
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
// acc = ((t0*w0 + t1*w1) + t2*w2) + t3*w3 in __fmul_rn / __fadd_rn (exact
// integers for such weights), then sat_u8(floor((acc + 2^14) * 2^-15)).

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

// fixed32 mode: weights [4, N] integers scaled by 2^15, the taps at
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

}  // namespace

// As isp_remap_float (remap_float.cu), with mode 0 (lerp: weights
// [cameras,] 6, N) or 1 (fixed32: weights [cameras,] 4, N).
extern "C" int isp_remap_lerp(const void* p0, const void* p1, const void* p2, const void* base,
                              const void* weights, void* out, int cameras, int batch, int h,
                              int w, int ho, int wo, int channels, int v, int chunk, int planes16,
                              int mode, void* stream) {
  if (mode == 1) {
    return isp_remap::dispatch<isp_remap::Tiles<Fixed32Mode>>(
        p0, p1, p2, base, weights, out, cameras, batch, h, w, ho, wo, channels, v, chunk,
        planes16, stream);
  }
  if (mode != 0) return (int)cudaErrorInvalidValue;
  return isp_remap::dispatch<LerpTiles>(p0, p1, p2, base, weights, out, cameras, batch, h, w, ho,
                                        wo, channels, v, chunk, planes16, stream);
}
