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
// Design: remap_tile.cuh, shared with kernel E (remap_float.cu): 8 x 64
// output tiles, the map loaded once for all frames, the tile's source box
// staged by cp.async one frame ahead, word stores.
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
//   fma differ by at most one ulp and give the same byte unless the fma's
//   result lies within a few ulps of a half-integer (y * 2^-21 bounds four
//   ulps); there, a few values in a hundred thousand, the emulation's
//   result is taken.
// A pixel outside that domain (fx in (0, 2^-17), fy outside [0, 1), or a
// mask other than 0 or 1: no map of remap_precompute's but one with x in
// (0, 2^-17)) is blended by the emulation throughout. Every operation of
// the emulation is an __f*_rn intrinsic, so nvcc cannot contract it.
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

// lerp mode: weights [6, N] = (fx, fy, m00, m01, m10, m11), tap 0 at
// base - (w+1), taps clamped into the frame and multiplied by their masks
struct LerpMode {
  static constexpr int kRows = 6, kTapRow = 2;
  // 72 registers with 84 bytes spilled (C = 3): 7 blocks an SM measured
  // faster than 4, 5 and 6 (80 registers, 52 bytes spilled) and than 8
  static constexpr int kMinBlocks = 7;
  __device__ static long long origin(int w) { return (long long)w + 1; }

  // outside the domain where the fmas give the emulation's bytes
  __device__ __forceinline__ static bool special(const float (&wt)[kRows][kRun], int j) {
    const float fx = wt[0][j], fy = wt[1][j];
    bool native = (fx == 0.0f || (fx >= 0x1p-17f && fx < 1.0f)) && fy >= 0.0f && fy < 1.0f;
#pragma unroll
    for (int k = 2; k < 6; ++k) native = native && (wt[k][j] == 0.0f || wt[k][j] == 1.0f);
    return !native;
  }

  __device__ __forceinline__ static uint32_t blend(uint32_t u0, uint32_t u1, uint32_t u2,
                                                   uint32_t u3, const float (&wt)[kRows][kRun],
                                                   int j, bool sp) {
    const float fx = wt[0][j], fy = wt[1][j];
    const float v00 = __fmul_rn(u8_to_f32(u0), wt[2][j]);
    const float v01 = __fmul_rn(u8_to_f32(u1), wt[3][j]);
    const float v10 = __fmul_rn(u8_to_f32(u2), wt[4][j]);
    const float v11 = __fmul_rn(u8_to_f32(u3), wt[5][j]);
    float y;
    if (!sp) {
      const float t = __fmaf_rn(fx, __fsub_rn(v01, v00), v00);
      const float b = __fmaf_rn(fx, __fsub_rn(v11, v10), v10);
      const float d = __fsub_rn(b, t);
      y = __fmaf_rn(fy, d, t);
      // within four ulps of a half-integer (y in [0, 255], so y + 2^23
      // rounds it to the nearest integer r, and 0.5 - |y - r| is its
      // distance to the nearest half-integer), the byte is the emulation's
      const float r = __fsub_rn(__fadd_rn(y, isp_remap::kMagic), isp_remap::kMagic);
      if (__fsub_rn(0.5f, fabsf(__fsub_rn(y, r))) <= __fmul_rn(y, 0x1p-21f)) {
        y = fma_emulated(fy, d, t);
      }
    } else {
      const float t = lerp_x_emulated(fx, v00, v01);
      const float b = lerp_x_emulated(fx, v10, v11);
      y = fma_emulated(fy, __fsub_rn(b, t), t);
    }
    return to_u8_bits(y);
  }

  __device__ __forceinline__ static uint32_t gather(const uint8_t* __restrict__ src, long long a,
                                                    int w, long long size,
                                                    const float (&wt)[kRows][kRun], int j,
                                                    bool sp) {
    auto at = [&](long long i) {
      return (uint32_t)__ldg(src + (i < 0 ? 0 : (i >= size ? size - 1 : i)));
    };
    return blend(at(a), at(a + 1), at(a + w), at(a + w + 1), wt, j, sp);
  }
};

// fixed32 mode: weights [4, N] integers scaled by 2^15, the taps at
// base + {0, 1, w, w+1}, a tap outside the frame reads 0
struct Fixed32Mode : isp_remap::AnchorTaps<Fixed32Mode> {
  __device__ __forceinline__ static uint32_t blend(uint32_t u0, uint32_t u1, uint32_t u2,
                                                   uint32_t u3, const float (&wt)[kRows][kRun],
                                                   int j, bool) {
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
  switch (mode) {
    case 0: return isp_remap::dispatch<LerpMode>(p0, p1, p2, base, weights, out, cameras, batch,
                                                 h, w, ho, wo, channels, v, chunk, planes16,
                                                 stream);
    case 1: return isp_remap::dispatch<Fixed32Mode>(p0, p1, p2, base, weights, out, cameras,
                                                    batch, h, w, ho, wo, channels, v, chunk,
                                                    planes16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
