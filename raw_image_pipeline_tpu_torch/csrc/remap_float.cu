// Kernel E: the fisheye remap in "float" mode, cv::remap(INTER_LINEAR,
// BORDER_CONSTANT=0) with the plain two-rounding f32 blend, equal to
// ops/undistortion.remap_float_planes.
//
// Replaces: raw_image_pipeline_tpu/ops/remap_blend_pallas.py `_blend_kernel`
// (line 42), reached through `blend_rows_pallas` (line 70). On the TPU the
// blend ran over tap pairs that an XLA gather had packed; here the kernel
// gathers its own four taps, so the pack is not made at all.
//
// What bounds it on the H100 (PERF.md section 6): first the gathers' trips
// through the L1. A fisheye map bends output rows across source rows, so
// the 32 lanes of a warp, on 32 neighbouring output pixels, touch several
// source cache lines with every tap; gathering the 12 taps of a pixel
// straight from global memory held every thread-per-pixel and
// run-per-thread form near the first form's time at B=4, however the map
// and the stores were arranged. Staged in shared memory, a warp's gather
// costs about one wavefront. What is left (0.55 ms at B=64 1080p, 45% of
// the byte bound) is spread over the box copies, the blends and the
// stores: leaving out any one of them saved a tenth or so, and no change
// tried of the instruction count, the copies' depth, the tile's shape or
// the stores' width moved it by more than a few percent.
//
// Design: remap_tile.cuh, shared with kernel F (remap_lerp.cu).
//
// Exactness: the taps sit at base + {0, 1, W, W+1}; a tap outside [0, H*W)
// reads 0. A u8 tap becomes an exact f32 as (2^23 + t) - 2^23. Products and
// sums are __fmul_rn / __fadd_rn in the reference order ((t0*w0 + t1*w1) +
// t2*w2) + t3*w3, so nvcc cannot contract them into fmas. The result is
// clamped to [0, 255] and rounded half to even by adding 2^23 (whose ulp is
// 1): that equals rintf then the clamp, and leaves the byte in the low bits.

#include "remap_tile.cuh"

namespace {

using isp_remap::u8_to_f32;

// float mode: weights [4, N], the taps at base + {0, 1, w, w+1}, a tap
// outside the frame reads 0
struct FloatMode : isp_remap::AnchorTaps<FloatMode> {
  __device__ __forceinline__ static uint32_t blend(uint32_t u0, uint32_t u1, uint32_t u2,
                                                   uint32_t u3,
                                                   const float (&wt)[kRows][isp_remap::kRun],
                                                   int j) {
    float acc = __fadd_rn(__fmul_rn(u8_to_f32(u0), wt[0][j]), __fmul_rn(u8_to_f32(u1), wt[1][j]));
    acc = __fadd_rn(acc, __fmul_rn(u8_to_f32(u2), wt[2][j]));
    acc = __fadd_rn(acc, __fmul_rn(u8_to_f32(u3), wt[3][j]));
    return isp_remap::to_u8_bits(acc);
  }
};

}  // namespace

// cameras: maps stacked in base [cameras, N] and weights [cameras, 4, N],
// and the planes' frames camera-major, `batch` frames a camera (1: one map
// for all `batch` frames);
// channels: 1 (p0 only) or 3 (p0, p1, p2 interleaved into the output);
// v: ops/undistortion.remap_run_width (4: word stores, 1: byte stores);
// chunk: frames per grid row within a camera's block
// (ops/undistortion.remap_frame_chunk);
// planes16: w and every plane's address are multiples of 16, so that the
// tiles' source boxes can be copied into shared memory as 16-byte words
// (else every tile gathers from global memory).
extern "C" int isp_remap_float(const void* p0, const void* p1, const void* p2, const void* base,
                               const void* weights, void* out, int cameras, int batch, int h,
                               int w, int ho, int wo, int channels, int v, int chunk,
                               int planes16, void* stream) {
  return isp_remap::dispatch<isp_remap::Tiles<FloatMode>>(p0, p1, p2, base, weights, out, cameras,
                                                         batch, h, w, ho, wo, channels, v, chunk,
                                                         planes16, stream);
}
