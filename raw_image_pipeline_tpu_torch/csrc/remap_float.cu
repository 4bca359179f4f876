// Kernel E: the fisheye remap in "float" mode, cv::remap(INTER_LINEAR,
// BORDER_CONSTANT=0) with the plain two-rounding f32 blend, equal to
// ops/undistortion.remap_float_planes.
//
// Replaces: raw_image_pipeline_tpu/ops/remap_blend_pallas.py `_blend_kernel`
// (line 42), reached through `blend_rows_pallas` (line 70). On the TPU the
// blend ran over tap pairs that an XLA gather had packed; here the kernel
// gathers its own four taps straight from the three planes, so the pack is
// not made at all.
//
// What bounds it on the H100: device memory. Per output pixel and frame it
// reads 4 bytes of base and 16 of weights (shared by the frames, from L2
// after the first), gathers 4 taps from each of the 3 planes (neighbouring
// output pixels read neighbouring source pixels, so most come from L1/L2)
// and writes 3 bytes.
//
// Design: one thread per output pixel and frame (grid x over the Ho*Wo
// pixels, grid y over the frames); the thread writes the 3 channels of its
// pixel in [B, Ho, Wo, 3]. The taps sit at base + {0, 1, W, W+1}; a tap
// outside [0, H*W) reads 0, as the reference's zero-padded pack does for
// degenerate maps. Products and sums are __fmul_rn / __fadd_rn in the
// reference order ((t0*w0 + t1*w1) + t2*w2) + t3*w3, so nvcc cannot
// contract them into fmas; then rintf (half to even) and a clamp to
// [0, 255].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float tap(const uint8_t* __restrict__ plane,
                                     long long idx, long long size) {
  return (idx >= 0 && idx < size) ? (float)__ldg(plane + idx) : 0.0f;
}

__global__ void remap_float_kernel(const uint8_t* __restrict__ p0,
                                   const uint8_t* __restrict__ p1,
                                   const uint8_t* __restrict__ p2,
                                   const int32_t* __restrict__ base,
                                   const float* __restrict__ weights,
                                   uint8_t* __restrict__ out, int h, int w,
                                   int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int f = blockIdx.y;
  const long long size = (long long)h * w;
  const long long b0 = __ldg(base + i);
  const float w0 = __ldg(weights + i);
  const float w1 = __ldg(weights + n + i);
  const float w2 = __ldg(weights + 2 * n + i);
  const float w3 = __ldg(weights + 3 * n + i);
  const uint8_t* planes[3] = {p0, p1, p2};
  uint8_t* o = out + ((size_t)f * n + i) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const uint8_t* src = planes[ch] + (size_t)f * size;
    const float t0 = tap(src, b0, size);
    const float t1 = tap(src, b0 + 1, size);
    const float t2 = tap(src, b0 + w, size);
    const float t3 = tap(src, b0 + w + 1, size);
    float acc = __fadd_rn(__fmul_rn(t0, w0), __fmul_rn(t1, w1));
    acc = __fadd_rn(acc, __fmul_rn(t2, w2));
    acc = __fadd_rn(acc, __fmul_rn(t3, w3));
    o[ch] = (uint8_t)fminf(fmaxf(rintf(acc), 0.0f), 255.0f);
  }
}

}  // namespace

extern "C" int isp_remap_float(const void* p0, const void* p1, const void* p2,
                               const void* base, const void* weights,
                               void* out, int batch, int h, int w, int n,
                               void* stream) {
  const int threads = 256;
  const dim3 grid((n + threads - 1) / threads, batch);
  remap_float_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)p0, (const uint8_t*)p1, (const uint8_t*)p2,
      (const int32_t*)base, (const float*)weights, (uint8_t*)out, h, w, n);
  return (int)cudaGetLastError();
}
