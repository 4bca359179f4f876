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
// Design:
// - A block of 128 threads owns a tile of 8 x 64 output pixels and a
//   thread a run of 4 consecutive pixels of one tile row. The thread loads
//   its run's bases and weights once (16-byte vector loads) and keeps them
//   in registers, then loops over a range of frames [f0, f1) against that
//   one map; grid y splits the batch into such ranges only where the tiles
//   of one frame cannot fill the card (ops/undistortion.remap_frame_chunk).
// - The block reduces its live pixels' taps to one bounding box in the
//   source (a few bytes an output pixel on the fisheye maps) and copies
//   the box of each plane into shared memory with 16-byte cp.async, one
//   frame ahead of the frame it blends; the taps are then read from shared
//   memory. A tile whose box exceeds the buffer, or whose taps leave the
//   plane or wrap past a row's end (hostile maps, sources of height or
//   width 1), gathers from global memory instead, each tap checked; so does
//   every tile where W or a plane's address is not a multiple of 16 (no
//   chain gives such planes).
// - A pixel whose four weights are all zero (about 10% of a fisheye map) is
//   not gathered: its output is exactly 0 (+-0 * t sums to +-0, which rounds
//   and clamps to 0).
// - The run's 4C output bytes (C = 1 or 3 interleaved channels, a template
//   argument) go out as C 4-byte words where the output's width and
//   address allow it (ops/undistortion.remap_run_width), else byte by byte.
//   16-byte words of whole tile rows, through shared memory, were measured
//   and were no faster.
//
// Exactness: the taps sit at base + {0, 1, W, W+1}; a tap outside [0, H*W)
// reads 0. A u8 tap becomes an exact f32 as (2^23 + t) - 2^23. Products and
// sums are __fmul_rn / __fadd_rn in the reference order ((t0*w0 + t1*w1) +
// t2*w2) + t3*w3, so nvcc cannot contract them into fmas. The result is
// clamped to [0, 255] and rounded half to even by adding 2^23 (whose ulp is
// 1): that equals rintf then the clamp, and leaves the byte in the low bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kBlock = 128;                 // threads per block
constexpr int kMinBlocks = 7;               // resident blocks an SM (72 registers)
constexpr int kTileH = 8, kTileW = 64;      // output pixels of a block's tile
constexpr int kRun = 4;                     // consecutive pixels of a thread
constexpr int kRunsPerRow = kTileW / kRun;  // 16 threads a tile row
constexpr int kStage = 4096;                // bytes of one plane's box
constexpr int kStages = 2;                  // frames of boxes in shared memory
constexpr int kChunks = (kStage / 16 + kBlock - 1) / kBlock;  // 16-byte copies a thread
constexpr float kMagic = 8388608.0f;        // 2^23

// 16 bytes from global memory to the shared-memory address `smem`
__device__ __forceinline__ void cp_async16(unsigned smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ float u8_to_f32(uint32_t t) {
  return __fsub_rn(__uint_as_float(0x4B000000u | t), kMagic);
}

// clamp(rint(acc), 0, 255) in the low byte of the result
__device__ __forceinline__ uint32_t to_u8_bits(float acc) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(acc, 0.0f), 255.0f), kMagic));
}

__device__ __forceinline__ uint32_t blend(uint32_t u0, uint32_t u1, uint32_t u2, uint32_t u3,
                                          float w0, float w1, float w2, float w3) {
  float acc = __fadd_rn(__fmul_rn(u8_to_f32(u0), w0), __fmul_rn(u8_to_f32(u1), w1));
  acc = __fadd_rn(acc, __fmul_rn(u8_to_f32(u2), w2));
  acc = __fadd_rn(acc, __fmul_rn(u8_to_f32(u3), w3));
  return to_u8_bits(acc);
}

__device__ __forceinline__ uint32_t tap(const uint8_t* __restrict__ plane, long long idx,
                                        long long size) {
  return (idx >= 0 && idx < size) ? (uint32_t)__ldg(plane + idx) : 0u;
}

// the low bytes of a, b, c, d as one word, a lowest
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// A run's output bytes (the low byte of each px[], [pixel][channel]) to
// dst: as C 4-byte words (WORDS), else the first `left` pixels byte by byte.
template <int C, bool WORDS>
__device__ __forceinline__ void store_run(uint8_t* dst, const uint32_t* px, int left) {
  if constexpr (WORDS) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      reinterpret_cast<uint32_t*>(dst)[i] =
          pack4(px[4 * i], px[4 * i + 1], px[4 * i + 2], px[4 * i + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (j < left) {
#pragma unroll
        for (int c = 0; c < C; ++c) dst[j * C + c] = (uint8_t)px[j * C + c];
      }
    }
  }
}

// WORDS: Wo and the output's address are multiples of 4 and the map is
// 16-byte aligned; planes16: W and every plane's address are multiples of 16
// (else every tile gathers from global memory).
template <int C, bool WORDS>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    remap_float_kernel(const uint8_t* __restrict__ p0, const uint8_t* __restrict__ p1,
                       const uint8_t* __restrict__ p2, const int32_t* __restrict__ base,
                       const float* __restrict__ weights, uint8_t* __restrict__ out, int batch,
                       int h, int w, int ho, int wo, int chunk, bool planes16) {
  __shared__ __align__(16) uint8_t stage[kStages][C][kStage];
  __shared__ int box[4][kBlock / 32];

  const int t = threadIdx.x;
  const int tiles_x = (wo + kTileW - 1) / kTileW;
  const int r = (blockIdx.x / tiles_x) * kTileH + t / kRunsPerRow;
  const int c0 = (blockIdx.x % tiles_x) * kTileW + (t % kRunsPerRow) * kRun;
  const long long n = (long long)ho * wo;
  const long long q0 = (long long)r * wo + c0;
  const long long size = (long long)h * w;

  // the run's map, once for all frames
  int b[kRun];
  float wt[4][kRun];
  if (WORDS && r < ho && c0 < wo) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(base + q0));
    b[0] = q.x, b[1] = q.y, b[2] = q.z, b[3] = q.w;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(weights + k * n + q0));
      wt[k][0] = f.x, wt[k][1] = f.y, wt[k][2] = f.z, wt[k][3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const bool in = r < ho && c0 + j < wo;
      b[j] = in ? __ldg(base + q0 + j) : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) wt[k][j] = in ? __ldg(weights + k * n + q0 + j) : 0.0f;
    }
  }

  // live pixels, and the bounding box of their taps in the source
  uint32_t live = 0;
  bool unsafe = false;
  int by[kRun], bx[kRun];
  int rmin = INT_MAX, rmax = -1, cmin = INT_MAX, cmax = -1;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    by[j] = bx[j] = 0;
    if (wt[0][j] != 0.0f || wt[1][j] != 0.0f || wt[2][j] != 0.0f || wt[3][j] != 0.0f) {
      live |= 1u << j;
      if (b[j] < 0 || b[j] + (long long)w + 1 >= size) {
        unsafe = true;
      } else {
        by[j] = b[j] / w;
        bx[j] = b[j] - by[j] * w;
        unsafe = unsafe || bx[j] == w - 1;  // tap b+1 wraps to the next row
        rmin = min(rmin, by[j]), rmax = max(rmax, by[j] + 1);
        cmin = min(cmin, bx[j]), cmax = max(cmax, bx[j] + 1);
      }
    }
  }
  const int lane = t & 31, warp = t >> 5;
  rmin = __reduce_min_sync(0xffffffffu, rmin);
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  cmin = __reduce_min_sync(0xffffffffu, cmin);
  cmax = __reduce_max_sync(0xffffffffu, cmax);
  if (lane == 0) {
    box[0][warp] = rmin, box[1][warp] = rmax, box[2][warp] = cmin, box[3][warp] = cmax;
  }
  const bool any_live = __syncthreads_or(live != 0);
  const bool any_unsafe = __syncthreads_or(unsafe);
#pragma unroll
  for (int i = 0; i < kBlock / 32; ++i) {
    rmin = min(rmin, box[0][i]), rmax = max(rmax, box[1][i]);
    cmin = min(cmin, box[2][i]), cmax = max(cmax, box[3][i]);
  }
  const int xa = cmin & ~15;                   // the box's columns [xa, xa + pitch)
  const int pitch = ((cmax + 16) & ~15) - xa;  // a multiple of 16
  const int rows = rmax - rmin + 1;            // and its rows [rmin, rmax]
  const bool staged =
      planes16 && any_live && !any_unsafe && (long long)rows * pitch <= kStage;

  // this thread's part of a box: copy k is the 16 bytes at goff[k] of the
  // plane and soff[k] of the buffer
  int goff[kChunks], soff[kChunks];
  bool has[kChunks];
  const int per_row = staged ? pitch / 16 : 1;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int i = t + k * kBlock;
    has[k] = staged && i < rows * per_row;
    const int sr = has[k] ? i / per_row : 0, sc = has[k] ? i - sr * per_row : 0;
    goff[k] = has[k] ? (rmin + sr) * w + xa + 16 * sc : 0;
    soff[k] = sr * pitch + 16 * sc;
  }
  int s[kRun];  // tap 0's place in the box
#pragma unroll
  for (int j = 0; j < kRun; ++j) s[j] = staged ? (by[j] - rmin) * pitch + bx[j] - xa : 0;

  const uint8_t* planes[3] = {p0, p1, p2};
  const int f0 = blockIdx.y * chunk;
  const int f1 = min(batch, f0 + chunk);
  const bool stores = r < ho && c0 < wo;
  uint8_t* dst = out + ((size_t)f0 * n + q0) * C;
  const size_t frame_out = (size_t)n * C;

  if (!staged) {
#pragma unroll 1
    for (int f = f0; f < f1; ++f, dst += frame_out) {
      uint32_t px[kRun * C] = {};  // the run's output bytes, [pixel][channel]
      if (any_live) {
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          if (!((live >> j) & 1)) continue;
          const long long i0 = b[j];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const uint8_t* src = planes[c] + (size_t)f * size;
            px[j * C + c] = blend(tap(src, i0, size), tap(src, i0 + 1, size),
                                  tap(src, i0 + w, size), tap(src, i0 + w + 1, size), wt[0][j],
                                  wt[1][j], wt[2][j], wt[3][j]);
          }
        }
      }
      if (stores) store_run<C, WORDS>(dst, px, wo - c0);
    }
    return;
  }

  // frame f's boxes into stage[buf]: one cp.async group per call, empty past
  // the range
  const unsigned stage_at = (unsigned)__cvta_generic_to_shared(&stage[0][0][0]);
  auto issue = [&](int f, int buf) {
    if (f < f1) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint8_t* src = planes[c] + (size_t)f * size;
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          if (has[k]) cp_async16(stage_at + (buf * C + c) * kStage + soff[k], src + goff[k]);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(f0 + i, i);
#pragma unroll 1
  for (int f = f0; f < f1; ++f, dst += frame_out) {
    const int buf = (f - f0) % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of frame f have landed
    // every thread's copies of frame f have landed, and every thread is done
    // with frame f - 1's buffer, which the next line refills
    __syncthreads();
    issue(f + kStages - 1, (f - f0 + kStages - 1) % kStages);
    uint32_t px[kRun * C] = {};
    const uint8_t* sb = &stage[buf][0][0];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (!((live >> j) & 1)) continue;
      const uint8_t* top = sb + s[j];
      const uint8_t* bottom = top + pitch;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        px[j * C + c] = blend(top[c * kStage], top[c * kStage + 1], bottom[c * kStage],
                              bottom[c * kStage + 1], wt[0][j], wt[1][j], wt[2][j], wt[3][j]);
      }
    }
    if (stores) store_run<C, WORDS>(dst, px, wo - c0);
  }
}

template <int C, bool WORDS>
int launch(const void* p0, const void* p1, const void* p2, const void* base,
           const void* weights, void* out, int batch, int h, int w, int ho, int wo, int chunk,
           bool planes16, cudaStream_t stream) {
  const long long tiles =
      (long long)((ho + kTileH - 1) / kTileH) * ((wo + kTileW - 1) / kTileW);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)((batch + chunk - 1) / chunk));
  remap_float_kernel<C, WORDS><<<grid, kBlock, 0, stream>>>(
      (const uint8_t*)p0, (const uint8_t*)p1, (const uint8_t*)p2, (const int32_t*)base,
      (const float*)weights, (uint8_t*)out, batch, h, w, ho, wo, chunk, planes16);
  return (int)cudaGetLastError();
}

template <int C>
int by_width(bool words, const void* p0, const void* p1, const void* p2, const void* base,
             const void* weights, void* out, int batch, int h, int w, int ho, int wo, int chunk,
             bool planes16, cudaStream_t s) {
  return words ? launch<C, true>(p0, p1, p2, base, weights, out, batch, h, w, ho, wo, chunk,
                                 planes16, s)
               : launch<C, false>(p0, p1, p2, base, weights, out, batch, h, w, ho, wo, chunk,
                                  planes16, s);
}

}  // namespace

// channels: 1 (p0 only) or 3 (p0, p1, p2 interleaved into the output);
// v: ops/undistortion.remap_run_width (4: word stores, 1: byte stores);
// chunk: frames per grid row (ops/undistortion.remap_frame_chunk);
// planes16: w and every plane's address are multiples of 16, so that the
// tiles' source boxes can be copied into shared memory as 16-byte words
// (else every tile gathers from global memory).
extern "C" int isp_remap_float(const void* p0, const void* p1, const void* p2, const void* base,
                               const void* weights, void* out, int batch, int h, int w, int ho,
                               int wo, int channels, int v, int chunk, int planes16,
                               void* stream) {
  if (chunk < 1 || (v != 1 && v != 4) || (v == 4 && wo % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (channels) {
    case 1: return by_width<1>(v == 4, p0, p1, p2, base, weights, out, batch, h, w, ho, wo,
                               chunk, planes16 != 0, s);
    case 3: return by_width<3>(v == 4, p0, p1, p2, base, weights, out, batch, h, w, ho, wo,
                               chunk, planes16 != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
