// Output tiles of the fisheye remap, shared by kernel E (remap_float.cu,
// "float") and kernel F (remap_lerp.cu, "lerp" and "fixed32"): cv::remap
// (INTER_LINEAR, BORDER_CONSTANT=0) over remap_precompute's factors, one
// anchor index and a few weights per output pixel. The kernels differ only
// in the weights a pixel carries, where its four taps sit and how they are
// blended: a Mode (below) says so, and everything else is here.
//
// Design:
// - A block of 128 threads owns a tile of 8 x 64 output pixels and a
//   thread a run of 4 consecutive pixels of one tile row. The thread loads
//   its run's bases and weights once (16-byte vector loads) and keeps them
//   in registers, then loops over a range of frames [f0, f1) against that
//   one map; grid y splits the batch into such ranges only where the tiles
//   of one frame cannot fill the card (ops/undistortion.remap_frame_chunk).
// - Several cameras, each with its own map (the camera-blocked multicamera
//   chain): the batch is camera-major, `cameras` blocks of `batch` frames,
//   and base and weights are stacked [cameras, N] and [cameras, ROWS, N].
//   Grid z is the camera: a block offsets the map by its camera's N (ROWS*N
//   for the weights), reduces its source box from that camera's map, and
//   takes its frame range from that camera's block of frames. With one
//   camera the grid, the map and the frames are those of a single map.
// - The block reduces its live pixels' taps to one bounding box in the
//   source (a few bytes an output pixel on the fisheye maps) and copies
//   the box of each plane into shared memory with 16-byte cp.async, one
//   frame ahead of the frame it blends; the taps are then read from shared
//   memory. A tile whose box exceeds the buffer, or whose taps leave the
//   plane or wrap past a row's end (hostile maps, sources of height or
//   width 1, the lerp's pixels on the source's border), gathers from global
//   memory instead, each tap read by the mode's border rule; so does every
//   tile where W or a plane's address is not a multiple of 16 (no chain
//   gives such planes).
// - A pixel whose tap weights (Mode::kTapRow..+3) are all zero (about 10%
//   of a fisheye map) is not gathered: its output is exactly 0 in every
//   mode.
// - The run's 4C output bytes (C = 1 or 3 interleaved channels, a template
//   argument) go out as C 4-byte words where the output's width and
//   address allow it (ops/undistortion.remap_run_width), else byte by byte.
//   16-byte words of whole tile rows, through shared memory, were measured
//   and were no faster (kernel E, PERF.md section 6).
//
// A Mode is a struct of:
//   kRows       weight rows a pixel (4; the lerp's 6);
//   kTapRow     the first of the four rows whose zeros mark a pixel live
//               or not (0; the lerp's masks, 2);
//   kMinBlocks  resident blocks an SM (the registers a thread may hold);
//   origin(w)   tap 0's place below base (0; the lerp's pack margin w + 1):
//               the taps sit at base - origin + {0, 1, w, w + 1};
//   special(wt, j)  a flag of pixel j computed once for all frames;
//   blend(u0, u1, u2, u3, wt, j, special)  the output byte (in the low bits
//               of the result) from the four u8 taps of pixel j;
//   gather(plane, a, w, size, wt, j, special)  the same, the taps read from
//               global memory at a + {0, 1, w, w + 1} by the mode's rule for
//               taps outside [0, size).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace isp_remap {

constexpr int kBlock = 128;                 // threads per block
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

// a u8 tap as an exact f32: (2^23 + t) - 2^23
__device__ __forceinline__ float u8_to_f32(uint32_t t) {
  return __fsub_rn(__uint_as_float(0x4B000000u | t), kMagic);
}

// clamp(rint(acc), 0, 255) in the low byte of the result: adding 2^23 (whose
// ulp is 1) rounds half to even and leaves the byte in the low bits
__device__ __forceinline__ uint32_t to_u8_bits(float acc) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(acc, 0.0f), 255.0f), kMagic));
}

// plane[idx], 0 outside [0, size)
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

// The modes whose taps sit at base + {0, 1, w, w+1}, a tap outside the
// frame reading 0 (float and fixed32: 4 weight rows, 72 registers):
// everything but Blend::blend, which gather reaches through the derived
// mode.
template <class Blend>
struct AnchorTaps {
  static constexpr int kRows = 4, kTapRow = 0, kMinBlocks = 7;
  __device__ static constexpr long long origin(int) { return 0; }
  __device__ static constexpr bool special(const float (&)[kRows][kRun], int) { return false; }
  __device__ __forceinline__ static uint32_t gather(const uint8_t* __restrict__ src, long long a,
                                                    int w, long long size,
                                                    const float (&wt)[kRows][kRun], int j,
                                                    bool sp) {
    return Blend::blend(tap(src, a, size), tap(src, a + 1, size), tap(src, a + w, size),
                        tap(src, a + w + 1, size), wt, j, sp);
  }
};

// WORDS: Wo and the output's address are multiples of 4 and the map is
// 16-byte aligned; planes16: W and every plane's address are multiples of 16
// (else every tile gathers from global memory). batch: frames of one camera
// (blockIdx.z); base and weights: that camera's map at blockIdx.z * N.
template <class Mode, int C, bool WORDS>
__global__ void __launch_bounds__(kBlock, Mode::kMinBlocks)
    remap_kernel(const uint8_t* __restrict__ p0, const uint8_t* __restrict__ p1,
                 const uint8_t* __restrict__ p2, const int32_t* __restrict__ base,
                 const float* __restrict__ weights, uint8_t* __restrict__ out, int batch, int h,
                 int w, int ho, int wo, int chunk, bool planes16) {
  constexpr int R = Mode::kRows, T = Mode::kTapRow;
  __shared__ __align__(16) uint8_t stage[kStages][C][kStage];
  __shared__ int box[4][kBlock / 32];

  const int t = threadIdx.x;
  const int tiles_x = (wo + kTileW - 1) / kTileW;
  const int r = (blockIdx.x / tiles_x) * kTileH + t / kRunsPerRow;
  const int c0 = (blockIdx.x % tiles_x) * kTileW + (t % kRunsPerRow) * kRun;
  const long long n = (long long)ho * wo;
  const long long q0 = (long long)r * wo + c0;
  const long long size = (long long)h * w;
  base += blockIdx.z * n;  // this camera's map
  weights += blockIdx.z * R * n;

  // the run's map, once for all frames
  int b[kRun];
  float wt[R][kRun];
  if (WORDS && r < ho && c0 < wo) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(base + q0));
    b[0] = q.x, b[1] = q.y, b[2] = q.z, b[3] = q.w;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(weights + k * n + q0));
      wt[k][0] = f.x, wt[k][1] = f.y, wt[k][2] = f.z, wt[k][3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const bool in = r < ho && c0 + j < wo;
      b[j] = in ? __ldg(base + q0 + j) : 0;
#pragma unroll
      for (int k = 0; k < R; ++k) wt[k][j] = in ? __ldg(weights + k * n + q0 + j) : 0.0f;
    }
  }

  // live pixels, each one's flag, and the bounding box of their taps in the
  // source
  uint32_t live = 0, special = 0;
  bool unsafe = false;
  int by[kRun], bx[kRun];
  int rmin = INT_MAX, rmax = -1, cmin = INT_MAX, cmax = -1;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    by[j] = bx[j] = 0;
    if (wt[T][j] != 0.0f || wt[T + 1][j] != 0.0f || wt[T + 2][j] != 0.0f ||
        wt[T + 3][j] != 0.0f) {
      live |= 1u << j;
      if (Mode::special(wt, j)) special |= 1u << j;
      const long long a = (long long)b[j] - Mode::origin(w);  // tap 0
      if (a < 0 || a + w + 1 >= size) {
        unsafe = true;
      } else {
        const int ai = (int)a;
        by[j] = ai / w;
        bx[j] = ai - by[j] * w;
        unsafe = unsafe || bx[j] == w - 1;  // tap a+1 wraps to the next row
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
  const int first = blockIdx.z * batch;  // this camera's first frame
  const int f0 = first + blockIdx.y * chunk;
  const int f1 = min(first + batch, f0 + chunk);
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
          const long long a = (long long)b[j] - Mode::origin(w);
          const bool sp = (special >> j) & 1;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            px[j * C + c] = Mode::gather(planes[c] + (size_t)f * size, a, w, size, wt, j, sp);
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
      const bool sp = (special >> j) & 1;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        px[j * C + c] = Mode::blend(top[c * kStage], top[c * kStage + 1], bottom[c * kStage],
                                    bottom[c * kStage + 1], wt, j, sp);
      }
    }
    if (stores) store_run<C, WORDS>(dst, px, wo - c0);
  }
}

template <class Mode, int C, bool WORDS>
int launch(const void* p0, const void* p1, const void* p2, const void* base,
           const void* weights, void* out, int cameras, int batch, int h, int w, int ho, int wo,
           int chunk, bool planes16, cudaStream_t stream) {
  const long long tiles =
      (long long)((ho + kTileH - 1) / kTileH) * ((wo + kTileW - 1) / kTileW);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)((batch + chunk - 1) / chunk), (unsigned)cameras);
  remap_kernel<Mode, C, WORDS><<<grid, kBlock, 0, stream>>>(
      (const uint8_t*)p0, (const uint8_t*)p1, (const uint8_t*)p2, (const int32_t*)base,
      (const float*)weights, (uint8_t*)out, batch, h, w, ho, wo, chunk, planes16);
  return (int)cudaGetLastError();
}

// The C entry's checks and dispatch: channels 1 (p0 only) or 3 (p0, p1, p2
// interleaved into the output), v 4 (word stores) or 1 (byte stores).
template <class Mode>
int dispatch(const void* p0, const void* p1, const void* p2, const void* base,
             const void* weights, void* out, int cameras, int batch, int h, int w, int ho, int wo,
             int channels, int v, int chunk, int planes16, void* stream) {
  if (chunk < 1 || cameras < 1 || cameras > 65535 || (v != 1 && v != 4) ||
      (v == 4 && wo % 4 != 0) || (channels != 1 && channels != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const bool p16 = planes16 != 0;
  if (channels == 1) {
    return v == 4 ? launch<Mode, 1, true>(p0, p1, p2, base, weights, out, cameras, batch, h, w,
                                          ho, wo, chunk, p16, s)
                  : launch<Mode, 1, false>(p0, p1, p2, base, weights, out, cameras, batch, h, w,
                                           ho, wo, chunk, p16, s);
  }
  return v == 4 ? launch<Mode, 3, true>(p0, p1, p2, base, weights, out, cameras, batch, h, w, ho,
                                        wo, chunk, p16, s)
                : launch<Mode, 3, false>(p0, p1, p2, base, weights, out, cameras, batch, h, w,
                                         ho, wo, chunk, p16, s);
}

}  // namespace isp_remap
