// Output tiles of the fisheye remap, shared by kernel E (remap_float.cu,
// "float") and kernel F (remap_lerp.cu: "lerp" and "fixed32"): cv::remap
// (INTER_LINEAR, BORDER_CONSTANT=0) over remap_precompute's factors, one
// anchor index and a few weights per output pixel. remap_kernel runs kernel
// E's float mode, whose taps sit at base + {0, 1, w, w + 1} and whose blend
// a Mode (below) says. F's two modes each have a kernel of their own that
// holds its map in a form of its own (remap_lerp_kernel: fx, fy and four
// mask bits; remap_fixed32_kernel: an anchor and a compact weight code) and
// call the same pieces: a thread's run (run_of), the block's source box
// (block_box), the staged frames (staged_frames), the word stores
// (put_byte, store_words) and the C entry's checks and launch (dispatch,
// which passes a kernel's own trailing arguments on).
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
//   width 1), gathers from global
//   memory instead, a tap outside the plane reading 0; so does every tile
//   where W or a plane's address is not a multiple of 16 (no chain gives
//   such planes).
// - A pixel whose four weights are all zero (about 10% of a fisheye map)
//   is not gathered: its output is exactly 0 in every mode.
// - The run's 4C output bytes (C = 1 or 3 interleaved channels, a template
//   argument) are packed into C words as they are made and go out as C
//   4-byte words where the output's width and address allow it
//   (ops/undistortion.remap_run_width), else byte by byte. 16-byte words of
//   whole tile rows, through shared memory, were measured and were no
//   faster (kernel E, PERF.md section 6).
//
// A Mode of remap_kernel (AnchorTaps<Blend>: the taps at base + {0, 1, w,
// w + 1}) is a struct of:
//   kRows       weight rows a pixel (4);
//   kMinBlocks  resident blocks an SM (the registers a thread may hold);
//   blend(u0, u1, u2, u3, wt, j)  the output byte (in the low bits of the
//               result) from the four u8 taps of pixel j;
//   gather(plane, a, w, size, wt, j)  the same, the taps read from global
//               memory at a + {0, 1, w, w + 1}, a tap outside [0, size)
//               reading 0.

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

// A run's output bytes packed as they are made, byte i = j * C + c (pixel
// j, channel c) in byte i % 4 of word i / 4: C words live where the bytes
// of the 4C outputs would be. v's low byte is the byte.
template <int C>
__device__ __forceinline__ void put_byte(uint32_t (&words)[C], int i, uint32_t v) {
  const uint32_t sel = i % 4 == 0 ? 0x3214 : i % 4 == 1 ? 0x3240 : i % 4 == 2 ? 0x3410 : 0x4210;
  words[i / 4] = __byte_perm(words[i / 4], v, sel);  // i is a constant once unrolled
}

// the run's words to dst: as C 4-byte words (WORDS), else the first `left`
// pixels byte by byte
template <int C, bool WORDS>
__device__ __forceinline__ void store_words(uint8_t* dst, const uint32_t (&words)[C], int left) {
  if constexpr (WORDS) {
#pragma unroll
    for (int i = 0; i < C; ++i) reinterpret_cast<uint32_t*>(dst)[i] = words[i];
  } else {
#pragma unroll
    for (int i = 0; i < kRun * C; ++i) {
      if (i / C < left) dst[i] = (uint8_t)(words[i / 4] >> (8 * (i % 4)));
    }
  }
}

// A thread's run: output row r and first column c0, its place q0 = r * wo
// + c0 in a map of n = ho * wo pixels, whether it lies in the output
// (stores), and its block's frames [f0, f1): grid y's range of `chunk`
// frames within camera blockIdx.z's block of `batch`.
struct Run {
  int r, c0, f0, f1;
  long long n, q0;
  bool stores;
};

__device__ __forceinline__ Run run_of(int ho, int wo, int batch, int chunk) {
  const int t = threadIdx.x;
  const int tiles_x = (wo + kTileW - 1) / kTileW;
  Run u;
  u.r = (blockIdx.x / tiles_x) * kTileH + t / kRunsPerRow;
  u.c0 = (blockIdx.x % tiles_x) * kTileW + (t % kRunsPerRow) * kRun;
  u.n = (long long)ho * wo;
  u.q0 = (long long)u.r * wo + u.c0;
  u.stores = u.r < ho && u.c0 < wo;
  const int first = blockIdx.z * batch;  // this camera's first frame
  u.f0 = first + blockIdx.y * chunk;
  u.f1 = min(first + batch, u.f0 + chunk);
  return u;
}

// The block's source box, rows [rmin, rmin + rows) and columns [xa, xa +
// pitch) (pitch a multiple of 16), around every thread's bounds of its live
// taps (rmin, rmax, cmin, cmax: INT_MAX, -1 where it has none); whether a
// thread of the block is live; and whether the box is staged: W and the
// planes 16-byte aligned (planes16), a live pixel, no unsafe one and the
// box within kStage. Every thread of the block calls it.
struct Box {
  int rmin, xa, pitch, rows;
  bool any_live, staged;
};

__device__ __forceinline__ Box block_box(int rmin, int rmax, int cmin, int cmax, bool live,
                                         bool unsafe, bool planes16,
                                         int (&part)[4][kBlock / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  rmin = __reduce_min_sync(0xffffffffu, rmin);
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  cmin = __reduce_min_sync(0xffffffffu, cmin);
  cmax = __reduce_max_sync(0xffffffffu, cmax);
  if (lane == 0) {
    part[0][warp] = rmin, part[1][warp] = rmax, part[2][warp] = cmin, part[3][warp] = cmax;
  }
  Box x;
  x.any_live = __syncthreads_or(live);
  const bool any_unsafe = __syncthreads_or(unsafe);
#pragma unroll
  for (int i = 0; i < kBlock / 32; ++i) {
    rmin = min(rmin, part[0][i]), rmax = max(rmax, part[1][i]);
    cmin = min(cmin, part[2][i]), cmax = max(cmax, part[3][i]);
  }
  x.rmin = rmin;
  x.xa = cmin & ~15;
  x.pitch = ((cmax + 16) & ~15) - x.xa;
  x.rows = rmax - rmin + 1;
  x.staged = planes16 && x.any_live && !any_unsafe && (long long)x.rows * x.pitch <= kStage;
  return x;
}

// The frames [f0, f1) of a staged box: each frame's boxes of the C planes
// are copied into `stage` with 16-byte cp.async, one frame ahead, and
// blend(f, sb) runs once every thread's copies of frame f have landed (sb:
// the frame's buffer, plane c's box at sb + c * kStage, its row i at
// i * pitch).
template <int C, class Blend>
__device__ __forceinline__ void staged_frames(uint8_t (&stage)[kStages][C][kStage],
                                              const uint8_t* (&planes)[3], long long size,
                                              int w, const Box& box, int f0, int f1,
                                              Blend&& blend) {
  // this thread's part of a box: copy k is the 16 bytes at goff[k] of the
  // plane and soff[k] of the buffer
  const int t = threadIdx.x, per_row = box.pitch / 16;
  int goff[kChunks], soff[kChunks];
  bool has[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int i = t + k * kBlock;
    has[k] = i < box.rows * per_row;
    const int sr = has[k] ? i / per_row : 0, sc = has[k] ? i - sr * per_row : 0;
    goff[k] = has[k] ? (box.rmin + sr) * w + box.xa + 16 * sc : 0;
    soff[k] = sr * box.pitch + 16 * sc;
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
  for (int f = f0; f < f1; ++f) {
    const int buf = (f - f0) % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of frame f have landed
    // every thread's copies of frame f have landed, and every thread is done
    // with frame f - 1's buffer, which the next line refills
    __syncthreads();
    issue(f + kStages - 1, (f - f0 + kStages - 1) % kStages);
    blend(f, &stage[buf][0][0]);
  }
}

// The modes whose taps sit at base + {0, 1, w, w+1}, a tap outside the
// frame reading 0 (float: 4 weight rows, 72 registers):
// everything but Blend::blend, which gather reaches through the derived
// mode.
template <class Blend>
struct AnchorTaps {
  static constexpr int kRows = 4, kMinBlocks = 7;
  __device__ __forceinline__ static uint32_t gather(const uint8_t* __restrict__ src, long long a,
                                                    int w, long long size,
                                                    const float (&wt)[kRows][kRun], int j) {
    return Blend::blend(tap(src, a, size), tap(src, a + 1, size), tap(src, a + w, size),
                        tap(src, a + w + 1, size), wt, j);
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
  constexpr int R = Mode::kRows;
  __shared__ __align__(16) uint8_t stage[kStages][C][kStage];
  __shared__ int part[4][kBlock / 32];

  const Run u = run_of(ho, wo, batch, chunk);
  const long long n = u.n, q0 = u.q0;
  const long long size = (long long)h * w;
  base += blockIdx.z * n;  // this camera's map
  weights += blockIdx.z * R * n;

  // the run's map, once for all frames
  int b[kRun];
  float wt[R][kRun];
  if (WORDS && u.stores) {
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
      const bool in = u.r < ho && u.c0 + j < wo;
      b[j] = in ? __ldg(base + q0 + j) : 0;
#pragma unroll
      for (int k = 0; k < R; ++k) wt[k][j] = in ? __ldg(weights + k * n + q0 + j) : 0.0f;
    }
  }

  // live pixels and the bounding box of their taps in the source
  uint32_t live = 0;
  bool unsafe = false;
  int by[kRun], bx[kRun];
  int rmin = INT_MAX, rmax = -1, cmin = INT_MAX, cmax = -1;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    by[j] = bx[j] = 0;
    if (wt[0][j] != 0.0f || wt[1][j] != 0.0f || wt[2][j] != 0.0f || wt[3][j] != 0.0f) {
      live |= 1u << j;
      const long long a = b[j];  // tap 0
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
#pragma unroll
          for (int c = 0; c < C; ++c) {
            put_byte(words, j * C + c,
                     Mode::gather(planes[c] + (size_t)f * size, b[j], w, size, wt, j));
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
      const uint8_t* bottom = top + box.pitch;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        put_byte(words, j * C + c,
                 Mode::blend(top[c * kStage], top[c * kStage + 1], bottom[c * kStage],
                             bottom[c * kStage + 1], wt, j));
      }
    }
    if (u.stores) store_words<C, WORDS>(dst, words, wo - u.c0);
    dst += frame_out;
  });
}

// a kernel of remap_kernel's signature, followed by a kernel's own arguments
template <class... Extra>
using KernelOf = void (*)(const uint8_t*, const uint8_t*, const uint8_t*, const int32_t*,
                          const float*, uint8_t*, int, int, int, int, int, int, bool, Extra...);
using Kernel = KernelOf<>;

// remap_kernel of a Mode, as dispatch takes it
template <class Mode>
struct Tiles {
  template <int C, bool WORDS>
  static Kernel kernel() {
    return remap_kernel<Mode, C, WORDS>;
  }
};

// The C entry's checks and launch: channels 1 (p0 only) or 3 (p0, p1, p2
// interleaved into the output), v 4 (word stores) or 1 (byte stores), each
// through K::kernel<C, WORDS>(), which takes `extra` after planes16.
template <class K, class... Extra>
int dispatch(const void* p0, const void* p1, const void* p2, const void* base,
             const void* weights, void* out, int cameras, int batch, int h, int w, int ho, int wo,
             int channels, int v, int chunk, int planes16, void* stream, Extra... extra) {
  if (chunk < 1 || cameras < 1 || cameras > 65535 || (v != 1 && v != 4) ||
      (v == 4 && wo % 4 != 0) || (channels != 1 && channels != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles =
      (long long)((ho + kTileH - 1) / kTileH) * ((wo + kTileW - 1) / kTileW);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)((batch + chunk - 1) / chunk), (unsigned)cameras);
  const KernelOf<Extra...> kernel =
      channels == 1 ? (v == 4 ? K::template kernel<1, true>() : K::template kernel<1, false>())
                    : (v == 4 ? K::template kernel<3, true>() : K::template kernel<3, false>());
  kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)p0, (const uint8_t*)p1, (const uint8_t*)p2, (const int32_t*)base,
      (const float*)weights, (uint8_t*)out, batch, h, w, ho, wo, chunk, planes16 != 0, extra...);
  return (int)cudaGetLastError();
}

}  // namespace isp_remap
