// Row strips, shared by kernel A (debayer.cu) and kernel D (debayer_mht.cu).
//
// Each thread owns an output strip of 2 rows (an even/odd pair, aligned to
// the Bayer 2x2 cell) by COLS columns, COLS even, so the phase of every
// pixel of the strip is fixed by its place in the strip. Threads are
// numbered row pair by row pair and strip by strip, so neighbouring lanes
// of a warp hold neighbouring strips of one row pair (or the last strip of
// one pair and the first of the next, which never share a halo).
//
// V is the widest of 16, 8 and 4 bytes that divides the row width and the
// addresses of the mosaic and of the output (the wrapper's
// ops/debayer.strip_width), else 1. With V >= 4 a strip is V columns, each
// of its rows read and each plane row written as one V-byte word; the halo
// columns come from the neighbouring lanes' words by warp shuffles, and
// only a warp's edge lanes read theirs from memory. With V = 1 a strip is
// 2 columns read and written byte by byte, each column clamped.
//
// Shuffles, not a shared-memory tile: each input byte is then read from
// memory once (twice for the few halo words at a warp's edge), with no
// barrier and no shared memory, and the first build of this form met the
// targets set for both kernels (PERF.md), so the tile was not tried.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace isp_strip {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBlock = 128;  // threads per block, a multiple of the warp

template <int V>
__host__ __device__ constexpr int cols() {
  return V < 2 ? 2 : V;
}

struct Strip {
  int r0, c0;        // the strip's first output row (even) and column
  bool active;       // false: a lane past the frame's last strip
  bool first, last;  // the row's first / last strip
};

// The strip of this thread, for a frame of `pairs` row pairs and `nstrips`
// strips per row. Lanes past the end take the last strip (their loads stay
// inside the frame and they store nothing): every lane joins the shuffles.
__device__ __forceinline__ Strip locate(int pairs, int nstrips, int ncols) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = pairs * nstrips;
  const int u = min(t, total - 1);
  const int pair = u / nstrips;
  const int s = u - pair * nstrips;
  return Strip{2 * pair, s * ncols, t < total, s == 0, s == nstrips - 1};
}

template <int V>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t* wd) {
  if constexpr (V == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    wd[0] = q.x, wd[1] = q.y, wd[2] = q.z, wd[3] = q.w;
  } else if constexpr (V == 8) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    wd[0] = q.x, wd[1] = q.y;
  } else {
    wd[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

template <int V>
__device__ __forceinline__ void store_words(uint8_t* p, const uint32_t* wd) {
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  } else if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(wd[0], wd[1]);
  } else {
    *reinterpret_cast<unsigned int*>(p) = wd[0];
  }
}

// px[0 .. COLS + 2*HALO): mosaic row `row` at columns c0 - HALO ..
// c0 + COLS + HALO - 1, each column clamped to [0, w - 1] (only a row's
// first and last strips reach past it). HALO <= 4. Every lane of the warp
// must call it (the shuffles).
template <int V, int HALO>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ row, int c0, int w,
                                         bool first, bool last, int* px) {
  constexpr int COLS = cols<V>();
  if constexpr (V == 1) {
#pragma unroll
    for (int j = 0; j < COLS + 2 * HALO; ++j) {
      px[j] = __ldg(row + min(max(c0 - HALO + j, 0), w - 1));
    }
  } else {
    constexpr int NW = V / 4;
    uint32_t wd[NW];
    load_words<V>(row + c0, wd);
    const int lane = threadIdx.x & 31;
    uint32_t left = __shfl_up_sync(kFullMask, wd[NW - 1], 1);
    uint32_t right = __shfl_down_sync(kFullMask, wd[0], 1);
    if (first) {
      left = __byte_perm(wd[0], 0, 0x0000);  // column 0, four times
    } else if (lane == 0) {
      left = __ldg(reinterpret_cast<const unsigned int*>(row + c0 - 4));
    }
    if (last) {
      right = __byte_perm(wd[NW - 1], 0, 0x3333);  // column w - 1, four times
    } else if (lane == 31) {
      right = __ldg(reinterpret_cast<const unsigned int*>(row + c0 + COLS));
    }
#pragma unroll
    for (int k = 0; k < HALO; ++k) {
      px[HALO - 1 - k] = (left >> (24 - 8 * k)) & 255;
      px[HALO + COLS + k] = (right >> (8 * k)) & 255;
    }
#pragma unroll
    for (int j = 0; j < COLS; ++j) px[HALO + j] = (wd[j >> 2] >> (8 * (j & 3))) & 255;
  }
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)a | ((uint32_t)b << 8) | ((uint32_t)c << 16) | ((uint32_t)d << 24);
}

// The sample a parity cell holds under the packed phase table KINDS
// (ops/debayer.phase_kinds): 0 R site, 1 G in an R row, 2 G in a B row,
// 3 B site. With row and col known at compile time (unrolled loops over a
// strip) the compiler folds it to a constant.
template <int KINDS>
__host__ __device__ constexpr int kind_at(int row, int col) {
  return (KINDS >> (2 * (((row & 1) << 1) | (col & 1)))) & 3;
}

// The four phases' packed tables (rggb, grbg, gbrg, bggr), each an
// instantiation of the kernels.
constexpr int kKindsRGGB = 0xE4, kKindsGRBG = 0xB1, kKindsGBRG = 0x4E, kKindsBGGR = 0x1B;

// One thread per strip of each frame, the frame index on the grid's y.
inline dim3 grid_for(int batch, int pairs, int nstrips) {
  return dim3((unsigned)((pairs * nstrips + kBlock - 1) / kBlock), (unsigned)batch);
}

// f(kinds, v) with both as std::integral_constant: the instantiation for
// the runtime phase table and strip width, or cudaErrorInvalidValue where
// there is none.
template <typename F>
int dispatch(int kinds, int v, F&& f) {
  auto by_width = [&](auto k) -> int {
    switch (v) {
      case 16: return f(k, std::integral_constant<int, 16>());
      case 8: return f(k, std::integral_constant<int, 8>());
      case 4: return f(k, std::integral_constant<int, 4>());
      case 1: return f(k, std::integral_constant<int, 1>());
      default: return (int)cudaErrorInvalidValue;
    }
  };
  switch (kinds) {
    case kKindsRGGB: return by_width(std::integral_constant<int, kKindsRGGB>());
    case kKindsGRBG: return by_width(std::integral_constant<int, kKindsGRBG>());
    case kKindsGBRG: return by_width(std::integral_constant<int, kKindsGBRG>());
    case kKindsBGGR: return by_width(std::integral_constant<int, kKindsBGGR>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace isp_strip
