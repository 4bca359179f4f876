// The statistical white balances' pixel walk, shared by kernels K
// (wb_stats.cu) and L (wb_hist64.cu): a frame of three u8 planes as chunks
// of kChunk consecutive pixels of the flattened frame, each chunk loaded
// as one 16-byte word a plane where the planes allow it.
//
// A frame's pixel at flat position i = y * w + x lies at byte y * sy + x * sx
// of each plane. Where the rows are contiguous (sx == 1, sy == w) and the
// three planes share their address modulo 16, flat position i lies at byte
// i of each plane, and chunk c covers the 16-byte-aligned word
// [16c - head, 16c - head + 16) of flat positions, head being the frame's
// first byte's address modulo 16: the first and the last chunk may hold
// bytes outside the frame (never across a page, never counted). Any other
// strides take the general path, chunk c = flat positions [16c, 16c + 16),
// byte by byte. The positional rules (grey-world's 16-pixel SIMD body,
// learned's 8-lane rank) read the flat position, never a thread index.

#pragma once

#include <stdint.h>

namespace wbp {

constexpr int kChunk = 16;  // consecutive pixels a thread takes at once

struct Frame {
  const uint8_t* p[3];  // the frame's first byte of each plane
  long long sy, sx;     // row and column strides, in bytes
  int w;
  long long n;          // its pixels
  bool flat;            // the 16-byte path
  int head;             // flat: flat position 0's address modulo 16
  long long chunks;
};

__device__ __forceinline__ Frame frame_of(const uint8_t* b, const uint8_t* g, const uint8_t* r,
                                          long long sb, long long sy, long long sx, int h, int w,
                                          int f) {
  Frame fr;
  fr.p[0] = b + f * sb, fr.p[1] = g + f * sb, fr.p[2] = r + f * sb;
  fr.sy = sy, fr.sx = sx, fr.w = w;
  fr.n = (long long)h * w;
  const uintptr_t a = (uintptr_t)fr.p[0];
  fr.flat = sx == 1 && (sy == w || h == 1) && ((uintptr_t)fr.p[1] - a) % 16 == 0 &&
            ((uintptr_t)fr.p[2] - a) % 16 == 0;
  fr.head = fr.flat ? (int)(a % 16) : 0;
  fr.chunks = (fr.head + fr.n + kChunk - 1) / kChunk;
  return fr;
}

// a chunk's pixels: byte k of each plane in word k / 4 (byte k % 4), the
// flat position of byte 0, and a bit a byte inside the frame
struct Chunk {
  uint32_t v[3][4];
  long long pos0;
  uint32_t valid;
};

__device__ __forceinline__ int byte_at(const Chunk& ch, int plane, int k) {
  return (int)((ch.v[plane][k >> 2] >> (8 * (k & 3))) & 255u);
}

__device__ __forceinline__ void pixel_at(const Chunk& ch, int k, int& b, int& g, int& r) {
  b = byte_at(ch, 0, k), g = byte_at(ch, 1, k), r = byte_at(ch, 2, k);
}

__device__ __forceinline__ void load_chunk(const Frame& fr, long long c, Chunk& ch) {
  if (fr.flat) {
    ch.pos0 = c * kChunk - fr.head;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(fr.p[k] + ch.pos0));
      ch.v[k][0] = q.x, ch.v[k][1] = q.y, ch.v[k][2] = q.z, ch.v[k][3] = q.w;
    }
  } else {
    ch.pos0 = c * kChunk;
    int y = (int)(ch.pos0 / fr.w), x = (int)(ch.pos0 - (long long)y * fr.w);
#pragma unroll
    for (int k = 0; k < 3; ++k) ch.v[k][0] = ch.v[k][1] = ch.v[k][2] = ch.v[k][3] = 0u;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (ch.pos0 + j < fr.n) {
        const long long off = y * fr.sy + x * fr.sx;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          ch.v[k][j >> 2] |= (uint32_t)__ldg(fr.p[k] + off) << (8 * (j & 3));
        }
      }
      if (++x == fr.w) x = 0, ++y;
    }
  }
  const long long lo = ch.pos0 < 0 ? -ch.pos0 : 0;            // bytes before the frame
  const long long hi = fr.n - ch.pos0 < kChunk ? fr.n - ch.pos0 : kChunk;  // bytes up to its end
  ch.valid = hi <= lo ? 0u : ((1u << hi) - 1u) & ~((1u << lo) - 1u);
}

}  // namespace wbp
