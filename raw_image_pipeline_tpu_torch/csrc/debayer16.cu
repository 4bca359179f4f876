// Kernel P: bilinear demosaic of 16-bit Bayer frames, the zero-padded
// stencil and cv::demosaicing's 1-pixel border replication of kernel A on
// 2-byte samples, written as planar BGR in one of two modes: u16 (the op
// layer's value) or u8, each value >> 8 (the chain's scale into its 8-bit
// stages; the shift follows the average, avg(x) >> 8 not avg(x >> 8)).
//
// Replaces: no TPU kernel. The JAX package leaves the 16-bit debayer to
// XLA: raw_image_pipeline_tpu/ops/debayer.py:327 `debayer_bilinear16`,
// with the chain's `>> 8` at raw_image_pipeline_tpu/pipeline.py:541-547.
// On the card the port ran it as about 35 eager torch launches over int32
// [B, 3, H, W] intermediates.
//
// What bounds it on the H100: device-memory bytes, two mosaic bytes read
// and three plane bytes written per pixel in u8 mode (six in u16 mode);
// two averages a pixel, as kernel A.
//
// Design: kernel A's strips (debayer_strip.cuh: a thread per 2 output rows
// by V columns, threads numbered along a row pair, the phase a template
// argument, the border rule of debayer.cu), with loads of its own for
// 2-byte samples: a strip row of V columns is 2V bytes, read as one
// 16-byte (V = 8) or 8-byte (V = 4) word, the halo columns the
// neighbouring lanes' edge samples by one shuffle each (a 32-bit word holds
// two columns), a warp's edge lanes reading theirs as one aligned 4-byte
// word. V is the wider of 8 and 4 columns that divides W and whose rows
// start on the words' alignment in the mosaic and in the output
// (ops/debayer.strip_width with the sample sizes), else 1 (2 columns,
// sample by sample). V = 16, two 16-byte loads a row, was slower at
// 1920x1080 (B = 4 and 64, both modes; PERF.md section 6), so the dispatch
// refuses it. The sums stay in int: a sum of four u16 values reaches
// 262 142, and every average lies in [0, 65535], so the plain version's
// clamp never binds. Odd sizes take no padded copy; H or W = 2
// runs the TWO instantiation, as A.

#include "debayer_strip.cuh"

namespace {

using isp_strip::kind_at;

// as debayer.cu: the stencil row (or column) whose value cv's border
// replication stores at output row r of a frame of n rows
template <bool TWO>
__device__ __forceinline__ int border_src(int r, int n) {
  return (TWO && n == 2) ? 1 - r : min(max(r, 1), n - 2);
}

// The V columns of a strip row as 32-bit words (two samples each).
template <int V>
__device__ __forceinline__ void load_words16(const uint16_t* p, uint32_t* wd) {
  if constexpr (V == 8) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    wd[0] = a.x, wd[1] = a.y, wd[2] = a.z, wd[3] = a.w;
  } else {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    wd[0] = a.x, wd[1] = a.y;
  }
}

// px[0 .. COLS + 2): mosaic row `row` at columns c0 - 1 .. c0 + COLS, each
// clamped to [0, w - 1] (only a row's first and last strips reach past
// it). Every lane of the warp must call it (the shuffles).
template <int V>
__device__ __forceinline__ void load_row16(const uint16_t* __restrict__ row, int c0, int w,
                                           bool first, bool last, int* px) {
  constexpr int COLS = isp_strip::cols<V>();
  if constexpr (V == 1) {
#pragma unroll
    for (int j = 0; j < COLS + 2; ++j) px[j] = __ldg(row + min(max(c0 - 1 + j, 0), w - 1));
  } else {
    constexpr int NW = V / 2;
    uint32_t wd[NW];
    load_words16<V>(row + c0, wd);
    const int lane = threadIdx.x & 31;
    uint32_t left = __shfl_up_sync(isp_strip::kFullMask, wd[NW - 1], 1);
    uint32_t right = __shfl_down_sync(isp_strip::kFullMask, wd[0], 1);
    if (first) {
      left = wd[0] << 16;  // column 0 in the high half
    } else if (lane == 0) {
      left = __ldg(reinterpret_cast<const unsigned int*>(row + c0 - 2));
    }
    if (last) {
      right = wd[NW - 1] >> 16;  // column w - 1 in the low half
    } else if (lane == 31) {
      right = __ldg(reinterpret_cast<const unsigned int*>(row + c0 + COLS));
    }
    px[0] = left >> 16;
    px[COLS + 1] = right & 0xffff;
#pragma unroll
    for (int j = 0; j < COLS; ++j) px[1 + j] = (wd[j >> 1] >> (16 * (j & 1))) & 0xffff;
  }
}

// One plane row of the strip, V columns (V = 8 or 4), from its values v.
template <int V, typename Out>
__device__ __forceinline__ void store_row(Out* dst, const int* v) {
  if constexpr (sizeof(Out) == 1) {
    uint32_t wd[V / 4];
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      wd[k] = isp_strip::pack4(v[4 * k] >> 8, v[4 * k + 1] >> 8, v[4 * k + 2] >> 8,
                               v[4 * k + 3] >> 8);
    }
    isp_strip::store_words<V>(dst, wd);
  } else {
    uint32_t wd[V / 2];
#pragma unroll
    for (int k = 0; k < V / 2; ++k) wd[k] = (uint32_t)v[2 * k] | ((uint32_t)v[2 * k + 1] << 16);
    // 16 bytes at V = 8, 8 at V = 4
    isp_strip::store_words<2 * V>(reinterpret_cast<uint8_t*>(dst), wd);
  }
}

// Out: uint8_t (each value >> 8) or uint16_t; TWO: H or W is 2
template <int KINDS, int V, typename Out, bool TWO>
__global__ void __launch_bounds__(isp_strip::kBlock)
    debayer_bilinear16_kernel(const uint16_t* __restrict__ in, Out* __restrict__ out, int h,
                              int w, int pairs, int nstrips) {
  constexpr int COLS = isp_strip::cols<V>();
  const isp_strip::Strip st = isp_strip::locate(pairs, nstrips, COLS);
  const size_t plane = (size_t)h * w;
  const uint16_t* f = in + blockIdx.y * plane;
  const int pr = st.r0 == h - 1 ? st.r0 - 2 : st.r0;
  const int pc = (V == 1 && st.c0 == w - 1) ? st.c0 - 2 : st.c0;

  int px[4][COLS + 2];  // rows pr-1 .. pr+2, columns pc-1 .. pc+COLS
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int row = min(max(pr - 1 + k, 0), h - 1);
    load_row16<V>(f + (size_t)row * w, pc, w, st.first, st.last, px[k]);
    if constexpr (TWO) {
      if (h == 2 && (k == 0 || k == 3)) {  // rows -1 and 2: the stencil's zero padding
#pragma unroll
        for (int j = 0; j < COLS + 2; ++j) px[k][j] = 0;
      }
      if (V == 1 && w == 2) px[k][0] = px[k][3] = 0;  // columns -1 and 2
    }
  }

  int o[2][3][COLS];  // the computed block: [row][B, G, R][column]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int x = px[i + 1][j + 1];
      const int n = px[i][j + 1], s = px[i + 2][j + 1];
      const int wv = px[i + 1][j], e = px[i + 1][j + 2];
      const int kind = kind_at<KINDS>(i, j);  // a constant once unrolled
      int bl, g, rd;
      if (kind == 0 || kind == 3) {  // R or B site
        const int d4 = (px[i][j] + px[i][j + 2] + px[i + 2][j] + px[i + 2][j + 2] + 2) >> 2;
        g = (n + s + wv + e + 2) >> 2;
        rd = kind == 0 ? x : d4;
        bl = kind == 0 ? d4 : x;
      } else {  // G site: R along the row in an R row, along the column in a B row
        const int h2 = (wv + e + 1) >> 1, v2 = (n + s + 1) >> 1;
        g = x;
        rd = kind == 1 ? h2 : v2;
        bl = kind == 1 ? v2 : h2;
      }
      o[i][0][j] = bl;
      o[i][1][j] = g;
      o[i][2][j] = rd;
    }
  }

  if (!st.active) return;
  Out* ob = out + blockIdx.y * 3 * plane;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = st.r0 + q;
    if (r >= h) break;
    const bool second = border_src<TWO>(r, h) > pr;  // which computed row
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Out* dst = ob + c * plane + (size_t)r * w + st.c0;
      int v[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) v[j] = second ? o[1][c][j] : o[0][c][j];
      if constexpr (V == 1) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const int col = st.c0 + j;
          const int val = border_src<TWO>(col, w) > pc ? v[1] : v[0];
          if (col < w) dst[j] = (Out)(sizeof(Out) == 1 ? val >> 8 : val);
        }
      } else {
        if (st.first) v[0] = v[1];
        if (st.last) v[COLS - 1] = v[COLS - 2];
        store_row<V>(dst, v);
      }
    }
  }
}

// The instantiation for the frame's mode and for H or W = 2.
template <int KINDS, int V>
int launch(const void* in, void* out, int batch, int h, int w, int out_bytes,
           cudaStream_t s) {
  constexpr int COLS = isp_strip::cols<V>();
  const int pairs = (h + 1) / 2, nstrips = (w + COLS - 1) / COLS;
  const dim3 grid = isp_strip::grid_for(batch, pairs, nstrips);
  const uint16_t* src = (const uint16_t*)in;
  const bool two = h == 2 || w == 2;
  if (out_bytes == 1) {
    auto kernel = two ? debayer_bilinear16_kernel<KINDS, V, uint8_t, true>
                      : debayer_bilinear16_kernel<KINDS, V, uint8_t, false>;
    kernel<<<grid, isp_strip::kBlock, 0, s>>>(src, (uint8_t*)out, h, w, pairs, nstrips);
  } else {
    auto kernel = two ? debayer_bilinear16_kernel<KINDS, V, uint16_t, true>
                      : debayer_bilinear16_kernel<KINDS, V, uint16_t, false>;
    kernel<<<grid, isp_strip::kBlock, 0, s>>>(src, (uint16_t*)out, h, w, pairs, nstrips);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// kinds: ops/debayer.phase_kinds(phase); v: ops/debayer.strip_width (in
// columns, with the sample sizes: 8, 4 or 1); out_bytes: 1 (u8 mode) or 2
// (u16 mode).
extern "C" int isp_debayer_bilinear16(const void* in, void* out, int batch, int h, int w,
                                      int kinds, int v, int out_bytes, void* stream) {
  if (out_bytes != 1 && out_bytes != 2) return (int)cudaErrorInvalidValue;
  return isp_strip::dispatch(kinds, v, [&](auto k, auto vc) -> int {
    constexpr int KINDS = decltype(k)::value, V = decltype(vc)::value;
    if constexpr (V == 16) {
      return (int)cudaErrorInvalidValue;  // a u16 strip row is at most one 16-byte word
    } else {
      return launch<KINDS, V>(in, out, batch, h, w, out_bytes, (cudaStream_t)stream);
    }
  });
}
