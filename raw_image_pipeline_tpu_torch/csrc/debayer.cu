// Kernel A: bilinear demosaic, bit-exact vs cv::demosaicing (COLOR_Bayer*2BGR).
//
// Replaces: raw_image_pipeline_tpu/ops/debayer_pallas.py `_kernel` (line 51),
// reached through `debayer_bilinear_pallas` (line 115).
//
// What bounds it on the H100: device-memory bytes, one mosaic byte read and
// three plane bytes written per pixel; its integer instructions come close
// (about 29 a pixel at V = 8, 18 of them on the integer ALU, by
// tools/sass_census.py: the taps' extraction and the outputs' packing
// outweigh the two averages). The first form (a thread per pixel, nine
// byte loads, a switch on the phase, three byte stores) was bound by its
// memory instructions instead, at 28% of the byte bound.
//
// Design (debayer_strip.cuh): a thread per output strip of 2 rows by V
// columns; its 4 input rows are read as V-byte words, the halo columns come
// from the neighbouring lanes by warp shuffles, and each plane row is
// written as one V-byte word (V = 16 at 1920 and 1440 wide, 8 at 1080). The
// phase is a template argument and a strip starts on an even row and
// column, so each pixel's formula is fixed at compile time: no per-pixel
// switch. The arithmetic stays in int, two averages a pixel.
//
// Borders: cv::demosaicing's replication, output (r, c) = the stencil at
// (clamp(r, 1, H-2), clamp(c, 1, W-2)) with that pixel's phase. A strip
// computes the 2 x COLS block at (pr, pc) and stores each output pixel from
// the block's pixel at its clamped position: row 0 takes the pair's second
// row, the last row of an even H the first; the last row of an odd H (a
// pair of its own) computes the pair above it (pr = r0 - 2) and takes its
// second row. Columns likewise (the first strip's column 0 from column 1,
// the last strip's last column from the one before; with V = 1 a last
// strip of one column computes the strip to its left). Taps past the
// frame are read clamped and feed only pixels that are not stored, so any
// H x W >= 3 (odd included) works without a padded copy.

#include "debayer_strip.cuh"

namespace {

using isp_strip::kind_at;

template <int KINDS, int V>
__global__ void __launch_bounds__(isp_strip::kBlock)
    debayer_bilinear_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h,
                            int w, int pairs, int nstrips) {
  constexpr int COLS = isp_strip::cols<V>();
  const isp_strip::Strip st = isp_strip::locate(pairs, nstrips, COLS);
  const size_t plane = (size_t)h * w;
  const uint8_t* f = in + blockIdx.y * plane;
  const int pr = st.r0 == h - 1 ? st.r0 - 2 : st.r0;
  const int pc = (V == 1 && st.c0 == w - 1) ? st.c0 - 2 : st.c0;

  int px[4][COLS + 2];  // rows pr-1 .. pr+2, columns pc-1 .. pc+COLS
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int row = min(max(pr - 1 + k, 0), h - 1);
    isp_strip::load_row<V, 1>(f + (size_t)row * w, pc, w, st.first, st.last, px[k]);
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
  uint8_t* ob = out + blockIdx.y * 3 * plane;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = st.r0 + q;
    if (r >= h) break;
    const bool second = min(max(r, 1), h - 2) > pr;  // which computed row
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint8_t* dst = ob + c * plane + (size_t)r * w + st.c0;
      int v[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) v[j] = second ? o[1][c][j] : o[0][c][j];
      if constexpr (V == 1) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const int col = st.c0 + j;
          if (col < w) dst[j] = (uint8_t)(min(max(col, 1), w - 2) > pc ? v[1] : v[0]);
        }
      } else {
        if (st.first) v[0] = v[1];
        if (st.last) v[COLS - 1] = v[COLS - 2];
        uint32_t wd[V / 4];
#pragma unroll
        for (int k = 0; k < V / 4; ++k) {
          wd[k] = isp_strip::pack4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
        }
        isp_strip::store_words<V>(dst, wd);
      }
    }
  }
}

}  // namespace

// kinds: ops/debayer.phase_kinds(phase); v: ops/debayer.strip_width.
extern "C" int isp_debayer_bilinear(const void* in, void* out, int batch, int h, int w,
                                    int kinds, int v, void* stream) {
  return isp_strip::dispatch(kinds, v, [&](auto k, auto vc) -> int {
    constexpr int KINDS = decltype(k)::value, V = decltype(vc)::value;
    constexpr int COLS = isp_strip::cols<V>();
    const int pairs = (h + 1) / 2, nstrips = (w + COLS - 1) / COLS;
    debayer_bilinear_kernel<KINDS, V>
        <<<isp_strip::grid_for(batch, pairs, nstrips), isp_strip::kBlock, 0,
           (cudaStream_t)stream>>>((const uint8_t*)in, (uint8_t*)out, h, w, pairs, nstrips);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* isp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
