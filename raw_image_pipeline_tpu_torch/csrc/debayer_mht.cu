// Kernel D: Malvar-He-Cutler 5x5 demosaic, the reference's CUDA algorithm
// (cv::cuda::demosaicing, *_MHT), equal to ops/debayer.debayer_mht_planar.
//
// Replaces: raw_image_pipeline_tpu/ops/debayer_pallas.py `_mht_kernel`
// (line 229), reached through `debayer_mht_pallas` (line 295).
//
// What bounds it on the H100: its integer instructions. Its function
// needs one mosaic byte read and three plane bytes written per pixel and
// 33.5 integer operations (tools/measure.DEBAYER_OPS_PER_PIXEL); the
// compiled strip spends about 48 instructions a pixel at V = 8, 26.5 of
// them on the integer ALU (tools/sass_census.py: the taps' extraction and
// the outputs' packing besides the filters), and at the 64 INT32 lanes of
// an SM those alone take longer than the bytes (PERF.md). The first form (a thread per
// pixel, 13 byte loads, a switch on the phase, three byte stores) was bound
// by its memory instructions, at 15% of the byte bound.
//
// Design (debayer_strip.cuh): a thread per output strip of 2 rows by V
// columns; its 6 input rows are read as V-byte words, the 2 halo columns on
// each side come from the neighbouring lanes by warp shuffles, and each
// plane row is written as one V-byte word. The phase is a template
// argument and a strip starts on an even row and column, so each pixel
// computes only the two filters its site needs (g_at_rb and rb_at_br at an
// R or B site, the row and column filters at a G site), chosen at compile
// time; the taps live in registers and the compiler shares sums such as
// w1+e1 between them.
//
// Borders: every tap is read at (clamp(r+dy, 0, H-1), clamp(c+dx, 0, W-1)),
// the reference's cudaAddressModeClamp texture addressing: the rows by
// clamped row indices, the columns by replicating column 0 and column W-1
// into the halo words of a row's first and last strips (with V = 1 each
// byte's column is clamped). The phase is the output pixel's. No padded
// copy is made and any H x W >= 1 (odd included) works. Filters are x16
// integers; desc8 divides by 16 with round-half-even on an arithmetic shift
// (values may be negative), and only the filters' results are clamped.

#include "debayer_strip.cuh"

namespace {

using isp_strip::kind_at;

// v / 16 rounded half to even: ops/debayer._desc8's (v + 8) >> 4, less one
// where v % 16 == 8 and the result is odd, in four instructions (equal for
// every |v| < 2^22; the filters stay within 2^13).
__device__ __forceinline__ int desc8(int v) { return (v + 7 + ((v >> 4) & 1)) >> 4; }

__device__ __forceinline__ int sat_u8(int v) { return min(max(v, 0), 255); }

template <int KINDS, int V>
__global__ void __launch_bounds__(isp_strip::kBlock)
    debayer_mht_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h, int w,
                       int pairs, int nstrips) {
  constexpr int COLS = isp_strip::cols<V>();
  const isp_strip::Strip st = isp_strip::locate(pairs, nstrips, COLS);
  const size_t plane = (size_t)h * w;
  const uint8_t* f = in + blockIdx.y * plane;

  int px[6][COLS + 4];  // rows r0-2 .. r0+3, columns c0-2 .. c0+COLS+1, clamped
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int row = min(max(st.r0 - 2 + k, 0), h - 1);
    isp_strip::load_row<V, 2>(f + (size_t)row * w, st.c0, w, st.first, st.last, px[k]);
  }
  if (!st.active) return;

  uint8_t* ob = out + blockIdx.y * 3 * plane;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = st.r0 + i;
    if (r >= h) break;
    int o[3][COLS];  // B, G, R
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
#define TAP(dy, dx) px[i + 2 + (dy)][j + 2 + (dx)]
      const int x = TAP(0, 0);
      const int ns1 = TAP(-1, 0) + TAP(1, 0), we1 = TAP(0, -1) + TAP(0, 1);
      const int ns2 = TAP(-2, 0) + TAP(2, 0), we2 = TAP(0, -2) + TAP(0, 2);
      const int diag4 = TAP(-1, -1) + TAP(-1, 1) + TAP(1, -1) + TAP(1, 1);
#undef TAP
      const int kind = kind_at<KINDS>(i, j);  // a constant once unrolled
      int bl, g, rd;  // x is a byte already: only the filters are clamped
      if (kind == 0 || kind == 3) {  // R or B site
        const int axial4 = ns2 + we2;
        g = sat_u8(desc8(8 * x + 4 * (ns1 + we1) - 2 * axial4));
        const int other = sat_u8(desc8(12 * x + 4 * diag4 - 3 * axial4));
        rd = kind == 0 ? x : other;
        bl = kind == 0 ? other : x;
      } else {  // G site: along the row and along the column
        const int hz = sat_u8(desc8(10 * x + 8 * we1 - 2 * diag4 - 2 * we2 + ns2));
        const int vt = sat_u8(desc8(10 * x + 8 * ns1 - 2 * diag4 - 2 * ns2 + we2));
        g = x;
        rd = kind == 1 ? hz : vt;  // G in an R row: R is the row's neighbour
        bl = kind == 1 ? vt : hz;
      }
      o[0][j] = bl;
      o[1][j] = g;
      o[2][j] = rd;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint8_t* dst = ob + c * plane + (size_t)r * w + st.c0;
      if constexpr (V == 1) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          if (st.c0 + j < w) dst[j] = (uint8_t)o[c][j];
        }
      } else {
        uint32_t wd[V / 4];
#pragma unroll
        for (int k = 0; k < V / 4; ++k) {
          wd[k] = isp_strip::pack4(o[c][4 * k], o[c][4 * k + 1], o[c][4 * k + 2], o[c][4 * k + 3]);
        }
        isp_strip::store_words<V>(dst, wd);
      }
    }
  }
}

}  // namespace

// kinds: ops/debayer.phase_kinds(phase); v: ops/debayer.strip_width.
extern "C" int isp_debayer_mht(const void* in, void* out, int batch, int h, int w, int kinds,
                               int v, void* stream) {
  return isp_strip::dispatch(kinds, v, [&](auto k, auto vc) -> int {
    constexpr int KINDS = decltype(k)::value, V = decltype(vc)::value;
    constexpr int COLS = isp_strip::cols<V>();
    const int pairs = (h + 1) / 2, nstrips = (w + COLS - 1) / COLS;
    debayer_mht_kernel<KINDS, V>
        <<<isp_strip::grid_for(batch, pairs, nstrips), isp_strip::kBlock, 0,
           (cudaStream_t)stream>>>((const uint8_t*)in, (uint8_t*)out, h, w, pairs, nstrips);
    return (int)cudaGetLastError();
  });
}
