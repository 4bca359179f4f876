// Kernel D: Malvar-He-Cutler 5x5 demosaic, the reference's CUDA algorithm
// (cv::cuda::demosaicing, *_MHT), equal to ops/debayer.debayer_mht.
//
// Replaces: raw_image_pipeline_tpu/ops/debayer_pallas.py `_mht_kernel`
// (line 229), reached through `debayer_mht_pallas` (line 295).
//
// What bounds it on the H100: device-memory bytes, one mosaic byte read and
// three plane bytes written per pixel. The 13 taps of the stencil are
// re-read by neighbouring threads and come from L1; the integer arithmetic
// (four x16 filters and their descale) is a few dozen operations a pixel.
//
// Design: one thread per output pixel, 32x8 threads per block over the
// frame, one grid z-slice per frame. Every tap is read at
// (clamp(r+dy,0,H-1), clamp(c+dx,0,W-1)): that clamp is the reference's
// cudaAddressModeClamp texture addressing, so no padded copy is made, any
// H x W >= 1 (odd included) works, and no border pass is needed. The phase
// of the output pixel (not of the clamped tap) picks the filters, as in the
// plain version. Filters are x16 integers; desc8 divides by 16 with
// round-half-even on an arithmetic shift (values may be negative).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int desc8(int v) {
  const int q = (v + 8) >> 4;
  return q - ((((v & 15) == 8) && ((q & 1) == 1)) ? 1 : 0);
}

__device__ __forceinline__ uint8_t sat_u8(int v) {
  return (uint8_t)min(max(v, 0), 255);
}

// kinds packs, for each parity cell (row&1)*2 + (col&1), which sample the
// mosaic holds there: 0 R site, 1 G in an R row, 2 G in a B row, 3 B site.
__global__ void debayer_mht_kernel(const uint8_t* __restrict__ in,
                                   uint8_t* __restrict__ out, int h, int w,
                                   int kinds) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const size_t plane = (size_t)h * w;
  const uint8_t* f = in + (size_t)blockIdx.z * plane;

  int row[5], col[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    row[k] = min(max(r + k - 2, 0), h - 1) * w;
    col[k] = min(max(c + k - 2, 0), w - 1);
  }
  // tap(dy, dx) = f[row[dy + 2] + col[dx + 2]]
#define TAP(dy, dx) ((int)__ldg(f + row[(dy) + 2] + col[(dx) + 2]))
  const int x = TAP(0, 0);
  const int n1 = TAP(-1, 0), s1 = TAP(1, 0), w1 = TAP(0, -1), e1 = TAP(0, 1);
  const int n2 = TAP(-2, 0), s2 = TAP(2, 0), w2 = TAP(0, -2), e2 = TAP(0, 2);
  const int diag4 = TAP(-1, -1) + TAP(-1, 1) + TAP(1, -1) + TAP(1, 1);
#undef TAP
  const int cross4 = n1 + s1 + w1 + e1;
  const int axial4 = n2 + s2 + w2 + e2;

  const int kind = (kinds >> (2 * (((r & 1) << 1) | (c & 1)))) & 3;
  int bl, g, rd;
  if (kind == 0 || kind == 3) {  // R or B site
    g = desc8(8 * x + 4 * cross4 - 2 * axial4);
    const int other = desc8(12 * x + 4 * diag4 - 3 * axial4);
    rd = kind == 0 ? x : other;
    bl = kind == 0 ? other : x;
  } else {  // G site: along the row and along the column
    const int hz = desc8(10 * x + 8 * (w1 + e1) - 2 * diag4 - 2 * (w2 + e2) + (n2 + s2));
    const int vt = desc8(10 * x + 8 * (n1 + s1) - 2 * diag4 - 2 * (n2 + s2) + (w2 + e2));
    g = x;
    rd = kind == 1 ? hz : vt;  // G in an R row: R is the row's neighbour
    bl = kind == 1 ? vt : hz;
  }
  uint8_t* o = out + (size_t)blockIdx.z * 3 * plane + (size_t)r * w + c;
  o[0] = sat_u8(bl);
  o[plane] = sat_u8(g);
  o[2 * plane] = sat_u8(rd);
}

}  // namespace

extern "C" int isp_debayer_mht(const void* in, void* out, int batch, int h,
                               int w, int kinds, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y,
                  batch);
  debayer_mht_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, h, w, kinds);
  return (int)cudaGetLastError();
}
