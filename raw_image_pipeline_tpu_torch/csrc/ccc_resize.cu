// Kernel H: the CCC working resize, cv::resize's 8u INTER_LINEAR of up to
// three u8 planes [B, h, W] to [B, rows, dst_w] in one launch, bit-exact.
//
// Replaces: raw_image_pipeline_tpu/ops/resize.py `resize_linear_u8_plane`
// (line 192), which the reference package leaves to XLA (no Pallas); its
// plain versions here are ops/resize.py `resize_linear_u8_rows` (the slab
// form, which `resize_linear_u8_plane` calls). The chain runs it on the
// three debayered planes to 270x360 before kernel B.
//
// What it computes, per output pixel (x, y) and plane p, from the host
// tables (ops/resize.resize_table, int32: sx, sx2, a0, a1 for each output
// column; sy, sy2, b0, b1 for each output row of the slab, the rows counted
// from the slab's first source row):
//   S_k = p[sy_k][sx] * a0 + p[sy_k][sx2] * a1   (int32, no descale)
//   out = clamp((((b0 * (S_0 >> 4)) >> 16) + ((b1 * (S_1 >> 4)) >> 16) + 2) >> 2)
// the horizontal pass first: the truncating shifts do not commute. The
// coordinates are never recomputed here: they are f64 -> f32 products made
// on the host, and the vertical border's raw weights with clamped rows
// (ops/resize._tables_y) come with the table as they are.
//
// What bounds it on the H100: bytes, and few of them (at 1920x1080 -> 270x
// 360 a thread reads 4 source bytes of each plane; the planes' other bytes
// are never read). At B=4 the launch and the gathers' latency set its time.
// Design: one thread per output pixel and all planes (the tables read once
// for the three), blocks of 32 columns x 8 rows, the frame in the grid's z;
// strides in and out in elements, so a plane may be a view of an
// interleaved [..., H, W, 3] frame (the op layer's) and the output may be
// one ([..., rows, dst_w, 3], written in place).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int MAX_PLANES = 3;

struct Planes {
  const uint8_t* src[MAX_PLANES];
  uint8_t* dst[MAX_PLANES];
};

struct Strides {  // in elements
  long long frame, row, col;
};

__global__ void __launch_bounds__(TX * TY)
ccc_resize_kernel(Planes planes, int nplanes, const int* __restrict__ table, int dst_w, int rows,
                  Strides in, Strides out) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= dst_w || y >= rows) return;
  const long long frame = blockIdx.z;
  const int sx = table[x], sx2 = table[dst_w + x];
  const int a0 = table[2 * dst_w + x], a1 = table[3 * dst_w + x];
  const int* ty = table + 4 * dst_w;
  const int sy = ty[y], sy2 = ty[rows + y], b0 = ty[2 * rows + y], b1 = ty[3 * rows + y];
  const long long r0 = frame * in.frame + sy * in.row, r1 = frame * in.frame + sy2 * in.row;
  const long long c0 = sx * in.col, c1 = sx2 * in.col;
  const long long o = frame * out.frame + y * out.row + x * out.col;
#pragma unroll
  for (int p = 0; p < MAX_PLANES; ++p) {
    if (p < nplanes) {
      const uint8_t* f = planes.src[p];
      const int s0 = ((int)f[r0 + c0] * a0 + (int)f[r0 + c1] * a1) >> 4;
      const int s1 = ((int)f[r1 + c0] * a0 + (int)f[r1 + c1] * a1) >> 4;
      const int v = (((b0 * s0) >> 16) + ((b1 * s1) >> 16) + 2) >> 2;
      planes.dst[p][o] = (uint8_t)min(max(v, 0), 255);  // the clamp is a guard
    }
  }
}

}  // namespace

// src*, dst*: the first frame of each of nplanes (1-3) planes, all of one
// shape and strides (in elements: frame, row, column), unused ones null;
// table: int32 [4 * dst_w + 4 * rows] on the device (ops/resize.
// resize_table); batch: frames, at most 65535. Returns the launch's error.
extern "C" int isp_ccc_resize(const void* src0, const void* src1, const void* src2, void* dst0,
                              void* dst1, void* dst2, int nplanes, const void* table, int batch,
                              int dst_w, int rows, long long in_frame, long long in_row,
                              long long in_col, long long out_frame, long long out_row,
                              long long out_col, void* stream) {
  if (nplanes < 1 || nplanes > MAX_PLANES || batch > 65535) return (int)cudaErrorInvalidValue;
  if (batch == 0 || dst_w == 0 || rows == 0) return (int)cudaSuccess;
  Planes planes = {{(const uint8_t*)src0, (const uint8_t*)src1, (const uint8_t*)src2},
                   {(uint8_t*)dst0, (uint8_t*)dst1, (uint8_t*)dst2}};
  const dim3 grid((dst_w + TX - 1) / TX, (rows + TY - 1) / TY, batch);
  ccc_resize_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
      planes, nplanes, (const int*)table, dst_w, rows, Strides{in_frame, in_row, in_col},
      Strides{out_frame, out_row, out_col});
  return (int)cudaGetLastError();
}
