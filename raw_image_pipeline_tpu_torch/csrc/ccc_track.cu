// Kernel J: the CCC illuminant track and the gains. Measured peaks uv
// [R, 2] int32 in; the BGR gains [R, 3] f32 of the Kalman-filtered peaks
// and the new Kalman state out, in one launch.
//
// Replaces: raw_image_pipeline_tpu/ops/ccc.py `kalman_update` (line 511),
// `kalman_scan` (line 492) and `gains_from_uv` (line 425), which the
// reference package leaves to XLA (no Pallas); the plain versions are
// ops/ccc.py `kalman_update`, `kalman_scan` and `gains_from_uv_table`,
// composed as this kernel walks them in ops/ccc.py `track_plain`.
//
// Layout: one thread per track walks its `steps` frames in time order; the
// frame of track t at step s is row t * steps + s of uv, so one entry
// serves every mode without a copy: "cameras" (B tracks of one frame),
// "sequence" (one track of B frames; the mesh's gathered frames), the
// camera-blocked sequence (n_cameras tracks of cam_b frames) and no Kalman
// at all (x_in null: the gains of the measured peaks). The state of track
// t is element t * stride of x (pairs), p and initialized, each with its
// own stride: 0 where the field is one value for every track, as the plain
// form broadcasts it ("cameras" mode from a fresh state of shape () gives x
// a value per frame but keeps p and initialized one value, which every
// track computes alike; track 0 writes it).
//
// Arithmetic, as the plain form rounds it (nvcc contracts a*b + c into an
// fma by default, so every step is an explicit intrinsic):
//   p' = p + 1;  k = p' / (p' + 10);  x = x + k * (z - x);  p = (1 - k) * p'
// with the first measurement setting x = z and leaving p; the peak is
// trunc(x); the gains are exp_tab[x-peak] (r) and exp_tab[y-peak] (b), the
// served libm table (params.ccc_exp_tab), never the device's expf, each
// divided by min(g_b, 1, g_r) in IEEE division. A peak is clamped to
// [0, 255] before it indexes the table (the plain version's index is in
// range for every peak the chain makes).
//
// What bounds it: latency. The work is a few dozen operations a frame; a
// "sequence" track is a chain of dependent divisions, B of them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ int clamp_bin(int u) { return min(max(u, 0), 255); }

__global__ void __launch_bounds__(THREADS)
ccc_track_kernel(const int* __restrict__ uv, float* __restrict__ gains,
                 const float* __restrict__ exp_tab,
                 const float* __restrict__ x_in, const float* __restrict__ p_in,
                 const uint8_t* __restrict__ init_in, long long x_stride, long long p_stride,
                 long long init_stride, float* __restrict__ x_out, float* __restrict__ p_out,
                 uint8_t* __restrict__ init_out, long long p_out_stride,
                 long long init_out_stride, int tracks, int steps) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= tracks) return;
  const bool kalman = x_in != nullptr;
  float x0 = 0.f, x1 = 0.f, p = 0.f;
  bool init = false;
  if (kalman) {
    x0 = x_in[2 * t * x_stride];
    x1 = x_in[2 * t * x_stride + 1];
    p = p_in[t * p_stride];
    init = init_in[t * init_stride] != 0;
  }
  for (int step = 0; step < steps; ++step) {
    const long long row = (long long)t * steps + step;
    int u0 = uv[2 * row], u1 = uv[2 * row + 1];
    if (kalman) {
      const float z0 = (float)u0, z1 = (float)u1;
      if (init) {
        const float pp = __fadd_rn(p, 1.f);
        const float k = __fdiv_rn(pp, __fadd_rn(pp, 10.f));
        x0 = __fadd_rn(x0, __fmul_rn(k, __fsub_rn(z0, x0)));
        x1 = __fadd_rn(x1, __fmul_rn(k, __fsub_rn(z1, x1)));
        p = __fmul_rn(__fsub_rn(1.f, k), pp);
      } else {  // the first measurement: x = z, p as it was
        x0 = z0;
        x1 = z1;
      }
      init = true;
      u0 = __float2int_rz(x0);
      u1 = __float2int_rz(x1);
    }
    const float g_r = exp_tab[clamp_bin(u0)], g_b = exp_tab[clamp_bin(u1)];
    const float m = fminf(fminf(g_b, 1.f), g_r);
    gains[3 * row] = __fdiv_rn(g_b, m);
    gains[3 * row + 1] = __fdiv_rn(1.f, m);
    gains[3 * row + 2] = __fdiv_rn(g_r, m);
  }
  if (kalman) {
    x_out[2 * t] = x0;
    x_out[2 * t + 1] = x1;
    // a field of one value: every track computed it alike, track 0 writes it
    if (p_out_stride || t == 0) p_out[t * p_out_stride] = p;
    if (init_out_stride || t == 0) init_out[t * init_out_stride] = init ? 1 : 0;
  }
}

}  // namespace

// uv: [tracks * steps, 2] int32; gains: [tracks * steps, 3] f32; exp_tab:
// 256 f32; row t * steps + s is step s of track t. x_in ([.., 2] f32), p_in
// (f32), init_in (bool as bytes): the state, element t * (its stride) for
// track t, or all null (no Kalman);
// x_out: [tracks, 2]; p_out, init_out: [tracks] or one value (stride 0),
// written where x_in is given. Returns the launch's error.
extern "C" int isp_ccc_track(const void* uv, void* gains, const void* exp_tab,
                             const void* x_in, const void* p_in, const void* init_in,
                             long long x_stride, long long p_stride, long long init_stride,
                             void* x_out, void* p_out, void* init_out, long long p_out_stride,
                             long long init_out_stride, int tracks, int steps, void* stream) {
  if (tracks <= 0) return (int)cudaSuccess;
  ccc_track_kernel<<<(tracks + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)uv, (float*)gains, (const float*)exp_tab, (const float*)x_in,
      (const float*)p_in, (const uint8_t*)init_in, x_stride, p_stride, init_stride,
      (float*)x_out, (float*)p_out, (uint8_t*)init_out, p_out_stride, init_out_stride, tracks,
      steps);
  return (int)cudaGetLastError();
}
