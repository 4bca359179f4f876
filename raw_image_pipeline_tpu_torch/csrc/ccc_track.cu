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
// Layout: the frame of track t at step s is row t * steps + s of uv, so one
// entry serves every mode without a copy: "cameras" (B tracks of one
// frame), "sequence" (one track of B frames; the mesh's gathered frames),
// the camera-blocked sequence (n_cameras tracks of cam_b frames) and no
// Kalman at all (x_in null: the gains of the measured peaks). The state of
// track t is element t * stride of x (pairs), p and initialized, each with
// its own stride: 0 where the field is one value for every track, as the
// plain form broadcasts it ("cameras" mode from a fresh state of shape ()
// gives x a value per frame but keeps p and initialized one value, which
// every track computes alike; track 0 writes it).
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
// What bounds it: latency. A track is a serial chain, and the gains are a
// few operations a frame; the bytes are nanoseconds. So the design keeps
// the chain short and everything else off it:
//
//   * p does not depend on the data. Once a step gives p the bits it came
//     in with, every later step computes the same p' and k from the same
//     bits, and the same p again: the walker keeps k and runs only
//     x = x + k * (z - x) from then on (three dependent f32 operations a
//     coordinate, no division). This is exact, not an approximation: the
//     skipped operations would give the kept bits. The test compares bits
//     (a NaN repeats as bits though it never equals itself; +0 and -0
//     differ as bits, so a -0 p divides once more). From a fresh state p
//     repeats after 27 dividing steps, from every p >= 0 tried within 29,
//     from some negative p (near the map's other fixed point, -3.7016)
//     only after 55 (tests/test_torch_ccc_track.py).
//   * The dividing steps' gains k need only p, so the walker makes up to
//     PRECOMPUTED of them into shared memory before it walks; the walk
//     then takes them as it takes the kept one (past PRECOMPUTED without a
//     repeat it divides as it goes).
//   * The chain kernel ("sequence", the camera-blocked sequence, the
//     gathered peaks: more than one step a track) gives each track a block
//     of CHAIN_THREADS. Warp 0's lane 0 walks the track in registers,
//     reading each z from shared memory and writing x's bits back over it
//     (with the kept gain, KEEP_GROUP z at a time, loaded a group ahead).
//     Warps 1-3 (the helpers) stage the peaks by cp.async, TRACK_CHUNK
//     steps a stage in a ring of STAGES issued STAGES chunks ahead,
//     convert each landed stage to f32 in place and mark it on an mbarrier
//     ("full") that the walker waits on, so the walker neither waits on
//     global memory after the first stage nor converts; behind the walker
//     they turn each walked stage ("walked" mbarrier) into gains (the
//     truncation of x, the table, the divisions), a thread a word of the
//     [rows, 3] output (so a warp stores 128 consecutive bytes), and refill
//     the stage. Any number of steps: a stage walks min(TRACK_CHUNK, steps
//     left).
//   * The flat kernel (one step a track, "cameras" mode, or no Kalman: no
//     chain) gives each thread a row: its step, then the block's gains a
//     word a thread from the filtered peaks staged in shared memory.
//   * Both are launched as programmatic dependents of the kernel before
//     (in the chain, kernel I, the argmax that writes the peaks), so J's
//     launch and block set-up overlap that kernel's drain (I letting its
//     dependents launch early, once its own wait was over, made the range
//     no faster in turns: PERF.md, kernel J). griddepcontrol.wait comes
//     before J's first read of global memory: it is the only thing that
//     makes the kernel before's writes visible, and the peaks are that
//     kernel's output; the state and the table may be too, for a wrapper
//     makes a field contiguous by a copy kernel right before the launch
//     when it is not, and a caller may write the state just before. Reading
//     them early would save little: after the wait they go out with the
//     peaks' loads, and the dividing steps' gains are made while the first
//     stage lands. Where the kernel before is a torch op (the mesh's
//     GatherData, a copy), which never triggers its dependents, the launch
//     waits for it to end: plain stream order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FLAT_THREADS = 128;   // the flat kernel: a row a thread
constexpr int CHAIN_THREADS = 128;  // the chain kernel: warp 0 walks, warps 1-3 help
constexpr int HELPERS = CHAIN_THREADS - 32;
constexpr int TRACK_CHUNK = 512;  // steps a stage of the chain kernel holds
constexpr int STAGES = 3;         // stages in the ring
constexpr int KEEP_GROUP = 8;     // steps of the kept gain whose z the walker loads together
constexpr int PRECOMPUTED = 32;   // dividing steps whose gains the walker makes before walking
constexpr int HELPER_BARRIER = 1;  // the helpers' named barrier (0 is __syncthreads)

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ int clamp_bin(int u) { return min(max(u, 0), 255); }

// word c (0: b, 1: g, 2: r) of the gains of the filtered peak (u0, u1),
// from the table in shared memory
__device__ __forceinline__ float gain_word(int u0, int u1, int c, const float* tab) {
  const float g_r = tab[clamp_bin(u0)], g_b = tab[clamp_bin(u1)];
  const float m = fminf(fminf(g_b, 1.f), g_r);
  return __fdiv_rn(c == 0 ? g_b : (c == 1 ? 1.f : g_r), m);
}

// One track's filter in registers.
struct Walk {
  float x0, x1, p, k;
  bool init;   // a measurement was taken (the state's initialized)
  bool fixed;  // p has repeated: k is the kept gain

  // one step with the full arithmetic (p has not repeated yet)
  __device__ __forceinline__ void divide(float z0, float z1) {
    if (!init) {  // the first measurement: x = z, p as it was
      x0 = z0;
      x1 = z1;
      init = true;
      return;
    }
    const float pp = __fadd_rn(p, 1.f);
    k = __fdiv_rn(pp, __fadd_rn(pp, 10.f));
    x0 = __fadd_rn(x0, __fmul_rn(k, __fsub_rn(z0, x0)));
    x1 = __fadd_rn(x1, __fmul_rn(k, __fsub_rn(z1, x1)));
    const float pn = __fmul_rn(__fsub_rn(1.f, k), pp);
    fixed = __float_as_uint(pn) == __float_as_uint(p);
    p = pn;
  }
  // one step once p has repeated: the same k, the same p
  __device__ __forceinline__ void keep(float z0, float z1) {
    x0 = __fadd_rn(x0, __fmul_rn(k, __fsub_rn(z0, x0)));
    x1 = __fadd_rn(x1, __fmul_rn(k, __fsub_rn(z1, x1)));
  }
  __device__ __forceinline__ int2 peak() const {
    return make_int2(__float2int_rz(x0), __float2int_rz(x1));
  }
  // x's bits, which the chain kernel's walker leaves for the helpers to
  // truncate (the conversion stays off the walker's issue slots)
  __device__ __forceinline__ int2 bits() const {
    return make_int2(__float_as_int(x0), __float_as_int(x1));
  }
};

// the state's fields, in and out (x_in null: no Kalman)
struct State {
  const float* x_in;
  const float* p_in;
  const uint8_t* init_in;
  long long x_stride, p_stride, init_stride;
  float* x_out;
  float* p_out;
  uint8_t* init_out;
  long long p_out_stride, init_out_stride;

  __device__ __forceinline__ Walk load(long long t) const {
    Walk w;
    w.x0 = x_in[2 * t * x_stride];
    w.x1 = x_in[2 * t * x_stride + 1];
    w.p = p_in[t * p_stride];
    w.init = init_in[t * init_stride] != 0;
    w.k = 0.f;
    w.fixed = false;
    return w;
  }
  __device__ __forceinline__ void store(long long t, const Walk& w) const {
    x_out[2 * t] = w.x0;
    x_out[2 * t + 1] = w.x1;
    // a field of one value: every track computed it alike, track 0 writes it
    if (p_out_stride || t == 0) p_out[t * p_out_stride] = w.p;
    if (init_out_stride || t == 0) init_out[t * init_out_stride] = w.init ? 1 : 0;
  }
};

// the mbarrier and cp.async primitives of the chain kernel
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "wait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(HELPER_BARRIER), "n"(HELPERS) : "memory");
}

// grid (ceil(rows / FLAT_THREADS)): row r = blockIdx.x * FLAT_THREADS +
// threadIdx.x; with the filter, steps is 1 and row r is track r
__global__ void __launch_bounds__(FLAT_THREADS)
ccc_track_flat_kernel(const int* __restrict__ uv, float* __restrict__ gains,
                      const float* __restrict__ exp_tab, State st, long long rows) {
  __shared__ float tab[256];
  __shared__ int2 filtered[FLAT_THREADS];
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * FLAT_THREADS;
  const long long row = r0 + tid;
  grid_dependency_wait();
  for (int i = tid; i < 256; i += FLAT_THREADS) tab[i] = exp_tab[i];
  if (row < rows) {
    int2 u = make_int2(uv[2 * row], uv[2 * row + 1]);
    if (st.x_in != nullptr) {
      Walk w = st.load(row);
      w.divide((float)u.x, (float)u.y);
      st.store(row, w);
      u = w.peak();
    }
    filtered[tid] = u;
  }
  __syncthreads();
  const int n = (int)min((long long)FLAT_THREADS, rows - r0);
  for (int i = tid; i < 3 * n; i += FLAT_THREADS) {
    const int2 u = filtered[i / 3];
    gains[3 * r0 + i] = gain_word(u.x, u.y, i % 3, tab);
  }
}

// the gains k of the dividing steps from p alone (k = p' / (p' + 10) of
// each p along p = (1 - k) p'), at most PRECOMPUTED and `need` of them,
// into ks; *p_after: p after them; *repeated: whether the last one gave p
// the bits it came in with (its k is kept from there). Returns the count.
__device__ __forceinline__ int dividing_gains(float p, int need, float* ks, float* p_after,
                                              bool* repeated) {
  const int m = min(need, PRECOMPUTED);
  bool rep = false;
  int i = 0;
  while (i < m && !rep) {
    const float pp = __fadd_rn(p, 1.f);
    const float k = __fdiv_rn(pp, __fadd_rn(pp, 10.f));
    const float pn = __fmul_rn(__fsub_rn(1.f, k), pp);
    ks[i++] = k;
    rep = __float_as_uint(pn) == __float_as_uint(p);
    p = pn;
  }
  *p_after = p;
  *repeated = rep;
  return i;
}

__device__ __forceinline__ void wait_copies(int newer) {  // all but the `newer` groups landed
  if (newer >= 2) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (newer == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// grid (tracks): block t walks track t (rows t * steps ... + steps - 1)
__global__ void __launch_bounds__(CHAIN_THREADS)
ccc_track_chain_kernel(const int* __restrict__ uv, float* __restrict__ gains,
                       const float* __restrict__ exp_tab, State st, int steps) {
  __shared__ float tab[256];
  // a stage's z as f32 bits, then its walked x's; KEEP_GROUP past the end
  // for the walker's loads ahead, never used
  __shared__ __align__(16) int2 ring[STAGES][TRACK_CHUNK + KEEP_GROUP];
  __shared__ float ks[PRECOMPUTED];
  __shared__ __align__(8) uint64_t full[STAGES], walked[STAGES];
  const int tid = threadIdx.x;
  const long long t = blockIdx.x;
  const long long first = t * steps;  // the track's first row
  const int chunks = (steps + TRACK_CHUNK - 1) / TRACK_CHUNK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], HELPERS);  // every helper's part of the stage is in, as f32
      bar_init(&walked[s], 1);      // the walker is through the stage
    }
  }
  __syncthreads();
  grid_dependency_wait();

  if (tid < 32) {  // the walker warp: lane 0 walks
    if (tid != 0) return;
    Walk w = st.load(t);
    // the dividing steps' gains, made while the first stage lands
    float p_after;
    bool rep;
    const int m = dividing_gains(w.p, steps - (w.init ? 0 : 1), ks, &p_after, &rep);
    w.p = p_after;
    w.fixed = rep;
    int j = 0;  // the precomputed gains taken
    for (int c = 0; c < chunks; ++c) {
      const int b = c % STAGES;
      const int n = min(TRACK_CHUNK, steps - c * TRACK_CHUNK);
      int2* z = ring[b];  // each z replaced by the bits of its filtered x
      bar_wait(&full[b], (c / STAGES) & 1);
      int s = 0;
      if (!w.init && n > 0) {  // the first measurement: x = z, p as it was
        w.divide(__int_as_float(z[0].x), __int_as_float(z[0].y));
        z[0] = w.bits();
        s = 1;
      }
      for (; s < n && j < m; ++s, ++j) {  // the precomputed gains, the last one kept
        w.k = ks[j];
        w.keep(__int_as_float(z[s].x), __int_as_float(z[s].y));
        z[s] = w.bits();
      }
      for (; s < n && !w.fixed; ++s) {  // past PRECOMPUTED gains with no repeat yet
        w.divide(__int_as_float(z[s].x), __int_as_float(z[s].y));
        z[s] = w.bits();
      }
      if (s < n) {  // the kept gain: the next group's z loaded ahead of this group's steps
        int2 cur[KEEP_GROUP];
#pragma unroll
        for (int i = 0; i < KEEP_GROUP; ++i) cur[i] = z[s + i];
        for (; s + KEEP_GROUP <= n; s += KEEP_GROUP) {
          int2 next[KEEP_GROUP];
#pragma unroll
          for (int i = 0; i < KEEP_GROUP; ++i) next[i] = z[s + KEEP_GROUP + i];
#pragma unroll
          for (int i = 0; i < KEEP_GROUP; ++i) {
            w.keep(__int_as_float(cur[i].x), __int_as_float(cur[i].y));
            z[s + i] = w.bits();
            cur[i] = next[i];
          }
        }
        for (; s < n; ++s) {
          w.keep(__int_as_float(z[s].x), __int_as_float(z[s].y));
          z[s] = w.bits();
        }
      }
      bar_arrive(&walked[b]);
    }
    st.store(t, w);
    return;
  }

  // the helpers: stage the peaks ahead of the walker as f32, make the gains
  // behind it
  const int h = tid - 32;
  const int* src = uv + 2 * first;
  auto issue = [&](int c) {  // chunk c's peaks into its stage: one cp.async group
    const int n = 2 * min(TRACK_CHUNK, steps - c * TRACK_CHUNK);  // ints
    const int* from = src + 2LL * c * TRACK_CHUNK;
    int* to = reinterpret_cast<int*>(ring[c % STAGES]);
    for (int i = h; i < n; i += HELPERS) copy4(to + i, from + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto ready = [&](int c, int newer) {  // chunk c, landed, to f32 in place; full
    wait_copies(newer);
    const int n = 2 * min(TRACK_CHUNK, steps - c * TRACK_CHUNK);
    int* v = reinterpret_cast<int*>(ring[c % STAGES]);
    for (int i = h; i < n; i += HELPERS) v[i] = __float_as_int((float)v[i]);
    bar_arrive(&full[c % STAGES]);
  };
  int issued = min(STAGES, chunks);
  for (int c = 0; c < issued; ++c) issue(c);
  if (chunks) ready(0, issued - 1);
  for (int i = h; i < 256; i += HELPERS) tab[i] = exp_tab[i];
  helpers_sync();  // the table is in
  for (int c = 0; c < chunks; ++c) {
    const int b = c % STAGES;
    const int n = min(TRACK_CHUNK, steps - c * TRACK_CHUNK);
    float* out = gains + 3 * (first + (long long)c * TRACK_CHUNK);
    if (c + 1 < chunks) ready(c + 1, issued - (c + 2));  // the walker's next stage
    bar_wait(&walked[b], (c / STAGES) & 1);
    for (int i = h; i < 3 * n; i += HELPERS) {
      const int2 x = ring[b][i / 3];  // the walked x's bits
      out[i] = gain_word(__float2int_rz(__int_as_float(x.x)),
                         __float2int_rz(__int_as_float(x.y)), i % 3, tab);
    }
    if (c + STAGES < chunks) {
      helpers_sync();  // every helper is through the stage
      issue(c + STAGES);
      ++issued;
    }
  }
}

}  // namespace

// uv: [tracks * steps, 2] int32; gains: [tracks * steps, 3] f32; exp_tab:
// 256 f32; row t * steps + s is step s of track t. x_in ([.., 2] f32), p_in
// (f32), init_in (bool as bytes): the state, element t * (its stride) for
// track t, or all null (no Kalman);
// x_out: [tracks, 2]; p_out, init_out: [tracks] or one value (stride 0),
// written where x_in is given. One launch: the chain kernel where the
// filter walks more than one step a track (or none: the state passes
// through), else the flat kernel. Returns the launch's error.
extern "C" int isp_ccc_track(const void* uv, void* gains, const void* exp_tab,
                             const void* x_in, const void* p_in, const void* init_in,
                             long long x_stride, long long p_stride, long long init_stride,
                             void* x_out, void* p_out, void* init_out, long long p_out_stride,
                             long long init_out_stride, int tracks, int steps, void* stream) {
  if (tracks <= 0 || steps < 0) return (int)cudaSuccess;
  const State st = {(const float*)x_in, (const float*)p_in, (const uint8_t*)init_in,
                    x_stride, p_stride, init_stride, (float*)x_out, (float*)p_out,
                    (uint8_t*)init_out, p_out_stride, init_out_stride};
  const bool chain = x_in != nullptr && steps != 1;
  const long long rows = (long long)tracks * steps;
  if (!chain && rows == 0) return (int)cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.stream = (cudaStream_t)stream;
  cudaError_t err;
  if (chain) {
    cfg.gridDim = dim3((unsigned)tracks, 1, 1);
    cfg.blockDim = dim3(CHAIN_THREADS, 1, 1);
    err = cudaLaunchKernelEx(&cfg, ccc_track_chain_kernel, (const int*)uv, (float*)gains,
                             (const float*)exp_tab, st, steps);
  } else {
    const long long blocks = (rows + FLAT_THREADS - 1) / FLAT_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cfg.gridDim = dim3((unsigned)blocks, 1, 1);
    cfg.blockDim = dim3(FLAT_THREADS, 1, 1);
    err = cudaLaunchKernelEx(&cfg, ccc_track_flat_kernel, (const int*)uv, (float*)gains,
                             (const float*)exp_tab, st, rows);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

namespace {
// an empty block of the chain kernel's threads: its wait and nothing else
__global__ void __launch_bounds__(CHAIN_THREADS) ccc_track_empty_kernel() {
  grid_dependency_wait();
}
}  // namespace

// One block that waits and does nothing, launched as the kernels above are
// (a programmatic dependent of the kernel before, CHAIN_THREADS threads):
// its device time is the launch term of kernel J's latency floor
// (tools/measure.ccc_track_floor). It is not kernel J and is no launch of
// it. Returns the launch's error.
extern "C" int isp_ccc_track_empty(void* stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.stream = (cudaStream_t)stream;
  cfg.gridDim = dim3(1, 1, 1);
  cfg.blockDim = dim3(CHAIN_THREADS, 1, 1);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ccc_track_empty_kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
