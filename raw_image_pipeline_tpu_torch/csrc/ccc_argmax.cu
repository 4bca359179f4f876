// Kernel I: the CCC response's first-occurrence argmax, [B, 256, 256] ->
// [B, 2] int32 (column, row), one block per frame, for a response of any
// dtype torch.argmax takes: f32 (the chain's), f64, f16, bf16, u8, i8,
// i16, i32, i64.
//
// Replaces: raw_image_pipeline_tpu/ops/ccc.py `response_argmax` (line
// 401), which the reference package leaves to XLA (no Pallas); its plain
// version is ops/ccc.py `response_argmax_plain` (torch.argmax).
//
// The rule (torch.argmax's and jnp.argmax's, cv::minMaxLoc's maxLoc on a
// finite response): the index of the largest value, the lowest index among
// equal values (so +0.0 and -0.0 tie and the first wins, and a frame of
// equal values gives 0); a NaN counts as larger than any number, and the
// first NaN wins. Each thread walks its elements in increasing index order
// and keeps the first best (a later element wins only if strictly better),
// then the block reduces (value, index) pairs with `better`, which breaks
// every tie by the lower index, so the order of the tree does not matter.
// Values are compared in their own type (f16 and bf16 widened to f32, the
// small integers to int: both exact, so the order is the type's own).
//
// What bounds it on the H100: bytes (256 KB a frame of f32, read once); at
// the chain's B=4 four blocks run, and the launch and one SM's read rate set
// its time. Design: 1024 threads a frame, 16-byte loads (or scalar loads
// for a frame off a 16-byte boundary), warp shuffles, then one warp over
// the 32 warps' results in shared memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 256 * 256;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

// the type a value is compared in (one __shfl_down_sync takes)
template <typename T> struct Cmp { using C = T; };
template <> struct Cmp<__half> { using C = float; };
template <> struct Cmp<__nv_bfloat16> { using C = float; };
template <> struct Cmp<uint8_t> { using C = int; };
template <> struct Cmp<int8_t> { using C = int; };
template <> struct Cmp<int16_t> { using C = int; };

template <typename T> __device__ __forceinline__ typename Cmp<T>::C widen(T v) {
  return (typename Cmp<T>::C)v;
}
template <> __device__ __forceinline__ float widen(__half v) { return __half2float(v); }
template <> __device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (v, i) is preferred to (w, j): NaN above every number, then the larger
// value, then (equal values, or two NaNs) the lower index; v != v is a NaN
// test (the flags keep IEEE comparisons) and false for an integer
template <typename C>
__device__ __forceinline__ bool better(C v, int i, C w, int j) {
  const bool vn = v != v, wn = w != w;
  if (vn || wn) return vn && (!wn || i < j);
  return v > w || (v == w && i < j);
}

template <typename C>
__device__ __forceinline__ void take(C v, int i, C& best, int& at) {
  if (better(v, i, best, at)) {
    best = v;
    at = i;
  }
}

template <typename C>
__device__ __forceinline__ void warp_reduce(C& best, int& at) {
#pragma unroll
  for (int d = 16; d > 0; d /= 2) {
    const C v = __shfl_down_sync(0xffffffffu, best, d);
    const int i = __shfl_down_sync(0xffffffffu, at, d);
    take(v, i, best, at);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
ccc_argmax_kernel(const T* __restrict__ resp, int* __restrict__ out) {
  using C = typename Cmp<T>::C;
  const T* r = resp + (size_t)blockIdx.x * N;
  const int t = threadIdx.x;
  C best;
  int at;
  if (VEC) {  // E values a 16-byte load, N / E loads a frame
    constexpr int E = 16 / sizeof(T);
    const uint4* r16 = reinterpret_cast<const uint4*>(r);
    union { uint4 q; T v[E]; } u;
    u.q = r16[t];
    best = widen(u.v[0]);
    at = E * t;
#pragma unroll
    for (int e = 1; e < E; ++e) take(widen(u.v[e]), E * t + e, best, at);
    for (int k = t + THREADS; k < N / E; k += THREADS) {
      u.q = r16[k];
#pragma unroll
      for (int e = 0; e < E; ++e) take(widen(u.v[e]), E * k + e, best, at);
    }
  } else {
    best = widen(r[t]);
    at = t;
#pragma unroll 4
    for (int k = t + THREADS; k < N; k += THREADS) take(widen(r[k]), k, best, at);
  }
  warp_reduce(best, at);
  __shared__ C s_best[WARPS];
  __shared__ int s_at[WARPS];
  if (t % 32 == 0) {
    s_best[t / 32] = best;
    s_at[t / 32] = at;
  }
  __syncthreads();
  if (t < 32) {
    best = s_best[t];
    at = s_at[t];
    warp_reduce(best, at);
    if (t == 0) {
      out[2 * blockIdx.x] = at % 256;      // x: the column
      out[2 * blockIdx.x + 1] = at / 256;  // y: the row
    }
  }
}

template <typename T>
int launch(const void* resp, void* uv, int batch, cudaStream_t stream) {
  if ((uintptr_t)resp % 16 == 0)
    ccc_argmax_kernel<T, true><<<batch, THREADS, 0, stream>>>((const T*)resp, (int*)uv);
  else
    ccc_argmax_kernel<T, false><<<batch, THREADS, 0, stream>>>((const T*)resp, (int*)uv);
  return (int)cudaGetLastError();
}

}  // namespace

// resp: [batch, 256, 256], contiguous, of the dtype `dtype` names (0 f32,
// 1 f64, 2 f16, 3 bf16, 4 u8, 5 i8, 6 i16, 7 i32, 8 i64; ops/ccc.
// ARGMAX_DTYPES); uv: [batch, 2] int32. Returns the launch's error.
extern "C" int isp_ccc_argmax(const void* resp, void* uv, int batch, int dtype, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(resp, uv, batch, s);
    case 1: return launch<double>(resp, uv, batch, s);
    case 2: return launch<__half>(resp, uv, batch, s);
    case 3: return launch<__nv_bfloat16>(resp, uv, batch, s);
    case 4: return launch<uint8_t>(resp, uv, batch, s);
    case 5: return launch<int8_t>(resp, uv, batch, s);
    case 6: return launch<int16_t>(resp, uv, batch, s);
    case 7: return launch<int32_t>(resp, uv, batch, s);
    case 8: return launch<long long>(resp, uv, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
