// Kernel I: the CCC response's first-occurrence argmax, [B, 256, 256] ->
// [B, 2] int32 (column, row), one thread-block cluster per frame, for a
// response of any dtype torch.argmax takes: f32 (the chain's), f64, f16,
// bf16, u8, i8, i16, i32, i64.
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
// then the block and the cluster reduce (value, index) pairs with `better`,
// which breaks every tie by the lower index, so the order of the tree does
// not matter. Values are compared in their own type (f16 and bf16 widened
// to f32, the small integers to int: both exact, so the order is the
// type's own).
//
// What bounds it on the H100: bytes (256 KB a frame of f32, read once). A
// block a frame reads at one SM's rate, so at the chain's B=4 only 4 of 132
// SMs would stream. Design: a cluster of CLUSTER blocks a frame (ops/ccc.
// argmax_cluster picks it from the batch and the SM count: B x CLUSTER
// within half the SMs, or 2 where that gives 1 and B x 2 fits them; 16 at
// B <= 4 as a non-portable cluster, 1 once B fills the card); block r
// walks the r-th 1/CLUSTER slice of the frame with
// 16-byte loads (or scalar loads for a frame off a 16-byte boundary),
// reduces by warp shuffles and one warp over the warps' results, and
// stores its pair into rank 0's shared memory (distributed shared memory).
// After cluster.sync() rank 0's first warp combines the CLUSTER pairs (a
// relaxed cluster arrive at the start, waited on before the remote store,
// makes sure rank 0 has started before it is written to).
// One launch, no workspace, no atomics. A thread whose share of the slice
// is empty (u8 at large clusters) holds the sentinel (lowest value, index
// N), which every element beats.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int N = 256 * 256;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;  // above 8 a non-portable cluster size

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

// the sentinel's value: no element is below it
template <typename C> __device__ __forceinline__ C lowest();
template <> __device__ __forceinline__ float lowest() { return -__int_as_float(0x7f800000); }
template <> __device__ __forceinline__ double lowest() {
  return -__longlong_as_double(0x7ff0000000000000LL);
}
template <> __device__ __forceinline__ int lowest() { return INT_MIN; }
template <> __device__ __forceinline__ long long lowest() { return LLONG_MIN; }

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

// the cluster barrier in two halves: a block's shared memory may be
// written by another block only once the block has started, so every
// thread arrives first thing and waits before the first remote store
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// grid (cluster, batch), cluster dims (cluster, 1, 1): block rank r of
// frame blockIdx.y walks elements [r, r + 1) * N / cluster
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
ccc_argmax_kernel(const T* __restrict__ resp, int* __restrict__ out) {
  using C = typename Cmp<T>::C;
  __shared__ C s_best[WARPS];
  __shared__ int s_at[WARPS];
  __shared__ C c_best[MAX_CLUSTER];  // rank 0's: each rank's pair
  __shared__ int c_at[MAX_CLUSTER];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)gridDim.x;  // the cluster: the grid's x is one frame's
  const int slice = N / ranks;
  const int first = rank * slice;  // the slice's first index in the frame
  const T* r = resp + (size_t)blockIdx.y * N + first;
  const int t = threadIdx.x;
  cluster_arrive_relaxed();
  // launched as a programmatic dependent of the kernel before (the
  // response's last stage): the response is read only from here on
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  C best = lowest<C>();
  int at = N;
  if (VEC) {  // E values a 16-byte load, slice / E loads a block
    constexpr int E = 16 / sizeof(T);
    const uint4* r16 = reinterpret_cast<const uint4*>(r);
    union { uint4 q; T v[E]; } u;
#pragma unroll 4
    for (int k = t; k < slice / E; k += THREADS) {
      u.q = r16[k];
#pragma unroll
      for (int e = 0; e < E; ++e) take(widen(u.v[e]), first + E * k + e, best, at);
    }
  } else {
#pragma unroll 4
    for (int k = t; k < slice; k += THREADS) take(widen(r[k]), first + k, best, at);
  }
  warp_reduce(best, at);
  if (t % 32 == 0) {
    s_best[t / 32] = best;
    s_at[t / 32] = at;
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  if (t < 32) {
    best = s_best[t];
    at = s_at[t];
    warp_reduce(best, at);
    if (t == 0) {  // this block's pair into rank 0's shared memory
      *cluster.map_shared_rank(c_best + rank, 0) = best;
      *cluster.map_shared_rank(c_at + rank, 0) = at;
    }
  }
  cluster.sync();  // every rank's pair has arrived; rank 0 reads only its own memory
  if (rank == 0 && t < 32) {
    best = t < ranks ? c_best[t] : lowest<C>();
    at = t < ranks ? c_at[t] : N;
    warp_reduce(best, at);
    if (t == 0) {
      out[2 * blockIdx.y] = at % 256;      // x: the column
      out[2 * blockIdx.y + 1] = at / 256;  // y: the row
    }
  }
}

template <typename T, bool VEC>
cudaError_t configure(int cluster) {
  // a cluster above 8 needs the non-portable attribute, set once per device
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || cluster <= 8 || (dev < 64 && allowed[dev])) return err;
  err = cudaFuncSetAttribute(ccc_argmax_kernel<T, VEC>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  return err;
}

cudaLaunchConfig_t config(int cluster, int batch, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

template <typename T>
int launch(const void* resp, void* uv, int batch, int cluster, cudaStream_t stream) {
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = config(cluster, batch, stream, attr);
  cudaError_t err;
  if ((uintptr_t)resp % 16 == 0) {
    err = configure<T, true>(cluster);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, ccc_argmax_kernel<T, true>, (const T*)resp, (int*)uv);
  } else {
    err = configure<T, false>(cluster);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, ccc_argmax_kernel<T, false>, (const T*)resp, (int*)uv);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the largest cluster size of 16, 8, ... 1 of which one cluster can be
// resident on the current device
template <typename T>
int largest(int vec, int* size) {
  for (int c = MAX_CLUSTER; c > 1; c /= 2) {
    cudaError_t err = vec ? configure<T, true>(c) : configure<T, false>(c);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = config(c, 1, 0, attr);
    int clusters = 0;
    err = vec ? cudaOccupancyMaxActiveClusters(&clusters, ccc_argmax_kernel<T, true>, &cfg)
              : cudaOccupancyMaxActiveClusters(&clusters, ccc_argmax_kernel<T, false>, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters > 0) {
      *size = c;
      return (int)cudaSuccess;
    }
  }
  *size = 1;
  return (int)cudaSuccess;
}

}  // namespace

// resp: [batch, 256, 256], contiguous, of the dtype `dtype` names (0 f32,
// 1 f64, 2 f16, 3 bf16, 4 u8, 5 i8, 6 i16, 7 i32, 8 i64; ops/ccc.
// ARGMAX_DTYPES); uv: [batch, 2] int32; cluster: blocks a frame, 1, 2, 4,
// 8 or 16 (ops/ccc.argmax_cluster). Returns the launch's error.
extern "C" int isp_ccc_argmax(const void* resp, void* uv, int batch, int dtype, int cluster,
                              void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(resp, uv, batch, cluster, s);
    case 1: return launch<double>(resp, uv, batch, cluster, s);
    case 2: return launch<__half>(resp, uv, batch, cluster, s);
    case 3: return launch<__nv_bfloat16>(resp, uv, batch, cluster, s);
    case 4: return launch<uint8_t>(resp, uv, batch, cluster, s);
    case 5: return launch<int8_t>(resp, uv, batch, cluster, s);
    case 6: return launch<int16_t>(resp, uv, batch, cluster, s);
    case 7: return launch<int32_t>(resp, uv, batch, cluster, s);
    case 8: return launch<long long>(resp, uv, batch, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// *size: the largest cluster of 16, 8, ... 1 blocks that can be resident
// on the current device for the dtype code `dtype` (as isp_ccc_argmax's)
// with 16-byte loads (vec 1) or scalar ones (vec 0), by
// cudaOccupancyMaxActiveClusters. Returns the error.
extern "C" int isp_ccc_argmax_cluster_limit(int dtype, int vec, int* size) {
  switch (dtype) {
    case 0: return largest<float>(vec, size);
    case 1: return largest<double>(vec, size);
    case 2: return largest<__half>(vec, size);
    case 3: return largest<__nv_bfloat16>(vec, size);
    case 4: return largest<uint8_t>(vec, size);
    case 5: return largest<int8_t>(vec, size);
    case 6: return largest<int16_t>(vec, size);
    case 7: return largest<int32_t>(vec, size);
    case 8: return largest<long long>(vec, size);
    default: return (int)cudaErrorInvalidValue;
  }
}
