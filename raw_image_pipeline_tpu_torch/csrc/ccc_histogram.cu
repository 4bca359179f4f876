// Kernel B: the CCC log-chroma histogram, fused with its bin computation
// and its scale: three [B, h, w] u8 planes in, the [B, 256, 256] f32
// histogram out, in one launch.
//
// Replaces: raw_image_pipeline_tpu/ops/ccc.py `_hist_pallas_kernel`
// (line 96), reached through `_hist_counts_pallas` (line 128), together
// with the per-pixel gray/mask/log/bin prologue and the `counts *
// pixel_weight` epilogue that the reference package computes in XLA
// (`_log_chroma_histogram_core`, ccc.py:186-245).
//
// What bounds it on the H100: bytes would allow well under a microsecond
// (three 270x360 u8 planes in, 256 KB of f32 out per frame); what it
// waits on is latency: of the loads, of the adds, of the reads from other
// blocks. Adds issued one by one to device memory (L2) or to another
// block's shared memory are few per SM and cycle, and __match_any_sync
// is slower still (PERF.md), so every add goes to the adding block's own
// shared memory, unmerged.
//
// Design: one thread-block cluster of CLUSTER blocks per frame
// (cudaLaunchKernelEx with the cluster dimension); block r takes the r-th
// of CLUSTER equal runs of the frame's pixels. Each block keeps a private
// histogram of the whole frame in shared memory as 16-bit counts, two per
// 32-bit word (128 KB); a block adds at most 65535 pixels, so no count
// carries into its neighbour (frames of up to MAX_PIXELS pixels). A thread
// takes PIX consecutive pixels per pass (one 16-byte load per plane; the
// working resize's 97200 pixels are one pass, whose loads are issued
// before the histogram is zeroed), computes their bins, merges runs of
// equal bins among them and adds each run by one shared-memory atomicAdd. After cluster.sync() block r owns bins
// [r, r+1) * 65536/CLUSTER: it reads them from every block's histogram
// (distributed shared memory, all CLUSTER loads of a thread in flight
// together), sums them in int32 and writes __fmul_rn((float)count,
// pixel_weight). Every output element is written once, so no memset runs,
// and since counts are integers below 2^24 this equals counts.float() *
// f32(1/(h*w)) bit for bit. The log table is a device array uploaded once
// per device by the wrapper and copied into shared memory here, so no
// host-to-device copy runs per call. The f32 arithmetic is written with
// __fmul_rn/__fadd_rn/__fsub_rn so that nvcc cannot contract it into
// fmas: the gray value is the plain chain (r*.299 + g*.587) + b*.114.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BINS = 256 * 256;
constexpr int CLUSTER = 8;     // blocks per frame, the portable maximum
constexpr int THREADS = 1024;
constexpr int PIX = 16;        // consecutive pixels per thread and pass
constexpr int SHARE = BINS / CLUSTER;  // bins each block sums and writes
constexpr int MAX_RUN = 65535 / PIX * PIX;  // pixels a block may count in 16 bits
constexpr long long MAX_PIXELS = (long long)CLUSTER * MAX_RUN;  // ops/ccc.py's too
constexpr int SMEM_BYTES = BINS / 2 * 4 + 256 * 4;  // the counts, the log table
static_assert(SHARE % (4 * THREADS) == 0, "whole groups of 4 bins per thread");
static_assert(PIX == 16, "one 16-byte load per plane");

__device__ __forceinline__ int bin_of(float t) {
  // C++ round(): half away from zero, then clip to [0, 255]
  const float q = t >= 0.f ? floorf(__fadd_rn(t, 0.5f))
                           : ceilf(__fsub_rn(t, 0.5f));
  return (int)fminf(fmaxf(q, 0.f), 255.f);
}

// PIX consecutive bytes of each plane
struct Pixels {
  uint4 b, g, r;
};

__device__ __forceinline__ int byte_of(const uint4& v, int k) {
  const unsigned w = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
  return (w >> (8 * (k % 4))) & 255;
}

// the pixels [p0, p0 + PIX) of a frame's planes; those at or past `end`
// read as zeros, which are not counted
__device__ __forceinline__ Pixels load_pixels(const uint8_t* fb, const uint8_t* fg,
                                              const uint8_t* fr, int p0, int end,
                                              int vector_loads) {
  if (vector_loads)  // runs and planes aligned to PIX bytes
    return {*reinterpret_cast<const uint4*>(fb + p0), *reinterpret_cast<const uint4*>(fg + p0),
            *reinterpret_cast<const uint4*>(fr + p0)};
  unsigned b[4] = {}, g[4] = {}, r[4] = {};
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    if (p0 + k < end) {
      b[k / 4] |= (unsigned)fb[p0 + k] << (8 * (k % 4));
      g[k / 4] |= (unsigned)fg[p0 + k] << (8 * (k % 4));
      r[k / 4] |= (unsigned)fr[p0 + k] << (8 * (k % 4));
    }
  }
  return {make_uint4(b[0], b[1], b[2], b[3]), make_uint4(g[0], g[1], g[2], g[3]),
          make_uint4(r[0], r[1], r[2], r[3])};
}

// pixel's bin, or -1 for a pixel that is not counted
__device__ __forceinline__ int pixel_bin(int b, int g, int r, const float* s_log,
                                         float bright_cut, float dark_cut, float uv0) {
  const float gray = __fadd_rn(__fadd_rn(__fmul_rn((float)r, 0.299f),
                                         __fmul_rn((float)g, 0.587f)),
                               __fmul_rn((float)b, 0.114f));
  // a zero channel has log -inf: not finite, so not counted
  if (!(gray <= bright_cut && gray > dark_cut && b > 0 && g > 0 && r > 0)) return -1;
  const float lb = s_log[b], lg = s_log[g], lr = s_log[r];
  // (x - uv0) / (1/64) is exactly (x - uv0) * 64
  const int u = bin_of(__fmul_rn(__fsub_rn(__fsub_rn(lg, lr), uv0), 64.f));
  const int v = bin_of(__fmul_rn(__fsub_rn(__fsub_rn(lg, lb), uv0), 64.f));
  return u * 256 + v;
}

__global__ void __launch_bounds__(THREADS)
ccc_histogram_kernel(const uint8_t* __restrict__ pb, const uint8_t* __restrict__ pg,
                     const uint8_t* __restrict__ pr, const float* __restrict__ log_tab,
                     float* __restrict__ out, int npix, int run, int vector_loads,
                     float bright_cut, float dark_cut, float uv0, float pixel_weight) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* pairs = smem;  // bin 2i in the low half of word i, bin 2i+1 in the high half
  float* s_log = reinterpret_cast<float*>(smem + BINS / 2);  // f32 log(i); log(0) = -inf
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const size_t frame = blockIdx.y;
  const int t = threadIdx.x;
  const uint8_t* fb = pb + frame * npix;
  const uint8_t* fg = pg + frame * npix;
  const uint8_t* fr = pr + frame * npix;
  const int end = min(npix, (rank + 1) * run);
  int p0 = rank * run + PIX * t;
  Pixels px = {};
  if (p0 < end) px = load_pixels(fb, fg, fr, p0, end, vector_loads);

  for (int i = t; i < BINS / 8; i += THREADS)
    reinterpret_cast<uint4*>(pairs)[i] = make_uint4(0, 0, 0, 0);
  if (t < 256) s_log[t] = log_tab[t];
  __syncthreads();

  while (p0 < end) {
    // neighbouring pixels often share a bin: one add per run of equal bins
    int bin = -1, count = 0;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int next = pixel_bin(byte_of(px.b, k), byte_of(px.g, k), byte_of(px.r, k), s_log,
                                 bright_cut, dark_cut, uv0);
      if (next != bin) {
        if (bin >= 0) atomicAdd(pairs + bin / 2, (unsigned)count << (16 * (bin & 1)));
        bin = next;
        count = 0;
      }
      ++count;
    }
    if (bin >= 0) atomicAdd(pairs + bin / 2, (unsigned)count << (16 * (bin & 1)));
    p0 += PIX * THREADS;
    if (p0 < end) px = load_pixels(fb, fg, fr, p0, end, vector_loads);
  }
  cluster.sync();  // every block's histogram is complete

  // this block's bins in groups of 4, summed over the cluster's histograms
  for (int group = t; group < SHARE / 4; group += THREADS) {
    const int w = (rank * SHARE + 4 * group) / 2;  // the group's first word
    uint2 c[CLUSTER];
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q)
      c[q] = *reinterpret_cast<const uint2*>(cluster.map_shared_rank(pairs + w, q));
    unsigned sum[4] = {};
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) {
      sum[0] += c[q].x & 0xffffu;
      sum[1] += c[q].x >> 16;
      sum[2] += c[q].y & 0xffffu;
      sum[3] += c[q].y >> 16;
    }
    *reinterpret_cast<float4*>(out + frame * BINS + 2 * w) = make_float4(
        __fmul_rn((float)sum[0], pixel_weight), __fmul_rn((float)sum[1], pixel_weight),
        __fmul_rn((float)sum[2], pixel_weight), __fmul_rn((float)sum[3], pixel_weight));
  }
  cluster.sync();  // no block leaves while another still reads its histogram
}

}  // namespace

// b, g, r: [batch, npix] u8; log_tab: 256 f32 on the device; hist:
// [batch, 256, 256] f32, every element written. Returns the launch's error
// (cudaErrorInvalidValue for npix above MAX_PIXELS, 524160 pixels).
extern "C" int isp_ccc_histogram(const void* b, const void* g, const void* r,
                                 const void* log_tab, void* hist, int batch, int npix,
                                 float bright_cut, float dark_cut, float uv0,
                                 float pixel_weight, void* stream) {
  if (npix > MAX_PIXELS) return (int)cudaErrorInvalidValue;
  // above 48 KB, dynamic shared memory needs the attribute, set once per
  // device
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(ccc_histogram_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, batch, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // each block's run of pixels: a CLUSTER-th of the frame, in whole PIX
  const int run = (npix + CLUSTER * PIX - 1) / (CLUSTER * PIX) * PIX;
  const int vector_loads =
      npix % PIX == 0 && ((uintptr_t)b | (uintptr_t)g | (uintptr_t)r) % PIX == 0;
  err = cudaLaunchKernelEx(&cfg, ccc_histogram_kernel, (const uint8_t*)b, (const uint8_t*)g,
                           (const uint8_t*)r, (const float*)log_tab, (float*)hist, npix, run,
                           vector_loads, bright_cut, dark_cut, uv0, pixel_weight);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
