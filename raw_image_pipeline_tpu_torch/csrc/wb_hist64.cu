// Kernel L: learned white balance's 64^3 histogram of the kept pixels,
// after kernel K: three [B, h, w] u8 planes and K's record in, the counts
// added into a [B, 64^3] int32 histogram that K zeroed; equal to
// ops/learned_wb.hist64_plain. A pixel is kept while max(b, g, r) <
// t255; its bin is (i(b) * 64 + i(g)) * 64 + i(r) with i(v) =
// floor(f32(v) * 64 / hi) clamped to [0, 63], hi = f32(max(64, the frame's
// max of max(b, g, r))) from K's record.
//
// Replaces: the JAX package leaves it to XLA, with no Pallas kernel:
// raw_image_pipeline_tpu/ops/learned_wb.py `_extract_features` (line 152),
// its histogram of kept pixels. The port's plain version is a
// torch.bincount over an int64 copy of the frames' bin indices.
//
// What bounds it on the H100: bytes would allow 0.139 ms at B=64
// 1920x1080 (three bytes a pixel read, 1 MB a frame of counts written);
// what it waits on is the adds, one a run of equal bins: noise-like frames
// change bin at almost every pixel, and a thread's add reads its slot's key
// before it adds, two dependent shared-memory operations a run.
//
// Design: grid (blocks a frame, B: four an SM in all, and at least one
// every 2^17 pixels), the frame's 16-pixel chunks
// (wb_planes.cuh) split evenly over its blocks, a thread a chunk at a time
// with the next chunk's loads in flight. A block first tabulates i(v) for
// the 256 values (its frame's hi), so a pixel's bin is three shared-memory
// reads. A thread carries a run of equal bins (across its chunks too) and
// adds the run's length once it ends, into the block's table of SLOTS
// (bin, count) pairs in shared memory, direct-mapped by a hash of the bin:
// the first bin to claim a slot (atomicCAS) keeps it, and a run whose slot
// holds another bin is added to device memory directly. 8192 slots (64 KB,
// two blocks an SM) send 18% of a noise-like frame's runs to device memory
// where 4096 sent 29%. At the end the block adds its slots to device
// memory. The counts are integers, so the order of the adds leaves the
// histogram exact and the same every run.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wb_planes.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int SLOTS = 8192;     // a block's (bin, count) table
constexpr int LOG_SLOTS = 13;
constexpr int SMEM = SLOTS * 8;
constexpr unsigned EMPTY = 0xFFFFFFFFu;
constexpr int HIST64 = 64 * 64 * 64;
constexpr int RECORD = 7, HI = 4;  // ops/learned_wb.SLOTS, HI
static_assert(1 << LOG_SLOTS == SLOTS, "LOG_SLOTS");

struct Params {
  const uint8_t* b;
  const uint8_t* g;
  const uint8_t* r;
  long long sb, sy, sx;
  int h, w, t255;
  const long long* record;
  int* hist;
};

__device__ __forceinline__ unsigned slot_of(unsigned bin) {
  return (bin * 2654435761u) >> (32 - LOG_SLOTS);  // Fibonacci hashing
}

// a run of `cnt` pixels in `bin`: into the block's table, or device memory
__device__ __forceinline__ void add_run(unsigned bin, unsigned cnt, unsigned* keys,
                                        unsigned* cnts, int* frame_hist) {
  const unsigned s = slot_of(bin);
  unsigned k = reinterpret_cast<volatile unsigned*>(keys)[s];
  if (k == EMPTY) {
    k = atomicCAS(keys + s, EMPTY, bin);
    if (k == EMPTY) k = bin;  // claimed
  }
  if (k == bin) {
    atomicAdd(cnts + s, cnt);
  } else {
    atomicAdd(frame_hist + bin, (int)cnt);
  }
}

__global__ void __launch_bounds__(THREADS, 2) wb_hist64_kernel(const Params p) {
  extern __shared__ unsigned table[];
  unsigned* keys = table;
  unsigned* cnts = table + SLOTS;
  __shared__ unsigned idx[256];  // i(v)
  const int f = blockIdx.y, t = threadIdx.x;
  const wbp::Frame fr = wbp::frame_of(p.b, p.g, p.r, p.sb, p.sy, p.sx, p.h, p.w, f);
  const long long per = (fr.chunks + gridDim.x - 1) / gridDim.x;
  const long long c1 = min(fr.chunks, (blockIdx.x + 1) * per);
  long long c = blockIdx.x * per + t;
  wbp::Chunk next;
  if (c < c1) wbp::load_chunk(fr, c, next);

  for (int i = t; i < SLOTS; i += THREADS) keys[i] = EMPTY, cnts[i] = 0u;
  if (t < 256) {
    const float hi = (float)max(p.record[(long long)f * RECORD + HI], 64LL);
    const float q = floorf(__fdiv_rn(__fmul_rn((float)t, 64.0f), hi));
    idx[t] = (unsigned)fminf(fmaxf(q, 0.0f), 63.0f);
  }
  __syncthreads();

  int* frame_hist = p.hist + (long long)f * HIST64;
  unsigned cur = EMPTY, cnt = 0;
  while (c < c1) {
    const wbp::Chunk ch = next;
    const long long cn = c + THREADS;
    if (cn < c1) wbp::load_chunk(fr, cn, next);
#pragma unroll
    for (int k = 0; k < wbp::kChunk; ++k) {
      int b, g, r;
      wbp::pixel_at(ch, k, b, g, r);
      if (!((ch.valid >> k) & 1u) || max(max(b, g), r) >= p.t255) continue;
      const unsigned bin = (idx[b] << 12) | (idx[g] << 6) | idx[r];
      if (bin != cur) {
        if (cnt) add_run(cur, cnt, keys, cnts, frame_hist);
        cur = bin, cnt = 0;
      }
      ++cnt;
    }
    c = cn;
  }
  if (cnt) add_run(cur, cnt, keys, cnts, frame_hist);
  __syncthreads();
  for (int i = t; i < SLOTS; i += THREADS) {
    if (cnts[i]) atomicAdd(frame_hist + keys[i], (int)cnts[i]);
  }
}

}  // namespace

// b, g, r: [batch, h, w] u8 planes of shared strides (frame, row, column,
// in bytes); t255: the saturation threshold; record: kernel K's [batch, 7]
// int64 record (its HI slot); hist: [batch, 64^3] int32, zeroed (by K),
// into which the counts are added. Launches on `stream` and returns the
// launch's error.
extern "C" int isp_wb_hist64(const void* b, const void* g, const void* r, long long sb,
                             long long sy, long long sx, int batch, int h, int w, int t255,
                             const void* record, void* hist, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (h <= 0 || w <= 0 || (long long)h * w >= (1LL << 31) || batch > 65535 || !record || !hist) {
    return (int)cudaErrorInvalidValue;
  }
  static int sms[64] = {0};  // SMs of each device, read once, and the attribute set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaFuncSetAttribute(wb_hist64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  Params p;
  p.b = (const uint8_t*)b, p.g = (const uint8_t*)g, p.r = (const uint8_t*)r;
  p.sb = sb, p.sy = sy, p.sx = sx, p.h = h, p.w = w, p.t255 = t255;
  p.record = (const long long*)record, p.hist = (int*)hist;
  // about four blocks an SM in all, and a block at least every 2^17 pixels
  // (a block that meets more colours than its table holds spills more:
  // at B=64 1920x1080 16 blocks a frame, not 9), but no block without a
  // chunk a thread
  const long long chunks = (long long)h * w / wbp::kChunk + 2;
  const long long want = std::max((4LL * sms[dev] + batch - 1) / batch,
                                  ((long long)h * w + (1 << 17) - 1) >> 17);
  const long long fill = (chunks + THREADS - 1) / THREADS;
  const int blocks = (int)std::max(1LL, std::min(want, fill));
  wb_hist64_kernel<<<dim3(blocks, batch, 1), THREADS, SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
