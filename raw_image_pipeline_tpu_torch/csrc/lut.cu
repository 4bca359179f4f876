// Kernel O: the u8 lookup table, out = lut[x] byte for byte, for a u8
// tensor of any shape read as rows of contiguous bytes (ops/gamma
// .lut_layout: one row for a contiguous tensor, else the rows of an
// [N, H, W] view at its frame and row strides), into a new contiguous
// tensor; equal to ops/gamma.apply_lut(..., plain=True), the gather.
//
// Replaces: the JAX package applies the table with XLA, no Pallas kernel
// (raw_image_pipeline_tpu/ops/gamma.py:221 `apply_lut`, through
// ops/common.lut_select); its chain calls it on mono planes after the flip
// (pipeline.py's gamma stage), and the op layer on any u8 frames.
//
// What bounds it on the H100: bytes, each input byte read once and each
// output byte written once, and the 256-byte table (2 * numel + 256 bytes:
// 0.0792 ms at 3.35 TB/s for B=64 1920x1080 mono planes, 0.0050 at B=4).
//
// Design:
//   - the table is staged in shared memory once a block, replicated a lane:
//     entry v for lane l is word v * 32 + l (its low byte), so the 32 lookups
//     of a warp fall in 32 different banks whatever the bytes; a lookup is a
//     shift and a LOP3 of the input word into the byte offset, then one LDS;
//   - a row is split as ops/gamma.lut_split: head bytes up to the input's
//     first 16-byte boundary, a body of whole 16-byte chunks, a tail; the
//     body moves as one 16-byte load and one store a chunk (stores narrower
//     only where the output is not on the input's alignment), the head and
//     tail a byte a thread after the body;
//   - a thread takes kUnroll chunks of a grid-stride walk at once and issues
//     the next kUnroll loads before it looks up and stores the current ones
//     (2 * kUnroll * 16 bytes in flight a thread); its first loads go out
//     before the table is staged;
//   - the grid comes from the card: at most its SMs times the resident
//     blocks, rows over gridDim.y (the rows of a strided view), a row's
//     chunks over gridDim.x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte chunks a thread looks up at once
constexpr int kLanes = 32;
constexpr int kEdgeSlots = 32;  // a row's head (< 16) and tail (< 16) bytes, one slot each
constexpr int kGridY = 65535;

struct Params {
  const uint8_t* in;
  uint8_t* out;  // rows * width contiguous bytes
  const uint8_t* lut;
  unsigned rows;
  long long width;  // bytes a row
  unsigned h;       // rows a frame: row r is frame r / h, row r % h
  long long sb, sy;  // the input's frame and row strides in bytes
};

// the table, entry v for lane l at word v * kLanes + l
__shared__ __align__(16) uint32_t tab[256 * kLanes];

struct Row {
  const uint8_t* body_in;  // 16-byte aligned
  uint8_t* body_out;
  long long body;  // whole 16-byte chunks
  int store;       // body_out's address mod 16: the store width's rule
};

// row r's split: the same rule as ops/gamma.lut_split on its input address
__device__ __forceinline__ Row row_of(const Params& p, unsigned r) {
  const unsigned f = r / p.h, y = r - f * p.h;
  const uint8_t* a = p.in + f * p.sb + y * p.sy;
  const long long lead = (16 - ((uintptr_t)a & 15)) & 15;
  const long long head = lead < p.width ? lead : p.width;
  Row row;
  row.body_in = a + head;
  row.body_out = p.out + (long long)r * p.width + head;
  row.body = (p.width - head) >> 4;
  row.store = (int)((uintptr_t)row.body_out & 15);
  return row;
}

// lut[byte k of w] for the four bytes of w, repacked: the byte's offset in
// `tab` is v * 128 + lane * 4, one shift and one LOP3 from w
__device__ __forceinline__ uint32_t lookup4(uint32_t w, uint32_t lane4) {
  const char* t = reinterpret_cast<const char*>(tab);
  const uint32_t b0 = *reinterpret_cast<const uint32_t*>(t + (((w << 7) & 0x7F80u) | lane4));
  const uint32_t b1 = *reinterpret_cast<const uint32_t*>(t + (((w >> 1) & 0x7F80u) | lane4));
  const uint32_t b2 = *reinterpret_cast<const uint32_t*>(t + (((w >> 9) & 0x7F80u) | lane4));
  const uint32_t b3 = *reinterpret_cast<const uint32_t*>(t + (((w >> 17) & 0x7F80u) | lane4));
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

__device__ __forceinline__ void store16(uint8_t* dst, const uint4 v, int align) {
  if (align == 0) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else if ((align & 7) == 0) {
    reinterpret_cast<uint2*>(dst)[0] = make_uint2(v.x, v.y);
    reinterpret_cast<uint2*>(dst)[1] = make_uint2(v.z, v.w);
  } else if ((align & 3) == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
  }
}

// the first (r, j) at or after (r, j) whose row has chunk j: rows over
// gridDim.y, j restarting at j0 in the next row
__device__ __forceinline__ bool seek(const Params& p, unsigned& r, long long& j, long long j0,
                                     Row& row) {
  while (r < p.rows) {
    row = row_of(p, r);
    if (j < row.body) return true;
    r += gridDim.y, j = j0;
  }
  return false;
}

__device__ __forceinline__ void load_batch(uint4 (&v)[kUnroll], const Row& row, long long j,
                                           long long stride) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long c = j + k * stride;
    if (c < row.body) v[k] = __ldg(reinterpret_cast<const uint4*>(row.body_in) + c);
  }
}

__global__ void __launch_bounds__(kThreads) lut_kernel(const Params p) {
  const int t = threadIdx.x;
  const uint32_t lane4 = (uint32_t)(t & (kLanes - 1)) * 4;
  const long long j0 = (long long)blockIdx.x * kThreads + t;
  const long long stride = (long long)gridDim.x * kThreads;
  unsigned r = blockIdx.y;
  long long j = j0;
  Row row;
  bool live = seek(p, r, j, j0, row);
  uint4 v[kUnroll];
  if (live) load_batch(v, row, j, stride);  // in flight while the table is staged

  for (int i = t; i < 256 * kLanes / 4; i += kThreads) {  // 8 words of 4 lanes an entry
    const uint32_t e = __ldg(p.lut + (i >> 3));
    reinterpret_cast<uint4*>(tab)[i] = make_uint4(e, e, e, e);
  }
  __syncthreads();

  while (live) {
    uint4 cur[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) cur[k] = v[k];
    const Row cur_row = row;
    const long long cj = j;
    j += kUnroll * stride;
    if (j >= row.body) {
      r += gridDim.y, j = j0;
      live = seek(p, r, j, j0, row);
    }
    if (live) load_batch(v, row, j, stride);  // the next chunks, before this batch's stores
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long c = cj + k * stride;
      if (c < cur_row.body) {
        const uint4 o = make_uint4(lookup4(cur[k].x, lane4), lookup4(cur[k].y, lane4),
                                   lookup4(cur[k].z, lane4), lookup4(cur[k].w, lane4));
        store16(cur_row.body_out + 16 * c, o, cur_row.store);
      }
    }
  }

  // the heads and tails: slot s < 16 of row r is head byte s, slot 16 + s
  // tail byte s
  const long long all = (long long)gridDim.x * gridDim.y * kThreads;
  const long long slots = (long long)p.rows * kEdgeSlots;
  for (long long e = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + t; e < slots;
       e += all) {
    const unsigned er = (unsigned)(e / kEdgeSlots);
    const int s = (int)(e % kEdgeSlots);
    const Row er_row = row_of(p, er);
    const uint8_t* a = p.in + (er / p.h) * p.sb + (er % p.h) * p.sy;
    const long long head = er_row.body_in - a;
    const long long tail = p.width - head - 16 * er_row.body;
    const long long x = s < 16 ? (s < head ? s : -1)
                               : (s - 16 < tail ? p.width - tail + (s - 16) : -1);
    if (x >= 0) {
      const uint32_t b = a[x];
      p.out[(long long)er * p.width + x] =
          (uint8_t)*reinterpret_cast<const uint32_t*>(reinterpret_cast<const char*>(tab) +
                                                      ((b << 7) | lane4));
    }
  }
}

}  // namespace

// in: `rows` rows of `width` bytes, row r at in + (r / h) * sb + (r % h) * sy
// (bytes); out: rows * width contiguous bytes; lut: 256 bytes. Every byte
// of out is lut[its input byte]. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int isp_lut(const void* in, void* out, const void* lut, long long rows,
                       long long width, long long h, long long sb, long long sy, void* stream) {
  if (rows < 0 || width < 0 || h < 1 || rows >= (1LL << 31) || h >= (1LL << 31) || !in ||
      !out || !lut) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0 || width == 0) return (int)cudaSuccess;
  static int resident[64] = {0};  // blocks the card holds at once, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!resident[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lut_kernel, kThreads, 0);
    }
    if (err != cudaSuccess) return (int)err;
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  Params p;
  p.in = (const uint8_t*)in, p.out = (uint8_t*)out, p.lut = (const uint8_t*)lut;
  p.rows = (unsigned)rows, p.width = width, p.h = (unsigned)h, p.sb = sb, p.sy = sy;
  // enough blocks for a batch of chunks a thread, at most what the card holds
  const long long chunks = rows * (width / 16 + 1);
  const long long want = (chunks + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long blocks = want < resident[dev] ? want : resident[dev];
  long long gy = rows < blocks ? rows : blocks;
  if (gy > kGridY) gy = kGridY;
  const long long gx = blocks / gy > 1 ? blocks / gy : 1;
  lut_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
