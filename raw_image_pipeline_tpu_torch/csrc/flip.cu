// Kernel N: the flips (cv::flip / transpose, reference modules/flip.cpp:37-58),
// rows [r0, r1) of the flipped frame, up to three planes of one set of strides
// in one launch; equal to ops/flip.flip_rows_plain:
//
//   180  flipped (i, j) = frame (h - 1 - i, w - 1 - j)
//    90  flipped (i, j) = frame (h - 1 - j, i)      (clockwise; w x h out)
//   270  flipped (i, j) = frame (j, w - 1 - i)      (counter-clockwise)
//
// A pixel is an opaque group of `elem` bytes (1 to 16: u8 mosaics and
// planes, u16 frames, [..., H, W, C] frames of any dtype); nothing is
// computed, only bytes move.
//
// Replaces: the JAX package leaves the flip to XLA, with no Pallas kernel
// (raw_image_pipeline_tpu/ops/flip.py:48 `flip`, called by its chain at
// pipeline.py:529, 579 and 583); the port's plain version is torch.flip of
// torch.transpose, eager.
//
// What bounds it on the H100: bytes, each input byte of the rows read once
// and each output byte written once (265 MB for the wb_* chains' B=64
// 1920x1080 planes, 0.079 ms at 3.35 TB/s).
//
// Design: three routes, the host picks (ops/flip.flip_route):
//   route 1 (180, 1-byte pixels, rows of whole 16-byte chunks, every base
//            and stride 16-byte aligned): a thread a 16-byte chunk of an
//            output row, one 16-byte load of the mirrored chunk, its bytes
//            reversed by __byte_perm, one 16-byte store; the planes' loads
//            issued before their stores;
//   route 2 (90 / 270, 1-byte pixels, bases and strides 4-byte aligned): a
//            block a 64 x 64 byte tile through shared memory held as 32-bit
//            words (rows padded by one word): a thread loads four words of
//            four input rows, transposes the 4 x 4 bytes in registers by
//            __byte_perm, and stores four words; then a thread writes 16
//            output bytes, one 16-byte store where the address allows it,
//            two of 8 bytes for rows 8 bytes off (a 1080-byte row pitch),
//            words or bytes otherwise; tiles across the frame's edge take
//            byte loads and stores with bounds (a 128 x 128 byte tile was
//            no faster);
//   route 0 (anything else: odd widths, unaligned views, pixels of 2-16
//            bytes): the same maps over words of `word` bytes (the largest
//            power of two that divides the pixel, the bases and the
//            strides), 180 a thread a word, 90 / 270 through a 32 x 32 pixel
//            tile in dynamic shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_PLANES = 3;
constexpr int CHUNK_THREADS = 128;  // route 1
constexpr int TILE8 = 64;           // route 2's tile, bytes
constexpr int WORDS8 = TILE8 / 4;
constexpr int TILE8_THREADS = 256;
constexpr int TILE = 32;  // route 0's transpose tile, pixels
constexpr int TILE_ROWS = 8;
constexpr int WORD_THREADS = 256;  // route 0's 180
constexpr int GRID_Y = 65535;

struct Params {
  const uint8_t* in[MAX_PLANES];
  uint8_t* out[MAX_PLANES];
  int planes;
  int h, w, elem;     // the input frame: h x w pixels of elem bytes
  long long sb, sy;   // its frame and row strides in bytes (pixels contiguous)
  long long ob;       // the output's frame stride in bytes (rows of ow * elem bytes)
  int angle, r0, rows, ow;  // flipped rows [r0, r0 + rows), ow pixels wide
};

// plane k's bases, selected without indexing the parameters (which would
// copy them to the stack)
__device__ __forceinline__ const uint8_t* in_plane(const Params& p, int k) {
  return k == 0 ? p.in[0] : k == 1 ? p.in[1] : p.in[2];
}
__device__ __forceinline__ uint8_t* out_plane(const Params& p, int k) {
  return k == 0 ? p.out[0] : k == 1 ? p.out[1] : p.out[2];
}

// --- route 1: 180 over 16-byte chunks ----------------------------------------

__device__ __forceinline__ uint32_t reversed(uint32_t v) { return __byte_perm(v, 0, 0x0123); }

__global__ void __launch_bounds__(CHUNK_THREADS) flip180_chunks(const Params p) {
  const int q = blockIdx.x * CHUNK_THREADS + threadIdx.x;  // the output row's chunk
  const int chunks = p.w >> 4;
  if (q >= chunks) return;
  const long long f = blockIdx.z;
  for (int r = blockIdx.y; r < p.rows; r += gridDim.y) {
    const int y = p.h - 1 - (p.r0 + r);
    const long long src = f * p.sb + y * p.sy + (long long)(chunks - 1 - q) * 16;
    const long long dst = f * p.ob + (long long)r * p.w + (long long)q * 16;
    uint4 v[MAX_PLANES];
#pragma unroll
    for (int k = 0; k < MAX_PLANES; ++k) {
      if (k < p.planes) v[k] = __ldg(reinterpret_cast<const uint4*>(p.in[k] + src));
    }
#pragma unroll
    for (int k = 0; k < MAX_PLANES; ++k) {
      if (k < p.planes) {
        const uint4 o = make_uint4(reversed(v[k].w), reversed(v[k].z), reversed(v[k].y),
                                   reversed(v[k].x));
        *reinterpret_cast<uint4*>(p.out[k] + dst) = o;
      }
    }
  }
}

// --- route 2: 90 / 270 over 64 x 64 byte tiles of words ----------------------

// bytes c of a0..a3 as one word (a0's in byte 0): the columns of a 4 x 4 block
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                           uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a0, a1, 0x7362);
  const uint32_t t2 = __byte_perm(a2, a3, 0x5140), t3 = __byte_perm(a2, a3, 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410), col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410), col[3] = __byte_perm(t1, t3, 0x7632);
}

template <bool CW>  // CW: 90 (clockwise), else 270
__global__ void __launch_bounds__(TILE8_THREADS) flip_tiles8(const Params p) {
  __shared__ uint32_t tile[TILE8][WORDS8 + 1];  // [out row][out word], padded
  const int t = threadIdx.x;
  const int ox0 = blockIdx.x * TILE8;  // the output tile's column
  const long long f = blockIdx.z;
  for (int oy0 = blockIdx.y * TILE8; oy0 < p.rows; oy0 += gridDim.y * TILE8) {
    // the input tile's origin: input (a, b) is output (b, TILE8 - 1 - a) at
    // 90 and (TILE8 - 1 - b, a) at 270, relative to the tiles
    const int iy0 = CW ? p.h - ox0 - TILE8 : ox0;
    const int ix0 = CW ? p.r0 + oy0 : p.w - p.r0 - oy0 - TILE8;
    const bool whole = iy0 >= 0 && iy0 + TILE8 <= p.h && ix0 >= 0 && ix0 + TILE8 <= p.w &&
                       (ix0 & 3) == 0;
#pragma unroll 1
    for (int k = 0; k < p.planes; ++k) {
      const uint8_t* in = in_plane(p, k) + f * p.sb;
      // 4 x 4 byte blocks: input rows 4g..4g+3, bytes 4cw..4cw+3; a warp
      // reads whole rows of the tile
#pragma unroll
      for (int blk = t; blk < WORDS8 * WORDS8; blk += TILE8_THREADS) {
        const int g = blk / WORDS8, cw = blk % WORDS8;
        uint32_t a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int y = iy0 + 4 * g + j, x = ix0 + 4 * cw;
          if (whole) {
            a[j] = __ldg(reinterpret_cast<const uint32_t*>(in + y * p.sy + x));
          } else {
            a[j] = 0;
            if (y >= 0 && y < p.h) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (x + c >= 0 && x + c < p.w) {
                  a[j] |= (uint32_t)__ldg(in + y * p.sy + x + c) << (8 * c);
                }
              }
            }
          }
        }
        uint32_t col[4];
        if (CW) {
          transpose4(a[3], a[2], a[1], a[0], col);  // output columns run up the input rows
#pragma unroll
          for (int c = 0; c < 4; ++c) tile[4 * cw + c][WORDS8 - 1 - g] = col[c];
        } else {
          transpose4(a[0], a[1], a[2], a[3], col);
#pragma unroll
          for (int c = 0; c < 4; ++c) tile[TILE8 - 1 - 4 * cw - c][g] = col[c];
        }
      }
      __syncthreads();
      // 16 output bytes a thread; a warp writes whole rows of the tile
#pragma unroll
      for (int chunk = t; chunk < TILE8 * (TILE8 / 16); chunk += TILE8_THREADS) {
        const int orow = chunk / (TILE8 / 16), oq = chunk % (TILE8 / 16);
        const int oy = oy0 + orow, ox = ox0 + 16 * oq;
        if (oy < p.rows && ox < p.ow) {
          uint8_t* dst = out_plane(p, k) + f * p.ob + (long long)oy * p.ow + ox;
          const uint32_t* wds = tile[orow] + 4 * oq;
          if (ox + 16 <= p.ow && ((uintptr_t)dst & 15) == 0) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(wds[0], wds[1], wds[2], wds[3]);
          } else if (ox + 16 <= p.ow && ((uintptr_t)dst & 7) == 0) {  // rows 8 bytes off
            reinterpret_cast<uint2*>(dst)[0] = make_uint2(wds[0], wds[1]);
            reinterpret_cast<uint2*>(dst)[1] = make_uint2(wds[2], wds[3]);
          } else if (ox + 16 <= p.ow && ((uintptr_t)dst & 3) == 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j) reinterpret_cast<uint32_t*>(dst)[j] = wds[j];
          } else {
            for (int j = 0; j < 16 && ox + j < p.ow; ++j) {
              dst[j] = (uint8_t)(wds[j >> 2] >> (8 * (j & 3)));
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

// --- route 0: any pixel size, over words of T ---------------------------------

template <typename T>
__global__ void __launch_bounds__(WORD_THREADS) flip180_words(const Params p) {
  const int lanes = p.elem / (int)sizeof(T);
  const long long k = (long long)blockIdx.x * WORD_THREADS + threadIdx.x;  // word of the row
  if (k >= (long long)p.w * lanes) return;
  const int x = (int)(k / lanes), l = (int)(k - (long long)x * lanes);
  const long long f = blockIdx.z;
  for (int r = blockIdx.y; r < p.rows; r += gridDim.y) {
    const int y = p.h - 1 - (p.r0 + r);
    const long long src = f * p.sb + y * p.sy + (long long)(p.w - 1 - x) * p.elem;
    const long long dst = f * p.ob + (long long)r * p.ow * p.elem + (long long)x * p.elem;
#pragma unroll
    for (int q = 0; q < MAX_PLANES; ++q) {
      if (q < p.planes) {
        reinterpret_cast<T*>(p.out[q] + dst)[l] = __ldg(reinterpret_cast<const T*>(p.in[q] + src) + l);
      }
    }
  }
}

template <typename T, bool CW>
__global__ void __launch_bounds__(TILE * TILE_ROWS) flip_tiles(const Params p) {
  extern __shared__ uint4 smem[];  // [TILE][TILE * lanes + 1] words of T
  T* tile = reinterpret_cast<T*>(smem);
  const int lanes = p.elem / (int)sizeof(T), pitch = TILE * lanes + 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ox0 = blockIdx.x * TILE;
  const long long f = blockIdx.z;
  for (int oy0 = blockIdx.y * TILE; oy0 < p.rows; oy0 += gridDim.y * TILE) {
    // input (a, b) is output (b, 31 - a) at 90 and (31 - b, a) at 270
    const int iy0 = CW ? p.h - ox0 - TILE : ox0;
    const int ix0 = CW ? p.r0 + oy0 : p.w - p.r0 - oy0 - TILE;
#pragma unroll 1
    for (int q = 0; q < p.planes; ++q) {
      const uint8_t* in = in_plane(p, q) + f * p.sb;
      for (int a = ty; a < TILE; a += TILE_ROWS) {
        const int y = iy0 + a;
        if (y < 0 || y >= p.h) continue;
        for (int c = tx; c < TILE * lanes; c += TILE) {
          const int x = ix0 + c / lanes;
          if (x >= 0 && x < p.w) {
            tile[a * pitch + c] =
                __ldg(reinterpret_cast<const T*>(in + y * p.sy + (long long)x * p.elem) + c % lanes);
          }
        }
      }
      __syncthreads();
      for (int rr = ty; rr < TILE; rr += TILE_ROWS) {
        const int oy = oy0 + rr;
        if (oy >= p.rows) break;
        T* dst = reinterpret_cast<T*>(out_plane(p, q) + f * p.ob + (long long)oy * p.ow * p.elem);
        for (int c = tx; c < TILE * lanes; c += TILE) {
          const int cc = c / lanes, ox = ox0 + cc;
          if (ox >= p.ow) break;
          const int a = CW ? TILE - 1 - cc : cc, b = CW ? rr : TILE - 1 - rr;
          dst[(long long)ox * lanes + c % lanes] = tile[a * pitch + b * lanes + c % lanes];
        }
      }
      __syncthreads();
    }
  }
}

int tiles_y(int rows, int tile) {
  const int n = (rows + tile - 1) / tile;
  return n < GRID_Y ? n : GRID_Y;
}

// whether every plane's base and the strides are multiples of `a` bytes
bool aligned(const Params& p, long long a, bool out) {
  for (int k = 0; k < p.planes; ++k) {
    if ((uintptr_t)p.in[k] % a || (out && (uintptr_t)p.out[k] % a)) return false;
  }
  return p.sb % a == 0 && p.sy % a == 0 && (!out || p.ob % a == 0);
}

template <typename T>
cudaError_t launch_words(const Params& p, int batch, cudaStream_t s) {
  const int lanes = p.elem / (int)sizeof(T);
  if (p.angle == 180) {
    const long long words = (long long)p.w * lanes;
    const dim3 grid((unsigned)((words + WORD_THREADS - 1) / WORD_THREADS),
                    (unsigned)(p.rows < GRID_Y ? p.rows : GRID_Y), (unsigned)batch);
    flip180_words<T><<<grid, WORD_THREADS, 0, s>>>(p);
    return cudaGetLastError();
  }
  const dim3 grid((unsigned)((p.ow + TILE - 1) / TILE),
                  (unsigned)tiles_y(p.rows, TILE), (unsigned)batch);
  const dim3 block(TILE, TILE_ROWS);
  const size_t smem = (size_t)TILE * (TILE * lanes + 1) * sizeof(T);
  if (p.angle == 90) {
    flip_tiles<T, true><<<grid, block, smem, s>>>(p);
  } else {
    flip_tiles<T, false><<<grid, block, smem, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// in0..in2, out0..out2: `planes` (1-3) planes' bases (unused ones null);
// batch frames of h x w pixels of elem bytes (1-16) at input strides sb, sy
// (bytes; a row's pixels contiguous); out: rows [r0, r1) of the flipped
// frame, contiguous rows of ow * elem bytes (ow = w at 180, h at 90 / 270),
// frames ob bytes apart; angle 90, 180 or 270; route 0 (words of `word`
// bytes: 1, 2, 4, 8 or 16, dividing elem, the bases and the strides), 1
// (180 over 16-byte chunks: elem 1, w a multiple of 16, every base and
// stride 16-byte aligned) or 2 (90 / 270 over byte tiles: elem 1, input
// bases and strides 4-byte aligned), as ops/flip.flip_route picks.
// Launches on `stream` and returns the launch's error.
extern "C" int isp_flip(const void* in0, const void* in1, const void* in2, void* out0, void* out1,
                        void* out2, int planes, int batch, int h, int w, int elem, long long sb,
                        long long sy, long long ob, int angle, int r0, int r1, int route, int word,
                        void* stream) {
  const int oh = angle == 180 ? h : w, ow = angle == 180 ? w : h;
  if (planes < 1 || planes > MAX_PLANES || batch < 1 || batch > 65535 || h <= 0 || w <= 0 ||
      elem < 1 || elem > 16 || (angle != 90 && angle != 180 && angle != 270) || r0 < 0 ||
      r1 < r0 || r1 > oh || (word & (word - 1)) || word < 1 || word > 16 || elem % word ||
      (route == 1 && (angle != 180 || elem != 1 || w % 16)) ||
      (route == 2 && (angle == 180 || elem != 1)) || route < 0 || route > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ins[MAX_PLANES] = {in0, in1, in2};
  void* outs[MAX_PLANES] = {out0, out1, out2};
  Params p;
  for (int k = 0; k < MAX_PLANES; ++k) {
    if (k < planes && (!ins[k] || !outs[k])) return (int)cudaErrorInvalidValue;
    p.in[k] = (const uint8_t*)ins[k], p.out[k] = (uint8_t*)outs[k];
  }
  p.planes = planes, p.h = h, p.w = w, p.elem = elem, p.sb = sb, p.sy = sy, p.ob = ob;
  p.angle = angle, p.r0 = r0, p.rows = r1 - r0, p.ow = ow;
  if ((route == 1 && !aligned(p, 16, true)) || (route == 2 && !aligned(p, 4, false)) ||
      (route == 0 && !aligned(p, word, true))) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    const dim3 grid((unsigned)((w / 16 + CHUNK_THREADS - 1) / CHUNK_THREADS),
                    (unsigned)(p.rows < GRID_Y ? p.rows : GRID_Y), (unsigned)batch);
    flip180_chunks<<<grid, CHUNK_THREADS, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  if (route == 2) {
    const dim3 grid((unsigned)((ow + TILE8 - 1) / TILE8),
                    (unsigned)tiles_y(p.rows, TILE8), (unsigned)batch);
    if (angle == 90) {
      flip_tiles8<true><<<grid, TILE8_THREADS, 0, s>>>(p);
    } else {
      flip_tiles8<false><<<grid, TILE8_THREADS, 0, s>>>(p);
    }
    return (int)cudaGetLastError();
  }
  switch (word) {
    case 1: return (int)launch_words<uint8_t>(p, batch, s);
    case 2: return (int)launch_words<uint16_t>(p, batch, s);
    case 4: return (int)launch_words<uint32_t>(p, batch, s);
    case 8: return (int)launch_words<uint2>(p, batch, s);
    default: return (int)launch_words<uint4>(p, batch, s);
  }
}
