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
//   route 2 (90 / 270, 1-byte pixels, the input's bases, strides and first
//            column 4-byte aligned): persistent blocks, each walking tiles
//            of 64 output rows x 224 output bytes (and every plane of a
//            tile) through shared memory held as 32-bit words (rows padded
//            by one word). A tile's rows are placed on the output's own
//            32-byte sectors: row r writes the 224 bytes from its tile
//            column less (its start address mod 32), so every interior
//            store is one aligned 16-byte store and one block writes each
//            32-byte sector of an output row whole (a 1080-byte pitch puts
//            every other row 8 bytes off a 16-byte boundary); the tile
//            stages 32 output columns more than it writes (256 input rows
//            of 64 bytes) to cover the skew. A thread loads 16 bytes of
//            four input rows (word 16: one 16-byte load a row; word 4:
//            four word loads), transposes the 4 x 4 byte blocks in
//            registers by __byte_perm into shared memory, and, after the
//            barrier, writes the tile's rows (a chunk's 16 bytes read from
//            shared memory by a funnel shift of five words), then loads its
//            next tile; tiles across the frame's edge take byte loads and
//            stores with bounds. A large batch runs R2_BUSY_BLOCKS blocks an
//            SM, a small one as many as fit. Measured against variants
//            (tools/lut_flip_variants.py): the next tile's loads issued
//            before the stores, 16-byte rows in place of 32-byte sectors,
//            4-byte loads, tiles of 128 x 224 and 64 x 480, the streaming
//            cache hints, 2, 4 or all blocks an SM at B=64 were each slower;
//            the loads alone and the stores alone each move 1.8-1.9 TB/s
//            (rows read 64 bytes and written 224 at a time);
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
// route 2: a tile writes R2_ROWS output rows of R2_COLS bytes and stages
// R2_SPAN output columns (input rows), R2_MARGIN more than it writes
constexpr int R2_ROWS = 64;
constexpr int R2_COLS = 224;
constexpr int R2_MARGIN = 32;
constexpr int R2_SPAN = R2_COLS + R2_MARGIN;
constexpr int R2_WORDS = R2_SPAN / 4;
constexpr int R2_PITCH = R2_WORDS + 1;  // odd: a warp's transposed stores hit 32 banks
constexpr int R2_CHUNKS = R2_COLS / 16;  // 16-byte output chunks a tile row
constexpr int R2_THREADS = 256;
// blocks an SM once every block has R2_BUSY_TILES tiles or more at that
// count (a large batch): fewer than fit keep fewer scattered rows in flight
// (tools/lut_flip_variants.py); a smaller batch takes as many as fit
constexpr int R2_BUSY_BLOCKS = 3;
constexpr int R2_BUSY_TILES = 4;
// load units (4 input rows x 16 bytes) a thread
constexpr int R2_UNITS = R2_WORDS * (R2_ROWS / 16) / R2_THREADS;
static_assert(R2_UNITS * R2_THREADS == R2_WORDS * (R2_ROWS / 16), "whole units a thread");
static_assert(R2_COLS % 32 == 0 && R2_ROWS % 16 == 0, "tiles on 32-byte sectors");
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

// --- route 2: 90 / 270 over tiles on the output's sectors -----------------

// bytes c of a0..a3 as one word (a0's in byte 0): the columns of a 4 x 4 block
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                           uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a0, a1, 0x7362);
  const uint32_t t2 = __byte_perm(a2, a3, 0x5140), t3 = __byte_perm(a2, a3, 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410), col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410), col[3] = __byte_perm(t1, t3, 0x7632);
}

// word q (a constant after unrolling) of v
__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// one work item: a tile of a frame of one plane
struct Tile {
  long long f;  // frame
  int k;        // plane
  int oy0;      // its first output row (of the launch's rows)
  int c0;       // its tile column: it writes from c0 - (a row's skew), a multiple of 32
};

__device__ __forceinline__ Tile tile_of(long long item, int planes, int across, int down) {
  Tile t;
  t.k = (int)(item % planes);
  long long q = item / planes;
  t.c0 = (int)(q % across) * R2_COLS;
  q /= across;
  t.oy0 = (int)(q % down) * R2_ROWS;
  t.f = q / down;
  return t;
}

// load unit v of a tile: staged output columns 4g..4g+3 (four input rows),
// 16 input bytes (output rows 16cq..16cq+15 in input order); pairs of
// lanes read one 32-byte sector of a row
__device__ __forceinline__ void unit_of(int v, int& g, int& cq) {
  g = (v >> 1) % R2_WORDS;
  cq = (v & 1) | (((v >> 1) / R2_WORDS) << 1);
}

template <bool CW, int WORD>
__device__ __forceinline__ void load_unit(const Params& p, const Tile& tl, int g, int cq,
                                          uint4 (&a)[4]) {
  const uint8_t* in = in_plane(p, tl.k) + tl.f * p.sb;
  // input columns of the tile: 90: r0 + oy0 + (output row); 270: w - 1 -
  // (r0 + oy0 + (output row)), i.e. from ix0 upwards in reverse
  const int ix0 = CW ? p.r0 + tl.oy0 : p.w - p.r0 - tl.oy0 - R2_ROWS;
  const int x = ix0 + 16 * cq;
  const bool cols = x >= 0 && x + 16 <= p.w;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ox = tl.c0 - R2_MARGIN + 4 * g + j;  // the output column
    const int y = CW ? p.h - 1 - ox : ox;          // its input row
    a[j] = make_uint4(0, 0, 0, 0);
    if (ox < 0 || ox >= p.h) continue;  // ow == h
    const uint8_t* src = in + (long long)y * p.sy + x;
    if (cols) {
      if (WORD == 16) {
        a[j] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src);
        a[j] = make_uint4(__ldg(s4), __ldg(s4 + 1), __ldg(s4 + 2), __ldg(s4 + 3));
      }
    } else {
      uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        if (x + c >= 0 && x + c < p.w) v[c >> 2] |= (uint32_t)__ldg(src + c) << (8 * (c & 3));
      }
      a[j] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <bool CW, int WORD>
__global__ void __launch_bounds__(R2_THREADS) flip_tiles16(const Params p, int across,
                                                           int down, long long items) {
  __shared__ uint32_t tile[R2_ROWS][R2_PITCH];  // [output row][staged output word]
  const int t = threadIdx.x;
  long long item = blockIdx.x;
  uint4 a[R2_UNITS][4];

  auto load = [&](long long it) {
    const Tile tl = tile_of(it, p.planes, across, down);
#pragma unroll
    for (int n = 0; n < R2_UNITS; ++n) {
      int g, cq;
      unit_of(t + n * R2_THREADS, g, cq);
      load_unit<CW, WORD>(p, tl, g, cq, a[n]);
    }
  };

  if (item < items) load(item);
  while (item < items) {
    const Tile tl = tile_of(item, p.planes, across, down);
    // each unit's 16 input columns, 4 x 4 blocks transposed: input column
    // 16cq + 4q + c holds output row 16cq + 4q + c (90) or its mirror (270)
#pragma unroll
    for (int n = 0; n < R2_UNITS; ++n) {
      int g, cq;
      unit_of(t + n * R2_THREADS, g, cq);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t col[4];
        transpose4(word_of(a[n][0], q), word_of(a[n][1], q), word_of(a[n][2], q),
                   word_of(a[n][3], q), col);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 16 * cq + 4 * q + c;
          tile[CW ? i : R2_ROWS - 1 - i][g] = col[c];
        }
      }
    }
    __syncthreads();
    const long long next = item + gridDim.x;
    uint8_t* out = out_plane(p, tl.k) + tl.f * p.ob;
#pragma unroll
    for (int e = t; e < R2_ROWS * R2_CHUNKS; e += R2_THREADS) {
      const int rr = e / R2_CHUNKS, q = e - rr * R2_CHUNKS;
      const int oy = tl.oy0 + rr;
      if (oy >= p.rows) continue;
      uint8_t* row = out + (long long)oy * p.ow;
      const int skew = (int)((uintptr_t)(row + tl.c0) & 31);
      const int x = tl.c0 - skew + 16 * q;  // the chunk's first output column
      if (x + 16 <= 0 || x >= p.ow) continue;
      const int u = R2_MARGIN - skew + 16 * q;  // its staged column
      const uint32_t* src = tile[rr] + (u >> 2);
      const int sh = 8 * (u & 3);
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __funnelshift_r(src[j], src[j + 1], sh);
      if (x >= 0 && x + 16 <= p.ow) {
        *reinterpret_cast<uint4*>(row + x) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {  // across the row's first or last sector
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          if (x + c >= 0 && x + c < p.ow) row[x + c] = (uint8_t)(v[c >> 2] >> (8 * (c & 3)));
        }
      }
    }
    __syncthreads();
    if (next < items) load(next);
    item = next;
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

// route 2's persistent grid: every tile of every frame and plane, at most
// what the card holds at once
template <bool CW, int WORD>
int launch_tiles16(const Params& p, int batch, cudaStream_t s) {
  static int resident[64] = {0}, busy[64] = {0};  // blocks the card holds, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!resident[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flip_tiles16<CW, WORD>,
                                                          R2_THREADS, 0);
    }
    if (err != cudaSuccess) return (int)err;
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
    busy[dev] = sms * (per_sm < R2_BUSY_BLOCKS ? (per_sm > 0 ? per_sm : 1) : R2_BUSY_BLOCKS);
  }
  // a row's skew is below 32: R2_COLS columns a tile from c0 - skew cover
  // [0, ow) with ceil((ow + 31) / R2_COLS) tiles
  const int across = (p.ow + 31 + R2_COLS - 1) / R2_COLS;
  const int down = (p.rows + R2_ROWS - 1) / R2_ROWS;
  const long long items = (long long)batch * down * across * p.planes;
  const long long blocks = items >= (long long)busy[dev] * R2_BUSY_TILES ? busy[dev]
                           : items < resident[dev] ? items : resident[dev];
  flip_tiles16<CW, WORD><<<(unsigned)blocks, R2_THREADS, 0, s>>>(p, across, down, items);
  return (int)cudaGetLastError();
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
// stride 16-byte aligned) or 2 (90 / 270 over byte tiles: elem 1, loads of
// `word` bytes, 4 or 16, which divides the input's bases and strides and
// its first column, r0 at 90 and w - r0 at 270), as ops/flip.flip_route
// picks.
// Launches on `stream` and returns the launch's error.
extern "C" int isp_flip(const void* in0, const void* in1, const void* in2, void* out0, void* out1,
                        void* out2, int planes, int batch, int h, int w, int elem, long long sb,
                        long long sy, long long ob, int angle, int r0, int r1, int route, int word,
                        void* stream) {
  const int oh = angle == 180 ? h : w, ow = angle == 180 ? w : h;
  if (planes < 1 || planes > MAX_PLANES || batch < 1 || batch > 65535 || h <= 0 || w <= 0 ||
      elem < 1 || elem > 16 || (angle != 90 && angle != 180 && angle != 270) || r0 < 0 ||
      r1 < r0 || r1 > oh || (word & (word - 1)) || word < 1 || word > 16 ||
      (route != 2 && elem % word) || (route == 1 && (angle != 180 || elem != 1 || w % 16)) ||
      (route == 2 && (angle == 180 || elem != 1 || (word != 4 && word != 16) ||
                      (angle == 90 ? r0 : w - r0) % word)) ||
      route < 0 || route > 2) {
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
  if ((route == 1 && !aligned(p, 16, true)) || (route == 2 && !aligned(p, word, false)) ||
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
    if (angle == 90) return word == 16 ? launch_tiles16<true, 16>(p, batch, s)
                                       : launch_tiles16<true, 4>(p, batch, s);
    return word == 16 ? launch_tiles16<false, 16>(p, batch, s)
                      : launch_tiles16<false, 4>(p, batch, s);
  }
  switch (word) {
    case 1: return (int)launch_words<uint8_t>(p, batch, s);
    case 2: return (int)launch_words<uint16_t>(p, batch, s);
    case 4: return (int)launch_words<uint32_t>(p, batch, s);
    case 8: return (int)launch_words<uint2>(p, batch, s);
    default: return (int)launch_words<uint4>(p, batch, s);
  }
}
