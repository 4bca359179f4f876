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
// What bounds it on the H100: bytes. The taps of an output row at 1920 ->
// 360 are two bytes every 5.33 of two source rows, so every 32-byte sector
// of those rows is fetched whatever reads them: the floor is the tapped
// rows read whole (the sector floor of tools/measure.ccc_resize_work),
// 2.67x the tap bytes. Its integer work (about 25 instructions an output
// value from shared memory) is the second limit: it must overlap the
// staging to reach the floor.
//
// Two paths (ops/resize.resize_path picks one):
//   rows   — planes and output of column stride 1 (the chain's planar
//            planes and the mesh's slabs) at batches of 8 frames or
//            more (below, the gather path is the faster). An item is a
//            band of BAND_ROWS output rows of every plane of one frame; a
//            persistent grid of warp-specialised blocks walks the items.
//            A producer warp
//            stages each distinct source row an item taps once and whole,
//            by one 1-D bulk copy (TMA) a row, into a ring of STAGES
//            buffers in shared memory, ahead of the consumers; consumer
//            warps compute the item's outputs from shared memory (a lane
//            LANE_COLS columns, a warp's loads on neighbouring columns)
//            and store each row as 32-bit words where the output allows.
//            The staged rows and the slots each output row reads come
//            from the host's band table (ops/resize.resize_bands), made
//            from the table's sy/sy2. The kernel is a programmatic
//            dependent of the one before it: its prologue may overlap that
//            kernel's drain, and it reads the planes only after
//            griddepcontrol.wait.
//   gather — anything else (the op layer's [..., H, W, 3] frames read as
//            planes of column stride 3, an output of another column
//            stride): one thread per output pixel and all planes, four
//            byte gathers a plane, blocks of 32 columns x 8 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int MAX_PLANES = 3;
constexpr int LANE_COLS = 2;  // rows path: output columns a consumer lane takes an item
constexpr int CONSUMERS = 192;  // rows path: consumer threads, 384 columns an item at once
constexpr int ROWS_THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 2;  // rows path: items staged ahead
constexpr int BAND_ROWS = 2;  // output rows an item of the rows path (ops/resize.BAND_ROWS)
constexpr int MAX_SLOTS = 2 * BAND_ROWS;  // staged rows a band: two taps an output row
static_assert(MAX_PLANES * MAX_SLOTS <= 32, "a lane a staged row");
constexpr int ROWS_SMEM_LIMIT = 96 * 1024;  // ops/resize.ROWS_SMEM_LIMIT

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

// the mbarrier and 1-D bulk copy (TMA) primitives of the rows path
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
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
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bytes of shared memory a staged row takes: its 16-byte chunks from the
// one holding its first byte to the one holding its last, at most
// src_w / 16 + 2 (ops/resize.row_pitch)
__host__ __device__ __forceinline__ int row_pitch(int src_w) { return 16 * (src_w / 16 + 2); }

// the rows path's dynamic shared memory (ops/resize.rows_smem): STAGES
// buffers of a band's staged rows, nplanes * slots rows of row_pitch bytes
long long rows_stage(int nplanes, int slots, int src_w) {
  return (long long)nplanes * slots * row_pitch(src_w);
}
long long rows_smem(int nplanes, int slots, int src_w) {
  return STAGES * rows_stage(nplanes, slots, src_w);
}

struct Band {  // what the producer needs of the launch
  const int* bands;  // a row of slots + 2 * BAND_ROWS int32 a band (ops/resize.resize_bands)
  int n_bands, slots, src_w, stage;  // stage: one buffer's bytes
  long long in_frame, in_row;
};

struct Meta {  // an item as the producer leaves it beside its staged rows
  long long frame;
  int y0, nrows;
  int q[BAND_ROWS][2];  // the slots of each output row's sy and sy2
  int b[BAND_ROWS][2];  // its vertical weights b0, b1
  int off[MAX_PLANES * MAX_SLOTS];  // each staged row's address % 16
};

// a persistent grid over the items (frame, band of BAND_ROWS output rows),
// frame-major, block b taking items b, b + gridDim.x, ...; warp-specialised:
// the last warp produces (stages each item's rows into a ring of STAGES
// buffers, a bulk copy a row, ahead of the consumers), the CONSUMERS
// threads before it consume, each warp on its own (32 * LANE_COLS
// neighbouring output columns of every row and plane of the item from
// shared memory, stored as 32-bit words). full[s] completes when stage s's
// bytes and meta are in; empty[s] when every consumer warp has read it.
__global__ void __launch_bounds__(ROWS_THREADS, 4)
ccc_resize_rows_kernel(Planes planes, int nplanes, const int* __restrict__ table, Band bd,
                       int batch, int dst_w, int rows, Strides out, int words) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ Meta meta[STAGES];
  // each consumer warp's outputs of an item, BAND_ROWS * MAX_PLANES rows of its columns
  __shared__ __align__(4) uint8_t s_out[CONSUMERS / 32][BAND_ROWS * MAX_PLANES * 32 * LANE_COLS];
  const int t = threadIdx.x, pitch = row_pitch(bd.src_w), slots = bd.slots;
  const int items = batch * bd.n_bands;
  const int* ty = table + 4 * dst_w;
  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (t >= CONSUMERS) {  // the producer warp: lane q stages row q = p * slots + s
    const int q = t - CONSUMERS;
    // lane q's part of an item's band row (its staged row; for q < 2 *
    // BAND_ROWS an output row's slot and vertical weight), loaded an item
    // ahead so that its latency overlaps the item before
    auto fetch = [&](int w, int& row, int& slot, int& weight) {
      const int band = w % bd.n_bands;
      const int* brow = bd.bands + band * (slots + 2 * BAND_ROWS);
      const int nrows = min(BAND_ROWS, rows - band * BAND_ROWS);
      row = q < nplanes * slots ? brow[q % slots] : -1;
      slot = q < 2 * BAND_ROWS ? brow[slots + q] : 0;
      weight = q < 2 * BAND_ROWS
                   ? ty[(2 + q % 2) * rows + band * BAND_ROWS + min(q / 2, nrows - 1)] : 0;
    };
    int row, slot, weight;
    if (blockIdx.x < items) fetch(blockIdx.x, row, slot, weight);
    // launched as a programmatic dependent of the kernel before: everything
    // above overlapped its drain; its output (the planes) is read only
    // from here on, and every global store of the block follows a copy
    // issued here
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    int i = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x, ++i) {
      int next_row = -1, next_slot = 0, next_weight = 0;
      if (w + (int)gridDim.x < items) fetch(w + gridDim.x, next_row, next_slot, next_weight);
      const int s = i % STAGES;
      if (i >= STAGES) bar_wait(&empty[s], (i / STAGES - 1) & 1);
      const int frame = w / bd.n_bands, band = w - frame * bd.n_bands;
      Meta& m = meta[s];
      if (q < 2 * BAND_ROWS) {
        m.q[q / 2][q % 2] = slot;
        m.b[q / 2][q % 2] = weight;
      }
      uintptr_t first = 0, end = 0;
      if (row >= 0) {
        const int p = q / slots;
        const uint8_t* src = p == 0 ? planes.src[0] : p == 1 ? planes.src[1] : planes.src[2];
        const uintptr_t lo = (uintptr_t)(src + frame * bd.in_frame + row * bd.in_row);
        // the 16-byte chunks from the one holding the row's first byte to
        // the one holding its last, so byte i of the row lands at q * pitch
        // + (its address % 16) + i; the few bytes of those two chunks
        // outside the row are read and never used (an aligned 16-byte chunk
        // that holds a byte of the tensor lies in the same memory page)
        first = lo & ~(uintptr_t)15;
        end = (lo + bd.src_w + 15) & ~(uintptr_t)15;
        m.off[q] = (int)(lo - first);
        bulk_copy(smem + s * bd.stage + q * pitch, (const void*)first, (unsigned)(end - first),
                  &full[s]);
      }
      const unsigned total = __reduce_add_sync(0xffffffffu, (unsigned)(end - first));
      if (q == 0) {
        m.frame = frame;
        m.y0 = band * BAND_ROWS;
        m.nrows = min(BAND_ROWS, rows - band * BAND_ROWS);
      }
      __syncwarp();
      if (q == 0) bar_arrive_expect(&full[s], total);  // releases the meta written above
      row = next_row;
      slot = next_slot;
      weight = next_weight;
    }
    return;
  }

  // the consumers, each warp on its own: a warp takes LANE_COLS * 32
  // output columns, lane l the columns l, l + 32, ... of them (a warp's
  // loads of one row and plane read 32 neighbouring columns' taps: few
  // bank conflicts); every output of a column is computed before any is
  // stored (the stores could alias the loads), into the warp's own rows
  // of shared memory, which go out as 32-bit words
  const int lane = t % 32, warp = t / 32;
  constexpr int SPAN = 32 * LANE_COLS;  // a warp's columns
  uint8_t* w_out = s_out[warp];
  int sx_t[LANE_COLS], sx2_t[LANE_COLS], a0_t[LANE_COLS], a1_t[LANE_COLS];  // first columns
#pragma unroll
  for (int k = 0; k < LANE_COLS; ++k) {
    const int xe = min(warp * SPAN + 32 * k + lane, dst_w - 1);
    sx_t[k] = table[xe];
    sx2_t[k] = table[dst_w + xe];
    a0_t[k] = table[2 * dst_w + xe];
    a1_t[k] = table[3 * dst_w + xe];
  }
  int i = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x, ++i) {
    const int s = i % STAGES;
    bar_wait(&full[s], (i / STAGES) & 1);
    const Meta& m = meta[s];
    const int nrows = m.nrows, y0 = m.y0;
    const long long frame = m.frame;
    int b0[BAND_ROWS], b1[BAND_ROWS];
    // each output row's two staged rows, a plane, as offsets into smem
    int f0[BAND_ROWS][MAX_PLANES], f1[BAND_ROWS][MAX_PLANES];
#pragma unroll
    for (int yy = 0; yy < BAND_ROWS; ++yy) {
      b0[yy] = m.b[yy][0];
      b1[yy] = m.b[yy][1];
      const int q0 = m.q[min(yy, nrows - 1)][0], q1 = m.q[min(yy, nrows - 1)][1];
#pragma unroll
      for (int p = 0; p < MAX_PLANES; ++p) {
        const int pq0 = min(p, nplanes - 1) * slots + q0;
        const int pq1 = min(p, nplanes - 1) * slots + q1;
        f0[yy][p] = s * bd.stage + pq0 * pitch + m.off[pq0];
        f1[yy][p] = s * bd.stage + pq1 * pitch + m.off[pq1];
      }
    }
    uint8_t* o_row[BAND_ROWS][MAX_PLANES];  // each output row of the item, a plane
#pragma unroll
    for (int yy = 0; yy < BAND_ROWS; ++yy)
#pragma unroll
      for (int p = 0; p < MAX_PLANES; ++p)
        o_row[yy][p] = planes.dst[p] + frame * out.frame + (long long)(y0 + yy) * out.row;
    for (int base = warp * SPAN, chunk = 0; base < dst_w;
         base += CONSUMERS * LANE_COLS, ++chunk) {
#pragma unroll
      for (int k = 0; k < LANE_COLS; ++k) {
        int sx = sx_t[k], sx2 = sx2_t[k], a0 = a0_t[k], a1 = a1_t[k];
        if (chunk) {  // past the first CONSUMERS * LANE_COLS columns
          const int xe = min(base + 32 * k + lane, dst_w - 1);
          sx = table[xe];
          sx2 = table[dst_w + xe];
          a0 = table[2 * dst_w + xe];
          a1 = table[3 * dst_w + xe];
        }
        unsigned v[BAND_ROWS][MAX_PLANES];
#pragma unroll
        for (int yy = 0; yy < BAND_ROWS; ++yy) {
#pragma unroll
          for (int p = 0; p < MAX_PLANES; ++p) {
            const int r0 = f0[yy][p], r1 = f1[yy][p];
            const int s0 = ((int)smem[r0 + sx] * a0 + (int)smem[r0 + sx2] * a1) >> 4;
            const int s1 = ((int)smem[r1 + sx] * a0 + (int)smem[r1 + sx2] * a1) >> 4;
            const int r = (((b0[yy] * s0) >> 16) + ((b1[yy] * s1) >> 16) + 2) >> 2;
            v[yy][p] = (unsigned)min(max(r, 0), 255);  // the clamp is a guard
          }
        }
#pragma unroll
        for (int yy = 0; yy < BAND_ROWS; ++yy)
#pragma unroll
          for (int p = 0; p < MAX_PLANES; ++p)
            w_out[(yy * MAX_PLANES + p) * SPAN + 32 * k + lane] = (uint8_t)v[yy][p];
      }
      __syncwarp();
      // the warp's rows out, word j of a row (columns base + 4j ..) by lane j
      for (int j = lane; j < SPAN / 4; j += 32) {
        const int x = base + 4 * j;
#pragma unroll
        for (int yy = 0; yy < BAND_ROWS; ++yy) {
#pragma unroll
          for (int p = 0; p < MAX_PLANES; ++p) {
            if (yy < nrows && p < nplanes && x < dst_w) {
              const uint8_t* o_s = w_out + (yy * MAX_PLANES + p) * SPAN + 4 * j;
              uint8_t* o = o_row[yy][p] + x;
              if (words && x + 4 <= dst_w) {
                *reinterpret_cast<unsigned*>(o) = *reinterpret_cast<const unsigned*>(o_s);
              } else {
                for (int e = 0; e < min(4, dst_w - x); ++e) o[e] = o_s[e];
              }
            }
          }
        }
      }
      __syncwarp();  // w_out is free for the next columns
    }
    if (lane == 0) bar_arrive(&empty[s]);  // this warp is done with stage s
  }
}

}  // namespace

// src*, dst*: the first frame of each of nplanes (1-3) planes, all of one
// shape and strides (in elements: frame, row, column), unused ones null;
// table: int32 [4 * dst_w + 4 * rows] on the device (ops/resize.
// resize_table); batch: frames, at most 65535. bands: null for the gather
// path, else the rows path's band table on the device (ops/resize.
// resize_bands: ceil(rows / BAND_ROWS) rows of slots + 2 * BAND_ROWS
// int32), which needs column strides of 1 and rows_smem bytes within
// ROWS_SMEM_LIMIT. Returns the launch's error.
extern "C" int isp_ccc_resize(const void* src0, const void* src1, const void* src2, void* dst0,
                              void* dst1, void* dst2, int nplanes, const void* table,
                              const void* bands, int batch, int dst_w, int rows, int src_w,
                              int slots, long long in_frame, long long in_row,
                              long long in_col, long long out_frame, long long out_row,
                              long long out_col, void* stream) {
  if (nplanes < 1 || nplanes > MAX_PLANES || batch > 65535) return (int)cudaErrorInvalidValue;
  if (batch == 0 || dst_w == 0 || rows == 0) return (int)cudaSuccess;
  Planes planes = {{(const uint8_t*)src0, (const uint8_t*)src1, (const uint8_t*)src2},
                   {(uint8_t*)dst0, (uint8_t*)dst1, (uint8_t*)dst2}};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bands == nullptr) {
    const dim3 grid((dst_w + TX - 1) / TX, (rows + TY - 1) / TY, batch);
    ccc_resize_kernel<<<grid, dim3(TX, TY), 0, s>>>(planes, nplanes, (const int*)table, dst_w,
                                                    rows, Strides{in_frame, in_row, in_col},
                                                    Strides{out_frame, out_row, out_col});
    return (int)cudaGetLastError();
  }
  const long long smem = rows_smem(nplanes, slots, src_w);
  if (in_col != 1 || out_col != 1 || slots < 1 || slots > MAX_SLOTS || smem > ROWS_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  // the blocks that fit at once on the device, per device and shared memory
  static int sms[64] = {}, fit_smem[64] = {}, fit_blocks[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(ccc_resize_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, ROWS_SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (fit_smem[dev] != smem) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ccc_resize_rows_kernel, ROWS_THREADS,
                                                        (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    fit_blocks[dev] = n > 0 ? n : 1;
    fit_smem[dev] = (int)smem;
  }
  const int n_bands = (rows + BAND_ROWS - 1) / BAND_ROWS;
  const long long items = (long long)batch * n_bands;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < (long long)fit_blocks[dev] * sms[dev]
                             ? items : (long long)fit_blocks[dev] * sms[dev]);
  // 32-bit stores where every output row's first pixel is 4-byte aligned
  const int words = (out_frame | out_row) % 4 == 0 &&
                    ((uintptr_t)dst0 | (uintptr_t)dst1 | (uintptr_t)dst2) % 4 == 0;
  const Band bd = {(const int*)bands, n_bands, slots, src_w,
                   (int)rows_stage(nplanes, slots, src_w), in_frame, in_row};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(ROWS_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ccc_resize_rows_kernel, planes, nplanes, (const int*)table, bd,
                           batch, dst_w, rows, Strides{out_frame, out_row, out_col}, words);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
