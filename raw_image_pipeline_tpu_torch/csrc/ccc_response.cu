// Kernel C: the CCC response, resp = Re(IDFT2(DFT2(X) * W)) / 256^2 + bias.
//
// Replaces: raw_image_pipeline_tpu/ops/ccc.py `_response_pallas_kernel`
// (line 280), reached through `_response_pallas` (line 315).
//
// What bounds it on the H100: f32 FMA issue. Per frame the response is
// twelve real 256x256x256 products, 12 * 2 * 256^3 = 402.7 MFLOP (the
// operands, 256 KB each, stay in L2). TF32 and the tensor cores are not
// used: the argmax this feeds must match the f32 plain version.
//
// Four launches on the caller's stream, each a batched complex product of
// 256x256 matrices. With F = Fr + i*Fi the DFT matrix (symmetric, so F^T
// = F and conj(F)^T = conj(F)):
//   1. Q   = F @ X                  X real; written transposed, Q^T
//   2. Z   = (Q @ F) * W            the filter product fused, written as is
//   3. G   = conj(F) @ Z            written transposed, G^T
//   4. resp = Re(G @ conj(F)) / 256^2 + bias   scale and bias fused
// (1 and 2 are the forward DFT2 = F X F, 3 and 4 the inverse.) Stages
// 1-4 do 2, 4, 4 and 2 real products. A conjugate operand is a sign in the
// FMAs (an exact negation). The W product and the scale-and-bias epilogue
// keep __fmul_rn/__fadd_rn/__fsub_rn.
//
// Every operand is read K-major: a left operand L[m][k] from memory that
// holds L^T ([k][m]), a right operand R[k][n] as it is. F needs no
// transpose, X and Z are right operands, and stages 1 and 3 write their
// outputs transposed for stages 2 and 4 to read as left operands. So every
// shared-memory tile is a straight copy of global rows: 16-byte cp.async
// copies, no transposed scalar store.
//
// Design of one stage: a block computes a 32x32 output tile of one frame
// (grid 8 x 8 x B: 256 blocks at B=4 for the 132 SMs, two resident per SM)
// over all of K = 256, with its four warps splitting K (split-K inside the
// block: each warp takes 16 of every 64 rows of K) and a register tile of
// 4x8 complex values per thread. The K rows arrive in four steps of 64
// through a 3-stage cp.async pipeline (96 KB of shared memory). Reads of
// the tiles are conflict-free: a warp reads, per K row, 8 distinct float4s
// of the left tile and 4 of the right (all others broadcast). At the end
// the warps' partial sums meet in shared memory (rows padded to 36 floats:
// no bank conflicts) and are added in a fixed order, warp 0 + 1 + 2 + 3,
// so the result is the same on every run; then the epilogue writes the
// tile, coalesced.
//
// Four launches rather than one persistent launch with grid-wide syncs:
// a trace shows the four kernels back to back on the stream, about a
// microsecond apart. Stages 2-4 are launched as programmatic dependents
// of the stage before (cudaLaunchAttributeProgrammaticStreamSerialization):
// their blocks start while the previous stage drains, fetch their first
// tiles of F, and wait (griddepcontrol.wait) for the previous stage's
// output before they read it.

#include <cuda_runtime.h>

namespace {

constexpr int N = 256;          // the histogram is N x N; every product is N^3
constexpr int TILE = 32;        // output tile: TILE x TILE per block
constexpr int KG = 4;           // warps per block, each a slice of K
constexpr int THREADS = 32 * KG;
constexpr int KSTEP = 64;       // K rows per pipeline step
constexpr int KW = KSTEP / KG;  // K rows per warp per step
constexpr int STEPS = N / KSTEP;
constexpr int STAGES = 3;       // cp.async pipeline depth
constexpr int TILE_FLOATS = KSTEP * TILE;
constexpr int SMEM_BYTES = STAGES * 4 * TILE_FLOATS * (int)sizeof(float);
constexpr int PS = 36;          // padded row of the partial sums
static_assert(KSTEP % KG == 0 && N % KSTEP == 0 && N % TILE == 0, "tiling");
static_assert(2 * KG * TILE * PS * (int)sizeof(float) <= SMEM_BYTES, "partials fit");
static_assert((TILE_FLOATS / 4) % THREADS == 0, "whole cp.async rounds");

enum Epilogue { kStoreTransposed = 0, kTimesW = 1, kScaleBias = 2 };

struct Args {
  const float* l_re;  // left operand L[m][k], read from L^T ([k][m])
  const float* l_im;
  long long l_stride;  // per frame; 0 for a constant shared by every frame
  const float* r_re;   // right operand R[k][n]
  const float* r_im;   // nullptr: a real operand
  long long r_stride;
  float* out_re;  // [B][N][N]
  float* out_im;
  const float* w_re;  // kTimesW: the filter's DFT, [N][N]
  const float* w_im;
  const float* bias;  // kScaleBias: [N][N]
  float scale;
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}
// programmatic dependent launch: let the next stage's blocks start; wait
// until the previous stage has finished and its writes are visible (at
// once for a kernel launched without the attribute)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}
__device__ __forceinline__ void wait_for_previous_stage() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// R_CPLX: the right operand is complex; OUT_CPLX: the output is; L_CONJ,
// R_CONJ: an operand is conjugated.
template <bool R_CPLX, bool OUT_CPLX, bool L_CONJ, bool R_CONJ, int EPI>
__global__ void __launch_bounds__(THREADS, 2) dft_stage_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ty = lane >> 2, tx = lane & 3;  // rows 4*ty.., cols 4*tx.. and 16+4*tx..
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const long long z = blockIdx.z;
  const float* lre = a.l_re + z * a.l_stride;
  const float* lim = a.l_im + z * a.l_stride;
  const float* rre = a.r_re + z * a.r_stride;
  const float* rim = R_CPLX ? a.r_im + z * a.r_stride : nullptr;

  // stage s holds four KSTEP x TILE tiles: L re, L im, R re, R im
  auto tile = [&](int s, int part) { return smem + (s * 4 + part) * TILE_FLOATS; };
  // the operand that is F (a constant, stride 0) and the one that an
  // earlier stage or op wrote
  const bool l_const = a.l_stride == 0;
  auto load = [&](int step, int s, bool left, bool right) {
    const int k0 = step * KSTEP;
#pragma unroll
    for (int p = 0; p < TILE_FLOATS / 4 / THREADS; ++p) {
      const int q = t + p * THREADS;
      const int row = q / (TILE / 4), col = (q % (TILE / 4)) * 4;
      const size_t g = (size_t)(k0 + row) * N + col;
      const int so = row * TILE + col;
      if (left) {
        cp_async16(tile(s, 0) + so, lre + g + m0);
        cp_async16(tile(s, 1) + so, lim + g + m0);
      }
      if (right) {
        cp_async16(tile(s, 2) + so, rre + g + n0);
        if (R_CPLX) cp_async16(tile(s, 3) + so, rim + g + n0);
      }
    }
  };

  float acc_re[4][8] = {}, acc_im[4][8] = {};

  // F's first tiles are fetched before the previous stage has finished
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s, s, l_const, !l_const);
  wait_for_previous_stage();
  launch_dependents();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load(s, s, !l_const, l_const);
    cp_async_commit();
  }
#pragma unroll 1
  for (int step = 0; step < STEPS; ++step) {
    // the buffer refilled here was read in the previous step, which ended
    // with a barrier
    if (step + STAGES - 1 < STEPS)
      load(step + STAGES - 1, (step + STAGES - 1) % STAGES, true, true);
    cp_async_commit();  // an empty group keeps the count uniform
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int s = step % STAGES;
    const float* sLr = tile(s, 0) + warp * KW * TILE;
    const float* sLi = tile(s, 1) + warp * KW * TILE;
    const float* sRr = tile(s, 2) + warp * KW * TILE;
    const float* sRi = tile(s, 3) + warp * KW * TILE;
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const float4 lr4 = *reinterpret_cast<const float4*>(sLr + kk * TILE + 4 * ty);
      const float4 li4 = *reinterpret_cast<const float4*>(sLi + kk * TILE + 4 * ty);
      const float4 ra = *reinterpret_cast<const float4*>(sRr + kk * TILE + 4 * tx);
      const float4 rb = *reinterpret_cast<const float4*>(sRr + kk * TILE + 16 + 4 * tx);
      const float lr[4] = {lr4.x, lr4.y, lr4.z, lr4.w};
      const float li[4] = {li4.x, li4.y, li4.z, li4.w};
      const float rr[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
      float ri[8] = {};
      if (R_CPLX) {
        const float4 ia = *reinterpret_cast<const float4*>(sRi + kk * TILE + 4 * tx);
        const float4 ib = *reinterpret_cast<const float4*>(sRi + kk * TILE + 16 + 4 * tx);
        ri[0] = ia.x; ri[1] = ia.y; ri[2] = ia.z; ri[3] = ia.w;
        ri[4] = ib.x; ri[5] = ib.y; ri[6] = ib.z; ri[7] = ib.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (!R_CPLX) {  // (lr + i li) * rr
            acc_re[i][j] = fmaf(lr[i], rr[j], acc_re[i][j]);
            acc_im[i][j] = fmaf(li[i], rr[j], acc_im[i][j]);
          } else {
            // (lr + i sl li)(rr + i sr ri): re = lr rr - sl sr li ri,
            // im = sr lr ri + sl li rr
            acc_re[i][j] = fmaf(lr[i], rr[j], acc_re[i][j]);
            acc_re[i][j] = fmaf(L_CONJ == R_CONJ ? -li[i] : li[i], ri[j], acc_re[i][j]);
            if (OUT_CPLX) {
              acc_im[i][j] = fmaf(R_CONJ ? -lr[i] : lr[i], ri[j], acc_im[i][j]);
              acc_im[i][j] = fmaf(L_CONJ ? -li[i] : li[i], rr[j], acc_im[i][j]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // the warps' partial sums: part[warp][re, im][row][col], rows of PS floats
  auto part = [&](int w, int c, int m) { return smem + ((w * 2 + c) * TILE + m) * PS; };
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* d = part(warp, 0, 4 * ty + i) + 16 * h + 4 * tx;
      *reinterpret_cast<float4*>(d) = make_float4(acc_re[i][4 * h], acc_re[i][4 * h + 1],
                                                  acc_re[i][4 * h + 2], acc_re[i][4 * h + 3]);
      if (OUT_CPLX) {
        d = part(warp, 1, 4 * ty + i) + 16 * h + 4 * tx;
        *reinterpret_cast<float4*>(d) = make_float4(acc_im[i][4 * h], acc_im[i][4 * h + 1],
                                                    acc_im[i][4 * h + 2], acc_im[i][4 * h + 3]);
      }
    }
  }
  __syncthreads();

  const size_t frame = (size_t)z * N * N;
  if (EPI == kStoreTransposed) {
    // out^T[n][m]: a thread takes column n = lane and RPW rows, and writes
    // them as contiguous floats of out^T's row n
    constexpr int RPW = TILE / KG;
    const int n = lane, mb = warp * RPW;
#pragma unroll
    for (int c = 0; c < (OUT_CPLX ? 2 : 1); ++c) {
      float v[RPW];
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        float sum = part(0, c, mb + j)[n];
#pragma unroll
        for (int w = 1; w < KG; ++w) sum = __fadd_rn(sum, part(w, c, mb + j)[n]);
        v[j] = sum;
      }
      float* o = (c == 0 ? a.out_re : a.out_im) + frame + (size_t)(n0 + n) * N + m0 + mb;
#pragma unroll
      for (int j = 0; j < RPW; j += 4)
        *reinterpret_cast<float4*>(o + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  } else {
    // row-major: TPR threads per row, CPT contiguous columns each
    constexpr int TPR = THREADS / TILE, CPT = TILE / TPR;
    const int m = t / TPR, cb = (t % TPR) * CPT;
    const size_t e = (size_t)(m0 + m) * N + n0 + cb;
#pragma unroll
    for (int q = 0; q < CPT; q += 4) {
      float yr[4], yi[4];
#pragma unroll
      for (int c = 0; c < (OUT_CPLX ? 2 : 1); ++c) {
        float4 sum = *reinterpret_cast<const float4*>(part(0, c, m) + cb + q);
#pragma unroll
        for (int w = 1; w < KG; ++w) {
          const float4 p = *reinterpret_cast<const float4*>(part(w, c, m) + cb + q);
          sum = make_float4(__fadd_rn(sum.x, p.x), __fadd_rn(sum.y, p.y),
                            __fadd_rn(sum.z, p.z), __fadd_rn(sum.w, p.w));
        }
        float* y = c == 0 ? yr : yi;
        y[0] = sum.x; y[1] = sum.y; y[2] = sum.z; y[3] = sum.w;
      }
      if (EPI == kTimesW) {
        const float4 wr4 = *reinterpret_cast<const float4*>(a.w_re + e + q);
        const float4 wi4 = *reinterpret_cast<const float4*>(a.w_im + e + q);
        const float wr[4] = {wr4.x, wr4.y, wr4.z, wr4.w};
        const float wi[4] = {wi4.x, wi4.y, wi4.z, wi4.w};
        float zr[4], zi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          zr[j] = __fsub_rn(__fmul_rn(yr[j], wr[j]), __fmul_rn(yi[j], wi[j]));
          zi[j] = __fadd_rn(__fmul_rn(yr[j], wi[j]), __fmul_rn(yi[j], wr[j]));
        }
        *reinterpret_cast<float4*>(a.out_re + frame + e + q) =
            make_float4(zr[0], zr[1], zr[2], zr[3]);
        *reinterpret_cast<float4*>(a.out_im + frame + e + q) =
            make_float4(zi[0], zi[1], zi[2], zi[3]);
      } else {  // kScaleBias
        const float4 b4 = *reinterpret_cast<const float4*>(a.bias + e + q);
        *reinterpret_cast<float4*>(a.out_re + frame + e + q) = make_float4(
            __fadd_rn(__fmul_rn(yr[0], a.scale), b4.x), __fadd_rn(__fmul_rn(yr[1], a.scale), b4.y),
            __fadd_rn(__fmul_rn(yr[2], a.scale), b4.z), __fadd_rn(__fmul_rn(yr[3], a.scale), b4.w));
      }
    }
  }
}

template <bool R_CPLX, bool OUT_CPLX, bool L_CONJ, bool R_CONJ, int EPI>
cudaError_t launch_stage(const Args& a, int batch, cudaStream_t st, bool after_stage) {
  auto kernel = dft_stage_kernel<R_CPLX, OUT_CPLX, L_CONJ, R_CONJ, EPI>;
  // above 48 KB, dynamic shared memory needs the attribute, set once per
  // function and device
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (dev < 64) configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / TILE, N / TILE, batch);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after_stage ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x [B,N,N]; fr, fi: the DFT matrix; wr, wi: the filter's DFT; bias [N,N];
// out [B,N,N]; scratch [4,B,N,N]. All f32, contiguous, on one device.
extern "C" int isp_ccc_response(const void* x, const void* fr, const void* fi,
                                const void* wr, const void* wi,
                                const void* bias, void* out, void* scratch,
                                int batch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nn = (long long)N * N;
  float* s0 = (float*)scratch;
  float* s1 = s0 + nn * batch;
  float* s2 = s0 + 2 * nn * batch;
  float* s3 = s0 + 3 * nn * batch;
  const float* Fr = (const float*)fr;
  const float* Fi = (const float*)fi;
  cudaError_t err;
  // 1. Q^T, Q = F @ X
  err = launch_stage<false, true, false, false, kStoreTransposed>(
      Args{Fr, Fi, 0, (const float*)x, nullptr, nn, s0, s1, nullptr, nullptr, nullptr, 0.f},
      batch, st, false);
  if (err != cudaSuccess) return (int)err;
  // 2. Z = (Q @ F) * W
  err = launch_stage<true, true, false, false, kTimesW>(
      Args{s0, s1, nn, Fr, Fi, 0, s2, s3, (const float*)wr, (const float*)wi, nullptr, 0.f},
      batch, st, true);
  if (err != cudaSuccess) return (int)err;
  // 3. G^T, G = conj(F) @ Z
  err = launch_stage<true, true, true, false, kStoreTransposed>(
      Args{Fr, Fi, 0, s2, s3, nn, s0, s1, nullptr, nullptr, nullptr, 0.f}, batch, st, true);
  if (err != cudaSuccess) return (int)err;
  // 4. resp = Re(G @ conj(F)) / N^2 + bias
  err = launch_stage<true, false, false, true, kScaleBias>(
      Args{s0, s1, nn, Fr, Fi, 0, (float*)out, nullptr, nullptr, nullptr, (const float*)bias,
           1.f / (float)(N * N)},
      batch, st, true);
  return (int)err;
}
