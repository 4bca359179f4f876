// Kernel G: the chain's pointwise stretch in one pass over the planes, equal
// byte for byte to ops/pointwise.pointwise_plain, the composition of the
// stage functions it replaces, each step optional and in the chain's order:
//
//   0. the CCC gains: cv::multiply by per-frame [B, 3] gains, one f32
//      product, round half to even, saturate (ops/ccc.apply_gains_planes);
//   1. colour calibration: rn(rn(rn(b*m0) + rn(g*m1)) + rn(r*m2)), then
//      + bias, round, saturate (ops/color_calibration.color_correct_planes);
//   2. a u8 LUT (the BT.709 table, or the k table without vignetting);
//   3. vignetting: BGR2Lab through a linearize table passed in (the gamma
//      table composed in, or OpenCV's own), L = round_u8(f32(L) * mask[y, x]),
//      Lab2BGR (ops/vignetting.correct_planes, ops/colorspace);
//   4. the HSV enhancer: BGR2HSV, three u8 gain tables, HSV2BGR with cv2's
//      SIMD row kernel (final *255 floored) before column W - W % 32 and its
//      scalar kernel (rounded) from there (ops/color_enhancer.enhance_planes).
//
// Replaces: the JAX package leaves this stage to XLA, with no Pallas kernel:
// raw_image_pipeline_tpu/ops/ccc.py `apply_gains_planes` (line 447),
// ops/color_calibration.py `color_correct_planes` (line 22),
// ops/vignetting.py `correct_planes` (line 44) with `composed_gamma_lab_fn`
// (line 122), ops/color_enhancer.py `enhance_planes` (line 119). The port's
// plain versions run it as a few hundred eager passes over [B, H, W] tensors,
// with int32 and f32 temporaries of every intermediate.
//
// What bounds it on the H100: operations. Three bytes in and three out a
// pixel, but about 190 integer and f32 operations a pixel with every step
// on (tools/measure.POINTWISE_OPS), and a dozen table gathers.
//
// Design (a simple, correct first form): the constant tables (HSV division
// tables, the Lab cbrt table, Lab2BGR's y, ify and inverse-gamma tables and
// both conversions' coefficients; ops/pointwise.const_tables) and the call's
// own tables (linearize, LUT, enhancer gains) are staged in shared memory
// once per block, about 26 KB. Blocks are persistent (the SMs times their
// resident blocks) and walk tasks of one row of up to kFrames frames, a
// row's pixels across the block's threads: byte loads and stores coalesced
// along W, the row's mask value read once for the task's frames. A pixel's
// triple stays in registers from the first step to the last.
//
// Exactness: every f32 chain is written in __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc contracts nothing into an fma. HSV2BGR's two
// fma(-s, f, 1) are single-rounding fmas in the plain version too (Dekker's
// emulation, ops/common.fma_f32, equal to a true fma on all 2 x 65 536 of
// their operand pairs: tests/test_torch_pointwise.py), so they are
// __fmaf_rn here. Integer sums that could wrap are formed in unsigned
// arithmetic (int32 wrap, as torch's), `>>` on a negative int is arithmetic
// as torch's, `/` truncates as torch.div(rounding_mode="trunc").

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 4;  // frames a task: one mask load serves them all

// ops/pointwise.const_tables' layout (int32 entries)
constexpr int kSdiv = 0, kHdiv = 256, kCbrt = 512, kY = 3584, kIfy = 3840, kInvGamma = 4096,
              kLabCoef = 12288, kLab2Coef = 12297, kConstTables = 12306;
constexpr int kCbrtSize = 3072, kInvGammaSize = 8192;
static_assert(kInvGamma + kInvGammaSize == kLabCoef && kLab2Coef + 9 == kConstTables,
              "const_tables' layout");

// ops/colorspace's Lab constants
constexpr int kLabShift = 12, kLabShift2 = 15;
constexpr int kLScale = (116 * 255 + 50) / 100;
constexpr int kLShift = -((16 * 255 * (1 << kLabShift2) + 50) / 100);
constexpr int kLab2Base = 1 << 14;
constexpr int kLab2MinAB = -8145;
constexpr int kLab2ABMax = kLab2Base * 9 / 4 + kLab2MinAB - 1;
constexpr int kADivShift = 128 * kLab2Base / 500;
constexpr int kBDivShift = 128 * kLab2Base / 200;
constexpr float kInv255 = 0x1.010102p-8f;   // f32(1/255)
constexpr float kSixBy180 = 0x1.111112p-5f;  // f32(6/180)
constexpr int kSimdPx = 32;  // ops/color_enhancer.CV_SIMD_PX

struct Params {
  const uint8_t* in[3];
  uint8_t* out[3];
  long long in_sb, in_sy, in_sx, out_sb, out_sy, out_sx;  // strides in bytes
  int batch, h, w;
  const float* gains;   // [batch, 3] or null
  const float* matrix;  // [3, 3] row by row, or null
  const float* bias;    // [3], with matrix
  const uint8_t* lut;   // [256] or null
  const float* mask;    // [h, w] or null (no vignetting)
  const int* lab;       // [256] linearize table, with mask
  const uint8_t* enh;   // [3, 256] (H, S, V) gain tables, or null
  const int* tables;    // const_tables
};

__device__ __forceinline__ uint32_t round_u8(float x) {
  return (uint32_t)fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

__device__ __forceinline__ int clamp_i(int x, int lo, int hi) { return min(max(x, lo), hi); }

__device__ __forceinline__ int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

// int32 a*x + b*y + c*z with torch's wrap
__device__ __forceinline__ int dot3(int a, int x, int b, int y, int c, int z) {
  return (int)((uint32_t)a * (uint32_t)x + (uint32_t)b * (uint32_t)y + (uint32_t)c * (uint32_t)z);
}

// ops/colorspace._lab2_ab_to_xz
__device__ __forceinline__ int ab_to_xz(int i) {
  i = clamp_i(i, kLab2MinAB, kLab2ABMax);
  if (i <= 3390) return (i * 108) / 841 - 290;
  const int q = (i * i) >> 14;
  return (q * i) >> 14;
}

struct Shared {
  int sdiv[256], hdiv[256], cbrt[kCbrtSize], y[256], ify[256], lab[256];
  uint8_t inv_gamma[kInvGammaSize], lut[256], enh[768];
};

__global__ void __launch_bounds__(kThreads) pointwise_kernel(const Params p) {
  __shared__ Shared s;
  const int t0 = threadIdx.x;
  if (p.lut) {
    for (int i = t0; i < 256; i += kThreads) s.lut[i] = p.lut[i];
  }
  if (p.mask) {
    for (int i = t0; i < kCbrtSize; i += kThreads) s.cbrt[i] = p.tables[kCbrt + i];
    for (int i = t0; i < kInvGammaSize; i += kThreads) {
      s.inv_gamma[i] = (uint8_t)p.tables[kInvGamma + i];
    }
    for (int i = t0; i < 256; i += kThreads) {
      s.y[i] = p.tables[kY + i];
      s.ify[i] = p.tables[kIfy + i];
      s.lab[i] = p.lab[i];
    }
  }
  if (p.enh) {
    for (int i = t0; i < 256; i += kThreads) {
      s.sdiv[i] = p.tables[kSdiv + i];
      s.hdiv[i] = p.tables[kHdiv + i];
    }
    for (int i = t0; i < 768; i += kThreads) s.enh[i] = p.enh[i];
  }
  __syncthreads();

  float cc[12];  // the matrix row by row, then the bias
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    cc[i] = p.matrix ? __ldg(i < 9 ? p.matrix + i : p.bias + i - 9) : 0.0f;
  }
  int c1[9], c2[9];  // BGR2Lab's and Lab2BGR's coefficients
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    c1[i] = p.mask ? __ldg(p.tables + kLabCoef + i) : 0;
    c2[i] = p.mask ? __ldg(p.tables + kLab2Coef + i) : 0;
  }

  const int groups = (p.batch + kFrames - 1) / kFrames;
  const int tasks = p.h * groups;
  const int simd_end = p.w - p.w % kSimdPx;
  for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
    const int y = task / groups;
    const int f0 = (task - y * groups) * kFrames;
    const int nf = min(kFrames, p.batch - f0);
    for (int x = t0; x < p.w; x += kThreads) {
      const float m = p.mask ? __ldg(p.mask + (long long)y * p.w + x) : 0.0f;
      for (int f = f0; f < f0 + nf; ++f) {
        const long long io = f * p.in_sb + y * p.in_sy + x * p.in_sx;
        uint32_t b = p.in[0][io], g = p.in[1][io], r = p.in[2][io];
        if (p.gains) {
          const float* gn = p.gains + 3 * f;
          b = round_u8(__fmul_rn((float)b, __ldg(gn)));
          g = round_u8(__fmul_rn((float)g, __ldg(gn + 1)));
          r = round_u8(__fmul_rn((float)r, __ldg(gn + 2)));
        }
        if (p.matrix) {
          const float bf = (float)b, gf = (float)g, rf = (float)r;
          uint32_t o[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float v = __fadd_rn(__fmul_rn(bf, cc[3 * k]), __fmul_rn(gf, cc[3 * k + 1]));
            o[k] = round_u8(__fadd_rn(__fadd_rn(v, __fmul_rn(rf, cc[3 * k + 2])), cc[9 + k]));
          }
          b = o[0], g = o[1], r = o[2];
        }
        if (p.lut) {
          b = s.lut[b], g = s.lut[g], r = s.lut[r];
        }
        if (p.mask) {
          const int lb = s.lab[b], lg = s.lab[g], lr = s.lab[r];
          const int fx = s.cbrt[clamp_i(descale(dot3(lr, c1[0], lg, c1[1], lb, c1[2]), kLabShift),
                                        0, kCbrtSize - 1)];
          const int fy = s.cbrt[clamp_i(descale(dot3(lr, c1[3], lg, c1[4], lb, c1[5]), kLabShift),
                                        0, kCbrtSize - 1)];
          const int fz = s.cbrt[clamp_i(descale(dot3(lr, c1[6], lg, c1[7], lb, c1[8]), kLabShift),
                                        0, kCbrtSize - 1)];
          const int L = clamp_i(descale(kLScale * fy + kLShift, kLabShift2), 0, 255);
          const int A = clamp_i(descale(500 * (fx - fy) + 128 * (1 << kLabShift2), kLabShift2),
                                0, 255);
          const int Bb = clamp_i(descale(200 * (fy - fz) + 128 * (1 << kLabShift2), kLabShift2),
                                 0, 255);
          const uint32_t Lm = round_u8(__fmul_rn((float)L, m));
          const int yy = s.y[Lm], ify = s.ify[Lm];
          const int adiv = ((5 * A * 53687 + (1 << 7)) >> 13) - kADivShift;
          const int bdiv = ((Bb * 41943 + (1 << 4)) >> 9) - kBDivShift + 1;
          const int X = ab_to_xz(ify + adiv), Z = ab_to_xz(ify - bdiv);
          uint32_t o[3];
#pragma unroll
          for (int row = 0; row < 3; ++row) {
            const int sum = (int)((uint32_t)dot3(c2[3 * row], X, c2[3 * row + 1], yy,
                                                 c2[3 * row + 2], Z) + 8192u);
            o[row] = s.inv_gamma[clamp_i(sum >> 14, 0, kInvGammaSize - 1)];
          }
          b = o[2], g = o[1], r = o[0];
        }
        if (p.enh) {
          const int ib = (int)b, ig = (int)g, ir = (int)r;
          const int v = max(max(ib, ig), ir);
          const int diff = v - min(min(ib, ig), ir);
          const int sat = (diff * s.sdiv[v] + (1 << 11)) >> 12;
          const int hnum = v == ir ? ig - ib : (v == ig ? ib - ir + 2 * diff : ir - ig + 4 * diff);
          int hue = (hnum * s.hdiv[diff] + (1 << 11)) >> 12;
          hue += hue < 0 ? 180 : 0;
          const float hh = (float)s.enh[hue & 255];
          const float ss = __fmul_rn((float)s.enh[256 + (sat & 255)], kInv255);
          const float vv = __fmul_rn((float)s.enh[512 + (v & 255)], kInv255);
          const float hf = __fmul_rn(hh, kSixBy180);
          int sector = (int)floorf(hf);
          const float ff = __fsub_rn(hf, (float)sector);
          sector %= 6;
          const float t1 = __fmul_rn(vv, __fsub_rn(1.0f, ss));
          const float t2 = __fmul_rn(vv, __fmaf_rn(-ss, ff, 1.0f));
          const float t3 = __fmul_rn(vv, __fmaf_rn(-ss, __fsub_rn(1.0f, ff), 1.0f));
          float ob, og, orr;  // ops/colorspace._SECTOR_DATA
          switch (sector) {
            case 0: ob = t1, og = t3, orr = vv; break;
            case 1: ob = t1, og = vv, orr = t2; break;
            case 2: ob = t3, og = vv, orr = t1; break;
            case 3: ob = vv, og = t2, orr = t1; break;
            case 4: ob = vv, og = t1, orr = t3; break;
            default: ob = t2, og = t1, orr = vv; break;
          }
          const float pb = __fmul_rn(ob, 255.0f), pg = __fmul_rn(og, 255.0f),
                      pr = __fmul_rn(orr, 255.0f);
          if (x < simd_end) {
            b = (uint32_t)(int)floorf(pb) & 255u;
            g = (uint32_t)(int)floorf(pg) & 255u;
            r = (uint32_t)(int)floorf(pr) & 255u;
          } else {
            b = round_u8(pb), g = round_u8(pg), r = round_u8(pr);
          }
        }
        const long long oo = f * p.out_sb + y * p.out_sy + x * p.out_sx;
        p.out[0][oo] = (uint8_t)b;
        p.out[1][oo] = (uint8_t)g;
        p.out[2][oo] = (uint8_t)r;
      }
    }
  }
}

int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pointwise_kernel, kThreads, 0);
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

// Three [batch, h, w] u8 planes (in0..2, shared strides in bytes: frame,
// row, column) to three (out0..2, likewise); gains, matrix (with bias),
// lut, mask and enh switch their steps on (null: off); lab is the linearize
// table of the vignetting step; tables is ops/pointwise.const_tables. tasks = h *
// ceil(batch / 4) must fit an int (the wrapper checks). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int isp_pointwise(const void* in0, const void* in1, const void* in2, void* out0,
                             void* out1, void* out2, long long in_sb, long long in_sy,
                             long long in_sx, long long out_sb, long long out_sy,
                             long long out_sx, int batch, int h, int w, const void* gains,
                             const void* matrix, const void* bias, const void* lut,
                             const void* mask, const void* lab, const void* enh,
                             const void* tables, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (!tables || (mask && !lab) || (matrix && !bias)) return (int)cudaErrorInvalidValue;
  Params p;
  p.in[0] = (const uint8_t*)in0, p.in[1] = (const uint8_t*)in1, p.in[2] = (const uint8_t*)in2;
  p.out[0] = (uint8_t*)out0, p.out[1] = (uint8_t*)out1, p.out[2] = (uint8_t*)out2;
  p.in_sb = in_sb, p.in_sy = in_sy, p.in_sx = in_sx;
  p.out_sb = out_sb, p.out_sy = out_sy, p.out_sx = out_sx;
  p.batch = batch, p.h = h, p.w = w;
  p.gains = (const float*)gains, p.matrix = (const float*)matrix, p.bias = (const float*)bias;
  p.lut = (const uint8_t*)lut;
  p.mask = (const float*)mask, p.lab = (const int*)lab, p.enh = (const uint8_t*)enh;
  p.tables = (const int*)tables;
  const long long tasks = (long long)h * ((batch + kFrames - 1) / kFrames);
  const int resident = resident_blocks();
  const int blocks = (int)(tasks < resident ? tasks : (resident > 0 ? resident : 1));
  pointwise_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
