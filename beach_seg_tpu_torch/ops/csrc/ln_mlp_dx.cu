// Input gradient of the fused LayerNorm → Lin1 → GELU → Lin2 for Hopper
// (sm_90a), bf16.
//
// Replaces the TPU kernel `_kernel_dx` of beach_seg_tpu/ops/pallas_mlp.py:167
// (wrapper `_pallas_mlp_dx`). Per row, with the TPU kernel's rounding points:
//
//   xhat = (x - mean) * rstd                     fp32 stats, rstd = rsqrt(var + eps)
//   ln   = bf16(xhat * ln_scale + ln_bias)
//   hpre = ln · W1 + b1                          fp32 accumulation
//   dh   = bf16((g · W2ᵀ) * gelu'(hpre))         fp32, gelu' in fp32 (tanh form if approx)
//   dln  = dh · W1ᵀ                               fp32 accumulation
//   dxh  = dln * ln_scale
//   dx   = bf16((dxh - mean(dxh) - xhat * Σ(dxh·xhat) / C) * rstd)
//
// What bounds it: three products of C·M per row (6·C·M = 2.5e7 FLOP at
// ViT-L) against 6·C bytes of row traffic, so with the weights read once it
// is compute-bound on the tensor cores. As in ln_mlp.cu the TPU kernel's
// VMEM-resident weights do not fit a Hopper block, so the loop is inverted:
// one block of 8 warps takes 32 rows, keeps their LN and g rows in shared
// memory and the (32, C) fp32 dln accumulator in registers (C/8 columns per
// warp), and streams the hidden dimension in tiles of 128 units. Per tile:
//   1. hpre and g·W2ᵀ for the tile (K = C): each warp owns 16 units and
//      streams its W1[:, units] and W2[units, :] slices in 32-channel chunks;
//      the warp forms dh for its units into a shared (32, 128) bf16 tile;
//   2. dln += dh · W1[:, tile]ᵀ: each warp streams W1[its columns, tile].
// Each warp's weight slices pass through its own three-stage cp.async ring,
// so it waits on its own loads alone; products are mma.sync m16n8k16 (bf16
// in, fp32 accumulate) from ldmatrix fragments. Every 32-row block re-reads
// W1 twice and W2 once from L2; the 2-CTA cluster that halves this in
// ln_mlp.cu, and wgmma with TMA, are later steps. The LN VJP's two row sums
// over C are reduced across the warps through shared memory at the end.
// At ViT-H's C=1280 32 rows do not fit: the dln accumulator would be 160
// registers a thread and the block's shared memory 243,456 B (232,448
// available). So above C=1024 a block takes 16 rows (80 accumulator
// registers, 155,520 B), at twice the weight bytes per row; the C <= 1024
// instances keep 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;  // hidden units per tile
constexpr int NT = 256;  // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int HW = BM / NW;   // hidden units per warp in phase 1 (16)
constexpr int KC = 32;        // channels per phase-1 step
constexpr int HC = 16;        // hidden units per phase-2 step
constexpr int NS = 3;         // stages of each warp's ring (two chunks in flight)
constexpr int LDW1 = HW + 8;  // phase-1 W1 chunk [KC][HW] row stride (48 B)
constexpr int LDW2 = KC + 8;  // phase-1 W2 chunk [HW][KC] row stride (80 B)
constexpr int LDP2 = HC + 8;  // phase-2 W1 chunk [cols][HC] row stride (48 B)
constexpr int LDH = BM + 8;   // dh tile row stride

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// d/dh gelu(h) in fp32, the formulas of pallas_mlp._gelu_grad_f32
__device__ __forceinline__ float gelu_grad(float h, int approx) {
  if (approx) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    const float t = tanhf(c * (h + 0.044715f * (h * h * h)));
    return 0.5f * (1.0f + t) + 0.5f * h * (1.0f - t * t) * c * (1.0f + 0.134145f * h * h);
  }
  return 0.5f * (1.0f + erff(h * 0.7071067811865476f)) + h * expf(-0.5f * h * h) * 0.3989422804014327f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}
// A operand (16×16, row-major at p with row stride ld)
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], const bf16* p, int ld, int lane) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p + (lane % 16) * ld + (lane / 16) * 8)));
}
// B operands of two 8-column tiles from a [k][n] row-major 16×16 block:
// r[0..1] for columns 0-7, r[2..3] for columns 8-15
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&r)[4], const bf16* p, int ld, int lane) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p + (lane % 16) * ld + (lane / 16) * 8)));
}
// the same from an [n][k] row-major block (rows are output columns)
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&r)[4], const bf16* p, int ld, int lane) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p + ((lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) & 1) * 8)));
}
// d += a · b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C = 256·NCF: each warp owns CW = C/8 columns of dln, streamed in phase 2
// as NCC chunks of CC columns, for BR rows (MR tiles of 16) per block
template <int NCF>
struct Shape {
  static constexpr int BR = NCF <= 4 ? 32 : 16;  // rows per block
  static constexpr int MR = BR / 16;
  static constexpr int C = 256 * NCF;
  static constexpr int CW = C / NW;
  static constexpr int CC = CW % 64 == 0 ? 64 : 32;  // CW is a multiple of 32
  static constexpr int NCC = CW / CC;
  static constexpr int LDX = C + 8;  // LN / g rows
  static constexpr int N1 = C / KC;  // phase-1 steps per tile
  static constexpr int STEPS = N1 + (BM / HC) * NCC;
  static constexpr int STAGE1 = KC * LDW1 + HW * LDW2;
  static constexpr int STAGE2 = CC * LDP2;
  static constexpr int STAGE = STAGE1 > STAGE2 ? STAGE1 : STAGE2;  // elements
  static constexpr size_t smem = (size_t)(2 * BR * LDX + BR * LDH + NW * NS * STAGE) * sizeof(bf16)
                                 + (size_t)(2 * BR + 2 * NW * BR) * sizeof(float);
};

template <int NCF>
__global__ void __launch_bounds__(NT, 1) ln_mlp_dx_kernel(
    const bf16* __restrict__ x, const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2,
    const bf16* __restrict__ g, bf16* __restrict__ dx, int N, int M, float eps, int approx) {
  using Sh = Shape<NCF>;
  constexpr int C = Sh::C, CW = Sh::CW, CC = Sh::CC, NCC = Sh::NCC, LDX = Sh::LDX, N1 = Sh::N1;
  constexpr int STEPS = Sh::STEPS, BR = Sh::BR, MR = Sh::MR;
  extern __shared__ __align__(128) unsigned char smem[];
  const int r0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane >> 2, tig = lane & 3;
  bf16* sLn = reinterpret_cast<bf16*>(smem);
  bf16* sG = sLn + BR * LDX;
  bf16* sDh = sG + BR * LDX;
  bf16* sW = sDh + BR * LDH + warp * NS * Sh::STAGE;  // this warp's ring
  float* sMean = reinterpret_cast<float*>(sDh + BR * LDH + NW * NS * Sh::STAGE);
  float* sRstd = sMean + BR;
  float* sRed = sRstd + BR;  // [2][NW][BR] per-warp partial row sums of the LN VJP

  const int total = (M / BM) * STEPS;
  // this warp's slice of step s's weight chunk into its stage `st`
  auto fetch = [&](int s, int st) {
    const int t = s / STEPS, w = s % STEPS;
    bf16* dst = sW + st * Sh::STAGE;
    if (w < N1) {
      // W1[w·KC : +KC, t·BM + warp·HW : +HW] and W2[t·BM + warp·HW : +HW, w·KC : +KC]
      const int u0 = t * BM + warp * HW, c0 = w * KC;
      for (int i = lane; i < KC * 2; i += 32) {
        const int r = i / 2, c8 = (i % 2) * 8;
        cp_async16(dst + r * LDW1 + c8, w1 + (size_t)(c0 + r) * M + u0 + c8);
      }
      bf16* d2 = dst + KC * LDW1;
      for (int i = lane; i < HW * (KC / 8); i += 32) {
        const int r = i / (KC / 8), c8 = (i % (KC / 8)) * 8;
        cp_async16(d2 + r * LDW2 + c8, w2 + (size_t)(u0 + r) * C + c0 + c8);
      }
    } else {
      // W1[warp·CW + cc·CC : +CC, t·BM + uc·HC : +HC]
      const int q = w - N1, uc = q / NCC, cc = q % NCC;
      const int u0 = t * BM + uc * HC, c0 = warp * CW + cc * CC;
      for (int i = lane; i < CC * 2; i += 32) {
        const int r = i / 2, c8 = (i % 2) * 8;
        cp_async16(dst + r * LDP2 + c8, w1 + (size_t)(c0 + r) * M + u0 + c8);
      }
    }
  };
  for (int s = 0; s < NS - 1; ++s) {
    if (s < total) fetch(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // LayerNorm with fp32 statistics (two-pass variance), one warp per row;
  // the g rows alongside
  for (int r = warp; r < BR; r += NW) {
    const int row = r0 + r;
    if (row >= N) {
      for (int c = lane; c < C; c += 32) sLn[r * LDX + c] = sG[r * LDX + c] = __float2bfloat16_rn(0.0f);
      if (lane == 0) sMean[r] = sRstd[r] = 0.0f;
      continue;
    }
    const bf16* xr = x + (size_t)row * C;
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) sum += __bfloat162float(xr[c]);
    const float mean = warp_sum(sum) / C;
    float sq = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = __bfloat162float(xr[c]) - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
    for (int c = lane; c < C; c += 32) {
      const float xh = (__bfloat162float(xr[c]) - mean) * rstd;
      sLn[r * LDX + c] = __float2bfloat16_rn(xh * ln_scale[c] + ln_bias[c]);
      sG[r * LDX + c] = g[(size_t)row * C + c];
    }
    if (lane == 0) {
      sMean[r] = mean;
      sRstd[r] = rstd;
    }
  }
  __syncthreads();

  // accumulators: dln rows 16·m + {gr, gr+8} × this warp's columns
  // 8·n + 2·tig + {0,1}; hpre and g·W2ᵀ rows likewise × its 16 units
  float dacc[MR][CW / 8][4];
  float hacc[MR][2][4], gacc[MR][2][4];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) dacc[m][n][0] = dacc[m][n][1] = dacc[m][n][2] = dacc[m][n][3] = 0.0f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      hacc[m][n][0] = hacc[m][n][1] = hacc[m][n][2] = hacc[m][n][3] = 0.0f;
      gacc[m][n][0] = gacc[m][n][1] = gacc[m][n][2] = gacc[m][n][3] = 0.0f;
    }
  }

  int s = 0;
  // wait for step s's chunk (refilling the stage step s-1 used; one group per step)
  auto begin = [&]() -> const bf16* {
    if (s + NS - 1 < total) fetch(s + NS - 1, (s + NS - 1) % NS);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 1));
    __syncwarp();  // the warp's chunk visible to all its lanes
    return sW + (s % NS) * Sh::STAGE;
  };
  auto end = [&]() {
    __syncwarp();  // the warp is done with this stage before its refill
    ++s;
  };

  for (int t = 0; t < M / BM; ++t) {
    // phase 1: hpre and g·W2ᵀ for this warp's 16 units, K = C in KC chunks
    for (int k1 = 0; k1 < N1; ++k1) {
      const bf16* st = begin();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t b1f[4], b2f[4];
        ldsm_b_kn(b1f, st + kk * 16 * LDW1, LDW1, lane);
        ldsm_b_nk(b2f, st + KC * LDW1 + kk * 16, LDW2, lane);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          uint32_t a[4];
          ldsm_a(a, sLn + m * 16 * LDX + k1 * KC + kk * 16, LDX, lane);
          mma(hacc[m][0], a, b1f[0], b1f[1]);
          mma(hacc[m][1], a, b1f[2], b1f[3]);
          ldsm_a(a, sG + m * 16 * LDX + k1 * KC + kk * 16, LDX, lane);
          mma(gacc[m][0], a, b2f[0], b2f[1]);
          mma(gacc[m][1], a, b2f[2], b2f[3]);
        }
      }
      end();
    }
    // dh = (g·W2ᵀ)·gelu'(hpre + b1), rounded; every warp is done reading the
    // previous tile's dh before any overwrites it
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = warp * HW + 8 * n + 2 * tig;
      const float bl = __bfloat162float(b1[t * BM + col]), bh = __bfloat162float(b1[t * BM + col + 1]);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        float* h = hacc[m][n];
        float* gw = gacc[m][n];
        *reinterpret_cast<uint32_t*>(sDh + (16 * m + gr) * LDH + col) =
            pack(gw[0] * gelu_grad(h[0] + bl, approx), gw[1] * gelu_grad(h[1] + bh, approx));
        *reinterpret_cast<uint32_t*>(sDh + (16 * m + gr + 8) * LDH + col) =
            pack(gw[2] * gelu_grad(h[2] + bl, approx), gw[3] * gelu_grad(h[3] + bh, approx));
        h[0] = h[1] = h[2] = h[3] = gw[0] = gw[1] = gw[2] = gw[3] = 0.0f;
      }
    }
    __syncthreads();
    // phase 2: dln[:, this warp's columns] += dh · W1[those columns, tile]ᵀ
    for (int uc = 0; uc < BM / HC; ++uc) {
      uint32_t a[MR][4];
#pragma unroll
      for (int m = 0; m < MR; ++m) ldsm_a(a[m], sDh + m * 16 * LDH + uc * HC, LDH, lane);
#pragma unroll
      for (int cc = 0; cc < NCC; ++cc) {
        const bf16* st = begin();
#pragma unroll
        for (int cf = 0; cf < CC / 16; ++cf) {
          uint32_t b[4];
          ldsm_b_nk(b, st + cf * 16 * LDP2, LDP2, lane);
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            mma(dacc[m][cc * (CC / 8) + 2 * cf], a[m], b[0], b[1]);
            mma(dacc[m][cc * (CC / 8) + 2 * cf + 1], a[m], b[2], b[3]);
          }
        }
        end();
      }
    }
  }

  // LN VJP: dxh = dln·ln_scale; per-row Σ dxh and Σ dxh·xhat over C, reduced
  // over each quad, then over the warps in warp order
  float s1[MR][2] = {}, s2[MR][2] = {};
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * m + gr + 8 * hf, row = r0 + r;
      const float mean = sMean[r], rstd = sRstd[r];
      const bf16* xr = x + (size_t)min(row, N - 1) * C;
#pragma unroll
      for (int n = 0; n < CW / 8; ++n) {
        const int col = warp * CW + 8 * n + 2 * tig;
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xr + col);
        const float d0 = dacc[m][n][2 * hf] * ln_scale[col], d1 = dacc[m][n][2 * hf + 1] * ln_scale[col + 1];
        dacc[m][n][2 * hf] = d0;
        dacc[m][n][2 * hf + 1] = d1;
        const float x0 = (__bfloat162float(xv.x) - mean) * rstd, x1 = (__bfloat162float(xv.y) - mean) * rstd;
        s1[m][hf] += d0 + d1;
        s2[m][hf] += d0 * x0 + d1 * x1;
      }
      s1[m][hf] = quad_sum(s1[m][hf]);
      s2[m][hf] = quad_sum(s2[m][hf]);
      if (tig == 0) {
        sRed[warp * BR + r] = s1[m][hf];
        sRed[NW * BR + warp * BR + r] = s2[m][hf];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * m + gr + 8 * hf, row = r0 + r;
      if (row >= N) continue;
      float t1 = 0.0f, t2 = 0.0f;
      for (int w = 0; w < NW; ++w) {
        t1 += sRed[w * BR + r];
        t2 += sRed[NW * BR + w * BR + r];
      }
      const float mean = sMean[r], rstd = sRstd[r], dmean = t1 / C;
      const bf16* xr = x + (size_t)row * C;
#pragma unroll
      for (int n = 0; n < CW / 8; ++n) {
        const int col = warp * CW + 8 * n + 2 * tig;
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xr + col);
        const float x0 = (__bfloat162float(xv.x) - mean) * rstd, x1 = (__bfloat162float(xv.y) - mean) * rstd;
        *reinterpret_cast<uint32_t*>(dx + (size_t)row * C + col) =
            pack((dacc[m][n][2 * hf] - dmean - x0 * t2 / C) * rstd, (dacc[m][n][2 * hf + 1] - dmean - x1 * t2 / C) * rstd);
      }
    }
  }
}

template <int NCF>
int launch(const void* x, const void* ln_scale, const void* ln_bias, const void* w1, const void* b1,
           const void* w2, const void* g, void* dx, int N, int M, float eps, int approx, void* stream) {
  const size_t smem = Shape<NCF>::smem;
  cudaError_t err =
      cudaFuncSetAttribute(ln_mlp_dx_kernel<NCF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BR = Shape<NCF>::BR;
  ln_mlp_dx_kernel<NCF><<<(N + BR - 1) / BR, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)ln_scale, (const float*)ln_bias, (const bf16*)w1, (const bf16*)b1,
      (const bf16*)w2, (const bf16*)g, (bf16*)dx, N, M, eps, approx);
  return (int)cudaGetLastError();
}

// ---------------------------- narrow widths (C = 64, 128) ----------------------------
//
// As in ln_mlp.cu: C < 256 (the debug backbone's 64) takes a plain form, one
// warp a row, the LN row, g row and dh in shared memory, the three products
// on the FP32 units, the same rounding points.

constexpr int NARROW_WARPS = 4;

__global__ void __launch_bounds__(NARROW_WARPS * 32) ln_mlp_dx_narrow(
    const bf16* __restrict__ x, const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2, const bf16* __restrict__ g,
    bf16* __restrict__ dx, int N, int C, int M, float eps, int approx) {
  extern __shared__ float rows[];  // per warp: LN row (C), g row (C), dh (M)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, row = blockIdx.x * NARROW_WARPS + warp;
  if (row >= N) return;
  float* sLn = rows + warp * (2 * C + M);
  float* sG = sLn + C;
  float* sDh = sG + C;
  const bf16* xr = x + (size_t)row * C;
  float sum = 0.0f;
  for (int c = lane; c < C; c += 32) sum += __bfloat162float(xr[c]);
  for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / C;
  float var = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = __bfloat162float(xr[c]) - mean;
    var += d * d;
  }
  for (int o = 16; o; o >>= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
  const float rstd = rsqrtf(var / C + eps);
  for (int c = lane; c < C; c += 32) {
    sLn[c] = __bfloat162float(__float2bfloat16_rn((__bfloat162float(xr[c]) - mean) * rstd * ln_scale[c] + ln_bias[c]));
    sG[c] = __bfloat162float(g[(size_t)row * C + c]);
  }
  __syncwarp();
  for (int m = lane; m < M; m += 32) {
    float h = 0.0f, gw = 0.0f;
    for (int c = 0; c < C; ++c) {
      h = fmaf(sLn[c], __bfloat162float(w1[(size_t)c * M + m]), h);
      gw = fmaf(sG[c], __bfloat162float(w2[(size_t)m * C + c]), gw);
    }
    sDh[m] = __bfloat162float(__float2bfloat16_rn(gw * gelu_grad(h + __bfloat162float(b1[m]), approx)));
  }
  __syncwarp();
  // dxh = (dh · W1ᵀ) * ln_scale, then the LN VJP's two row sums
  float dxh[4], xh[4], s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i;
    dxh[i] = xh[i] = 0.0f;
    if (c < C) {
      float dl = 0.0f;
      for (int m = 0; m < M; ++m) dl = fmaf(sDh[m], __bfloat162float(w1[(size_t)c * M + m]), dl);
      dxh[i] = dl * ln_scale[c];
      xh[i] = (__bfloat162float(xr[c]) - mean) * rstd;
      s1 += dxh[i];
      s2 += dxh[i] * xh[i];
    }
  }
  for (int o = 16; o; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i;
    if (c < C) dx[(size_t)row * C + c] = __float2bfloat16_rn((dxh[i] - s1 / C - xh[i] * s2 / C) * rstd);
  }
}

int launch_narrow(const void* x, const void* ln_scale, const void* ln_bias, const void* w1, const void* b1,
                  const void* w2, const void* g, void* dx, int N, int C, int M, float eps, int approx,
                  void* stream) {
  const size_t smem = (size_t)NARROW_WARPS * (2 * C + M) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_dx_narrow, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_dx_narrow<<<(N + NARROW_WARPS - 1) / NARROW_WARPS, NARROW_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)ln_scale, (const float*)ln_bias, (const bf16*)w1, (const bf16*)b1,
      (const bf16*)w2, (const bf16*)g, (bf16*)dx, N, C, M, eps, approx);
  return (int)cudaGetLastError();
}

}  // namespace

// C a multiple of 256 up to 1280, or 64 or 128; M a multiple of 128
extern "C" int ln_mlp_dx_bf16(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                              const void* b1, const void* w2, const void* g, void* dx, int N, int C, int M,
                              float eps, int approx, void* stream) {
  if (C == 64 || C == 128) return launch_narrow(x, ln_scale, ln_bias, w1, b1, w2, g, dx, N, C, M, eps, approx, stream);
  switch (C / 256) {
    case 1:
      return launch<1>(x, ln_scale, ln_bias, w1, b1, w2, g, dx, N, M, eps, approx, stream);
    case 2:
      return launch<2>(x, ln_scale, ln_bias, w1, b1, w2, g, dx, N, M, eps, approx, stream);
    case 3:
      return launch<3>(x, ln_scale, ln_bias, w1, b1, w2, g, dx, N, M, eps, approx, stream);
    case 4:
      return launch<4>(x, ln_scale, ln_bias, w1, b1, w2, g, dx, N, M, eps, approx, stream);
    case 5:
      return launch<5>(x, ln_scale, ln_bias, w1, b1, w2, g, dx, N, M, eps, approx, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
