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
//   dln  = dh · W1ᵀ                               fp32 accumulation, not rounded
//   dxh  = dln * ln_scale
//   dx   = bf16((dxh - mean(dxh) - xhat * Σ(dxh·xhat) / C) * rstd)
//
// What bounds it: three products of C·M a row (6·C·M FLOP) against 6·C bytes
// of row traffic: compute-bound on the tensor cores with the weights read
// once. As in ln_mlp.cu, the TPU kernel's VMEM-resident weights do not fit
// a Hopper block, and the inverted loop the port had before (16-32-row
// blocks holding the dln accumulator in registers) re-read W1 twice and W2
// once per row tile from L2 at a pace that bounded it. So the row passes
// and the products split apart, four launches on the caller's stream:
//   1. ln_rows (mlp_rows.cuh): ln (N, C) bf16, mean and rstd (N) fp32;
//   2. dual_dh: per 128 × 128 tile of (rows, hidden units) two fp32
//      accumulators over K = C, hpre = ln·W1 (W1 as stored, MN-major) and
//      gw = g·W2ᵀ (W2's rows as stored, K-major), their k steps alternating
//      in one 6-stage ring; the epilogue writes dh = bf16(gw·gelu'(hpre + b1))
//      into an (N, M) bf16 scratch;
//   3. dln: dln = dh·W1ᵀ (W1's rows as stored, K-major), 128 × 256 tiles,
//      into an (N, C) fp32 scratch;
//   4. ln_vjp_rows: one warp a row, the LN VJP in fp32, dx in bf16.
// 2 and 3 are gemm_sm90.cuh's warp-specialized TMA + wgmma product. Every
// intermediate in device memory has the precision it has at that point in
// the TPU kernel (ln and dh bf16, dln fp32, hpre never leaves the
// accumulators), so no rounding point is added; the round trip costs ~0.1
// ms at ViT-L/H against the products' milliseconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_sm90.cuh"
#include "mlp_rows.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// d/dh gelu(h) in fp32, the formulas of pallas_mlp._gelu_grad_f32
__device__ __forceinline__ float gelu_grad(float h, int approx) {
  if (approx) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    const float t = tanhf(c * (h + 0.044715f * (h * h * h)));
    return 0.5f * (1.0f + t) + 0.5f * h * (1.0f - t * t) * c * (1.0f + 0.134145f * h * h);
  }
  return 0.5f * (1.0f + erff(h * 0.7071067811865476f)) + h * expf(-0.5f * h * h) * 0.3989422804014327f;
}

// the same in dual_dh's epilogue (see ln_mlp.cu's gelu_epi): with
// s = (1 + tanh(u)) / 2 = 1 / (1 + e^(-2u)), 1 - tanh² = 4·s·(1 - s), so
// gelu' = s + 2·h·s·(1 - s)·c·(1 + 3·0.044715·h²): one exp, one division;
// the erf form in an instance of its own
template <int APPROX>
__device__ __forceinline__ float gelu_grad_epi(float h) {
  if (APPROX) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    const float s = __fdividef(1.0f, 1.0f + __expf(-2.0f * c * (h + 0.044715f * (h * h * h))));
    return s + 2.0f * h * s * (1.0f - s) * c * (1.0f + 0.134145f * h * h);
  }
  return gelu_grad(h, 0);
}

using wg::pack;

constexpr int DUAL = 2;        // products of dual_dh: hpre and g·W2ᵀ
constexpr int RING_DUAL = 6;   // ring stages of dual_dh (32 KB each)
constexpr int BN_DLN = 256;    // output columns of a dln block
constexpr int RING_DLN = 4;    // ring stages of dln (48 KB each)

// dh[:, col..col+1] = bf16(gw · gelu'(hpre + b1)), v[0] hpre, v[NP-1] gw
template <int NP, int APPROX>
struct DhEpi {
  using Out = uint32_t;
  const bf16* b1;
  bf16* out;
  int ld;
  __device__ __forceinline__ Out operator()(int col, const float (&v)[NP][2]) const {
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + col));
    return pack(v[NP - 1][0] * gelu_grad_epi<APPROX>(v[0][0] + b.x), v[NP - 1][1] * gelu_grad_epi<APPROX>(v[0][1] + b.y));
  }
};

// dln[:, col..col+1] = the fp32 sums
struct F32Epi {
  using Out = float2;
  float* out;
  int ld;
  __device__ __forceinline__ Out operator()(int, const float (&v)[1][2]) const { return make_float2(v[0][0], v[0][1]); }
};

// dx = bf16((dxh - mean(dxh) - xhat · Σ(dxh·xhat) / C) · rstd), dxh = dln · ln_scale,
// one warp a row
__global__ void __launch_bounds__(rows::WARPS * 32) ln_vjp_rows(const float* __restrict__ dln, const bf16* __restrict__ x,
                                                                const float* __restrict__ ln_scale,
                                                                const float* __restrict__ mean,
                                                                const float* __restrict__ rstd, bf16* __restrict__ dx,
                                                                int N, int C) {
  const int row = blockIdx.x * rows::WARPS + threadIdx.x / 32, lane = threadIdx.x % 32, nch = C / 8;
  if (row >= N) return;
  const float mu = mean[row], rs = rstd[row];
  float d[rows::MAXCH][8], xh[rows::MAXCH][8];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < rows::MAXCH; ++i) {
    const int ch = lane + 32 * i;
    if (ch < nch) {
      float xv[8];
      rows::unpack8(*reinterpret_cast<const uint4*>(x + (size_t)row * C + 8 * ch), xv);
      const float4* dl = reinterpret_cast<const float4*>(dln + (size_t)row * C + 8 * ch);
      const float4* sc = reinterpret_cast<const float4*>(ln_scale + 8 * ch);
      const float4 d0 = dl[0], d1 = dl[1], s0 = sc[0], s1v = sc[1];
      const float dd[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const float ss[8] = {s0.x, s0.y, s0.z, s0.w, s1v.x, s1v.y, s1v.z, s1v.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[i][e] = dd[e] * ss[e];
        xh[i][e] = (xv[e] - mu) * rs;
        s1 += d[i][e];
        s2 += d[i][e] * xh[i][e];
      }
    }
  }
  s1 = rows::warp_sum(s1);
  s2 = rows::warp_sum(s2);
  const float dmean = s1 / C;
#pragma unroll
  for (int i = 0; i < rows::MAXCH; ++i) {
    const int ch = lane + 32 * i;
    if (ch < nch) {
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = (d[i][e] - dmean - xh[i][e] * s2 / C) * rs;
      *reinterpret_cast<uint4*>(dx + (size_t)row * C + 8 * ch) = rows::pack8(y);
    }
  }
}

// ---------------------------- narrow widths (C = 64, 128) ----------------------------
//
// As in ln_mlp.cu: C = 64, 128 (the debug backbone's 64) takes a plain form, one
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

// dh = bf16((g·W2ᵀ) · gelu'(ln·W1 + b1)): ln, g (N, C), W1 (C, M) and W2 (M, C) as stored, dh (N, M)
extern "C" int mlp_dual_dh_bf16(const void* ln, const void* g, const void* w1, const void* b1, const void* w2, void* dh,
                                int N, int C, int M, int approx, void* stream) {
  const g90::Operands ops[2] = {{ln, w1}, {g, w2}};
  if (approx)
    return g90::launch_gemm<128, DUAL, true, false, RING_DUAL>(ops, N, M, C, DhEpi<DUAL, 1>{(const bf16*)b1, (bf16*)dh, M},
                                                               (cudaStream_t)stream);
  return g90::launch_gemm<128, DUAL, true, false, RING_DUAL>(ops, N, M, C, DhEpi<DUAL, 0>{(const bf16*)b1, (bf16*)dh, M},
                                                             (cudaStream_t)stream);
}

// dln = dh · W1ᵀ in fp32: dh (N, M), W1 (C, M) as stored, dln (N, C)
extern "C" int mlp_dln_f32(const void* dh, const void* w1, void* dln, int N, int M, int C, void* stream) {
  const g90::Operands ops[1] = {{dh, w1}};
  return g90::launch_gemm<BN_DLN, 1, false, false, RING_DLN>(ops, N, C, M, F32Epi{(float*)dln, C}, (cudaStream_t)stream);
}

// dx from dln (N, C) fp32, x (N, C) bf16, ln_scale (C), mean and rstd (N) fp32
extern "C" int mlp_ln_vjp_bf16(const void* dln, const void* x, const void* ln_scale, const void* mean, const void* rstd,
                               void* dx, int N, int C, void* stream) {
  if (C % 8 || C > 8 * 32 * rows::MAXCH) return (int)cudaErrorInvalidValue;
  ln_vjp_rows<<<(N + rows::WARPS - 1) / rows::WARPS, rows::WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)dln, (const bf16*)x, (const float*)ln_scale, (const float*)mean, (const float*)rstd, (bf16*)dx, N, C);
  return (int)cudaGetLastError();
}

// the whole LN→MLP dx in one kernel at C = 64 or 128 (the narrow instance)
extern "C" int ln_mlp_dx_narrow_bf16(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                                     const void* b1, const void* w2, const void* g, void* dx, int N, int C, int M,
                                     float eps, int approx, void* stream) {
  if (C != 64 && C != 128) return (int)cudaErrorInvalidValue;
  return launch_narrow(x, ln_scale, ln_bias, w1, b1, w2, g, dx, N, C, M, eps, approx, stream);
}
