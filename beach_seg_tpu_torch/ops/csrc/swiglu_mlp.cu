// EVA-02's MLP (SwiGLU with a sub-LN) for Hopper (sm_90a), bf16, no
// residual. It replaces no TPU kernel (the JAX package has no EVA-02 block).
// Per row, at the rounding points of ops.cuda_mlp.swiglu_mlp_plain:
//
//   ln  = bf16(LN_C(x))                                   fp32 two-pass statistics over C
//   h   = bf16(silu(ln·W1 + b1) · (ln·W2 + b2))           fp32 accumulation and gate
//   hl  = bf16(LN_M(h))                                   fp32 two-pass statistics over exactly M
//   out = bf16(hl·W3 + b3)                                fp32 accumulation
//
// What bounds it: 6·C·M FLOP a row against ~4·C + 4·M bytes of row traffic,
// so with the weights read once it is compute-bound on the tensor cores, as
// #2 (ln_mlp.cu) is. #2's stages cannot carry it: the LN over the whole
// hidden row sits between the two products, so no block that holds a tile
// of h can finish it. Four launches on the caller's stream:
//   1. ln_rows (mlp_rows.cuh): ln into an (N, C) scratch;
//   2. dual: gemm_sm90.cuh's warp-specialized product with two accumulators
//      over one k loop (ln·W1 and ln·W2, both weights MN-major as stored;
//      128 × 128 tiles, a 6-stage ring, as #5's dual_dh), the epilogue
//      silu(g)·u into an (N, Mp) bf16 scratch;
//   3. ln_wide: one warp a row, the LN over the hidden width from registers
//      (M ≤ 2816: 11 chunks of 8 a lane), into an (N, Mp) scratch;
//   4. out: gemm_sm90.cuh's product with W3, 128 × 256 tiles, + b3.
// M = 2730 (EVA-02-L) is not a multiple of 64 or of 8, while the products'
// k steps are 64 wide and TMA wants 16-byte row strides. The wrapper pads
// the hidden width to Mp (a multiple of 64) with zero columns of W1, W2,
// b1, b2 and the LN's scale and shift, and zero rows of W3: a padded unit is
// silu(0)·0 = 0 in h, is left out of LN_M's statistics (they count exactly
// M columns) and is written 0 in hl, so it adds nothing to W3's product.
// Every intermediate is at the precision the plain version gives it there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_sm90.cuh"
#include "mlp_rows.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using wg::pack;

constexpr int DUAL_BN = 128;  // hidden units of a dual block
constexpr int DUAL_RING = 6;  // ring stages of the dual product (32 KB each)
constexpr int OUT_BN = 256;   // output columns of a W3 block
constexpr int OUT_RING = 4;   // ring stages of the W3 product (48 KB each)
constexpr int WIDE_CH = 11;   // 16-byte chunks a lane of ln_wide: Mp ≤ 2816

// silu(g) = g / (1 + e^(−g)) with one exp and one division, no call in the
// epilogue (a call there has ptxas serialize the wgmmas; see ln_mlp.cu)
__device__ __forceinline__ float silu(float g) { return __fdividef(g, 1.0f + __expf(-g)); }

// h[:, col..col+1] = bf16(silu(v[0] + b1) · (v[1] + b2))
struct SwiGluEpi {
  using Out = uint32_t;
  const bf16* b1;
  const bf16* b2;
  bf16* out;
  int ld;
  __device__ __forceinline__ Out operator()(int col, const float (&v)[2][2]) const {
    const float2 c1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + col));
    const float2 c2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + col));
    return pack(silu(v[0][0] + c1.x) * (v[1][0] + c2.x), silu(v[0][1] + c1.y) * (v[1][1] + c2.y));
  }
};

// out[:, col..col+1] = bf16(sum + b3)
struct BiasEpi {
  using Out = uint32_t;
  const bf16* b;
  bf16* out;
  int ld;
  __device__ __forceinline__ Out operator()(int col, const float (&v)[1][2]) const {
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + col));
    return pack(v[0][0] + c.x, v[0][1] + c.y);
  }
};

// hl = bf16((h - mean) · rstd · scale + shift) over the first M of each
// row's Mp columns, fp32 two-pass statistics over exactly M; columns M..Mp
// written 0. One warp a row.
__global__ void __launch_bounds__(rows::WARPS * 32) ln_wide(const bf16* __restrict__ h, const float* __restrict__ scale,
                                                            const float* __restrict__ shift, bf16* __restrict__ hl,
                                                            int N, int M, int Mp, float eps) {
  const int row = blockIdx.x * rows::WARPS + threadIdx.x / 32, lane = threadIdx.x % 32, nch = Mp / 8;
  if (row >= N) return;
  const bf16* hr = h + (size_t)row * Mp;
  float v[WIDE_CH][8];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < WIDE_CH; ++i) {
    const int ch = lane + 32 * i;
    if (ch < nch) {
      rows::unpack8(*reinterpret_cast<const uint4*>(hr + 8 * ch), v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += 8 * ch + e < M ? v[i][e] : 0.0f;
    }
  }
  const float mean = rows::warp_sum(sum) / M;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < WIDE_CH; ++i) {
    const int ch = lane + 32 * i;
    if (ch < nch) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mean;
        sq += 8 * ch + e < M ? d * d : 0.0f;
      }
    }
  }
  const float rstd = rsqrtf(rows::warp_sum(sq) / M + eps);
#pragma unroll
  for (int i = 0; i < WIDE_CH; ++i) {
    const int ch = lane + 32 * i;
    if (ch < nch) {
      const float4* sc = reinterpret_cast<const float4*>(scale + 8 * ch);
      const float4* sh = reinterpret_cast<const float4*>(shift + 8 * ch);
      const float4 s0 = sc[0], s1 = sc[1], b0 = sh[0], b1 = sh[1];
      const float s8[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float b8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = 8 * ch + e < M ? (v[i][e] - mean) * rstd * s8[e] + b8[e] : 0.0f;
      *reinterpret_cast<uint4*>(hl + (size_t)row * Mp + 8 * ch) = rows::pack8(y);
    }
  }
}

}  // namespace

// h = bf16(silu(ln·W1 + b1) · (ln·W2 + b2)): ln (N, C), W1 and W2 (C, Mp) as
// stored, b1 and b2 (Mp), h (N, Mp); C % 64 == 0, Mp % 64 == 0
extern "C" int swiglu_dual_bf16(const void* ln, const void* w1, const void* b1, const void* w2, const void* b2, void* h,
                                int N, int C, int Mp, void* stream) {
  if (Mp % 64) return (int)cudaErrorInvalidValue;
  const g90::Operands ops[2] = {{ln, w1}, {ln, w2}};
  return g90::launch_gemm<DUAL_BN, 2, true, true, DUAL_RING>(
      ops, N, Mp, C, SwiGluEpi{(const bf16*)b1, (const bf16*)b2, (bf16*)h, Mp}, (cudaStream_t)stream);
}

// hl = the LN over the first M of h's Mp columns (scale, shift (Mp) fp32,
// zero past M), hl (N, Mp)
extern "C" int swiglu_ln_wide_bf16(const void* h, const void* scale, const void* shift, void* hl, int N, int M, int Mp,
                                   float eps, void* stream) {
  if (Mp % 8 || M > Mp || Mp > 8 * 32 * WIDE_CH) return (int)cudaErrorInvalidValue;
  ln_wide<<<(N + rows::WARPS - 1) / rows::WARPS, rows::WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)h, (const float*)scale, (const float*)shift, (bf16*)hl, N, M, Mp, eps);
  return (int)cudaGetLastError();
}

// out = bf16(hl·W3 + b3): hl (N, Mp), W3 (Mp, C) as stored, out (N, C); Mp % 64 == 0
extern "C" int swiglu_out_bf16(const void* hl, const void* w3, const void* b3, void* out, int N, int Mp, int C,
                               void* stream) {
  const g90::Operands ops[1] = {{hl, w3}};
  return g90::launch_gemm<OUT_BN, 1, true, false, OUT_RING>(ops, N, C, Mp, BiasEpi{(const bf16*)b3, (bf16*)out, C},
                                                            (cudaStream_t)stream);
}
