// Fused LayerNorm → Lin1 → GELU → Lin2 (the transformer MLP, no residual)
// for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel `_kernel` of beach_seg_tpu/ops/pallas_mlp.py:37
// (wrapper `_pallas_mlp`). Per row, with the TPU kernel's rounding points:
//
//   ln  = bf16((x - mean) * rsqrt(var + eps) * ln_scale + ln_bias)   fp32 stats, fp32 scale/bias
//   h   = bf16(gelu(ln · W1 + b1))        fp32 accumulation, GELU in fp32 (tanh form if approx)
//   out = bf16(h · W2 + b2)               fp32 accumulation
//
// What bounds it: 4·C·M FLOP a row against 4·C bytes of row traffic, so
// with the weights read once it is compute-bound on the tensor cores (989
// TF/s bf16). The TPU kernel keeps both weight matrices resident in VMEM
// and streams rows past them. A Hopper block cannot hold them, and the
// inverted loop the port had before (the hidden dimension streamed past a
// row tile whose output accumulator stayed in registers) capped the row tile
// at 32-64 rows, so every row tile re-read W1 and W2 from L2 and that
// traffic set its pace. So the row pass and the products split apart, three
// launches on the caller's stream:
//   1. ln_rows (mlp_rows.cuh): fp32 two-pass statistics, ln into an (N, C)
//      bf16 scratch; memory-bound, microseconds;
//   2. lin1_gelu: h = bf16(gelu(ln · W1 + b1)) into an (N, M) bf16 scratch;
//   3. lin2: out = bf16(h · W2 + b2);
// 2 and 3 are gemm_sm90.cuh's warp-specialized TMA + wgmma product, 128 × 256
// output tiles (85 FLOP per byte loaded, against 32-64 before), W1 and W2
// read as stored (MN-major operands), a 4-stage ring. The intermediates go
// through device memory at exactly the precision they have at that point in
// the TPU kernel (ln and h are bf16 there too), so no rounding point is
// added; the round trip costs 2·N·(C + M)·2 bytes, ~0.1 ms at ViT-L/H, the
// products' L2 re-reads a few ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_sm90.cuh"
#include "mlp_rows.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// GELU in fp32, the formulas of jax.nn.gelu
__device__ __forceinline__ float gelu(float x, int approx) {
  if (approx) {
    const float k = 0.7978845608028654f;  // sqrt(2/pi)
    const float cdf = 0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x))));
    return x * cdf;
  }
  return 0.5f * x * erfcf(-x * 0.7071067811865476f);
}

// the same in the products' epilogue, one instance a form: the tanh form
// (the bf16 model's) as x·cdf with cdf = (1 + tanh(u)) / 2 = 1 / (1 + e^(-2u)),
// one exp and one division, no branch and no call; the fp32 result differs
// from the tanhf form by a few ulps, far below the bf16 step it is rounded
// to. A function that holds a call (erfcf's slow path) has ptxas serialize
// every wgmma in it, so the erf form gets an instance of its own.
template <int APPROX>
__device__ __forceinline__ float gelu_epi(float x) {
  if (APPROX) {
    const float u = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
    return __fdividef(x, 1.0f + __expf(-2.0f * u));
  }
  return gelu(x, 0);
}

using wg::pack;

constexpr int BN = 256;  // output columns of a block
constexpr int RING = 4;  // ring stages (48 KB each)

// h[:, col..col+1] = bf16(gelu(sum + b1))
template <int APPROX>
struct GeluEpi {
  using Out = uint32_t;
  const bf16* b1;
  bf16* out;
  int ld;
  __device__ __forceinline__ Out operator()(int col, const float (&v)[1][2]) const {
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + col));
    return pack(gelu_epi<APPROX>(v[0][0] + b.x), gelu_epi<APPROX>(v[0][1] + b.y));
  }
};

// out[:, col..col+1] = bf16(sum + b2)
struct BiasEpi {
  using Out = uint32_t;
  const bf16* b2;
  bf16* out;
  int ld;
  __device__ __forceinline__ Out operator()(int col, const float (&v)[1][2]) const {
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + col));
    return pack(v[0][0] + b.x, v[0][1] + b.y);
  }
};

// ---------------------------- narrow widths (C = 64, 128) ----------------------------
//
// The debug backbone's C=64 rows take a plain form (the products above
// want C a multiple of 256): one warp a row, the row's LN and GELU'd hidden
// units in shared memory, both products on the FP32 units with the weights
// read through the L1 cache. The same rounding points. At these widths the
// model's time is in its launches, not in this kernel.

constexpr int NARROW_WARPS = 4;

__global__ void __launch_bounds__(NARROW_WARPS * 32) ln_mlp_narrow(
    const bf16* __restrict__ x, const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2, const bf16* __restrict__ b2,
    bf16* __restrict__ out, int N, int C, int M, float eps, int approx) {
  extern __shared__ float rows[];  // per warp: LN row (C), hidden units (M)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, row = blockIdx.x * NARROW_WARPS + warp;
  if (row >= N) return;
  float* sLn = rows + warp * (C + M);
  float* sH = sLn + C;
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
  for (int c = lane; c < C; c += 32)
    sLn[c] = __bfloat162float(__float2bfloat16_rn((__bfloat162float(xr[c]) - mean) * rstd * ln_scale[c] + ln_bias[c]));
  __syncwarp();
  for (int m = lane; m < M; m += 32) {
    float h = 0.0f;
    for (int c = 0; c < C; ++c) h = fmaf(sLn[c], __bfloat162float(w1[(size_t)c * M + m]), h);
    sH[m] = __bfloat162float(__float2bfloat16_rn(gelu(h + __bfloat162float(b1[m]), approx)));
  }
  __syncwarp();
  for (int c = lane; c < C; c += 32) {
    float y = 0.0f;
    for (int m = 0; m < M; ++m) y = fmaf(sH[m], __bfloat162float(w2[(size_t)m * C + c]), y);
    out[(size_t)row * C + c] = __float2bfloat16_rn(y + __bfloat162float(b2[c]));
  }
}

int launch_narrow(const void* x, const void* ln_scale, const void* ln_bias, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* out, int N, int C, int M, float eps, int approx,
                  void* stream) {
  const size_t smem = (size_t)NARROW_WARPS * (C + M) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_narrow, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_narrow<<<(N + NARROW_WARPS - 1) / NARROW_WARPS, NARROW_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)ln_scale, (const float*)ln_bias, (const bf16*)w1, (const bf16*)b1,
      (const bf16*)w2, (const bf16*)b2, (bf16*)out, N, C, M, eps, approx);
  return (int)cudaGetLastError();
}

}  // namespace

// h = bf16(gelu(ln · W1 + b1)): ln (N, C), W1 (C, M) as stored, h (N, M); C % 64 == 0, M % 8 == 0
extern "C" int mlp_lin1_gelu_bf16(const void* ln, const void* w1, const void* b1, void* h, int N, int C, int M,
                                  int approx, void* stream) {
  const g90::Operands ops[1] = {{ln, w1}};
  if (approx)
    return g90::launch_gemm<BN, 1, true, false, RING>(ops, N, M, C, GeluEpi<1>{(const bf16*)b1, (bf16*)h, M},
                                                      (cudaStream_t)stream);
  return g90::launch_gemm<BN, 1, true, false, RING>(ops, N, M, C, GeluEpi<0>{(const bf16*)b1, (bf16*)h, M},
                                                    (cudaStream_t)stream);
}

// out = bf16(h · W2 + b2): h (N, M), W2 (M, C) as stored, out (N, C); M % 64 == 0, C % 8 == 0
extern "C" int mlp_lin2_bf16(const void* h, const void* w2, const void* b2, void* out, int N, int M, int C,
                             void* stream) {
  const g90::Operands ops[1] = {{h, w2}};
  return g90::launch_gemm<BN, 1, true, false, RING>(ops, N, C, M, BiasEpi{(const bf16*)b2, (bf16*)out, C},
                                                    (cudaStream_t)stream);
}

// the whole LN→MLP in one kernel at C = 64 or 128 (the narrow instance)
extern "C" int ln_mlp_narrow_bf16(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                                  const void* b1, const void* w2, const void* b2, void* out, int N, int C, int M,
                                  float eps, int approx, void* stream) {
  if (C != 64 && C != 128) return (int)cudaErrorInvalidValue;
  return launch_narrow(x, ln_scale, ln_bias, w1, b1, w2, b2, out, N, C, M, eps, approx, stream);
}
