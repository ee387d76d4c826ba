// EVA-02's attention forward for Hopper (sm_90a), bf16, head_dim 64: the
// 2D rotary positions on q and k in place of #1's rel-pos terms, a bias on
// q and v only. It replaces no TPU kernel (the JAX package has no EVA-02
// block); it is #1's warp-specialized body (attn_ws.cuh) in an instance
// without rel terms. Per (batch, head), with cos / sin the (S, 32) tables of
// ops.attention.rope_tables (pair j of the head dims turns by θ[s, j]):
//
//   q = round(rot(round(qkv[:, :, 0, head] + bq)))    k = round(rot(qkv[:, :, 1, head]))
//   v = round(qkv[:, :, 2, head] + bv)
//   rot: (a, b) at dims (2j, 2j+1) → (a·cos − b·sin, b·cos + a·sin), fp32
//   s[r,k] = round(q·scale)[r]·k[k]   (fp32)
//   p = exp(s - rowmax) | exp(min(s, 80)) | exp(s)          (stable | clamp | fast)
//   out[r] = round((Σ_k round(p[r,k])·v[k]) / (Σ_k p[r,k] (+1e-30 unless stable)))
//
// round() is to bf16: the rounding points of #1 with the rotation added
// after the bias (ops.cuda_attn.attn_qkv_rope_plain).
//
// What bounds it: at EVA-02-L (S = 2048, 16 heads of 64) the two S×S×64
// products are 1.7e10 FLOP a row against ~17 MB of qkv and output, so it is
// compute-bound on the tensor cores, as #1 is. Two launches:
//   rope_qkv: one thread per 8 head dims of a token, q + bq and k rotated,
//   v + bv, each rounded, into a (3, B·H, S, 64) scratch (the products in
//   fp32 without contraction into FMAs, so they equal the plain version's
//   bit for bit); it takes the place of #1's fill_slots / fill_slots_rel;
//   attn_kernel<SOFTMAX, false>: #1's TMA producer and two ping-pong
//   consumer warpgroups, Q, K and V all read from the scratch, the score
//   product Q·Kᵀ alone (no slot rows, no E tiles: a ring stage is 16 KB).
// S = 2048 is 16 full blocks of 128 query rows; other S run the ws body's
// tail (a last block of one consumer warpgroup, keys past S masked).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_ws.cuh"

namespace {

using flash::bf16;
using flash::ws::HD;

constexpr int PAIRS = HD / 2;  // cos / sin columns a token
constexpr int PRE_THREADS = 256;

// (a, b) → (a·cos − b·sin, b·cos + a·sin) over the 4 pairs of 8 bf16 values,
// fp32 products and sums each rounded once, the result rounded to bf16
__device__ __forceinline__ uint4 rotate(uint4 x, const float (&cs)[4], const float (&sn)[4]) {
  __align__(16) bf16 v[8];
  *reinterpret_cast<uint4*>(v) = x;
  uint32_t out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float a = __bfloat162float(v[2 * j]), b = __bfloat162float(v[2 * j + 1]);
    out[j] = wg::pack(__fsub_rn(__fmul_rn(a, cs[j]), __fmul_rn(b, sn[j])),
                      __fadd_rn(__fmul_rn(b, cs[j]), __fmul_rn(a, sn[j])));
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__device__ __forceinline__ uint4 add8(uint4 x, uint4 bb) {
  using flash::ws::add2;
  return make_uint4(add2(x.x, bb.x), add2(x.y, bb.y), add2(x.z, bb.z), add2(x.w, bb.w));
}

// qkv (B, S, 3, C), qv_bias (2, C), tables (2, S, 32) fp32 → scratch (3,
// B·H, S, 64): planes q, k, v; one thread per (b, s, head, 8 dims)
__global__ void __launch_bounds__(PRE_THREADS) rope_qkv(const bf16* __restrict__ qkv, const bf16* __restrict__ qv_bias,
                                                        const float* __restrict__ tables, bf16* __restrict__ scratch,
                                                        int B, int S, int H) {
  const size_t i = (size_t)blockIdx.x * PRE_THREADS + threadIdx.x;
  if (i >= (size_t)B * S * H * 8) return;
  const int c8 = (int)(i % 8), h = (int)(i / 8 % H);
  const size_t row = i / ((size_t)8 * H);  // b·S + s
  const int s = (int)(row % S), b = (int)(row / S), C = H * HD, col = h * HD + 8 * c8;
  const bf16* src = qkv + row * 3 * C + col;
  const float4 c4 = __ldg(reinterpret_cast<const float4*>(tables + (size_t)s * PAIRS + 4 * c8));
  const float4 s4 = __ldg(reinterpret_cast<const float4*>(tables + ((size_t)S + s) * PAIRS + 4 * c8));
  const float cs[4] = {c4.x, c4.y, c4.z, c4.w}, sn[4] = {s4.x, s4.y, s4.z, s4.w};
  const size_t plane = (size_t)B * H * S * HD, dst = ((size_t)(b * H + h) * S + s) * HD + 8 * c8;
  const uint4 q = add8(__ldg(reinterpret_cast<const uint4*>(src)), __ldg(reinterpret_cast<const uint4*>(qv_bias + col)));
  *reinterpret_cast<uint4*>(scratch + dst) = rotate(q, cs, sn);
  *reinterpret_cast<uint4*>(scratch + plane + dst) = rotate(__ldg(reinterpret_cast<const uint4*>(src + C)), cs, sn);
  *reinterpret_cast<uint4*>(scratch + 2 * plane + dst) =
      add8(__ldg(reinterpret_cast<const uint4*>(src + 2 * C)), __ldg(reinterpret_cast<const uint4*>(qv_bias + C + col)));
}

template <int SOFTMAX>
int launch(const void* qkv, const void* qv_bias, const void* tables, void* scratch, void* out, int B, int S, int H,
           float scale, void* stream) {
  namespace ws = flash::ws;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t units = (size_t)B * S * H * 8;
  rope_qkv<<<(unsigned)((units + PRE_THREADS - 1) / PRE_THREADS), PRE_THREADS, 0, st>>>(
      (const bf16*)qkv, (const bf16*)qv_bias, (const float*)tables, (bf16*)scratch, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = ws::attn_kernel<SOFTMAX, false>;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  // fewer registers at launch and setmaxnreg.inc would wait for ever
  if (attr.numRegs != ws::LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = ws::smem(0);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mqkv;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)3 * B * H};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)S * HD * 2};
  if (!ws::encode(&mqkv, scratch, 3, dims, strides)) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + ws::BQ - 1) / ws::BQ, B * H);
  // mq, mslots, me and the bias are not read by this instance
  kernel<<<grid, ws::NTB, bytes, st>>>(mqkv, mqkv, mqkv, mqkv, nullptr, (bf16*)out, S, H, 0, 0, 0, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B, S, 3, C) with C = H·64, qv_bias (2, C), tables (2, S, 32) fp32 cos
// and sin → out (B, S, C), bf16; scratch (3, B·H, S, 64) bf16; softmax 0
// stable, 1 clamp, 2 fast
extern "C" int attn_qkv_rope_bf16(const void* qkv, const void* qv_bias, const void* tables, void* scratch, void* out,
                                  int B, int S, int H, float scale, int softmax, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  switch (softmax) {
    case flash::STABLE:
      return launch<flash::STABLE>(qkv, qv_bias, tables, scratch, out, B, S, H, scale, stream);
    case flash::CLAMP:
      return launch<flash::CLAMP>(qkv, qv_bias, tables, scratch, out, B, S, H, scale, stream);
    case flash::FAST:
      return launch<flash::FAST>(qkv, qv_bias, tables, scratch, out, B, S, H, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
