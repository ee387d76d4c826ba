// Row passes of the LN→MLP kernels (ln_mlp.cu, ln_mlp_dx.cu): one warp a
// row, each lane 16-byte chunks of 8 channels, C ≤ 1280 (≤ 5 chunks a
// lane), a multiple of 8. Memory-bound: each reads its row once and writes
// it once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace rows {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;   // rows a block
constexpr int MAXCH = 5;   // 16-byte chunks a lane at C = 1280

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(wg::pack(v[0], v[1]), wg::pack(v[2], v[3]), wg::pack(v[4], v[5]), wg::pack(v[6], v[7]));
}

// ln = bf16((x - mean) · rsqrt(var + eps) · ln_scale + ln_bias), fp32
// two-pass statistics; mean and rstd (fp32, one a row)
__global__ void __launch_bounds__(WARPS * 32) ln_rows(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                                                      const float* __restrict__ ln_bias, bf16* __restrict__ ln,
                                                      float* __restrict__ mean_out, float* __restrict__ rstd_out, int N,
                                                      int C, float eps) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32, lane = threadIdx.x % 32, nch = C / 8;
  if (row >= N) return;
  const bf16* xr = x + (size_t)row * C;
  float v[MAXCH][8];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXCH; ++i) {
    const int ch = lane + 32 * i;
    if (ch < nch) {
      unpack8(*reinterpret_cast<const uint4*>(xr + 8 * ch), v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[i][e];
    }
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXCH; ++i) {
    if (lane + 32 * i < nch) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
  for (int i = 0; i < MAXCH; ++i) {
    const int ch = lane + 32 * i;
    if (ch < nch) {
      const float4* sc = reinterpret_cast<const float4*>(ln_scale + 8 * ch);
      const float4* bi = reinterpret_cast<const float4*>(ln_bias + 8 * ch);
      const float4 s0 = sc[0], s1 = sc[1], b0 = bi[0], b1 = bi[1];
      const float s8[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float b8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = (v[i][e] - mean) * rstd * s8[e] + b8[e];
      *reinterpret_cast<uint4*>(ln + (size_t)row * C + 8 * ch) = pack8(y);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

}  // namespace rows

// the LN rows of both kernels: (N, C) bf16 ln, (N,) fp32 mean and rstd
extern "C" int mlp_ln_rows_bf16(const void* x, const void* ln_scale, const void* ln_bias, void* ln, void* mean,
                                void* rstd, int N, int C, float eps, void* stream) {
  if (C % 8 || C > 8 * 32 * rows::MAXCH) return (int)cudaErrorInvalidValue;
  rows::ln_rows<<<(N + rows::WARPS - 1) / rows::WARPS, rows::WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const rows::bf16*)x, (const float*)ln_scale, (const float*)ln_bias, (rows::bf16*)ln, (float*)mean, (float*)rstd,
      N, C, eps);
  return (int)cudaGetLastError();
}
