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
// What bounds it: at ViT-L (C=1024, M=4096) the two products are 4·C·M =
// 1.7e7 FLOP per row against 4·C bytes of row traffic, so with the weights
// read once it is compute-bound on the tensor cores. The TPU kernel keeps both
// 8 MB weight matrices in VMEM; a Hopper block has 227 KB of shared memory, so
// the loop is inverted: the hidden dimension streams through in tiles of 128
// units while the rows' output accumulators stay in registers, and h never
// reaches device memory. Every row tile then re-reads both weight matrices
// from L2, and with 32-row tiles that traffic bounded the kernel (timed
// without its weight loads it ran in about half the time). So a cluster of
// two CTAs shares one 64-row tile and halves the weight bytes per row:
//   - each CTA holds its half of the channels of the LN rows and forms the
//     partial h = ln[:, half]·W1[half, tile]; the two fp32 partials are
//     exchanged through distributed shared memory (one cluster barrier per
//     tile) and summed, so both CTAs hold the whole GELU'd h tile;
//   - each CTA accumulates its half of the output columns, out[:, half] +=
//     h·W2[tile, half], in registers (8 warps × 64 rows × C/16 columns).
// Each warp streams only its own slice of every weight chunk (16 hidden
// units of W1, C/16 output columns of W2) through a private three-stage
// cp.async ring, so it waits on its own loads alone. Products are mma.sync
// m16n8k16 (bf16 in, fp32 accumulate) from ldmatrix fragments. wgmma and TMA
// multicast are the later steps.
// At ViT-H's C=1280 a 64-row tile does not fit: its output accumulator
// would be 160 registers a thread and its shared memory 241,664 B (232,448
// available). So above C=1024 a cluster takes 32 rows (80 accumulator
// registers, 157,696 B), at twice the weight bytes per row; the C <= 1024
// instances keep 64.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;  // hidden units per tile
constexpr int KC = 64;   // W1 rows (channels) per step
constexpr int HC = 16;   // W2 rows (hidden units) per step
constexpr int NS = 3;    // stages of each warp's weight ring (two chunks in flight)
constexpr int NT = 256;  // threads per CTA (8 warps)
constexpr int NW = NT / 32;
constexpr int HW = BM / NW;   // hidden units per warp in a tile (16)
constexpr int LDB1 = HW + 8;  // W1 slice row stride (48 B: conflict-free ldmatrix)
constexpr int LDH = BM + 8;   // bf16 h tile row stride
constexpr int LDP = BM + 4;   // fp32 partial-h exchange row stride

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// GELU in fp32, the formulas of jax.nn.gelu
__device__ __forceinline__ float gelu(float x, int approx) {
  if (approx) {
    const float k = 0.7978845608028654f;  // sqrt(2/pi)
    const float cdf = 0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x))));
    return x * cdf;
  }
  return 0.5f * x * erfcf(-x * 0.7071067811865476f);
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
// B operands of two 8-column tiles (16×16 [k][n], row-major at p): r[0..1]
// for columns 0-7, r[2..3] for columns 8-15
__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4], const bf16* p, int ld, int lane) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p + (lane % 16) * ld + (lane / 16) * 8)));
}
// d += a · b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C = 256·NCF: each CTA owns CH = C/2 channels (partial h) and C/2 output
// columns, each warp WC = CH/8 = 16·NCF of those columns, for BR rows
// (MR tiles of 16) per cluster
template <int NCF>
struct Shape {
  static constexpr int BR = NCF <= 4 ? 64 : 32;  // rows per cluster (both CTAs)
  static constexpr int MR = BR / 16;
  static constexpr int C = 256 * NCF;
  static constexpr int CH = C / 2;
  static constexpr int WC = CH / NW;
  static constexpr int LDX = CH + 8;   // LN rows (this CTA's channels)
  static constexpr int LDB2 = WC + 8;  // W2 slice row stride
  static constexpr int STAGE = (KC * LDB1 > HC * LDB2) ? KC * LDB1 : HC * LDB2;  // elements
  static constexpr size_t smem = (size_t)(BR * LDX + NW * NS * STAGE + BR * LDH) * sizeof(bf16)
                                 + (size_t)2 * BR * LDP * sizeof(float);
};

template <int NCF>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NT, 1) ln_mlp_kernel(
    const bf16* __restrict__ x, const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, bf16* __restrict__ out, int N, int M, float eps, int approx) {
  using Sh = Shape<NCF>;
  constexpr int C = Sh::C, CH = Sh::CH, WC = Sh::WC, LDX = Sh::LDX, LDB2 = Sh::LDB2, BR = Sh::BR, MR = Sh::MR;
  constexpr int N1 = CH / KC, N2 = BM / HC, STEPS = N1 + N2;  // steps per hidden tile
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // this CTA's channel / column half
  const int r0 = (blockIdx.x / 2) * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tig = lane & 3;
  bf16* sLn = reinterpret_cast<bf16*>(smem);
  bf16* sW = sLn + BR * LDX + warp * NS * Sh::STAGE;      // this warp's ring
  bf16* sH = sLn + BR * LDX + NW * NS * Sh::STAGE;        // the GELU'd h tile
  float* sX = reinterpret_cast<float*>(sH + BR * LDH);    // 2 buffers: the peer's partial h
  float* peerX = cluster.map_shared_rank(sX, rank ^ 1);   // the same buffers in the peer CTA

  const int total = (M / BM) * STEPS;
  // this warp's slice of step s's weight chunk into its stage `st`
  auto issue = [&](int s, int st) {
    const int t = s / STEPS, w = s % STEPS;
    bf16* dst = sW + st * Sh::STAGE;
    if (w < N1) {  // W1[rank·CH + w·KC : +KC, t·BM + warp·HW : +HW]
      for (int i = lane; i < KC * (HW / 8); i += 32) {
        const int r = i / (HW / 8), c8 = (i % (HW / 8)) * 8;
        cp_async16(dst + r * LDB1 + c8, w1 + (size_t)(rank * CH + w * KC + r) * M + t * BM + warp * HW + c8);
      }
    } else {  // W2[t·BM + (w-N1)·HC : +HC, rank·CH + warp·WC : +WC]
      for (int i = lane; i < HC * (WC / 8); i += 32) {
        const int r = i / (WC / 8), c8 = (i % (WC / 8)) * 8;
        cp_async16(dst + r * LDB2 + c8,
                   w2 + (size_t)(t * BM + (w - N1) * HC + r) * C + rank * CH + warp * WC + c8);
      }
    }
  };
  for (int s = 0; s < NS - 1; ++s) {
    if (s < total) issue(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // LayerNorm with fp32 statistics (two-pass variance) over the whole row,
  // one warp per row; this CTA keeps its half of the channels
  for (int r = warp; r < BR; r += NW) {
    const int row = r0 + r;
    if (row >= N) {
      for (int c = lane; c < CH; c += 32) sLn[r * LDX + c] = __float2bfloat16_rn(0.0f);
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
    for (int c = lane; c < CH; c += 32) {
      const int ch = rank * CH + c;
      const float y = (__bfloat162float(xr[ch]) - mean) * rstd * ln_scale[ch] + ln_bias[ch];
      sLn[r * LDX + c] = __float2bfloat16_rn(y);
    }
  }
  // LN rows visible CTA-wide, and the peer is running before any
  // distributed-shared-memory store reaches it
  cluster.sync();

  // accumulators: out rows 16·m + {g, g+8} × this warp's columns 8·n + 2·tig + {0,1};
  // partial h rows likewise × this warp's hidden units 8·n + 2·tig + {0,1}
  float yacc[MR][WC / 8][4];
  float hacc[MR][2][4];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int n = 0; n < WC / 8; ++n) yacc[m][n][0] = yacc[m][n][1] = yacc[m][n][2] = yacc[m][n][3] = 0.0f;
#pragma unroll
    for (int n = 0; n < 2; ++n) hacc[m][n][0] = hacc[m][n][1] = hacc[m][n][2] = hacc[m][n][3] = 0.0f;
  }

  for (int s = 0; s < total; ++s) {
    const int t = s / STEPS, w = s % STEPS;
    // refill the stage step s-1 used; one (possibly empty) group per step
    if (s + NS - 1 < total) issue(s + NS - 1, (s + NS - 1) % NS);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 1));
    __syncwarp();  // the warp's slice of step s visible to all its lanes
    const bf16* st = sW + (s % NS) * Sh::STAGE;
    if (w < N1) {
      // partial h += ln[:, w·KC : +KC] · W1 slice (this CTA's channels)
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t b[4];
        ldsm_b(b, st + kk * 16 * LDB1, LDB1, lane);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          uint32_t a[4];
          ldsm_a(a, sLn + m * 16 * LDX + w * KC + kk * 16, LDX, lane);
          mma(hacc[m][0], a, b[0], b[1]);
          mma(hacc[m][1], a, b[2], b[3]);
        }
      }
      if (w == N1 - 1) {
        // hand this CTA's partial to the peer (buffer t&1: the peer read it
        // in tile t-2, before the previous cluster barrier), meet, then
        // h = partial(channels 0..CH) + partial(CH..C), + b1, GELU in fp32,
        // round to bf16: both CTAs form the same h
        float* px = peerX + (t & 1) * BR * LDP;
        const float* mx = sX + (t & 1) * BR * LDP;
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = warp * HW + 8 * n + 2 * tig;
            *reinterpret_cast<float2*>(px + (16 * m + g) * LDP + col) = make_float2(hacc[m][n][0], hacc[m][n][1]);
            *reinterpret_cast<float2*>(px + (16 * m + g + 8) * LDP + col) = make_float2(hacc[m][n][2], hacc[m][n][3]);
          }
        cluster.sync();
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = warp * HW + 8 * n + 2 * tig;
          const float bl = __bfloat162float(b1[t * BM + col]), bh = __bfloat162float(b1[t * BM + col + 1]);
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            float* c = hacc[m][n];
            const float2 lo = *reinterpret_cast<const float2*>(mx + (16 * m + g) * LDP + col);
            const float2 hi = *reinterpret_cast<const float2*>(mx + (16 * m + g + 8) * LDP + col);
            const float h0 = rank ? lo.x + c[0] : c[0] + lo.x, h1 = rank ? lo.y + c[1] : c[1] + lo.y;
            const float h2 = rank ? hi.x + c[2] : c[2] + hi.x, h3 = rank ? hi.y + c[3] : c[3] + hi.y;
            *reinterpret_cast<uint32_t*>(sH + (16 * m + g) * LDH + col) =
                pack(gelu(h0 + bl, approx), gelu(h1 + bh, approx));
            *reinterpret_cast<uint32_t*>(sH + (16 * m + g + 8) * LDH + col) =
                pack(gelu(h2 + bl, approx), gelu(h3 + bh, approx));
            c[0] = c[1] = c[2] = c[3] = 0.0f;
          }
        }
        // the h tile is complete CTA-wide (its previous reads, in tile t-1,
        // ended before the cluster barrier above)
        __syncthreads();
      }
    } else {
      // out[:, this CTA's half] += h[:, (w-N1)·HC : +HC] · W2 slice, this warp's columns
      uint32_t a[MR][4];
#pragma unroll
      for (int m = 0; m < MR; ++m) ldsm_a(a[m], sH + m * 16 * LDH + (w - N1) * HC, LDH, lane);
#pragma unroll
      for (int cf = 0; cf < WC / 16; ++cf) {
        uint32_t b[4];
        ldsm_b(b, st + cf * 16, LDB2, lane);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          mma(yacc[m][2 * cf], a[m], b[0], b[1]);
          mma(yacc[m][2 * cf + 1], a[m], b[2], b[3]);
        }
      }
    }
    __syncwarp();  // the warp is done with this stage before its refill
  }

  // epilogue: + b2, round, store this CTA's columns
#pragma unroll
  for (int n = 0; n < WC / 8; ++n) {
    const int col = rank * CH + warp * WC + 8 * n + 2 * tig;
    const float bl = __bfloat162float(b2[col]), bh = __bfloat162float(b2[col + 1]);
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const int row = r0 + 16 * m + g;
      if (row < N) *reinterpret_cast<uint32_t*>(out + (size_t)row * C + col) = pack(yacc[m][n][0] + bl, yacc[m][n][1] + bh);
      if (row + 8 < N)
        *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8) * C + col) = pack(yacc[m][n][2] + bl, yacc[m][n][3] + bh);
    }
  }
}

template <int NCF>
int launch(const void* x, const void* ln_scale, const void* ln_bias, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int N, int M, float eps, int approx, void* stream) {
  const size_t smem = Shape<NCF>::smem;
  cudaError_t err =
      cudaFuncSetAttribute(ln_mlp_kernel<NCF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int clusters = (N + Shape<NCF>::BR - 1) / Shape<NCF>::BR;
  ln_mlp_kernel<NCF><<<2 * clusters, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)ln_scale, (const float*)ln_bias, (const bf16*)w1, (const bf16*)b1,
      (const bf16*)w2, (const bf16*)b2, (bf16*)out, N, M, eps, approx);
  return (int)cudaGetLastError();
}

// ---------------------------- narrow widths (C = 64, 128) ----------------------------
//
// The debug backbone's C=64 rows are too narrow for the cluster design
// (each CTA's half of the channels must hold 64-channel weight chunks), so
// C < 256 takes a plain form: one warp a row, the row's LN and GELU'd hidden
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

// C a multiple of 256 up to 1280, or 64 or 128; M a multiple of 128
extern "C" int ln_mlp_bf16(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out, int N, int C,
                           int M, float eps, int approx, void* stream) {
  if (C == 64 || C == 128) return launch_narrow(x, ln_scale, ln_bias, w1, b1, w2, b2, out, N, C, M, eps, approx, stream);
  switch (C / 256) {
    case 1:
      return launch<1>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, N, M, eps, approx, stream);
    case 2:
      return launch<2>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, N, M, eps, approx, stream);
    case 3:
      return launch<3>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, N, M, eps, approx, stream);
    case 4:
      return launch<4>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, N, M, eps, approx, stream);
    case 5:
      return launch<5>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, N, M, eps, approx, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
