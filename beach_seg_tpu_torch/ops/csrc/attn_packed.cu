// Attention over head-split q, k, v with precomputed decomposed rel-pos
// terms, merged-head output, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_packed` (beach_seg_tpu/ops/pallas_attn.py:126,
// wrapper `_pallas_attention_packed`), the attention the model takes when
// the qkv-rel kernel's head_dim-64 precondition fails (ViT-H: head_dim 80).
// Per (batch·head) bh = b·H + h, with q, k, v (S, D), rel_h (S, Hk), rel_w
// (S, Wk), S = Hk·Wk, all in the compute type:
//
//   s[r,k]   = (round(q·scale)[r]·k[k] + rel_h[r, k / Wk]) + rel_w[r, k % Wk]   (fp32)
//   p        = exp(s - rowmax)                                      (stable)
//   out[b, r, h·D : (h+1)·D] = round((Σ_k round(p[r,k])·v[k]) / Σ_k p[r,k])
//
// where round() is to the compute type (bf16 or fp32): the TPU kernel's
// rounding points. Its packed contraction ([q·scale ‖ rel_h] against
// [k ‖ onehot(k / Wk)]) and the 0/1 expansion matmul for rel_w fill MXU
// lanes; here the rel terms are added per score from shared memory.
//
// What bounds it: at ViT-H (S=1568, D=80, 16 heads) the two S×S×D products
// are 1.6e10 FLOP per image against ~13 MB of q, k, v, rel terms and
// output, so it is compute-bound on the tensor cores. Both kernels are
// flash-style: one block per (q tile, batch·head) streams 64-key tiles of K
// and V with an online softmax, so scores never reach device memory, and
// the block stores its rows straight into the merged (B, S, H·D) layout.
//   bf16: 7 warps × 16 query rows (112 rows: S=1568 is 14 tiles). The q
//   tile's (112, Hk) and (112, Wk) rel rows are staged in shared memory once
//   per block. Scores, probabilities and the output accumulator stay in
//   registers between mma.sync m16n8k16 products; K/V tiles are
//   double-buffered with cp.async.
//   fp32: the simple form, 64 query rows, products on the FP32 units with
//   scores and accumulator in shared memory.
// Head dims 64 and 80 are template instances. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BK = 64;        // keys per step
constexpr int MAXG = 64;      // largest Hk and Wk
constexpr int RLD = MAXG + 2; // bf16 rel-row stride (elements)

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ============================ bf16: mma.sync ============================

namespace mma16 {

constexpr int NW = 7;        // warps per block
constexpr int NT = NW * 32;
constexpr int BQ = 16 * NW;  // query rows per block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
// d += a · b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  // invalid rows are zero-filled (src-size 0)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <int HD>
struct Tile {
  static constexpr int LDT = HD + 8;  // smem row stride: 144 B (64) / 176 B (80), conflict-free ldmatrix
  static constexpr int KS = HD / 16;  // 16-wide k-steps over the head dim
  static constexpr int NO = HD / 8;   // 8-wide output tiles
  static constexpr size_t smem = (size_t)(BQ * LDT + 4 * BK * LDT + 2 * BQ * RLD) * sizeof(bf16);
};

// rows [r0, r0 + n) of an (S, HD) tensor into a tile (zero past S)
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int S, int r0, int n, int tid) {
  constexpr int LDT = Tile<HD>::LDT, CH = HD / 8;
  for (int i = tid; i < n * CH; i += NT) {
    const int r = i / CH, c8 = (i % CH) * 8, row = r0 + r;
    const bool valid = row < S;
    cp_async16(dst + r * LDT + c8, valid ? src + (size_t)row * HD + c8 : src, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 2) attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ rh, const bf16* __restrict__ rw, bf16* __restrict__ out, int S, int H, int hk,
    int wk, float scale) {
  constexpr int LDT = Tile<HD>::LDT, KS = Tile<HD>::KS, NO = Tile<HD>::NO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDT;      // 2 stages
  bf16* sV = sK + 2 * BK * LDT;  // 2 stages
  bf16* sRh = sV + 2 * BK * LDT;
  bf16* sRw = sRh + BQ * RLD;

  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tig = lane & 3;
  const size_t off = (size_t)bh * S * HD;
  const bf16 *qp = q + off, *kp = k + off, *vp = v + off;
  const bf16* rhp = rh + (size_t)bh * S * hk;
  const bf16* rwp = rw + (size_t)bh * S * wk;

  const int nk = (S + BK - 1) / BK;
  load_rows<HD>(sQ, qp, S, q0, BQ, tid);
  load_rows<HD>(sK, kp, S, 0, BK, tid);
  load_rows<HD>(sV, vp, S, 0, BK, tid);
  cp_async_commit();
  // the q tile's rel rows, staged once (rows past S read as zero)
  for (int i = tid; i < BQ * hk; i += NT) {
    const int r = i / hk, j = i % hk;
    sRh[r * RLD + j] = q0 + r < S ? rhp[(size_t)(q0 + r) * hk + j] : __float2bfloat16_rn(0.0f);
  }
  for (int i = tid; i < BQ * wk; i += NT) {
    const int r = i / wk, j = i % wk;
    sRw[r * RLD + j] = q0 + r < S ? rwp[(size_t)(q0 + r) * wk + j] : __float2bfloat16_rn(0.0f);
  }
  cp_async_wait<0>();
  __syncthreads();

  // q·scale in bf16 (the scale rounded to bf16 first), then this warp's 16
  // rows as mma operand fragments for the whole key loop
  const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    sQ[r * LDT + d] = __float2bfloat16_rn(__bfloat162float(sQ[r * LDT + d]) * scale_t);
  }
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4(qa[kk], sQ + (warp * 16 + (lane % 16)) * LDT + kk * 16 + (lane / 16) * 8);

  const int rA = warp * 16 + g, rB = rA + 8;  // this thread's two rows (local)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    const bf16* cK = sK + (kt & 1) * BK * LDT;
    const bf16* cV = sV + (kt & 1) * BK * LDT;
    __syncthreads();  // every warp is done with the stage the next prefetch overwrites
    if (kt + 1 < nk) {
      load_rows<HD>(sK + ((kt + 1) & 1) * BK * LDT, kp, S, k0 + BK, BK, tid);
      load_rows<HD>(sV + ((kt + 1) & 1) * BK * LDT, vp, S, k0 + BK, BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = (q·scale)·kᵀ, 8 tiles of 8 keys; the head dim in pairs of k-steps
    // (ldmatrix.x4) and, for an odd count, one more (ldmatrix.x2)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk + 1 < KS; kk += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, cK + (8 * j + (lane % 8)) * LDT + kk * 16 + (lane / 8) * 8);
        mma(s[j], qa[kk], kb[0], kb[1]);
        mma(s[j], qa[kk + 1], kb[2], kb[3]);
      }
      if (KS % 2) {
        uint32_t kb[2];
        ldsm_x2(kb, cK + (8 * j + (lane % 8)) * LDT + (KS - 1) * 16 + ((lane / 8) % 2) * 8);
        mma(s[j], qa[KS - 1], kb[0], kb[1]);
      }
    }

    // + rel terms, mask keys past S, row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * tig + e;
        if (key < S) {
          const int kh = key / wk, kw = key - kh * wk;
          s[j][e] = (s[j][e] + __bfloat162float(sRh[rA * RLD + kh])) + __bfloat162float(sRw[rA * RLD + kw]);
          s[j][2 + e] = (s[j][2 + e] + __bfloat162float(sRh[rB * RLD + kh])) + __bfloat162float(sRw[rB * RLD + kw]);
        } else {
          s[j][e] = s[j][2 + e] = -INFINITY;
        }
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mnew = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = __expf(m[i] - mnew);  // 0 on the first step (m = -inf)
      m[i] = mnew;
    }
    // p = exp(s - max) with the hardware exp2 (__expf, relative error ~1e-5
    // for the arguments ≤ 0 a stable softmax takes; p is rounded to bf16)
    float ls[2] = {0.0f, 0.0f};
    uint32_t pa[4][4];  // P as operand fragments, 4 steps of 16 keys
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = __expf(s[j][0] - m[0]), p1 = __expf(s[j][1] - m[0]);
      const float p2 = __expf(s[j][2] - m[1]), p3 = __expf(s[j][3] - m[1]);
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P·V, 4 steps of 16 keys × NO/2 pairs of 8-dim tiles
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int jj = 0; jj < NO / 2; ++jj) {
        uint32_t vb[4];
        ldsm_x4_t(vb, cV + (16 * t + (lane % 16)) * LDT + 16 * jj + (lane / 16) * 8);
        mma(o[2 * jj], pa[t], vb[0], vb[1]);
        mma(o[2 * jj + 1], pa[t], vb[2], vb[3]);
      }
    }
  }

  // straight into the merged (B, S, H·D) layout at this head's offset
  const int b = bh / H, h = bh % H;
  const size_t C = (size_t)H * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + (i ? rB : rA);
    const float lt = quad_sum(l[i]);
    if (row < S) {
      bf16* dst = out + ((size_t)b * S + row) * C + (size_t)h * HD + 2 * tig;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack(o[j][2 * i] / lt, o[j][2 * i + 1] / lt);
    }
  }
}

}  // namespace mma16

// ============================ fp32: SIMT ============================

namespace simt {

constexpr int BQ = 64;        // query rows per block
constexpr int NT = 256;       // 8 warps
constexpr int LDF = BK + 4;   // row stride of the score / probability tile (floats)
constexpr int RLDF = MAXG + 1;  // row stride of the rel-row tiles

template <int HD>
struct Tile {
  static constexpr int LD = HD + 4;  // row stride of the q / k / v / output tiles
  static constexpr size_t smem = (size_t)(4 * BQ * LD + BQ * LDF + 2 * BQ * RLDF + 2 * BQ) * sizeof(float);
};

// S = A·Bᵀ over the head dim: each thread owns rows ty+16i, keys tx+16j
template <int HD>
__device__ void gemm_abt(const float* A, const float* Bt, float* S, int tid) {
  constexpr int LD = Tile<HD>::LD;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int k = 0; k < HD; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bt[(tx + 16 * j) * LD + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) S[(ty + 16 * i) * LDF + tx + 16 * j] = acc[i][j];
}

// O += P·V over the keys: each thread owns rows ty+16i, dims tx+16j
template <int HD>
__device__ void gemm_pv_acc(const float* P, const float* V, float* O, int tid) {
  constexpr int LD = Tile<HD>::LD, NJ = HD / 16;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = O[(ty + 16 * i) * LD + tx + 16 * j];
  for (int k = 0; k < BK; ++k) {
    float a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty + 16 * i) * LDF + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = V[k * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) O[(ty + 16 * i) * LD + tx + 16 * j] = acc[i][j];
}

template <int HD>
__global__ void __launch_bounds__(NT) attn_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ rh, const float* __restrict__ rw, float* __restrict__ out, int S, int H, int hk,
    int wk, float scale) {
  constexpr int LD = Tile<HD>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // q, then q·scale
  float* sK = sQ + BQ * LD;
  float* sV = sK + BQ * LD;
  float* sO = sV + BQ * LD;
  float* sS = sO + BQ * LD;  // scores, then probabilities in place
  float* sRh = sS + BQ * LDF;
  float* sRw = sRh + BQ * RLDF;
  float* sM = sRw + BQ * RLDF;
  float* sL = sM + BQ;

  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t off = (size_t)bh * S * HD;
  const float *qp = q + off, *kp = k + off, *vp = v + off;
  const float* rhp = rh + (size_t)bh * S * hk;
  const float* rwp = rw + (size_t)bh * S * wk;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    sQ[r * LD + d] = row < S ? qp[(size_t)row * HD + d] * scale : 0.0f;
    sO[r * LD + d] = 0.0f;
  }
  for (int i = tid; i < BQ * hk; i += NT) {
    const int r = i / hk, j = i % hk;
    sRh[r * RLDF + j] = q0 + r < S ? rhp[(size_t)(q0 + r) * hk + j] : 0.0f;
  }
  for (int i = tid; i < BQ * wk; i += NT) {
    const int r = i / wk, j = i % wk;
    sRw[r * RLDF + j] = q0 + r < S ? rwp[(size_t)(q0 + r) * wk + j] : 0.0f;
  }
  if (tid < BQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.0f;
  }

  const int nk = (S + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous step is done with sK, sV, sS
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, key = k0 + r;
      const bool valid = key < S;
      sK[r * LD + d] = valid ? kp[(size_t)key * HD + d] : 0.0f;
      sV[r * LD + d] = valid ? vp[(size_t)key * HD + d] : 0.0f;
    }
    __syncthreads();
    gemm_abt<HD>(sQ, sK, sS, tid);
    __syncthreads();

    // softmax step: four lanes per query row, 16 keys each; p overwrites s
    {
      const int r = tid / 4, part = tid % 4;
      float s[16];
      float mloc = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = part + 4 * j, key = k0 + c;
        if (key < S) {
          const int kh = key / wk, kw = key - kh * wk;
          s[j] = (sS[r * LDF + c] + sRh[r * RLDF + kh]) + sRw[r * RLDF + kw];
        } else {
          s[j] = -INFINITY;
        }
        mloc = fmaxf(mloc, s[j]);
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, quad_max(mloc));
      float lsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = expf(s[j] - m_new);
        lsum += p;
        sS[r * LDF + part + 4 * j] = p;
      }
      lsum = quad_sum(lsum);
      const float alpha = expf(m_old - m_new);  // 0 on the first step
      for (int d = part; d < HD; d += 4) sO[r * LD + d] *= alpha;
      if (part == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + lsum;
      }
    }
    __syncthreads();
    gemm_pv_acc<HD>(sS, sV, sO, tid);
  }
  __syncthreads();

  const int b = bh / H, h = bh % H;
  const size_t C = (size_t)H * HD;
  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    if (row < S) out[((size_t)b * S + row) * C + (size_t)h * HD + d] = sO[r * LD + d] / sL[r];
  }
}

}  // namespace simt

template <typename T>
int launch(void (*kernel)(const T*, const T*, const T*, const T*, const T*, T*, int, int, int, int, float),
           size_t smem, int bq, int nt, const void* q, const void* k, const void* v, const void* rh, const void* rw,
           void* out, int BH, int S, int H, int hk, int wk, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + bq - 1) / bq, BH);
  kernel<<<grid, nt, smem, (cudaStream_t)stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)rh,
                                                   (const T*)rw, (T*)out, S, H, hk, wk, scale);
  return (int)cudaGetLastError();
}

bool shape_ok(int BH, int S, int H, int hk, int wk) {
  return H > 0 && BH % H == 0 && hk * wk == S && hk <= MAXG && wk <= MAXG;
}

}  // namespace

// q, k, v (BH, S, D), rel_h (BH, S, hk), rel_w (BH, S, wk), S = hk·wk,
// hk, wk <= 64, D 64 or 80, BH = B·H → out (B, S, H·D); all bf16
extern "C" int attn_packed_bf16(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                                void* out, int BH, int S, int D, int H, int hk, int wk, float scale,
                                void* stream) {
  if (!shape_ok(BH, S, H, hk, wk)) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<bf16>(mma16::attn_kernel<64>, mma16::Tile<64>::smem, mma16::BQ, mma16::NT, q, k, v, rh, rw,
                          out, BH, S, H, hk, wk, scale, stream);
    case 80:
      return launch<bf16>(mma16::attn_kernel<80>, mma16::Tile<80>::smem, mma16::BQ, mma16::NT, q, k, v, rh, rw,
                          out, BH, S, H, hk, wk, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the same contract in fp32
extern "C" int attn_packed_f32(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                               void* out, int BH, int S, int D, int H, int hk, int wk, float scale, void* stream) {
  if (!shape_ok(BH, S, H, hk, wk)) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<float>(simt::attn_kernel<64>, simt::Tile<64>::smem, simt::BQ, simt::NT, q, k, v, rh, rw, out,
                           BH, S, H, hk, wk, scale, stream);
    case 80:
      return launch<float>(simt::attn_kernel<80>, simt::Tile<80>::smem, simt::BQ, simt::NT, q, k, v, rh, rw, out,
                           BH, S, H, hk, wk, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
