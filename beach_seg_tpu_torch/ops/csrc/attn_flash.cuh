// Flash-style attention with precomputed decomposed rel-pos terms, for
// Hopper (sm_90a): the device code of three kernels that differ only in
// where they read and write and in one rounding point.
//
// Per (batch, head) bh = b·H + h, with q, k, v (S, D), rel_h (S, Hk),
// rel_w (S, Wk), S = Hk·Wk, all in the compute type T (bf16 or fp32):
//
//   PRESCALE:  s[r,k] = (round(q·scale)[r]·k[k] + rel_h[r, k / Wk]) + rel_w[r, k % Wk]   (fp32)
//   otherwise: s[r,k] = (q[r]·k[k])·scale + (rel_h[r, k / Wk] + rel_w[r, k % Wk])      (fp32)
//   p = exp(s - rowmax)   out[r] = round((Σ_k round(p[r,k])·v[k]) / Σ_k p[r,k])
//
// where round() is to T. The layouts, as template flags:
//   IN_MERGED  false: q, k, v (B·H, S, D) and rel_h (B·H, S, Hk), rel_w
//              (B·H, S, Wk); true: q, k, v are rows of stride `ld` with the
//              head at column h·D (the (B, S, 3C) qkv tensor, k and v
//              passed as qkv + C and qkv + 2C), and rel_h, rel_w rows of
//              stride `rld` with the head's terms in the 64-slot at h·64.
//   OUT_MERGED false: out (B·H, S, D); true: out (B, S, H·D).
// The three users (one source each, one shared library each):
//   attn_packed.cu  IN false, OUT true,  PRESCALE  (TPU `_kernel_packed`)
//   attn_qkv.cu     IN true,  OUT true,  PRESCALE  (TPU `_kernel_qkv`)
//   attn_fused.cu   IN false, OUT false, !PRESCALE (TPU `_kernel`)
//
// What bounds it: at S=1568 the two S×S×D products per head are ~5e8 FLOP
// against ~1 MB of q, k, v, rel terms and output, so it is compute-bound on
// the tensor cores (bf16) or the FP32 units (fp32). One block per (q tile,
// batch·head) streams 64-key tiles of K and V with an online softmax, so
// scores never reach device memory, and stores its rows straight into the
// output layout.
//   bf16: 7 warps × 16 query rows (112 rows: S=1568 is 14 tiles). The q
//   tile's (112, Hk) and (112, Wk) rel rows are staged in shared memory once
//   per block. Scores, probabilities and the output accumulator stay in
//   registers between mma.sync m16n8k16 products; K/V tiles are
//   double-buffered with cp.async.
//   fp32: the simple form, 64 query rows, products on the FP32 units with
//   scores and accumulator in shared memory.
// Head dims 64 and 80 are template instances. wgmma and TMA are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;        // keys per step
constexpr int MAXG = 64;      // largest Hk and Wk, and the rel slot width of the merged layout
constexpr int RLD = MAXG + 2; // bf16 rel-row stride (elements)

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// where one (batch, head)'s rows live in each layout
template <bool IN_MERGED>
struct Rows {
  size_t qkv, rh, rw;  // offsets of row 0
  int ld, ldh, ldw;    // row strides (elements)
  __device__ __forceinline__ Rows(int bh, int b, int h, int S, int HD, int hk, int wk, int ld_in, int rld) {
    if (IN_MERGED) {
      qkv = (size_t)b * S * ld_in + (size_t)h * HD;
      rh = rw = (size_t)b * S * rld + (size_t)h * MAXG;
      ld = ld_in;
      ldh = ldw = rld;
    } else {
      qkv = (size_t)bh * S * HD;
      rh = (size_t)bh * S * hk;
      rw = (size_t)bh * S * wk;
      ld = HD;
      ldh = hk;
      ldw = wk;
    }
  }
};

// element (row, d) of this head's output
template <bool OUT_MERGED>
__device__ __forceinline__ size_t out_at(int bh, int b, int h, int S, int H, int HD, int row) {
  return OUT_MERGED ? ((size_t)b * S + row) * ((size_t)H * HD) + (size_t)h * HD : ((size_t)bh * S + row) * HD;
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

// rows [r0, r0 + n) of an (S, HD) slice with row stride ld into a tile (zero past S)
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int ld, int S, int r0, int n, int tid) {
  constexpr int LDT = Tile<HD>::LDT, CH = HD / 8;
  for (int i = tid; i < n * CH; i += NT) {
    const int r = i / CH, c8 = (i % CH) * 8, row = r0 + r;
    const bool valid = row < S;
    cp_async16(dst + r * LDT + c8, valid ? src + (size_t)row * ld + c8 : src, valid);
  }
}

template <int HD, bool IN_MERGED, bool OUT_MERGED, bool PRESCALE>
__global__ void __launch_bounds__(NT, 2) attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ rh, const bf16* __restrict__ rw, bf16* __restrict__ out, int S, int H, int hk,
    int wk, int ld_in, int rld, float scale) {
  constexpr int LDT = Tile<HD>::LDT, KS = Tile<HD>::KS, NO = Tile<HD>::NO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDT;      // 2 stages
  bf16* sV = sK + 2 * BK * LDT;  // 2 stages
  bf16* sRh = sV + 2 * BK * LDT;
  bf16* sRw = sRh + BQ * RLD;

  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tig = lane & 3;
  const Rows<IN_MERGED> rows(bh, b, h, S, HD, hk, wk, ld_in, rld);
  const bf16 *qp = q + rows.qkv, *kp = k + rows.qkv, *vp = v + rows.qkv;
  const bf16* rhp = rh + rows.rh;
  const bf16* rwp = rw + rows.rw;

  const int nk = (S + BK - 1) / BK;
  load_rows<HD>(sQ, qp, rows.ld, S, q0, BQ, tid);
  load_rows<HD>(sK, kp, rows.ld, S, 0, BK, tid);
  load_rows<HD>(sV, vp, rows.ld, S, 0, BK, tid);
  cp_async_commit();
  // the q tile's rel rows, staged once (rows past S read as zero)
  for (int i = tid; i < BQ * hk; i += NT) {
    const int r = i / hk, j = i % hk;
    sRh[r * RLD + j] = q0 + r < S ? rhp[(size_t)(q0 + r) * rows.ldh + j] : __float2bfloat16_rn(0.0f);
  }
  for (int i = tid; i < BQ * wk; i += NT) {
    const int r = i / wk, j = i % wk;
    sRw[r * RLD + j] = q0 + r < S ? rwp[(size_t)(q0 + r) * rows.ldw + j] : __float2bfloat16_rn(0.0f);
  }
  cp_async_wait<0>();
  __syncthreads();

  if (PRESCALE) {
    // q·scale in bf16 (the scale rounded to bf16 first)
    const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
    for (int i = tid; i < BQ * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      sQ[r * LDT + d] = __float2bfloat16_rn(__bfloat162float(sQ[r * LDT + d]) * scale_t);
    }
    __syncthreads();
  }
  // this warp's 16 rows as mma operand fragments for the whole key loop
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
      load_rows<HD>(sK + ((kt + 1) & 1) * BK * LDT, kp, rows.ld, S, k0 + BK, BK, tid);
      load_rows<HD>(sV + ((kt + 1) & 1) * BK * LDT, vp, rows.ld, S, k0 + BK, BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = q·kᵀ, 8 tiles of 8 keys; the head dim in pairs of k-steps
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

    // (scale,) + rel terms, mask keys past S, row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * tig + e;
        if (key < S) {
          const int kh = key / wk, kw = key - kh * wk;
          const float hA = __bfloat162float(sRh[rA * RLD + kh]), wA = __bfloat162float(sRw[rA * RLD + kw]);
          const float hB = __bfloat162float(sRh[rB * RLD + kh]), wB = __bfloat162float(sRw[rB * RLD + kw]);
          if (PRESCALE) {
            s[j][e] = (s[j][e] + hA) + wA;
            s[j][2 + e] = (s[j][2 + e] + hB) + wB;
          } else {
            s[j][e] = s[j][e] * scale + (hA + wA);
            s[j][2 + e] = s[j][2 + e] * scale + (hB + wB);
          }
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

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + (i ? rB : rA);
    const float lt = quad_sum(l[i]);
    if (row < S) {
      bf16* dst = out + out_at<OUT_MERGED>(bh, b, h, S, H, HD, row) + 2 * tig;
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

template <int HD, bool IN_MERGED, bool OUT_MERGED, bool PRESCALE>
__global__ void __launch_bounds__(NT) attn_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ rh, const float* __restrict__ rw, float* __restrict__ out, int S, int H, int hk,
    int wk, int ld_in, int rld, float scale) {
  constexpr int LD = Tile<HD>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // q, or q·scale
  float* sK = sQ + BQ * LD;
  float* sV = sK + BQ * LD;
  float* sO = sV + BQ * LD;
  float* sS = sO + BQ * LD;  // scores, then probabilities in place
  float* sRh = sS + BQ * LDF;
  float* sRw = sRh + BQ * RLDF;
  float* sM = sRw + BQ * RLDF;
  float* sL = sM + BQ;

  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const Rows<IN_MERGED> rows(bh, b, h, S, HD, hk, wk, ld_in, rld);
  const float *qp = q + rows.qkv, *kp = k + rows.qkv, *vp = v + rows.qkv;
  const float* rhp = rh + rows.rh;
  const float* rwp = rw + rows.rw;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    const float x = row < S ? qp[(size_t)row * rows.ld + d] : 0.0f;
    sQ[r * LD + d] = PRESCALE ? x * scale : x;
    sO[r * LD + d] = 0.0f;
  }
  for (int i = tid; i < BQ * hk; i += NT) {
    const int r = i / hk, j = i % hk;
    sRh[r * RLDF + j] = q0 + r < S ? rhp[(size_t)(q0 + r) * rows.ldh + j] : 0.0f;
  }
  for (int i = tid; i < BQ * wk; i += NT) {
    const int r = i / wk, j = i % wk;
    sRw[r * RLDF + j] = q0 + r < S ? rwp[(size_t)(q0 + r) * rows.ldw + j] : 0.0f;
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
      sK[r * LD + d] = valid ? kp[(size_t)key * rows.ld + d] : 0.0f;
      sV[r * LD + d] = valid ? vp[(size_t)key * rows.ld + d] : 0.0f;
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
          s[j] = PRESCALE ? (sS[r * LDF + c] + sRh[r * RLDF + kh]) + sRw[r * RLDF + kw]
                          : sS[r * LDF + c] * scale + (sRh[r * RLDF + kh] + sRw[r * RLDF + kw]);
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

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    if (row < S) out[out_at<OUT_MERGED>(bh, b, h, S, H, HD, row) + d] = sO[r * LD + d] / sL[r];
  }
}

}  // namespace simt

template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, const T*, const T*, T*, int, int, int, int, int, int, float);

template <typename T>
int launch(KernelFn<T> kernel, size_t smem, int bq, int nt, const void* q, const void* k, const void* v,
           const void* rh, const void* rw, void* out, int BH, int S, int H, int hk, int wk, int ld_in, int rld,
           float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + bq - 1) / bq, BH);
  kernel<<<grid, nt, smem, (cudaStream_t)stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)rh,
                                                   (const T*)rw, (T*)out, S, H, hk, wk, ld_in, rld, scale);
  return (int)cudaGetLastError();
}

// the bf16 (mma.sync) or fp32 (SIMT) instance of one layout at head dim D
// (64 or 80; anything else is refused)
template <bool IN_MERGED, bool OUT_MERGED, bool PRESCALE>
int launch_bf16(int D, const void* q, const void* k, const void* v, const void* rh, const void* rw, void* out,
                int BH, int S, int H, int hk, int wk, int ld_in, int rld, float scale, void* stream) {
  switch (D) {
    case 64:
      return launch<bf16>(mma16::attn_kernel<64, IN_MERGED, OUT_MERGED, PRESCALE>, mma16::Tile<64>::smem,
                          mma16::BQ, mma16::NT, q, k, v, rh, rw, out, BH, S, H, hk, wk, ld_in, rld, scale, stream);
    case 80:
      return launch<bf16>(mma16::attn_kernel<80, IN_MERGED, OUT_MERGED, PRESCALE>, mma16::Tile<80>::smem,
                          mma16::BQ, mma16::NT, q, k, v, rh, rw, out, BH, S, H, hk, wk, ld_in, rld, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
template <bool IN_MERGED, bool OUT_MERGED, bool PRESCALE>
int launch_f32(int D, const void* q, const void* k, const void* v, const void* rh, const void* rw, void* out,
               int BH, int S, int H, int hk, int wk, int ld_in, int rld, float scale, void* stream) {
  switch (D) {
    case 64:
      return launch<float>(simt::attn_kernel<64, IN_MERGED, OUT_MERGED, PRESCALE>, simt::Tile<64>::smem, simt::BQ,
                           simt::NT, q, k, v, rh, rw, out, BH, S, H, hk, wk, ld_in, rld, scale, stream);
    case 80:
      return launch<float>(simt::attn_kernel<80, IN_MERGED, OUT_MERGED, PRESCALE>, simt::Tile<80>::smem, simt::BQ,
                           simt::NT, q, k, v, rh, rw, out, BH, S, H, hk, wk, ld_in, rld, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

inline bool shape_ok(int BH, int S, int H, int hk, int wk) {
  return H > 0 && BH % H == 0 && hk * wk == S && hk > 0 && wk > 0 && hk <= MAXG && wk <= MAXG;
}

}  // namespace flash
