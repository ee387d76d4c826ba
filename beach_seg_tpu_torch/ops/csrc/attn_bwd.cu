// Attention backward with the decomposed rel-pos terms, for Hopper (sm_90a),
// bf16 or fp32 (split-TF32 products, at the end of this file), both on the
// tensor cores, head_dim 64 (ViT-L) or 80 (ViT-H) as template instances.
//
// Replaces the TPU kernel `_bwd_kernel` (beach_seg_tpu/ops/pallas_attn.py:722,
// wrapper `_pallas_attention_bwd`). Per (batch·head), with q, k, v, g (S, D)
// and rel_h (S, Hk), rel_w (S, Wk), S = Hk·Wk, all in fp32 from the inputs:
//
//   s[r,k]  = (q[r]·k[k])·scale + (rel_h[r, k / Wk] + rel_w[r, k % Wk])
//   p       = exp(s - rowmax) · (1 / rowsum)      (stable, whatever the forward took)
//   dV = pᵀg    dP = g·vᵀ    dS = p∘(dP - D),  D[r] = Σ_k dP[r,k]·p[r,k]
//   dQ = dS·k·scale (q's type)   dK = dSᵀ·q·scale (fp32)   dV (fp32)
//   drh[r,kh] = Σ_{k / Wk = kh} dS[r,k]   drw[r,kw] = Σ_{k % Wk = kw} dS[r,k]   (the rel terms' type)
//
// What bounds it: five S×S×D products per head (10·S²·D FLOP) against
// ~1 MB of inputs and outputs, so at ViT-L it is compute-bound on the tensor
// cores. The TPU kernel walks q-blocks in grid order and accumulates dK/dV by
// revisiting the output block; Hopper blocks run in parallel, so this file
// splits the work into two kernels, both flash-style (scores never reach
// device memory) and deterministic (no atomics):
//   1. q-major, one block per (64-row q tile, batch·head): a first pass over
//      the keys gathers the row max, row sum and D with an online rescale; a
//      second pass recomputes p and dP, forms dS, accumulates dQ = dS·k on
//      the tensor cores, and drh/drw as dS times 0/1 key-to-slot matrices
//      (also on the tensor cores, dS split into bf16 high and low parts) into
//      per-row shared-memory histograms. It writes dQ, drh, drw and the row
//      statistics.
//   2. k-major, one block per (64-key tile, batch·head): recomputes pᵀ and
//      dPᵀ from those statistics for every q tile and accumulates dV = pᵀg
//      and dK = dSᵀq in registers.
// At head_dim 80 the head dim is five 16-wide k-steps (two ldmatrix.x4 and
// one .x2 per 8-key tile) and ten 8-wide output tiles. The q-major kernel's
// Q and G tiles are needed only until their mma fragments are in registers,
// so the drh/drw histograms reuse their shared memory: that keeps both
// kernels at two blocks per SM at head_dim 80.
// That is nine products where five would do (the statistics pass and the
// recompute of S and dP in both kernels), traded for no atomics and no
// S×S storage.
// Rounding (bf16): every product is mma.sync m16n8k16 with bf16 operands and fp32
// accumulation. q, k, v and g are bf16 already, so S and dP are exact
// products summed in fp32; p (for dV) and dS (for dQ and dK) are rounded to
// bf16 as operands, where the TPU kernel keeps them in fp32. drh and drw sum
// dS to 16 significant bits (bf16 high + low parts) in fp32. Exponentials
// use the hardware exp2 (__expf, relative error ~1e-5 for the arguments
// ≤ 0 a stable softmax takes), below the bf16 rounding of every output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "tf32x3.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 64;        // rows per block tile and per step (queries or keys)
constexpr int NW = 4;         // warps per block, 16 rows each
constexpr int NT = NW * 32;
constexpr int RLD = 64 + 2;   // bf16 rel-term row stride
constexpr int LDS = 64 + 1;   // fp32 histogram row stride

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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the tile shapes of one head dim
template <int HD>
struct Dim {
  static constexpr int LDT = HD + 8;  // bf16 tile row stride: 144 B (64) / 176 B (80), conflict-free ldmatrix
  static constexpr int KS = HD / 16;  // 16-wide k-steps over the head dim
  static constexpr int NO = HD / 8;   // 8-wide output tiles of a (·, HD) product
};

// rows [r0, r0 + BT) of an (S, HD) tensor into a bf16 tile (zero past S)
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int S, int r0, int tid) {
  constexpr int LDT = Dim<HD>::LDT, CH = HD / 8;
  for (int i = tid; i < BT * CH; i += NT) {
    const int r = i / CH, c8 = (i % CH) * 8, row = r0 + r;
    const bool valid = row < S;
    cp_async16(dst + r * LDT + c8, valid ? src + (size_t)row * HD + c8 : src, valid);
  }
}

// rows [r0, r0 + BT) of rel_h / rel_w into bf16 smem tiles (zero past S)
__device__ __forceinline__ void load_rel(bf16* sRh, bf16* sRw, const bf16* rh, const bf16* rw, int S, int hk,
                                         int wk, int r0, int tid) {
  for (int i = tid; i < BT * hk; i += NT) {
    const int r = i / hk, j = i % hk;
    sRh[r * RLD + j] = r0 + r < S ? rh[(size_t)(r0 + r) * hk + j] : __float2bfloat16_rn(0.0f);
  }
  for (int i = tid; i < BT * wk; i += NT) {
    const int r = i / wk, j = i % wk;
    sRw[r * RLD + j] = r0 + r < S ? rw[(size_t)(r0 + r) * wk + j] : __float2bfloat16_rn(0.0f);
  }
}

// acc[8][4] = A (this warp's 16 rows, registers) · Bᵀ, B = 64 rows of a
// bf16 tile (64 output columns, 8 tiles of 8); the head dim in pairs of
// k-steps (ldmatrix.x4) and, for an odd count, one more (ldmatrix.x2)
template <int HD>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[Dim<HD>::KS][4], const bf16* tile,
                                        int lane) {
  constexpr int LDT = Dim<HD>::LDT, KS = Dim<HD>::KS;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk + 1 < KS; kk += 2) {
      uint32_t b[4];
      ldsm_x4(b, tile + (8 * j + (lane % 8)) * LDT + kk * 16 + (lane / 8) * 8);
      mma(acc[j], a[kk], b[0], b[1]);
      mma(acc[j], a[kk + 1], b[2], b[3]);
    }
    if (KS % 2) {
      uint32_t b[2];
      ldsm_x2(b, tile + (8 * j + (lane % 8)) * LDT + (KS - 1) * 16 + ((lane / 8) % 2) * 8);
      mma(acc[j], a[KS - 1], b[0], b[1]);
    }
  }
}

// P (16 rows × 64, the accumulator layout of mma_abt) as bf16 A fragments
// of 4 k-steps, and optionally the bf16 rounding residue likewise (hi + lo
// carry 16 significant bits)
__device__ __forceinline__ void to_a(uint32_t (&pa)[4][4], const float (&p)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j / 2][(j % 2) * 2] = pack(p[j][0], p[j][1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack(p[j][2], p[j][3]);
  }
}
__device__ __forceinline__ void to_a_residue(uint32_t (&la)[4][4], const float (&p)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float r[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) r[c] = p[j][c] - __bfloat162float(__float2bfloat16_rn(p[j][c]));
    la[j / 2][(j % 2) * 2] = pack(r[0], r[1]);
    la[j / 2][(j % 2) * 2 + 1] = pack(r[2], r[3]);
  }
}

// acc[NO][4] += P · B, P as A fragments (to_a), B = a 64×HD bf16 tile [k][n]
template <int HD>
__device__ __forceinline__ void mma_pb(float (&acc)[Dim<HD>::NO][4], const uint32_t (&pa)[4][4], const bf16* tile,
                                       int lane) {
  constexpr int LDT = Dim<HD>::LDT;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int jj = 0; jj < Dim<HD>::NO / 2; ++jj) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + (16 * t + (lane % 16)) * LDT + 16 * jj + (lane / 16) * 8);
      mma(acc[2 * jj], pa[t], b[0], b[1]);
      mma(acc[2 * jj + 1], pa[t], b[2], b[3]);
    }
  }
}

// this warp's 16 rows of a bf16 tile as mma A fragments
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[Dim<HD>::KS][4], const bf16* tile, int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < Dim<HD>::KS; ++kk)
    ldsm_x4(a[kk], tile + (warp * 16 + (lane % 16)) * Dim<HD>::LDT + kk * 16 + (lane / 16) * 8);
}

// ============================ 1. q-major: dQ, drh, drw ============================

// bytes of the fp32 drh/drw histograms, which first hold the Q and G tiles
template <int HD>
struct Hist {
  static constexpr size_t HB = (size_t)2 * BT * LDS * sizeof(float);
  static constexpr size_t QG = (size_t)2 * BT * Dim<HD>::LDT * sizeof(bf16);
  static constexpr size_t bytes = HB > QG ? HB : QG;
};
template <int HD>
constexpr size_t smem_q() {
  return Hist<HD>::bytes + (size_t)(4 * BT * Dim<HD>::LDT + 2 * BT * RLD) * sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(NT, 2) bwd_q_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ rh, const bf16* __restrict__ rw, const bf16* __restrict__ g,
    bf16* __restrict__ dq, bf16* __restrict__ drh, bf16* __restrict__ drw, float* __restrict__ stats,
    int BH, int S, int hk, int wk, float scale) {
  constexpr int LDT = Dim<HD>::LDT, KS = Dim<HD>::KS, NO = Dim<HD>::NO;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sHh = reinterpret_cast<float*>(smem);  // drh histograms, one row per query
  float* sHw = sHh + BT * LDS;
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // Q and G tiles, until their fragments are loaded
  bf16* sG = sQ + BT * LDT;
  bf16* sK = reinterpret_cast<bf16*>(smem + Hist<HD>::bytes);  // 2 stages
  bf16* sV = sK + 2 * BT * LDT;  // 2 stages
  bf16* sRh = sV + 2 * BT * LDT;
  bf16* sRw = sRh + BT * RLD;

  const int q0 = blockIdx.x * BT, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane >> 2, tig = lane & 3;
  const size_t off = (size_t)bh * S * HD;
  const bf16 *qp = q + off, *kp = k + off, *vp = v + off, *gp = g + off;

  load_tile<HD>(sQ, qp, S, q0, tid);
  load_tile<HD>(sG, gp, S, q0, tid);
  load_tile<HD>(sK, kp, S, 0, tid);
  load_tile<HD>(sV, vp, S, 0, tid);
  cp_async_commit();
  load_rel(sRh, sRw, rh + (size_t)bh * S * hk, rw + (size_t)bh * S * wk, S, hk, wk, q0, tid);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KS][4], ga[KS][4];
  load_a<HD>(qa, sQ, warp, lane);
  load_a<HD>(ga, sG, warp, lane);
  __syncthreads();  // every warp holds its fragments before the histograms overwrite the tiles
  for (int i = tid; i < 2 * BT * LDS; i += NT) sHh[i] = 0.0f;  // sHh and sHw

  const int rA = warp * 16 + gr, rB = rA + 8;  // this thread's two rows (local)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, dd[2] = {0.0f, 0.0f}, linv[2];
  float dqa[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.0f;

  const int nk = (S + BT - 1) / BT;
  // step it walks the keys twice: pass 0 gathers the row statistics, pass 1
  // forms dS; the K/V tiles stream through two stages across both passes
  for (int it = 0; it < 2 * nk; ++it) {
    const int kt = it % nk, pass = it / nk, k0 = kt * BT;
    const bf16* cK = sK + (it & 1) * BT * LDT;
    const bf16* cV = sV + (it & 1) * BT * LDT;
    __syncthreads();  // every warp is done with the stage the next prefetch overwrites
    if (it + 1 < 2 * nk) {
      const int kn = ((it + 1) % nk) * BT;
      load_tile<HD>(sK + ((it + 1) & 1) * BT * LDT, kp, S, kn, tid);
      load_tile<HD>(sV + ((it + 1) & 1) * BT * LDT, vp, S, kn, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt<HD>(s, qa, cK, lane);
    mma_abt<HD>(dp, ga, cV, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * tig + e;
        if (key < S) {
          const int kh = key / wk, kw = key - kh * wk;
          s[j][e] = s[j][e] * scale + (__bfloat162float(sRh[rA * RLD + kh]) + __bfloat162float(sRw[rA * RLD + kw]));
          s[j][2 + e] = s[j][2 + e] * scale + (__bfloat162float(sRh[rB * RLD + kh]) + __bfloat162float(sRw[rB * RLD + kw]));
        } else {
          s[j][e] = s[j][2 + e] = -INFINITY;
        }
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    }

    if (pass == 0) {
      // online row max, row sum of u = exp(s - max) and Σ u·dP
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mnew = fmaxf(m[i], quad_max(mx[i]));
        const float alpha = __expf(m[i] - mnew);  // 0 on the first step (m = -inf)
        float ls = 0.0f, ds = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float u = __expf(s[j][2 * i + e] - mnew);
            ls += u;
            ds += u * dp[j][2 * i + e];
          }
        }
        l[i] = l[i] * alpha + ls;
        dd[i] = dd[i] * alpha + ds;
        m[i] = mnew;
      }
      if (it == nk - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] = quad_sum(l[i]);
          dd[i] = quad_sum(dd[i]) / l[i];  // D = rowsum(dP∘p)
          linv[i] = 1.0f / l[i];
        }
      }
      continue;
    }

    // pass 1: dS = p∘(dP - D), kept in s
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c / 2;
        const float p = __expf(s[j][c] - m[i]) * linv[i];
        s[j][c] = p * (dp[j][c] - dd[i]);
      }
    }
    uint32_t dsa[4][4], dsl[4][4];
    to_a(dsa, s);
    to_a_residue(dsl, s);
    // drh/drw on the tensor cores: (dS_hi + dS_lo) · E, E[key][slot] = 1
    // where the key's row (drh, slots from this tile's first row kh0) or
    // column (drw) is the slot, built in registers from the slot indices of
    // this thread's keys (8 bits each, 0xFF past S); each thread adds its
    // accumulator cells (its own rows and slots) into the histograms
    {
      const int kh0 = k0 / wk;
      uint32_t slots[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};  // [drh, drw][key index / 4]
#pragma unroll
      for (int idx = 0; idx < 16; ++idx) {  // key index 2j + e ↔ key 8j + 2·tig + e
        const int key = k0 + 8 * (idx / 2) + 2 * tig + (idx % 2);
        const int kh = key / wk;
        const uint32_t sh = key < S ? kh - kh0 : 0xFFu, sw = key < S ? key - kh * wk : 0xFFu;
        slots[0][idx / 4] |= sh << (8 * (idx % 4));
        slots[1][idx / 4] |= sw << (8 * (idx % 4));
      }
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const int nslots = which ? wk : (min(k0 + BT, S) - 1) / wk - kh0 + 1;
        float* hist = which ? sHw : sHh + kh0;
        for (int nt = 0; nt * 8 < nslots; ++nt) {
          const uint32_t slot = 8 * nt + gr;
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            uint32_t b[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // keys 16t + 8h + 2·tig + {0, 1}: key indices 4t + 2h + {0, 1}
              const uint32_t w = slots[which][t] >> (16 * h);
              b[h] = ((w & 0xFFu) == slot ? 0x3F80u : 0u) | (((w >> 8) & 0xFFu) == slot ? 0x3F800000u : 0u);
            }
            mma(acc, dsa[t], b[0], b[1]);
            mma(acc, dsl[t], b[0], b[1]);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = 8 * nt + 2 * tig + (c % 2);
            if (col < nslots) hist[(warp * 16 + gr + 8 * (c / 2)) * LDS + col] += acc[c];
          }
        }
      }
    }
    mma_pb<HD>(dqa, dsa, cK, lane);  // dQ += dS·k
  }
  // the histogram cells of this warp's rows were added to by other lanes
  // than those that write them out below (the loop's barriers order the
  // steps among themselves, nothing orders the last step and the write-out)
  __syncwarp();

  // outputs of this warp's rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + (i ? rB : rA);
    if (row >= S) continue;
    if (tig == 0) {
      const size_t o = (size_t)bh * S + row;
      stats[o] = m[i];
      stats[(size_t)BH * S + o] = l[i];
      stats[(size_t)2 * BH * S + o] = dd[i];
    }
    bf16* dst = dq + off + (size_t)row * HD + 2 * tig;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack(dqa[j][2 * i] * scale, dqa[j][2 * i + 1] * scale);
  }
  for (int i = lane; i < 16 * hk; i += 32) {
    const int r = i / hk, j = i % hk, row = q0 + warp * 16 + r;
    if (row < S) drh[((size_t)bh * S + row) * hk + j] = __float2bfloat16_rn(sHh[(warp * 16 + r) * LDS + j]);
  }
  for (int i = lane; i < 16 * wk; i += 32) {
    const int r = i / wk, j = i % wk, row = q0 + warp * 16 + r;
    if (row < S) drw[((size_t)bh * S + row) * wk + j] = __float2bfloat16_rn(sHw[(warp * 16 + r) * LDS + j]);
  }
}

// ============================ 2. k-major: dK, dV ============================

template <int HD>
constexpr size_t smem_k() {
  return (size_t)(6 * BT * Dim<HD>::LDT + 2 * BT * RLD) * sizeof(bf16) + (size_t)3 * BT * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(NT, 2) bwd_k_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ rh, const bf16* __restrict__ rw, const bf16* __restrict__ g,
    float* __restrict__ dk, float* __restrict__ dv, const float* __restrict__ stats,
    int BH, int S, int hk, int wk, float scale) {
  constexpr int LDT = Dim<HD>::LDT, KS = Dim<HD>::KS, NO = Dim<HD>::NO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BT * LDT;
  bf16* sQ = sV + BT * LDT;      // 2 stages
  bf16* sG = sQ + 2 * BT * LDT;  // 2 stages
  bf16* sRh = sG + 2 * BT * LDT;
  bf16* sRw = sRh + BT * RLD;
  float* sM = reinterpret_cast<float*>(sRw + BT * RLD);
  float* sLinv = sM + BT;  // 1 / row sum
  float* sD = sLinv + BT;

  const int k0 = blockIdx.x * BT, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane >> 2, tig = lane & 3;
  const size_t off = (size_t)bh * S * HD;
  const bf16 *qp = q + off, *kp = k + off, *vp = v + off, *gp = g + off;
  const bf16* rhp = rh + (size_t)bh * S * hk;
  const bf16* rwp = rw + (size_t)bh * S * wk;

  load_tile<HD>(sK, kp, S, k0, tid);
  load_tile<HD>(sV, vp, S, k0, tid);
  load_tile<HD>(sQ, qp, S, 0, tid);
  load_tile<HD>(sG, gp, S, 0, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t ka[KS][4], va[KS][4];
  load_a<HD>(ka, sK, warp, lane);
  load_a<HD>(va, sV, warp, lane);

  // this thread's two keys (rows of the transposed scores); keys past S
  // read table slot 0 and are never stored
  int kh[2], kw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = min(k0 + warp * 16 + gr + 8 * i, S - 1);
    kh[i] = key / wk;
    kw[i] = key - kh[i] * wk;
  }
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.0f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.0f;
  }

  const int nq = (S + BT - 1) / BT;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * BT;
    const bf16* cQ = sQ + (qt & 1) * BT * LDT;
    const bf16* cG = sG + (qt & 1) * BT * LDT;
    __syncthreads();  // every warp is done with the previous stage, rel rows and statistics
    if (qt + 1 < nq) {
      load_tile<HD>(sQ + ((qt + 1) & 1) * BT * LDT, qp, S, q0 + BT, tid);
      load_tile<HD>(sG + ((qt + 1) & 1) * BT * LDT, gp, S, q0 + BT, tid);
      cp_async_commit();
    }
    load_rel(sRh, sRw, rhp, rwp, S, hk, wk, q0, tid);
    for (int i = tid; i < BT; i += NT) {
      const bool valid = q0 + i < S;
      const size_t o = (size_t)bh * S + q0 + i;
      sM[i] = valid ? stats[o] : 0.0f;
      sLinv[i] = valid ? 1.0f / stats[(size_t)BH * S + o] : 1.0f;
      sD[i] = valid ? stats[(size_t)2 * BH * S + o] : 0.0f;
    }
    if (qt + 1 < nq) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float st[8][4], dpt[8][4];  // sᵀ and dPᵀ: this warp's 16 keys × 64 queries
    mma_abt<HD>(st, ka, cQ, lane);
    mma_abt<HD>(dpt, va, cG, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c / 2, qc = 8 * j + 2 * tig + (c % 2);
        float p = 0.0f;
        if (q0 + qc < S) {
          const float s = st[j][c] * scale +
                          (__bfloat162float(sRh[qc * RLD + kh[i]]) + __bfloat162float(sRw[qc * RLD + kw[i]]));
          p = __expf(s - sM[qc]) * sLinv[qc];
        }
        st[j][c] = p;
        dpt[j][c] = p * (dpt[j][c] - sD[qc]);  // dSᵀ
      }
    }
    uint32_t pa[4][4];
    to_a(pa, st);
    mma_pb<HD>(dva, pa, cG, lane);  // dV += pᵀ·g
    to_a(pa, dpt);
    mma_pb<HD>(dka, pa, cQ, lane);  // dK += dSᵀ·q
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + gr + 8 * i;
    if (key >= S) continue;
    float* dkr = dk + off + (size_t)key * HD + 2 * tig;
    float* dvr = dv + off + (size_t)key * HD + 2 * tig;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<float2*>(dkr + 8 * j) = make_float2(dka[j][2 * i] * scale, dka[j][2 * i + 1] * scale);
      *reinterpret_cast<float2*>(dvr + 8 * j) = make_float2(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* rh, const void* rw, const void* g, void* dq,
           void* dk, void* dv, void* drh, void* drw, void* stats, int BH, int S, int hk, int wk, float scale,
           void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(bwd_q_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q<HD>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_k_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_k<HD>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BT - 1) / BT, BH);
  cudaStream_t st = (cudaStream_t)stream;
  bwd_q_kernel<HD><<<grid, NT, smem_q<HD>(), st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                   (const bf16*)rh, (const bf16*)rw, (const bf16*)g, (bf16*)dq,
                                                   (bf16*)drh, (bf16*)drw, (float*)stats, BH, S, hk, wk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_k_kernel<HD><<<grid, NT, smem_k<HD>(), st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                   (const bf16*)rh, (const bf16*)rw, (const bf16*)g, (float*)dk,
                                                   (float*)dv, (const float*)stats, BH, S, hk, wk, scale);
  return (int)cudaGetLastError();
}

// ======================= fp32: split-TF32 mma.sync =======================
//
// The same two kernels with every input and output in fp32 and every
// product in split TF32 (tf32x3.cuh: three mma.sync m16n8k8 .tf32 a
// product, fp32-accurate to a few ulps): S, dP and dQ in the q-major
// kernel, Sᵀ, dPᵀ, dV and dK in the k-major one, and drh/drw as dS times
// the 0/1 key-to-slot matrices (exact in TF32, so two products: dS big and
// small). Warps of 16 rows with accumulators in registers, tiles by
// cp.async, two blocks of 4 warps per SM at both head dims:
//   q-major: 64 query rows a block; q and g stay in registers as fp32
//     fragment values (split where used), so their tiles share the K/V
//     stages' shared memory until the key loop; 32 keys a step; drh and
//     drw into shared histograms, one row per query (drh's slots move with
//     the step's key rows).
//   k-major: 64 keys a block, K and V tiles in shared memory as the A
//     operands, 32 queries a step: the next step's Q/G tiles load during
//     this step's products, its rel rows and statistics during dV and dK.
// The products over the head dim (S, dP and their transposes) take it in
// the order of tf32x3::dperm, so a thread's B values of two k steps are one
// 16-byte load. An accumulator tile is the A operand of the next product in the k order
// of tf32x3::to_a, so the B operands of dQ, dV and dK read rows 2t and
// 2t + 1 of each 8-row group; with a row stride of HD + 4 floats both
// orientations of a tile's fragment loads are free of bank conflicts.
// Exponentials use the exact expf.

namespace f32 {

constexpr int BK = 32;      // keys a step (q-major), queries a step (k-major)
constexpr int RLD = 64 + 4; // rel-row stride (floats)
constexpr int HLD = 64 + 1; // drh histogram row stride

template <int HD>
struct Dim32 {
  static constexpr int LD = HD + 4;  // tile row stride (floats)
  static constexpr int KS = HD / 8;  // 8-wide k steps over the head dim, and 8-wide output tiles
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  // invalid rows are zero-filled (src-size 0)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// rows [r0, r0 + ROWS) of an (S, HD) tensor into a tile (zero past S)
template <int HD, int ROWS>
__device__ __forceinline__ void load32(float* dst, const float* src, int S, int r0, int tid) {
  constexpr int LD = Dim32<HD>::LD, CH = HD / 4;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c4 = (i % CH) * 4, row = r0 + r;
    const bool valid = row < S;
    cp_async16(dst + r * LD + c4, valid ? src + (size_t)row * HD + c4 : src, valid);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// rows [r0, r0 + rows) of rel_h / rel_w (zero past S)
__device__ __forceinline__ void load_rel32(float* sRh, float* sRw, const float* rh, const float* rw, int S, int hk,
                                           int wk, int r0, int rows, int tid) {
  for (int i = tid; i < rows * hk; i += NT) {
    const int r = i / hk, j = i % hk;
    sRh[r * RLD + j] = r0 + r < S ? rh[(size_t)(r0 + r) * hk + j] : 0.0f;
  }
  for (int i = tid; i < rows * wk; i += NT) {
    const int r = i / wk, j = i % wk;
    sRw[r * RLD + j] = r0 + r < S ? rw[(size_t)(r0 + r) * wk + j] : 0.0f;
  }
}

// the A fragment values (a0..a3 of every k step) of 16 rows of a tile, the
// head dim in the order of tf32x3::dperm
template <int HD>
__device__ __forceinline__ void load_a32(float (&a)[Dim32<HD>::KS][4], const float* rows16, int gr, int t) {
  constexpr int LD = Dim32<HD>::LD;
  const float* r = rows16 + gr * LD;
#pragma unroll
  for (int kk = 0; kk < Dim32<HD>::KS; ++kk) {
    a[kk][0] = r[tf32x3::dperm<HD>(kk, t)];
    a[kk][1] = r[8 * LD + tf32x3::dperm<HD>(kk, t)];
    a[kk][2] = r[tf32x3::dperm<HD>(kk, t + 4)];
    a[kk][3] = r[8 * LD + tf32x3::dperm<HD>(kk, t + 4)];
  }
}

// the B fragment of a (·, HD)-wide product's output tile nt, k step j, from
// a [k][HD] tile in the k order of tf32x3::to_a (rows 8j + 2t, 8j + 2t + 1)
template <int HD>
__device__ __forceinline__ tf32x3::FragB b_kn(const float* tile, int j, int nt, int gr, int t) {
  const float* p = tile + (8 * j + 2 * t) * Dim32<HD>::LD + 8 * nt + gr;
  return tf32x3::split_b(p[0], p[Dim32<HD>::LD]);
}
// the B fragment values of an (·, 8j..8j+7) score tile, k steps 2p and
// 2p + 1 over the head dim (order of tf32x3::dperm), from an [n][HD] tile
// (row 8j + gr): b0, b1 of step 2p, then of step 2p + 1
template <int HD>
__device__ __forceinline__ float4 b_nk2(const float* tile, int j, int p, int gr, int t) {
  return *reinterpret_cast<const float4*>(tile + (8 * j + gr) * Dim32<HD>::LD + tf32x3::pair_col<HD>(p, t));
}

// acc += A · B over a step of 32 rows (4 k steps): A this thread's part of
// 4 accumulator tiles (k order of tf32x3::to_a), B a [k][HD] tile. The
// step's product has its own accumulator, added to acc on the FP32 units:
// the tensor cores' accumulation truncates, and a sum over all S rows inside
// them would carry S/8·3 truncations (588 at S=1568) where one
// step carries 12
template <int HD>
__device__ __forceinline__ void step_acc(float (&acc)[Dim32<HD>::KS][4], const float (&a)[4][4], const float* tile,
                                         int gr, int t) {
  constexpr int KS = Dim32<HD>::KS;
  float p[KS][4];
#pragma unroll
  for (int nt = 0; nt < KS; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const tf32x3::FragA fa = tf32x3::to_a(a[j]);
#pragma unroll
    for (int nt = 0; nt < KS; ++nt) tf32x3::mma3(p[nt], fa, b_kn<HD>(tile, j, nt, gr, t));
  }
#pragma unroll
  for (int nt = 0; nt < KS; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] += p[nt][c];
  }
}

// 1.0f where a slot byte equals the slot, as a TF32 operand
__device__ __forceinline__ uint32_t one_if(uint32_t byte, uint32_t slot) { return byte == slot ? 0x3F800000u : 0u; }

// ---------------------------- q-major: dQ, drh, drw ----------------------------

// drh or drw of a step of 32 keys as dS · E on the tensor cores, E[key][slot]
// = 1 where the key's slot (its row from the step's first, or its column)
// is the slot: E's B fragment is built in registers from the slot bytes of
// this thread's two keys of k step j (b0: key 8j + 2t, b1: 8j + 2t + 1).
// Up to 4 tiles of 8 slots from slot `first`; each thread adds its cells
// (its rows, its slots) into the histogram rows `hist` (slot `first` at
// hist[0]), n of them
__device__ __forceinline__ void slot_sums(float* hist, const uint32_t (&bytes)[2], const float (&ds)[4][4], int n,
                                          int rA, int rB, int gr, int t, int first = 0) {
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const tf32x3::FragA da = tf32x3::to_a(ds[j]);
    const uint32_t b2 = bytes[j / 2] >> (16 * (j % 2));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (8 * i < n) {
        const uint32_t slot = first + 8 * i + gr, e[2] = {one_if(b2 & 0xFFu, slot), one_if((b2 >> 8) & 0xFFu, slot)};
        tf32x3::mma2(acc[i], da, e);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 8 * i + 2 * t + (c % 2);
      if (col < n) hist[(c / 2 ? rB : rA) * HLD + col] += acc[i][c];
    }
  }
}

template <int HD>
constexpr size_t smem_q() {
  // K, V (2 stages of BK rows; first the Q and G tiles), rel rows, drh and drw histograms
  return (size_t)(4 * BK * Dim32<HD>::LD + 2 * BT * RLD + 2 * BT * HLD) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(NT, 2) bwd_q_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ rh, const float* __restrict__ rw, const float* __restrict__ g,
    float* __restrict__ dq, float* __restrict__ drh, float* __restrict__ drw, float* __restrict__ stats,
    int BH, int S, int hk, int wk, float scale) {
  using namespace tf32x3;
  constexpr int LD = Dim32<HD>::LD, KS = Dim32<HD>::KS;
  static_assert(2 * BT == 4 * BK, "the Q and G tiles fill the K/V stages");
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // 2 stages
  float* sV = sK + 2 * BK * LD;                 // 2 stages
  float* sQ = sK;                               // Q and G tiles, until their fragments are in registers
  float* sG = sQ + BT * LD;
  float* sRh = sK + 4 * BK * LD;
  float* sRw = sRh + BT * RLD;
  float* sHh = sRw + BT * RLD;  // drh histograms, one row per query
  float* sHw = sHh + BT * HLD;  // drw histograms

  const int q0 = blockIdx.x * BT, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane >> 2, t = lane & 3;
  const size_t off = (size_t)bh * S * HD;
  const float *qp = q + off, *kp = k + off, *vp = v + off, *gp = g + off;

  load32<HD, BT>(sQ, qp, S, q0, tid);
  load32<HD, BT>(sG, gp, S, q0, tid);
  cp_async_commit();
  load_rel32(sRh, sRw, rh + (size_t)bh * S * hk, rw + (size_t)bh * S * wk, S, hk, wk, q0, BT, tid);
  for (int i = tid; i < 2 * BT * HLD; i += NT) sHh[i] = 0.0f;  // sHh and sHw
  cp_async_wait<0>();
  __syncthreads();
  float qa[KS][4], ga[KS][4];
  load_a32<HD>(qa, sQ + warp * 16 * LD, gr, t);
  load_a32<HD>(ga, sG + warp * 16 * LD, gr, t);
  __syncthreads();  // every warp holds its fragments before the K/V stages overwrite the tiles
  load32<HD, BK>(sK, kp, S, 0, tid);
  load32<HD, BK>(sV, vp, S, 0, tid);
  cp_async_commit();

  const int rA = warp * 16 + gr, rB = rA + 8;  // this thread's two rows (local)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, dd[2] = {0.0f, 0.0f}, linv[2] = {0.0f, 0.0f};
  float dqa[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.0f;
  const float inv_wk = 1.0f / wk;

  const int nk = (S + BK - 1) / BK;
  // step it walks the keys twice: pass 0 gathers the row statistics, pass 1
  // forms dS; the K/V tiles stream through two stages across both passes
  for (int it = 0; it < 2 * nk; ++it) {
    const int kt = it % nk, pass = it / nk, k0 = kt * BK;
    const float* cK = sK + (it & 1) * BK * LD;
    const float* cV = sV + (it & 1) * BK * LD;
    __syncthreads();  // every warp is done with the stage the next prefetch overwrites
    if (it + 1 < 2 * nk) {
      const int kn = ((it + 1) % nk) * BK;
      load32<HD, BK>(sK + ((it + 1) & 1) * BK * LD, kp, S, kn, tid);
      load32<HD, BK>(sV + ((it + 1) & 1) * BK * LD, vp, S, kn, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = q·kᵀ and dP = g·vᵀ, 4 tiles of 8 keys (column n of tile j is key 8j + n)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
#pragma unroll
    for (int p = 0; p < KS / 2; ++p) {
      {
        const FragA f0 = split_a(qa[2 * p][0], qa[2 * p][1], qa[2 * p][2], qa[2 * p][3]);
        const FragA f1 = split_a(qa[2 * p + 1][0], qa[2 * p + 1][1], qa[2 * p + 1][2], qa[2 * p + 1][3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 b = b_nk2<HD>(cK, j, p, gr, t);
          mma3(s[j], f0, split_b(b.x, b.y));
          mma3(s[j], f1, split_b(b.z, b.w));
        }
      }
      const FragA f0 = split_a(ga[2 * p][0], ga[2 * p][1], ga[2 * p][2], ga[2 * p][3]);
      const FragA f1 = split_a(ga[2 * p + 1][0], ga[2 * p + 1][1], ga[2 * p + 1][2], ga[2 * p + 1][3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = b_nk2<HD>(cV, j, p, gr, t);
        mma3(dp[j], f0, split_b(b.x, b.y));
        mma3(dp[j], f1, split_b(b.z, b.w));
      }
    }
    // scores; this thread's keys 8j + 2t + e: their slots, 0xFF past S, a
    // byte each (drh from this step's first key row kh0) for pass 1
    const int kh0 = k0 / wk;
    uint32_t sh[2] = {0u, 0u}, sw[2] = {0u, 0u};
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e, byte = 8 * (2 * (j % 2) + e);
        if (key < S) {
          const int kh = static_cast<int>((key + 0.5f) * inv_wk), kw = key - kh * wk;
          s[j][e] = s[j][e] * scale + (sRh[rA * RLD + kh] + sRw[rA * RLD + kw]);
          s[j][2 + e] = s[j][2 + e] * scale + (sRh[rB * RLD + kh] + sRw[rB * RLD + kw]);
          sh[j / 2] |= (uint32_t)(kh - kh0) << byte;
          sw[j / 2] |= (uint32_t)kw << byte;
        } else {
          s[j][e] = s[j][2 + e] = -INFINITY;
          sh[j / 2] |= 0xFFu << byte;
          sw[j / 2] |= 0xFFu << byte;
        }
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    }

    if (pass == 0) {
      // online row max, row sum of u = exp(s - max) and Σ u·dP
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mnew = fmaxf(m[i], quad_max(mx[i]));
        const float alpha = expf(m[i] - mnew);  // 0 on the first step (m = -inf)
        float ls = 0.0f, ds = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float u = expf(s[j][2 * i + e] - mnew);
            ls += u;
            ds += u * dp[j][2 * i + e];
          }
        }
        l[i] = l[i] * alpha + ls;
        dd[i] = dd[i] * alpha + ds;
        m[i] = mnew;
      }
      if (it == nk - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] = quad_sum(l[i]);
          dd[i] = quad_sum(dd[i]) / l[i];  // D = rowsum(dP∘p)
          linv[i] = 1.0f / l[i];
        }
      }
      continue;
    }

    // pass 1: dS = p∘(dP - D), kept in s (0 past S)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c / 2;
        s[j][c] = expf(s[j][c] - m[i]) * linv[i] * (dp[j][c] - dd[i]);
      }
    }
    // dQ += dS·k, tile j of dS the A fragment of a k step of 8 keys
    step_acc<HD>(dqa, s, cK, gr, t);
    const int nh = (min(k0 + BK, S) - 1) / wk - kh0 + 1;  // drh slots this step touches (≤ BK)
    slot_sums(sHh + kh0, sh, s, nh, rA, rB, gr, t);         // drh: 4 tiles of 8 slots
    slot_sums(sHw, sw, s, min(wk, 32), rA, rB, gr, t);      // drw slots 0..31
    if (wk > 32) slot_sums(sHw + 32, sw, s, wk - 32, rA, rB, gr, t, 32);
  }
  // the histogram cells of this warp's rows were added to by other lanes
  // than those that write them out below
  __syncwarp();

  // outputs of this warp's rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + (i ? rB : rA);
    if (row >= S) continue;
    if (t == 0) {
      const size_t o = (size_t)bh * S + row;
      stats[o] = m[i];
      stats[(size_t)BH * S + o] = l[i];
      stats[(size_t)2 * BH * S + o] = dd[i];
    }
    float* dst = dq + off + (size_t)row * HD + 2 * t;
#pragma unroll
    for (int nt = 0; nt < KS; ++nt)
      *reinterpret_cast<float2*>(dst + 8 * nt) = make_float2(dqa[nt][2 * i] * scale, dqa[nt][2 * i + 1] * scale);
  }
  for (int i = lane; i < 16 * hk; i += 32) {
    const int r = i / hk, j = i % hk, row = q0 + warp * 16 + r;
    if (row < S) drh[((size_t)bh * S + row) * hk + j] = sHh[(warp * 16 + r) * HLD + j];
  }
  for (int i = lane; i < 16 * wk; i += 32) {
    const int r = i / wk, j = i % wk, row = q0 + warp * 16 + r;
    if (row < S) drw[((size_t)bh * S + row) * wk + j] = sHw[(warp * 16 + r) * HLD + j];
  }
}

// ---------------------------- k-major: dK, dV ----------------------------

// the rel rows and statistics (row max, row sum, D) of queries [q0, q0 + BK)
// by cp.async, zero past S; stats points at this (batch·head)'s row max,
// the other two are plane floats after it. A warp a row, its lanes along
// the slots: 16-byte pieces where hk and wk are multiples of 4 (then S is a
// multiple of 16 and every row 16-byte aligned), else floats
__device__ __forceinline__ void load_step(float* sRh, float* sRw, float* sStat, const float* rh, const float* rw,
                                          const float* stats, size_t plane, int S, int hk, int wk, int q0, int tid) {
  if ((hk | wk) % 4 == 0) {
    const int lane = tid % 32, nh = hk / 4, c = 4 * (lane - nh);  // lanes [0, nh) take rel_h, then rel_w
    for (int r = tid / 32; r < BK; r += NW) {
      const int row = min(q0 + r, S - 1);
      const bool valid = q0 + r < S;
      if (lane < nh) {
        cp_async16(sRh + r * RLD + 4 * lane, rh + (size_t)row * hk + 4 * lane, valid);
      } else if (c < wk) {
        cp_async16(sRw + r * RLD + c, rw + (size_t)row * wk + c, valid);
      }
    }
    if (tid < 3 * BK / 4) {
      const int w = tid / (BK / 4), r = 4 * (tid % (BK / 4));
      cp_async16(sStat + w * BK + r, stats + w * plane + min(q0 + r, S - 4), q0 + r < S);
    }
    return;
  }
  for (int r = tid / 32; r < BK; r += NW) {
    const int row = min(q0 + r, S - 1);
    const bool valid = q0 + r < S;
    for (int j = tid % 32; j < hk; j += 32) cp_async4(sRh + r * RLD + j, rh + (size_t)row * hk + j, valid);
    for (int j = tid % 32; j < wk; j += 32) cp_async4(sRw + r * RLD + j, rw + (size_t)row * wk + j, valid);
  }
  for (int i = tid; i < 3 * BK; i += NT) {
    const int w = i / BK, r = i % BK;
    cp_async4(sStat + i, stats + w * plane + min(q0 + r, S - 1), q0 + r < S);
  }
}

template <int HD>
constexpr size_t smem_k() {
  // K, V (BT rows), Q, G (2 stages of BK rows), rel rows and statistics of a step
  return (size_t)(2 * BT * Dim32<HD>::LD + 4 * BK * Dim32<HD>::LD + 2 * BK * RLD + 3 * BK) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(NT, 2) bwd_k_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ rh, const float* __restrict__ rw, const float* __restrict__ g,
    float* __restrict__ dk, float* __restrict__ dv, const float* __restrict__ stats,
    int BH, int S, int hk, int wk, float scale) {
  using namespace tf32x3;
  constexpr int LD = Dim32<HD>::LD, KS = Dim32<HD>::KS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;      // 2 stages
  float* sG = sQ + 2 * BK * LD;  // 2 stages
  float* sRh = sG + 2 * BK * LD;
  float* sRw = sRh + BK * RLD;
  float* sM = sRw + BK * RLD;  // row max, row sum, D of the step's queries
  float* sL = sM + BK;
  float* sD = sL + BK;

  const int k0 = blockIdx.x * BT, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane >> 2, t = lane & 3;
  const size_t off = (size_t)bh * S * HD;
  const float *qp = q + off, *kp = k + off, *vp = v + off, *gp = g + off;
  const float* rhp = rh + (size_t)bh * S * hk;
  const float* rwp = rw + (size_t)bh * S * wk;

  load32<HD, BT>(sK, kp, S, k0, tid);
  load32<HD, BT>(sV, vp, S, k0, tid);
  load32<HD, BK>(sQ, qp, S, 0, tid);
  load32<HD, BK>(sG, gp, S, 0, tid);
  load_step(sRh, sRw, sM, rhp, rwp, stats + (size_t)bh * S, (size_t)BH * S, S, hk, wk, 0, tid);
  cp_async_commit();

  // this thread's two keys (rows of the transposed scores); keys past S
  // read table slot 0 and are never stored
  int kh[2], kw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = min(k0 + warp * 16 + gr + 8 * i, S - 1);
    kh[i] = key / wk;
    kw[i] = key - kh[i] * wk;
  }
  float dka[KS][4], dva[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.0f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.0f;
  }
  const float* kr16 = sK + warp * 16 * LD;
  const float* vr16 = sV + warp * 16 * LD;

  const int nq = (S + BK - 1) / BK;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * BK;
    const float* cQ = sQ + (qt & 1) * BK * LD;
    const float* cG = sG + (qt & 1) * BK * LD;
    // this step's Q/G stage, rel rows and statistics have landed, and every
    // warp is done with the previous step
    cp_async_wait<0>();
    __syncthreads();
    if (qt + 1 < nq) {  // the next Q/G stage, during this step's products
      load32<HD, BK>(sQ + ((qt + 1) & 1) * BK * LD, qp, S, q0 + BK, tid);
      load32<HD, BK>(sG + ((qt + 1) & 1) * BK * LD, gp, S, q0 + BK, tid);
      cp_async_commit();
    }

    // sᵀ = k·qᵀ and dPᵀ = v·gᵀ: this warp's 16 keys × 4 tiles of 8 queries
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.0f;
#pragma unroll
    for (int p = 0; p < KS / 2; ++p) {
      const int col = pair_col<HD>(p, t);
      {
        const float4 x = *reinterpret_cast<const float4*>(kr16 + gr * LD + col);
        const float4 y = *reinterpret_cast<const float4*>(kr16 + (gr + 8) * LD + col);
        const FragA f0 = split_a(x.x, y.x, x.y, y.y), f1 = split_a(x.z, y.z, x.w, y.w);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 b = b_nk2<HD>(cQ, j, p, gr, t);
          mma3(st[j], f0, split_b(b.x, b.y));
          mma3(st[j], f1, split_b(b.z, b.w));
        }
      }
      const float4 x = *reinterpret_cast<const float4*>(vr16 + gr * LD + col);
      const float4 y = *reinterpret_cast<const float4*>(vr16 + (gr + 8) * LD + col);
      const FragA f0 = split_a(x.x, y.x, x.y, y.y), f1 = split_a(x.z, y.z, x.w, y.w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = b_nk2<HD>(cG, j, p, gr, t);
        mma3(dpt[j], f0, split_b(b.x, b.y));
        mma3(dpt[j], f1, split_b(b.z, b.w));
      }
    }
    // pᵀ and dSᵀ (0 for queries past S)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * j + 2 * t + e;
        const bool valid = q0 + qc < S;
        const float linv = valid ? __frcp_rn(sL[qc]) : 0.0f, m = sM[qc], d = sD[qc];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 2 * i + e;
          float p = 0.0f;
          if (valid) {
            const float s = st[j][c] * scale + (sRh[qc * RLD + kh[i]] + sRw[qc * RLD + kw[i]]);
            p = expf(s - m) * linv;
          }
          st[j][c] = p;
          dpt[j][c] = p * (dpt[j][c] - d);  // dSᵀ
        }
      }
    }
    __syncthreads();  // every warp is done with the step's rel rows and statistics
    if (qt + 1 < nq) {  // the next step's, during the dV and dK products
      load_step(sRh, sRw, sM, rhp, rwp, stats + (size_t)bh * S, (size_t)BH * S, S, hk, wk, q0 + BK, tid);
      cp_async_commit();
    }
    // dV += pᵀ·g, then dK += dSᵀ·q, tile j a k step of 8 queries
    step_acc<HD>(dva, st, cG, gr, t);
    step_acc<HD>(dka, dpt, cQ, gr, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + gr + 8 * i;
    if (key >= S) continue;
    float* dkr = dk + off + (size_t)key * HD + 2 * t;
    float* dvr = dv + off + (size_t)key * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      *reinterpret_cast<float2*>(dkr + 8 * j) = make_float2(dka[j][2 * i] * scale, dka[j][2 * i + 1] * scale);
      *reinterpret_cast<float2*>(dvr + 8 * j) = make_float2(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* rh, const void* rw, const void* g, void* dq,
           void* dk, void* dv, void* drh, void* drw, void* stats, int BH, int S, int hk, int wk, float scale,
           void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(bwd_q_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q<HD>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_k_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_k<HD>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BT - 1) / BT, BH);
  cudaStream_t st = (cudaStream_t)stream;
  bwd_q_kernel<HD><<<grid, NT, smem_q<HD>(), st>>>((const float*)q, (const float*)k, (const float*)v,
                                                   (const float*)rh, (const float*)rw, (const float*)g, (float*)dq,
                                                   (float*)drh, (float*)drw, (float*)stats, BH, S, hk, wk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_k_kernel<HD><<<grid, NT, smem_k<HD>(), st>>>((const float*)q, (const float*)k, (const float*)v,
                                                   (const float*)rh, (const float*)rw, (const float*)g, (float*)dk,
                                                   (float*)dv, (const float*)stats, BH, S, hk, wk, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

typedef int (*Launch)(const void*, const void*, const void*, const void*, const void*, const void*, void*, void*,
                      void*, void*, void*, void*, int, int, int, int, float, void*);

int dispatch(Launch l64, Launch l80, const void* q, const void* k, const void* v, const void* rh, const void* rw,
             const void* g, void* dq, void* dk, void* dv, void* drh, void* drw, void* stats, int BH, int S, int D,
             int hk, int wk, float scale, void* stream) {
  if (hk * wk != S || hk > 64 || wk > 64) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return l64(q, k, v, rh, rw, g, dq, dk, dv, drh, drw, stats, BH, S, hk, wk, scale, stream);
    case 80:
      return l80(q, k, v, rh, rw, g, dq, dk, dv, drh, drw, stats, BH, S, hk, wk, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, g (BH, S, D) with D 64 or 80, rel_h (BH, S, hk), rel_w (BH, S, wk)
// bf16, S = hk·wk, hk, wk <= 64 → dq, drh, drw bf16, dk, dv fp32; stats:
// (3, BH, S) fp32 scratch
extern "C" int attn_bwd_bf16(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                             const void* g, void* dq, void* dk, void* dv, void* drh, void* drw, void* stats,
                             int BH, int S, int D, int hk, int wk, float scale, void* stream) {
  return dispatch(launch<64>, launch<80>, q, k, v, rh, rw, g, dq, dk, dv, drh, drw, stats, BH, S, D, hk, wk, scale,
                  stream);
}

// the same contract with every input and output in fp32
extern "C" int attn_bwd_f32(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                            const void* g, void* dq, void* dk, void* dv, void* drh, void* drw, void* stats, int BH,
                            int S, int D, int hk, int wk, float scale, void* stream) {
  return dispatch(f32::launch<64>, f32::launch<80>, q, k, v, rh, rw, g, dq, dk, dv, drh, drw, stats, BH, S, D, hk,
                  wk, scale, stream);
}
