// Attention backward with the decomposed rel-pos terms, for Hopper (sm_90a),
// bf16 (tensor cores) or fp32 (FP32 units, at the end of this file),
// head_dim 64 (ViT-L) or 80 (ViT-H) as template instances.
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

// ============================ fp32: SIMT ============================
//
// The same two kernels in full fp32, every product on the FP32 units (no
// TF32), so the math is the TPU kernel's at fp32 up to the order of sums:
// 64-row tiles, 256 threads. Each product is a 64 × 64 (or 64 × D) tile in
// which a thread owns a 4 × 4 block (4 × D/16 for the head dim) and reads
// both operands as 128-bit shared-memory loads: the contraction dim runs
// along rows of "d-major" copies of the tiles (q, k, v, g transposed on
// their way into shared memory, dS transposed when it is formed), so one
// 16-byte load feeds four FMAs. Scores, dP and dS go through shared memory;
// dQ, dK and dV accumulate in registers. The q-major kernel's drh/drw: each
// (row, slot) cell is owned by one thread, which adds the tile's dS over
// that slot's keys, so the sums are deterministic and need no atomics.

namespace simt {

constexpr int NTS = 256;     // threads per block: 16 × 16, each a 4 × 4 block of a 64 × 64 tile
constexpr int LDD = BT + 4;  // row stride of d-major tiles and of 64 × 64 score tiles (floats, 16-byte rows)
constexpr int HLD = 64 + 1;  // row stride of the rel-row and histogram tiles

template <int HD>
struct Dim32 {
  static constexpr int LD = HD + 4;         // row stride of row-major (64, HD) tiles
  static constexpr int NE = (HD - 64) / 16;  // head-dim columns a thread owns past the first 64 (0 or 1)
  static constexpr int NJ = 4 + NE;          // columns 4·tx + j (j < 4), then 64 + tx + 16·e
};

// rows [r0, r0 + BT) of an (S, HD) tensor (zero past S) into a row-major
// tile and / or a d-major tile [d][row]
template <int HD, bool ROW, bool COL>
__device__ __forceinline__ void load32(float* row, float* colT, const float* src, int S, int r0, int tid) {
  constexpr int V = HD / 4;
  for (int i = tid; i < BT * V; i += NTS) {
    const int r = i / V, d = (i % V) * 4, gr = r0 + r;
    const float4 x = gr < S ? *reinterpret_cast<const float4*>(src + (size_t)gr * HD + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    if (ROW) *reinterpret_cast<float4*>(row + r * Dim32<HD>::LD + d) = x;
    if (COL) {
      colT[d * LDD + r] = x.x;
      colT[(d + 1) * LDD + r] = x.y;
      colT[(d + 2) * LDD + r] = x.z;
      colT[(d + 3) * LDD + r] = x.w;
    }
  }
}
__device__ __forceinline__ void load_rel32(float* sRh, float* sRw, const float* rh, const float* rw, int S, int hk,
                                           int wk, int r0, int tid) {
  for (int i = tid; i < BT * hk; i += NTS) {
    const int r = i / hk, j = i % hk;
    sRh[r * HLD + j] = r0 + r < S ? rh[(size_t)(r0 + r) * hk + j] : 0.0f;
  }
  for (int i = tid; i < BT * wk; i += NTS) {
    const int r = i / wk, j = i % wk;
    sRw[r * HLD + j] = r0 + r < S ? rw[(size_t)(r0 + r) * wk + j] : 0.0f;
  }
}

// C[r][c] (64 × 64, row-major) = Σ_d At[d][r] · Bt[d][c], At and Bt
// d-major (HD, 64) tiles: thread (ty, tx) owns rows 4ty.., columns 4tx..
template <int HD>
__device__ __forceinline__ void gemm_abt32(const float* At, const float* Bt, float* C, int tid) {
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(At + d * LDD + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(Bt + d * LDD + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(C + (4 * ty + i) * LDD + 4 * tx) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// head-dim column of a thread's j-th accumulator
template <int HD>
__device__ __forceinline__ int col32(int j, int tx) {
  return j < 4 ? 4 * tx + j : 64 + tx + 16 * (j - 4);
}

// acc[i][j] (rows 4ty + i, head-dim columns col32(j)) += Σ_c At[c][r] · B[c][d],
// At a 64 × 64 tile stored [c][r], B a row-major (64, HD) tile
template <int HD>
__device__ __forceinline__ void gemm_pb32(float (&acc)[4][Dim32<HD>::NJ], const float* At, const float* B, int tid) {
  constexpr int LD = Dim32<HD>::LD, NE = Dim32<HD>::NE;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll 4
  for (int c = 0; c < BT; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(At + c * LDD + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(B + c * LD + 4 * tx);
    float bv[4 + NE] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < NE; ++e) bv[4 + e] = B[c * LD + 64 + tx + 16 * e];
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 + NE; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int HD>
constexpr size_t smem_q32() {
  return (size_t)(4 * HD * LDD + BT * Dim32<HD>::LD + 2 * BT * LDD + 4 * BT * HLD) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(NTS) bwd_q_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ rh, const float* __restrict__ rw, const float* __restrict__ g,
    float* __restrict__ dq, float* __restrict__ drh, float* __restrict__ drw, float* __restrict__ stats,
    int BH, int S, int hk, int wk, float scale) {
  constexpr int NJ = Dim32<HD>::NJ;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQt = reinterpret_cast<float*>(smem);  // d-major q, g, k, v tiles
  float* sGt = sQt + HD * LDD;
  float* sKt = sGt + HD * LDD;
  float* sVt = sKt + HD * LDD;
  float* sK = sVt + HD * LDD;       // row-major k, for dQ
  float* sS = sK + BT * Dim32<HD>::LD;  // scores [q][key]
  float* sP = sS + BT * LDD;        // dP [q][key], then dS transposed [key][q]
  float* sRh = sP + BT * LDD;
  float* sRw = sRh + BT * HLD;
  float* sHh = sRw + BT * HLD;  // drh histograms, one row per query
  float* sHw = sHh + BT * HLD;

  const int q0 = blockIdx.x * BT, bh = blockIdx.y, tid = threadIdx.x;
  const size_t off = (size_t)bh * S * HD;
  const float *qp = q + off, *kp = k + off, *vp = v + off, *gp = g + off;
  load32<HD, false, true>(nullptr, sQt, qp, S, q0, tid);
  load32<HD, false, true>(nullptr, sGt, gp, S, q0, tid);
  load_rel32(sRh, sRw, rh + (size_t)bh * S * hk, rw + (size_t)bh * S * wk, S, hk, wk, q0, tid);
  for (int i = tid; i < 2 * BT * HLD; i += NTS) sHh[i] = 0.0f;  // sHh and sHw

  // the row step's thread layout: four lanes per query row, keys part + 4j
  const int r = tid / 4, part = tid % 4;
  float m = -INFINITY, l = 0.0f, dd = 0.0f, linv = 0.0f;
  float dqa[4][NJ] = {};

  const int nk = (S + BT - 1) / BT;
  for (int it = 0; it < 2 * nk; ++it) {
    const int kt = it % nk, pass = it / nk, k0 = kt * BT;
    __syncthreads();  // the previous step is done with the k / v tiles, sS and sP
    load32<HD, true, true>(sK, sKt, kp, S, k0, tid);
    load32<HD, false, true>(nullptr, sVt, vp, S, k0, tid);
    __syncthreads();
    gemm_abt32<HD>(sQt, sKt, sS, tid);  // q·kᵀ
    gemm_abt32<HD>(sGt, sVt, sP, tid);  // dP = g·vᵀ
    __syncthreads();

    float s[16], dp[16];
    float mloc = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = part + 4 * j, key = k0 + c;
      dp[j] = sP[r * LDD + c];
      if (key < S) {
        const int kh = key / wk, kw = key - kh * wk;
        s[j] = sS[r * LDD + c] * scale + (sRh[r * HLD + kh] + sRw[r * HLD + kw]);
      } else {
        s[j] = -INFINITY;
      }
      mloc = fmaxf(mloc, s[j]);
    }
    if (pass == 0) {
      // online row max, row sum of u = exp(s - max) and Σ u·dP
      const float mnew = fmaxf(m, quad_max(mloc));
      const float alpha = expf(m - mnew);  // 0 on the first step (m = -inf)
      float ls = 0.0f, ds = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float u = expf(s[j] - mnew);
        ls += u;
        ds += u * dp[j];
      }
      l = l * alpha + quad_sum(ls);
      dd = dd * alpha + quad_sum(ds);
      m = mnew;
      if (it == nk - 1) {
        dd /= l;  // D = rowsum(dP∘p)
        linv = 1.0f / l;
      }
      continue;
    }

    // pass 1: dS = p∘(dP - D), 0 for keys past S, stored transposed over dP
    __syncthreads();  // every thread holds its dP values
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = part + 4 * j;
      sP[c * LDD + r] = k0 + c < S ? expf(s[j] - m) * linv * (dp[j] - dd) : 0.0f;
    }
    __syncthreads();
    gemm_pb32<HD>(dqa, sP, sK, tid);  // dQ += dS·k
    // drh/drw: this thread's cells are row r's slots part, part + 4, ...
    const int kend = min(k0 + BT, S);
    const int kh0 = k0 / wk, kh1 = (kend - 1) / wk;
    for (int kh = kh0 + part; kh <= kh1; kh += 4) {
      float acc = 0.0f;
      for (int key = max(kh * wk, k0); key < min((kh + 1) * wk, kend); ++key) acc += sP[(key - k0) * LDD + r];
      sHh[r * HLD + kh] += acc;
    }
    for (int kw = part; kw < wk; kw += 4) {
      float acc = 0.0f;
      for (int key = k0 + (kw - k0 % wk + wk) % wk; key < kend; key += wk) acc += sP[(key - k0) * LDD + r];
      sHw[r * HLD + kw] += acc;
    }
  }
  __syncthreads();  // the histograms are written out by other threads than their owners

  if (part == 0 && q0 + r < S) {
    const size_t o = (size_t)bh * S + q0 + r;
    stats[o] = m;
    stats[(size_t)BH * S + o] = l;
    stats[(size_t)2 * BH * S + o] = dd;
  }
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[off + (size_t)row * HD + col32<HD>(j, tx)] = dqa[i][j] * scale;
  }
  for (int i = tid; i < BT * hk; i += NTS) {
    const int rr = i / hk, j = i % hk, row = q0 + rr;
    if (row < S) drh[((size_t)bh * S + row) * hk + j] = sHh[rr * HLD + j];
  }
  for (int i = tid; i < BT * wk; i += NTS) {
    const int rr = i / wk, j = i % wk, row = q0 + rr;
    if (row < S) drw[((size_t)bh * S + row) * wk + j] = sHw[rr * HLD + j];
  }
}

template <int HD>
constexpr size_t smem_k32() {
  return (size_t)(4 * HD * LDD + 2 * BT * Dim32<HD>::LD + 2 * BT * LDD + 2 * BT * HLD + 3 * BT) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(NTS) bwd_k_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ rh, const float* __restrict__ rw, const float* __restrict__ g,
    float* __restrict__ dk, float* __restrict__ dv, const float* __restrict__ stats,
    int BH, int S, int hk, int wk, float scale) {
  constexpr int NJ = Dim32<HD>::NJ;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sKt = reinterpret_cast<float*>(smem);  // d-major k, v, q, g tiles
  float* sVt = sKt + HD * LDD;
  float* sQt = sVt + HD * LDD;
  float* sGt = sQt + HD * LDD;
  float* sQ = sGt + HD * LDD;  // row-major q and g, for dK and dV
  float* sG = sQ + BT * Dim32<HD>::LD;
  float* sS = sG + BT * Dim32<HD>::LD;  // s, then p: [q][key]
  float* sP = sS + BT * LDD;            // dP, then dS: [q][key]
  float* sRh = sP + BT * LDD;
  float* sRw = sRh + BT * HLD;
  float* sM = sRw + BT * HLD;
  float* sLinv = sM + BT;  // 1 / row sum
  float* sD = sLinv + BT;

  const int k0 = blockIdx.x * BT, bh = blockIdx.y, tid = threadIdx.x;
  const size_t off = (size_t)bh * S * HD;
  const float *qp = q + off, *kp = k + off, *vp = v + off, *gp = g + off;
  const float* rhp = rh + (size_t)bh * S * hk;
  const float* rwp = rw + (size_t)bh * S * wk;
  load32<HD, false, true>(nullptr, sKt, kp, S, k0, tid);
  load32<HD, false, true>(nullptr, sVt, vp, S, k0, tid);
  float dka[4][NJ] = {}, dva[4][NJ] = {};

  const int nq = (S + BT - 1) / BT;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // the previous step is done with the q / g tiles, sS, sP, the rel rows and statistics
    load32<HD, true, true>(sQ, sQt, qp, S, q0, tid);
    load32<HD, true, true>(sG, sGt, gp, S, q0, tid);
    load_rel32(sRh, sRw, rhp, rwp, S, hk, wk, q0, tid);
    for (int i = tid; i < BT; i += NTS) {
      const bool valid = q0 + i < S;
      const size_t o = (size_t)bh * S + q0 + i;
      sM[i] = valid ? stats[o] : 0.0f;
      sLinv[i] = valid ? 1.0f / stats[(size_t)BH * S + o] : 1.0f;
      sD[i] = valid ? stats[(size_t)2 * BH * S + o] : 0.0f;
    }
    __syncthreads();
    gemm_abt32<HD>(sQt, sKt, sS, tid);  // s = q·kᵀ
    gemm_abt32<HD>(sGt, sVt, sP, tid);  // dP = g·vᵀ
    __syncthreads();
    // consecutive threads take consecutive keys of one query
    for (int i = tid; i < BT * BT; i += NTS) {
      const int qr = i / BT, kc = i % BT, key = k0 + kc;
      float p = 0.0f;
      if (key < S && q0 + qr < S) {
        const int kh = key / wk, kw = key - kh * wk;
        const float s = sS[qr * LDD + kc] * scale + (sRh[qr * HLD + kh] + sRw[qr * HLD + kw]);
        p = expf(s - sM[qr]) * sLinv[qr];
      }
      sS[qr * LDD + kc] = p;
      sP[qr * LDD + kc] = p * (sP[qr * LDD + kc] - sD[qr]);  // dS
    }
    __syncthreads();
    gemm_pb32<HD>(dva, sS, sG, tid);  // dV += pᵀ·g
    gemm_pb32<HD>(dka, sP, sQ, tid);  // dK += dSᵀ·q
  }

  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + (size_t)key * HD + col32<HD>(j, tx)] = dka[i][j] * scale;
      dv[off + (size_t)key * HD + col32<HD>(j, tx)] = dva[i][j];
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* rh, const void* rw, const void* g, void* dq,
           void* dk, void* dv, void* drh, void* drw, void* stats, int BH, int S, int hk, int wk, float scale,
           void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(bwd_q_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q32<HD>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_k_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_k32<HD>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BT - 1) / BT, BH);
  cudaStream_t st = (cudaStream_t)stream;
  bwd_q_kernel<HD><<<grid, NTS, smem_q32<HD>(), st>>>((const float*)q, (const float*)k, (const float*)v,
                                                      (const float*)rh, (const float*)rw, (const float*)g,
                                                      (float*)dq, (float*)drh, (float*)drw, (float*)stats, BH, S,
                                                      hk, wk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_k_kernel<HD><<<grid, NTS, smem_k32<HD>(), st>>>((const float*)q, (const float*)k, (const float*)v,
                                                      (const float*)rh, (const float*)rw, (const float*)g,
                                                      (float*)dk, (float*)dv, (const float*)stats, BH, S, hk, wk,
                                                      scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

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
  return dispatch(simt::launch<64>, simt::launch<80>, q, k, v, rh, rw, g, dq, dk, dv, drh, drw, stats, BH, S, D, hk,
                  wk, scale, stream);
}
