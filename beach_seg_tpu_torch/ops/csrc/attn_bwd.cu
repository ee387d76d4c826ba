// Attention backward with the decomposed rel-pos terms, for Hopper (sm_90a),
// bf16 or fp32 (split-TF32 products, at the end of this file), both on the
// tensor cores, head_dim 16 (the debug backbone), 64 (ViT-L) or 80 (ViT-H)
// as template instances.
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
// device memory) and deterministic (no atomics, every sum in a fixed order):
//   1. q-major, one block per (64-row q tile, batch·head): a first pass over
//      the keys gathers the row max, row sum and D with an online rescale; a
//      second pass recomputes p and dP, forms dS, accumulates dQ = dS·k,
//      and drh/drw as dS times the 0/1 key-to-slot matrix E. It writes dQ,
//      drh, drw and the row statistics.
//   2. k-major, one block per (64-key tile, batch·head): recomputes pᵀ and
//      dPᵀ from those statistics for every q tile and accumulates dV = pᵀg
//      and dK = dSᵀq.
// That is nine products where five would do (the statistics pass and the
// recompute of S and dP in both kernels), traded for no atomics and no
// S×S storage.
// bf16 (namespace wgb): one warpgroup a block, wgmma on 64-row tiles
// (wgmma.cuh), every operand tile in shared memory in one swizzled layout
// that serves as a K-major and an MN-major operand. In the k-major kernel
// Sᵀ and dPᵀ take K and V as the shared-memory A operands; dV and dK take
// pᵀ and dSᵀ from the accumulators as register A operands. In the q-major
// kernel S, dP, then dQ with dS from registers. The rel terms of a score are
// more k steps of the score product (with a power-of-two scale, as at head
// dims 16 and 64, the fixed Q or K tile is prescaled, exactly, so they join
// the product's chain; else they wait for S·scale): each row's slot terms (rel_h ‖ rel_w,
// packed by pack_slots) times E's rows (filled by fill_slots), over the
// slot chunks a key tile reaches, so no score takes a division or a lookup;
// drh ‖ drw is dS (bf16 high and low parts: 16 significant bits) times E on
// the tensor cores, accumulated in registers. The accumulators are the only
// per-thread state. The Q/G tiles, slot rows and statistics (k-major) and
// the K/V/E tiles (q-major) arrive through a 2-stage cp.async ring, one
// barrier a step, so two blocks fit an SM at head dims 64 and 80.
// Head dims 16, 64 and 80 are template instances (the wrapper pads 8 to 16).
// Rounding (bf16): q, k, v and g are bf16 already, so S and dP are exact
// products summed in fp32; p (for dV) and dS (for dQ and dK) are rounded to
// bf16 as operands, where the TPU kernel keeps them in fp32. Exponentials
// use the hardware exp2 (__expf, relative error ~1e-5 for the arguments
// ≤ 0 a stable softmax takes), below the bf16 rounding of every output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "tf32x3.cuh"
#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 64;        // rows per block tile (queries or keys)
constexpr int NW = 4;         // warps per block, 16 rows each
constexpr int NT = NW * 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// ============================ bf16: wgmma ============================

namespace wgb {

using namespace wg;

template <int HD>
struct Cfg {
  static constexpr int NP = HD / 16;      // 16-column panels of a 64-row q / k / v / g tile
  static constexpr int TB = BT * HD * 2;  // its bytes
  static constexpr int NS = 2;            // ring stages (two blocks an SM at ViT shapes)
  // alignment slack, two fixed tiles and the fixed slot or E rows, NS ring stages
  static size_t smem_q(int kx) { return 1024 + 2 * TB + (size_t)BT * kx * 2 + NS * stage_q(kx); }
  static size_t smem_k(int kx) { return 1024 + 2 * TB + (size_t)BT * kx * 2 + NS * stage_k(kx); }
  // q-major stage: K, V and E tiles; k-major stage: Q, G, slot rows and the three statistics
  static __host__ __device__ uint32_t stage_q(int kx) { return 2 * TB + BT * kx * 2; }
  static __host__ __device__ uint32_t stage_k(int kx) { return 2 * TB + BT * kx * 2 + 3 * BT * 4; }
};

// For a power-of-two scale (head dims 16 and 64 at scale head_dim^-1/2),
// multiplies the `bytes` of bf16 tile `tile` by it in place, which is exact,
// so S·scale needs no pass of its own; returns whether it did. Waits for
// every cp.async of the block so far.
__device__ __forceinline__ bool prescale_tile(uint32_t tile, int bytes, float scale, int tid) {
  int ex;
  if (frexpf(scale, &ex) != 0.5f) return false;
  cp_async_wait<0>();
  __syncthreads();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* p0 = smem_raw + (tile - smem_addr(smem_raw));
  for (int i = tid; i < bytes / 16; i += NT) {
    __align__(16) bf16 vals[8];
    *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(p0 + 16 * i);
#pragma unroll
    for (int j = 0; j < 8; ++j) vals[j] = __float2bfloat16_rn(__bfloat162float(vals[j]) * scale);
    *reinterpret_cast<uint4*>(p0 + 16 * i) = *reinterpret_cast<const uint4*>(vals);
  }
  return true;
}

// rel_h ‖ rel_w of every row into the (BH·S, KX) slot layout of wgmma.cuh
__global__ void pack_slots(const bf16* __restrict__ rh, const bf16* __restrict__ rw, bf16* __restrict__ out,
                           size_t n, int hk, int wk, int hkp, int kx) {
  const int nch = kx / 8;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n * nch; i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / nch;
    const int c0 = 8 * (int)(i - r * nch);
    const bool in_h = c0 < hkp;
    const bf16* src = in_h ? rh + r * hk : rw + r * wk;
    const int m = in_h ? hk : wk, j0 = in_h ? c0 : c0 - hkp;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) vals[j] = j0 + j < m ? src[j0 + j] : zero;
    *reinterpret_cast<uint4*>(out + r * kx + c0) = *reinterpret_cast<const uint4*>(vals);
  }
}

// ---------------------------- 1. q-major: dQ, drh, drw, row statistics ----------------------------

template <int HD>
__global__ void __launch_bounds__(NT, 2) bwd_q_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, const bf16* __restrict__ g,
    const bf16* __restrict__ slots, const bf16* __restrict__ e, bf16* __restrict__ dq, bf16* __restrict__ drh,
    bf16* __restrict__ drw, float* __restrict__ stats, int BH, int S, int hk, int wk, int kx, float scale) {
  constexpr int NP = Cfg<HD>::NP, TB = Cfg<HD>::TB, NS = Cfg<HD>::NS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sG = base + TB, sR = base + 2 * TB, ring = sR + BT * kx * 2;
  const uint32_t stage_bytes = Cfg<HD>::stage_q(kx);

  const int q0 = blockIdx.x * BT, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane >> 2, t = lane & 3;
  const int hkp = round16(hk), nx = kx / 16;
  const size_t off = (size_t)bh * S * HD;
  const bf16 *qp = q + off, *kp = k + off, *vp = v + off, *gp = g + off;
  const int nk = (S + BT - 1) / BT;

  // K, V and E tiles of step it (key tile it % nk) into its ring stage
  auto load_stage = [&](int it) {
    const uint32_t sb = ring + (it % NS) * stage_bytes;
    const int k0 = (it % nk) * BT;
    load_tile(sb, kp, HD, HD, S, k0, BT, tid);
    load_tile(sb + TB, vp, HD, HD, S, k0, BT, tid);
    load_tile(sb + 2 * TB, e, kx, kx, S, k0, BT, tid);
  };
  load_tile(sQ, qp, HD, HD, S, q0, BT, tid);
  load_tile(sG, gp, HD, HD, S, q0, BT, tid);
  load_tile(sR, slots + (size_t)bh * S * kx, kx, kx, S, q0, BT, tid);
  for (int st = 0; st < NS - 1; ++st) {
    load_stage(st);
    cp_async_commit();
  }
  // a power-of-two scale is exact on bf16: then Q·scale replaces the Q tile
  const bool pow2 = prescale_tile(sQ, TB, scale, tid);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, dd[2] = {0.0f, 0.0f}, linv[2] = {0.0f, 0.0f};
  float dqa[HD / 2], hist[8][8];  // dQ; drh ‖ drw, 16 slots a chunk
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) hist[c][i] = 0.0f;
  }

  // the keys twice: pass 0 gathers the row statistics, pass 1 forms dS; the
  // K/V/E tiles stream through the ring across both passes
  for (int it = 0; it < 2 * nk; ++it) {
    const int pass = it / nk, k0 = (it % nk) * BT;
    cp_async_wait<NS - 2>();  // step it's tiles have landed
    fence_async_smem();
    __syncthreads();          // for every thread's copies; every warp is done with the stage refilled next
    if (it + NS - 1 < 2 * nk) load_stage(it + NS - 1);
    cp_async_commit();
    const uint32_t sb = ring + (it % NS) * stage_bytes;
    const int c_lo = (k0 / wk) / 16, c_hi = (min(k0 + BT - 1, S - 1) / wk) / 16;

    // S = Q·Kᵀ·scale + the rel terms (slot rows · E tileᵀ) and dP = G·Vᵀ;
    // with Q prescaled the rel terms join S's chain, else they wait for S·scale
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    auto rel_terms = [&]() {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (touched(c, nx, hkp, c_lo, c_hi)) mma_ss<64>(s, kdesc(sR + c * BT * 32), kdesc(sb + 2 * TB + c * BT * 32), 1);
      }
    };
    fence_regs(s);
    fence_regs(dp);
    arrive();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) mma_ss<64>(s, kdesc(sQ + kk * BT * 32), kdesc(sb + kk * BT * 32), kk > 0);
    if (pow2) rel_terms();
    commit();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) mma_ss<64>(dp, kdesc(sG + kk * BT * 32), kdesc(sb + TB + kk * BT * 32), kk > 0);
    commit();
    if (!pow2) {
      wait<1>();
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale;
      fence_regs(s);
      arrive();
      rel_terms();
      commit();
    }
    wait<0>();
    fence_regs(s);
    fence_regs(dp);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= S) s[i] = -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }

    if (pass == 0) {
      // online row max, row sum of u = exp(s - max) and Σ u·dP
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mnew = fmaxf(m[r], quad_max(mx[r]));
        const float alpha = __expf(m[r] - mnew);  // 0 on the first step (m = -inf)
        float ls = 0.0f, ds = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (((i >> 1) & 1) == r) {
            const float u = __expf(s[i] - mnew);
            ls += u;
            ds += u * dp[i];
          }
        }
        l[r] = l[r] * alpha + ls;
        dd[r] = dd[r] * alpha + ds;
        m[r] = mnew;
      }
      if (it == nk - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = quad_sum(l[r]);
          dd[r] = quad_sum(dd[r]) / l[r];  // D = rowsum(dP∘p)
          linv[r] = 1.0f / l[r];
        }
      }
      continue;
    }

    // pass 1: dS = p∘(dP - D), in s; then dQ += dS·K and, on the tensor
    // cores, drh ‖ drw += (dS_hi + dS_lo)·E over the touched slot chunks
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = __expf(s[i] - m[r]) * linv[r] * (dp[i] - dd[r]);
    }
    uint32_t da[4][4], dl[4][4];
    to_a(da, s);
    to_a_residue(dl, s);
    fence_regs(dqa);
#pragma unroll
    for (int c = 0; c < 8; ++c) fence_regs(hist[c]);
    arrive();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_rs<HD>(dqa, da[ks], mndesc(sb + ks * 16 * 32, BT), 1);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (touched(c, nx, hkp, c_lo, c_hi)) {  // drh, drw
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t de = mndesc(sb + 2 * TB + c * BT * 32 + ks * 16 * 32, BT);
          mma_rs<16>(hist[c], da[ks], de, 1);
          mma_rs<16>(hist[c], dl[ks], de, 1);
        }
      }
    }
    commit();
    wait<0>();
    fence_regs(dqa);
#pragma unroll
    for (int c = 0; c < 8; ++c) fence_regs(hist[c]);
  }

  // outputs of this thread's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gr + 8 * r;
    if (row >= S) continue;
    if (t == 0) {
      const size_t o = (size_t)bh * S + row;
      stats[o] = m[r];
      stats[(size_t)BH * S + o] = linv[r];
      stats[(size_t)2 * BH * S + o] = dd[r];
    }
    bf16* dst = dq + off + (size_t)row * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack(dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c >= nx) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (((i >> 1) & 1) != r) continue;
        const int slot = 16 * c + 8 * (i / 4) + 2 * t + (i & 1);
        const bf16 x = __float2bfloat16_rn(hist[c][i]);
        if (slot < hk) {
          drh[((size_t)bh * S + row) * hk + slot] = x;
        } else if (slot >= hkp && slot - hkp < wk) {
          drw[((size_t)bh * S + row) * wk + slot - hkp] = x;
        }
      }
    }
  }
}

// ---------------------------- 2. k-major: dK, dV ----------------------------

template <int HD>
__global__ void __launch_bounds__(NT, 2) bwd_k_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, const bf16* __restrict__ g,
    const bf16* __restrict__ slots, const bf16* __restrict__ e, float* __restrict__ dk, float* __restrict__ dv,
    const float* __restrict__ stats, int BH, int S, int hk, int wk, int kx, float scale) {
  constexpr int NP = Cfg<HD>::NP, TB = Cfg<HD>::TB, NS = Cfg<HD>::NS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + TB, sE = base + 2 * TB, ring = sE + BT * kx * 2;
  const uint32_t stage_bytes = Cfg<HD>::stage_k(kx);

  const int k0 = blockIdx.x * BT, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane >> 2, t = lane & 3;
  const int hkp = round16(hk), nx = kx / 16;
  const size_t off = (size_t)bh * S * HD, plane = (size_t)BH * S;
  const bf16 *qp = q + off, *kp = k + off, *vp = v + off, *gp = g + off;
  const bf16* sp = slots + (size_t)bh * S * kx;
  const int nq = (S + BT - 1) / BT;

  // Q, G tiles, slot rows and statistics (row max, 1 / row sum, D) of query
  // tile qt into its ring stage, zero past S
  auto load_stage = [&](int qt) {
    const uint32_t sb = ring + (qt % NS) * stage_bytes;
    const int q0 = qt * BT;
    load_tile(sb, qp, HD, HD, S, q0, BT, tid);
    load_tile(sb + TB, gp, HD, HD, S, q0, BT, tid);
    load_tile(sb + 2 * TB, sp, kx, kx, S, q0, BT, tid);
    for (int i = tid; i < 3 * BT; i += NT) {
      const int w = i / BT, r = i - w * BT;
      const bool valid = q0 + r < S;
      cp_async4(sb + 2 * TB + BT * kx * 2 + 4 * i, stats + w * plane + (size_t)bh * S + (valid ? q0 + r : 0), valid);
    }
  };
  load_tile(sK, kp, HD, HD, S, k0, BT, tid);
  load_tile(sV, vp, HD, HD, S, k0, BT, tid);
  load_tile(sE, e, kx, kx, S, k0, BT, tid);
  for (int st = 0; st < NS - 1; ++st) {
    if (st < nq) load_stage(st);
    cp_async_commit();
  }
  const int c_lo = (k0 / wk) / 16, c_hi = (min(k0 + BT - 1, S - 1) / wk) / 16;
  // a power-of-two scale is exact on bf16: then K·scale replaces the K tile
  const bool pow2 = prescale_tile(sK, TB, scale, tid);

  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.0f;

  for (int qt = 0; qt < nq; ++qt) {
    cp_async_wait<NS - 2>();  // query tile qt's stage has landed
    fence_async_smem();
    __syncthreads();          // for every thread's copies; every warp is done with the stage refilled next
    if (qt + NS - 1 < nq) load_stage(qt + NS - 1);
    cp_async_commit();
    const uint32_t sb = ring + (qt % NS) * stage_bytes;
    const float* sStat = reinterpret_cast<const float*>(gbase + (sb + 2 * TB + BT * kx * 2 - base));

    // Sᵀ = K·Qᵀ·scale + the rel terms (E rows of the keys · slot rowsᵀ) and
    // dPᵀ = V·Gᵀ (this block's 64 keys × 64 queries); with K prescaled the
    // rel terms join Sᵀ's chain, else they wait for Sᵀ·scale
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.0f;
    auto rel_terms = [&]() {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (touched(c, nx, hkp, c_lo, c_hi)) mma_ss<64>(st, kdesc(sE + c * BT * 32), kdesc(sb + 2 * TB + c * BT * 32), 1);
      }
    };
    fence_regs(st);
    fence_regs(dpt);
    arrive();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) mma_ss<64>(st, kdesc(sK + kk * BT * 32), kdesc(sb + kk * BT * 32), kk > 0);
    if (pow2) rel_terms();
    commit();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) mma_ss<64>(dpt, kdesc(sV + kk * BT * 32), kdesc(sb + TB + kk * BT * 32), kk > 0);
    commit();
    if (!pow2) {
      wait<1>();
      fence_regs(st);
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] *= scale;
      fence_regs(st);
      arrive();
      rel_terms();
      commit();
    }
    wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // pᵀ and dSᵀ; queries past S have 1 / row sum 0, so p = 0
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = 8 * (i / 4) + 2 * t + (i & 1);
      const float p = __expf(st[i] - sStat[qc]) * sStat[BT + qc];
      st[i] = p;
      dpt[i] = p * (dpt[i] - sStat[2 * BT + qc]);
    }
    uint32_t pa[4][4], da[4][4];
    to_a(pa, st);
    to_a(da, dpt);
    // dV += pᵀ·G, dK += dSᵀ·Q (G and Q the MN-major B operands)
    fence_regs(dva);
    fence_regs(dka);
    arrive();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_rs<HD>(dva, pa[ks], mndesc(sb + TB + ks * 16 * 32, BT), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_rs<HD>(dka, da[ks], mndesc(sb + ks * 16 * 32, BT), 1);
    commit();
    wait<0>();
    fence_regs(dva);
    fence_regs(dka);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + gr + 8 * r;
    if (key >= S) continue;
    float* dkr = dk + off + (size_t)key * HD + 2 * t;
    float* dvr = dv + off + (size_t)key * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<float2*>(dkr + 8 * j) = make_float2(dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dvr + 8 * j) = make_float2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* rh, const void* rw, const void* g, void* e,
           void* slots, void* dq, void* dk, void* dv, void* drh, void* drw, void* stats, int BH, int S, int hk, int wk,
           float scale, void* stream) {
  const int hkp = round16(hk), kx = hkp + round16(wk), s_pad = (S + BT - 1) / BT * BT;
  cudaStream_t st = (cudaStream_t)stream;
  fill_slots<<<(s_pad * kx / 8 + 255) / 256, 256, 0, st>>>((bf16*)e, S, s_pad, wk, hkp, kx);
  const size_t n = (size_t)BH * S;
  const size_t nblk = (n * kx / 8 + 255) / 256;
  pack_slots<<<(unsigned)(nblk < 4096 ? nblk : 4096), 256, 0, st>>>(
      (const bf16*)rh, (const bf16*)rw, (bf16*)slots, n, hk, wk, hkp, kx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smq = Cfg<HD>::smem_q(kx), smk = Cfg<HD>::smem_k(kx);
  err = cudaFuncSetAttribute(bwd_q_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_k_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smk);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BT - 1) / BT, BH);
  bwd_q_kernel<HD><<<grid, NT, smq, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
                                          (const bf16*)slots, (const bf16*)e, (bf16*)dq, (bf16*)drh, (bf16*)drw,
                                          (float*)stats, BH, S, hk, wk, kx, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_k_kernel<HD><<<grid, NT, smk, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
                                          (const bf16*)slots, (const bf16*)e, (float*)dk, (float*)dv,
                                          (const float*)stats, BH, S, hk, wk, kx, scale);
  return (int)cudaGetLastError();
}

}  // namespace wgb

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

}  // namespace

// q, k, v, g (BH, S, D) with D 16, 64 or 80, rel_h (BH, S, hk), rel_w (BH,
// S, wk) bf16, S = hk·wk, hk, wk <= 64 → dq, drh, drw bf16, dk, dv fp32;
// scratch: stats (3, BH, S) fp32, e (S rounded up to 64, KX) and slots
// (BH, S, KX) bf16, KX = hk and wk each rounded up to 16, summed
extern "C" int attn_bwd_bf16(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                             const void* g, void* e, void* slots, void* dq, void* dk, void* dv, void* drh, void* drw,
                             void* stats, int BH, int S, int D, int hk, int wk, float scale, void* stream) {
  if (hk * wk != S || hk > 64 || wk > 64) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return wgb::launch<16>(q, k, v, rh, rw, g, e, slots, dq, dk, dv, drh, drw, stats, BH, S, hk, wk, scale, stream);
    case 64:
      return wgb::launch<64>(q, k, v, rh, rw, g, e, slots, dq, dk, dv, drh, drw, stats, BH, S, hk, wk, scale, stream);
    case 80:
      return wgb::launch<80>(q, k, v, rh, rw, g, e, slots, dq, dk, dv, drh, drw, stats, BH, S, hk, wk, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the same contract with every input and output in fp32 (e and slots unused)
extern "C" int attn_bwd_f32(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                            const void* g, void*, void*, void* dq, void* dk, void* dv, void* drh, void* drw,
                            void* stats, int BH, int S, int D, int hk, int wk, float scale, void* stream) {
  if (hk * wk != S || hk > 64 || wk > 64) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return f32::launch<16>(q, k, v, rh, rw, g, dq, dk, dv, drh, drw, stats, BH, S, hk, wk, scale, stream);
    case 64:
      return f32::launch<64>(q, k, v, rh, rw, g, dq, dk, dv, drh, drw, stats, BH, S, hk, wk, scale, stream);
    case 80:
      return f32::launch<80>(q, k, v, rh, rw, g, dq, dk, dv, drh, drw, stats, BH, S, hk, wk, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
