// Attention with the qkv bias and the decomposed rel-pos terms formed
// in-kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_qkv_rel` (beach_seg_tpu/ops/pallas_attn.py:389,
// wrapper `_pallas_attention_qkv_rel`). Per (batch, head):
//
//   q, k, v   = round(qkv[:, :, i, head] + bias[i, head])          (i = 0, 1, 2)
//   rel_h[r,j] = round(Σ_c q[r,c]·Rh[r / gw, j, c])   rel_w[r,j] = round(Σ_c q[r,c]·Rw[r % gw, j, c])
//   s[r,k]    = round(q·scale)[r]·k[k] + rel_h[r, k / gw] + rel_w[r, k % gw]   (fp32)
//   p         = exp(s - rowmax) | exp(min(s, 80)) | exp(s)         (stable | clamp | fast)
//   out[r]    = round((Σ_k round(p[r,k])·v[k]) / (Σ_k p[r,k] (+1e-30 unless stable)))
//
// where round() is to the compute type (bf16 or fp32), the rounding points
// of the TPU kernel. Output is the merged (B, S, C) layout at the head's
// channel offset; q, k and v are read from the (B, S, 3, C) tensor by stride.
//
// What bounds it: at ViT-L (S=1568, hd=64, 16 heads) the two S×S×64 products
// are 1.0e10 FLOP per image against ~13 MB of qkv+out, so it is
// compute-bound on the tensor cores. Both kernels are flash-style: one block
// per (q tile, head, batch) streams 64-key tiles of K and V with an online
// softmax, so scores never reach device memory.
//   bf16: 7 warps × 16 query rows (112 rows: S=1568 is 14 tiles). Scores,
//   probabilities and the output accumulator stay in registers between
//   mma.sync m16n8k16 products (the accumulator layout of S is the operand
//   layout of P); K/V tiles are double-buffered in shared memory with
//   cp.async, and the bias is added once per tile in shared memory.
//   fp32: the simple form, 64 query rows, products on the FP32 units with
//   scores and accumulator in shared memory.
// The bf16 kernel forms the rel terms on the tensor cores too (query rows
// that share a table row gathered into one mma operand); the fp32 one with
// warp dot products. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 64;      // head dim (the only one these kernels take)
constexpr int BK = 64;      // keys per step
constexpr int SLOTS = 64;   // padded rel-table key slots

enum Softmax { STABLE = 0, CLAMP = 1, FAST = 2 };

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// FAST_EXP: the hardware exp2 (__expf, relative error ~1e-5 at |s| ≤ 80),
// for the bf16 kernel whose p is rounded to bf16 (4e-3) anyway
template <bool FAST_EXP>
__device__ __forceinline__ float softmax_p(float s, float m, int softmax) {
  const float x = softmax == STABLE ? s - m : (softmax == CLAMP ? fminf(s, 80.0f) : s);
  return FAST_EXP ? __expf(x) : expf(x);
}

// ============================ bf16: mma.sync ============================

namespace mma16 {

constexpr int NW = 7;          // warps per block
constexpr int NT = NW * 32;
constexpr int BQ = 16 * NW;    // query rows per block
constexpr int LDT = HD + 8;    // smem row stride (elements): 144 B, conflict-free ldmatrix
constexpr int RLD = SLOTS + 2; // rel-term row stride (elements)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {  // bf16x2 a + b, rounded
  __nv_bfloat162 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  x = __hadd2(x, y);
  memcpy(&a, &x, 4);
  return a;
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
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

constexpr size_t smem_bytes() {
  return (size_t)((BQ + 1) * LDT + 4 * BK * LDT + 2 * BQ * RLD) * sizeof(bf16);  // q tile + a zero row
}

// K and V rows [k0, k0 + BK) of this (batch, head) into one stage
__device__ __forceinline__ void load_kv(bf16* sK, bf16* sV, const bf16* base, size_t rs, int C, int S,
                                        int k0, int tid) {
  for (int i = tid; i < 2 * BK * 8; i += NT) {
    const int which = i / (BK * 8), r = (i / 8) % BK, c8 = (i % 8) * 8, k = k0 + r;
    const bool valid = k < S;
    const bf16* src = valid ? base + k * rs + (which + 1) * C + c8 : base;
    cp_async16((which ? sV : sK) + r * LDT + c8, src, valid);
  }
}

__global__ void __launch_bounds__(NT, 2) attn_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias, const bf16* __restrict__ rh_tab,
    const bf16* __restrict__ rw_tab, bf16* __restrict__ out, int S, int C, int gh, int gw, float scale,
    int softmax) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + (BQ + 1) * LDT;  // 2 stages
  bf16* sV = sK + 2 * BK * LDT;  // 2 stages
  bf16* sRh = sV + 2 * BK * LDT;
  bf16* sRw = sRh + BQ * RLD;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tig = lane & 3;
  const size_t rs = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * S * rs + (size_t)h * HD;
  const bf16* bq = bias + h * HD;
  const bf16* bk = bias + C + h * HD;
  const bf16* bv = bias + 2 * C + h * HD;

  const int nk = (S + BK - 1) / BK;
  load_kv(sK, sV, base, rs, C, S, 0, tid);
  cp_async_commit();

  // q tile + bias, rounded; rows past S are zero
  for (int i = tid; i < BQ * 8; i += NT) {
    const int r = i / 8, c8 = (i % 8) * 8, q = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q < S) raw = *reinterpret_cast<const uint4*>(base + q * rs + c8);
    const uint4 bb = *reinterpret_cast<const uint4*>(bq + c8);
    uint4 res;
    res.x = add2(raw.x, bb.x);
    res.y = add2(raw.y, bb.y);
    res.z = add2(raw.z, bb.z);
    res.w = add2(raw.w, bb.w);
    if (q >= S) res = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(sQ + r * LDT + c8) = res;
  }
  for (int i = tid; i < 2 * BQ * RLD; i += NT) sRh[i] = __float2bfloat16_rn(0.0f);  // sRh and sRw
  for (int i = tid; i < LDT; i += NT) sQ[BQ * LDT + i] = __float2bfloat16_rn(0.0f);   // the zero row
  __syncthreads();

  // rel terms on the tensor cores. The block's query rows that read the
  // same table row (one y of Rh: a run of consecutive rows; one x of Rw:
  // rows gw apart) are gathered 16 at a time into an mma operand through
  // ldmatrix row addresses (missing rows read the zero row), multiplied by
  // that table row's slots, and the fp32 sums rounded to bf16 into
  // sRh / sRw. Work items are dealt to the warps round-robin.
  {
    const int nrows = min(BQ, S - q0);
    const int y_first = q0 / gw, y_last = (q0 + nrows - 1) / gw;
    int item = 0;
    auto run = [&](const bf16* table, int nslots, bf16* dst, int start, int stride, int count) {
      if (item++ % NW != warp) return;
      const int i = lane % 16;
      const int row = i < count ? start + i * stride : BQ;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], sQ + row * LDT + kk * 16 + (lane / 16) * 8);
      for (int nt = 0; nt * 8 < nslots; ++nt) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const bf16* tb = table + (8 * nt + g) * HD + 2 * tig;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma(acc, a[kk], *reinterpret_cast<const uint32_t*>(tb + kk * 16),
              *reinterpret_cast<const uint32_t*>(tb + kk * 16 + 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = g + (e / 2) * 8, j = 8 * nt + 2 * tig + (e % 2);
          if (ri < count && j < nslots) dst[(start + ri * stride) * RLD + j] = __float2bfloat16_rn(acc[e]);
        }
      }
    };
    for (int y = y_first; y <= y_last; ++y) {
      const int lo = max(y * gw - q0, 0), hi = min((y + 1) * gw - q0, nrows);
      for (int r = lo; r < hi; r += 16) run(rh_tab + (size_t)y * SLOTS * HD, gh, sRh, r, 1, min(16, hi - r));
    }
    for (int x = 0; x < gw; ++x) {
      const int first = ((x - q0) % gw + gw) % gw;
      for (int r = first; r < nrows; r += 16 * gw)
        run(rw_tab + (size_t)x * SLOTS * HD, gw, sRw, r, gw, min(16, (nrows - r + gw - 1) / gw));
    }
  }
  __syncthreads();

  // q·scale in bf16 (the scale rounded to bf16 first), then this warp's
  // 16 rows as mma operand fragments for the whole key loop
  const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    sQ[r * LDT + d] = __float2bfloat16_rn(__bfloat162float(sQ[r * LDT + d]) * scale_t);
  }
  __syncthreads();
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(qa[kk], sQ + (warp * 16 + (lane % 16)) * LDT + kk * 16 + (lane / 16) * 8);

  // this thread's 8-channel bias chunks of k and v for the per-tile bias pass
  // (its chunk column is fixed: NT is a multiple of 8)
  const uint4 bk8 = *reinterpret_cast<const uint4*>(bk + (tid % 8) * 8);
  const uint4 bv8 = *reinterpret_cast<const uint4*>(bv + (tid % 8) * 8);

  const int rA = warp * 16 + g, rB = rA + 8;  // this thread's two rows (local)
  float m[2] = {softmax == STABLE ? -INFINITY : 0.0f, softmax == STABLE ? -INFINITY : 0.0f};
  float l[2] = {0.0f, 0.0f};
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  const float inv_gw = 1.0f / gw;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    bf16* cK = sK + (kt & 1) * BK * LDT;
    bf16* cV = sV + (kt & 1) * BK * LDT;
    __syncthreads();  // every warp is done with the stage the next prefetch overwrites
    if (kt + 1 < nk) {
      load_kv(sK + ((kt + 1) & 1) * BK * LDT, sV + ((kt + 1) & 1) * BK * LDT, base, rs, C, S, k0 + BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // k + bias and v + bias, rounded, in place (zero-filled rows past S
    // become the bias; their probabilities are 0)
    for (int i = tid; i < 2 * BK * 8; i += NT) {
      const int which = i / (BK * 8), r = (i / 8) % BK, c8 = (i % 8) * 8;
      uint4* t = reinterpret_cast<uint4*>((which ? cV : cK) + r * LDT + c8);
      const uint4 bb = which ? bv8 : bk8;
      uint4 v = *t;
      v.x = add2(v.x, bb.x);
      v.y = add2(v.y, bb.y);
      v.z = add2(v.z, bb.z);
      v.w = add2(v.w, bb.w);
      *t = v;
    }
    __syncthreads();

    // S = (q·scale)·kᵀ, 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t kb[4];
        ldsm_x4(kb, cK + (8 * j + (lane % 8)) * LDT + half * 32 + (lane / 8) * 8);
        mma(s[j], qa[2 * half], kb[0], kb[1]);
        mma(s[j], qa[2 * half + 1], kb[2], kb[3]);
      }
    }

    // + rel terms, mask keys past S, row max (stable)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * tig + e;
        const int kh = static_cast<int>((key + 0.5f) * inv_gw), kw = key - kh * gw;
        if (key < S) {
          s[j][e] += __bfloat162float(sRh[rA * RLD + kh]) + __bfloat162float(sRw[rA * RLD + kw]);
          s[j][2 + e] += __bfloat162float(sRh[rB * RLD + kh]) + __bfloat162float(sRw[rB * RLD + kw]);
        } else {
          s[j][e] = s[j][2 + e] = -INFINITY;
        }
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    }
    float alpha[2] = {1.0f, 1.0f};
    if (softmax == STABLE) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mnew = fmaxf(m[i], quad_max(mx[i]));
        alpha[i] = expf(m[i] - mnew);  // 0 on the first step (m = -inf)
        m[i] = mnew;
      }
    }
    float ls[2] = {0.0f, 0.0f};
    uint32_t pa[4][4];  // P as operand fragments, 4 steps of 16 keys
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = softmax_p<true>(s[j][0], m[0], softmax), p1 = softmax_p<true>(s[j][1], m[0], softmax);
      const float p2 = softmax_p<true>(s[j][2], m[1], softmax), p3 = softmax_p<true>(s[j][3], m[1], softmax);
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
    if (softmax == STABLE) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
    }

    // O += P·V, 4 steps of 16 keys × 8 tiles of 8 dims
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t vb[4];
        ldsm_x4_t(vb, cV + (16 * t + (lane % 16)) * LDT + 16 * jj + (lane / 16) * 8);
        mma(o[2 * jj], pa[t], vb[0], vb[1]);
        mma(o[2 * jj + 1], pa[t], vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + (i ? rB : rA);
    const float lt = quad_sum(l[i]) + (softmax == STABLE ? 0.0f : 1e-30f);
    if (q < S) {
      bf16* dst = out + ((size_t)b * S + q) * C + (size_t)h * HD + 2 * tig;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack(o[j][2 * i] / lt, o[j][2 * i + 1] / lt);
    }
  }
}

}  // namespace mma16

// ============================ fp32: SIMT ============================

namespace simt {

constexpr int BQ = 64;       // query rows per block
constexpr int NT = 256;      // 8 warps
constexpr int LD = HD + 4;   // row stride of q/k/v/p tiles (floats)
constexpr int LDF = 64 + 4;  // row stride of score/output tiles
constexpr int RLD = 64 + 1;  // row stride of the rel-term tiles

// each thread owns a 4×4 set of outputs (rows ty+16i, cols tx+16j)
__device__ void gemm_abt(const float* A, const float* Bt, float* C, int tid) {  // C = A·Btᵀ
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
    for (int j = 0; j < 4; ++j) C[(ty + 16 * i) * LDF + tx + 16 * j] = acc[i][j];
}

__device__ void gemm_ab_acc(const float* A, const float* B, float* C, int tid) {  // C += A·B
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = C[(ty + 16 * i) * LDF + tx + 16 * j];
  for (int k = 0; k < BK; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[k * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) C[(ty + 16 * i) * LDF + tx + 16 * j] = acc[i][j];
}

constexpr size_t smem_bytes() {
  return (4 * BQ * LD + 2 * BQ * LDF + 2 * BQ * RLD + 2 * BQ) * sizeof(float);
}

__global__ void __launch_bounds__(NT) attn_kernel(
    const float* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ rh_tab,
    const float* __restrict__ rw_tab, float* __restrict__ out, int S, int C, int gh, int gw, float scale,
    int softmax) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // q + bias, then q·scale
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  float* sS = sP + BQ * LD;
  float* sO = sS + BQ * LDF;
  float* sRh = sO + BQ * LDF;
  float* sRw = sRh + BQ * RLD;
  float* sM = sRw + BQ * RLD;
  float* sL = sM + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t rs = 3 * (size_t)C;
  const float* base = qkv + (size_t)b * S * rs + (size_t)h * HD;
  const float* bq = bias + h * HD;
  const float* bk = bias + C + h * HD;
  const float* bv = bias + 2 * C + h * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, q = q0 + r;
    sQ[r * LD + d] = q < S ? base[q * rs + d] + bq[d] : 0.0f;
  }
  for (int i = tid; i < BQ * LDF; i += NT) sO[i] = 0.0f;
  for (int i = tid; i < 2 * BQ * RLD; i += NT) sRh[i] = 0.0f;  // sRh and sRw
  if (tid < BQ) {
    sM[tid] = softmax == STABLE ? -INFINITY : 0.0f;
    sL[tid] = 0.0f;
  }
  __syncthreads();

  // rel terms: one warp per query row, lanes over the channels
  for (int r = warp; r < BQ; r += NT / 32) {
    const int q = q0 + r;
    if (q >= S) continue;
    const float qa = sQ[r * LD + 2 * lane], qb = sQ[r * LD + 2 * lane + 1];
    const float* th = rh_tab + (size_t)(q / gw) * SLOTS * HD + 2 * lane;
    const float* tw = rw_tab + (size_t)(q % gw) * SLOTS * HD + 2 * lane;
    for (int j = 0; j < gh; ++j) {
      float a = fmaf(qa, th[j * HD], qb * th[j * HD + 1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0) sRh[r * RLD + j] = a;
    }
    for (int j = 0; j < gw; ++j) {
      float a = fmaf(qa, tw[j * HD], qb * tw[j * HD + 1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0) sRw[r * RLD + j] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * HD; i += NT) sQ[(i / HD) * LD + i % HD] *= scale;

  const int nk = (S + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous step is done with sK, sV, sP
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, k = k0 + r;
      const bool valid = k < S;
      sK[r * LD + d] = valid ? base[k * rs + C + d] + bk[d] : 0.0f;
      sV[r * LD + d] = valid ? base[k * rs + 2 * C + d] + bv[d] : 0.0f;
    }
    __syncthreads();
    gemm_abt(sQ, sK, sS, tid);
    __syncthreads();

    // softmax step: four lanes per query row, 16 keys each
    {
      const int r = tid / 4, part = tid % 4;
      float s[16];
      float mloc = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = part + 4 * j, k = k0 + c;
        s[j] = k < S ? sS[r * LDF + c] + sRh[r * RLD + k / gw] + sRw[r * RLD + k % gw] : -INFINITY;
        mloc = fmaxf(mloc, s[j]);
      }
      const float m_old = sM[r];
      const float m_new = softmax == STABLE ? fmaxf(m_old, quad_max(mloc)) : m_old;
      float lsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = softmax_p<false>(s[j], m_new, softmax);
        lsum += p;
        sP[r * LD + part + 4 * j] = p;
      }
      lsum = quad_sum(lsum);
      const float alpha = softmax == STABLE ? expf(m_old - m_new) : 1.0f;  // 0 on the first step
      if (softmax == STABLE) {
#pragma unroll
        for (int j = 0; j < 16; ++j) sO[r * LDF + part + 4 * j] *= alpha;
      }
      if (part == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + lsum;
      }
    }
    __syncthreads();
    gemm_ab_acc(sP, sV, sO, tid);
  }
  __syncthreads();

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, q = q0 + r;
    if (q < S) {
      const float l = softmax == STABLE ? sL[r] : sL[r] + 1e-30f;
      out[((size_t)b * S + q) * C + (size_t)h * HD + d] = sO[r * LDF + d] / l;
    }
  }
}

}  // namespace simt

template <typename T>
int launch(void (*kernel)(const T*, const T*, const T*, const T*, T*, int, int, int, int, float, int),
           size_t smem, int bq, int nt, const void* qkv, const void* bias, const void* rh, const void* rw,
           void* out, int B, int S, int C, int H, int gh, int gw, float scale, int softmax, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + bq - 1) / bq, H, B);
  kernel<<<grid, nt, smem, (cudaStream_t)stream>>>((const T*)qkv, (const T*)bias, (const T*)rh, (const T*)rw,
                                                   (T*)out, S, C, gh, gw, scale, softmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int attn_qkv_rel_bf16(const void* qkv, const void* bias, const void* rh, const void* rw,
                                 void* out, int B, int S, int C, int H, int gh, int gw, float scale,
                                 int softmax, void* stream) {
  return launch<bf16>(mma16::attn_kernel, mma16::smem_bytes(), mma16::BQ, mma16::NT, qkv, bias, rh, rw, out,
                      B, S, C, H, gh, gw, scale, softmax, stream);
}

extern "C" int attn_qkv_rel_f32(const void* qkv, const void* bias, const void* rh, const void* rw,
                                void* out, int B, int S, int C, int H, int gh, int gw, float scale,
                                int softmax, void* stream) {
  return launch<float>(simt::attn_kernel, simt::smem_bytes(), simt::BQ, simt::NT, qkv, bias, rh, rw, out,
                       B, S, C, H, gh, gw, scale, softmax, stream);
}
