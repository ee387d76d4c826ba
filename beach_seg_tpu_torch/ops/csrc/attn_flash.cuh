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
//   bf16 (namespace wgf): two warpgroups of 64 query rows share each key
//   tile, wgmma (wgmma.cuh).
//   S = Q·Kᵀ with Q and K from shared memory; the rel terms enter as more
//   k steps of the same product: the q tile's slot rows (rel_h ‖ rel_w,
//   staged once per block) times the key tile's rows of the 0/1 key-to-slot
//   matrix E (filled by fill_slots before the kernel), over the slot chunks
//   the key tile touches, so no score takes a division or a lookup. O += P·V
//   with P from the S accumulator in registers and V from shared memory.
//   K, V and E tiles arrive through a 2-stage cp.async ring (two blocks, four
//   warpgroups an SM at ViT shapes), one barrier a step. #7's scale on
//   the fp32 scores needs the rel terms in an accumulator of their own.
//   fp32 (namespace simt): the simple form, 64 query rows, products on the
//   FP32 units with scores and accumulator in shared memory.
// Head dims 16, 64 and 80 are template instances (the wrappers pad 8 to 16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "wgmma.cuh"

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;        // keys per step
constexpr int MAXG = 64;      // largest Hk and Wk, and the rel slot width of the merged layout

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

// ============================ bf16: wgmma ============================

namespace wgf {

using namespace wg;

constexpr int NWG = 2;          // warpgroups a block, 64 query rows each
constexpr int BQ = 64 * NWG;    // query rows per block
constexpr int NTB = NT * NWG;   // threads per block
constexpr int NS = 2;           // ring stages (two blocks an SM at ViT shapes)

template <int HD>
struct Cfg {
  static constexpr int NP = HD / 16;      // 16-column panels of a q / k / v tile
  static constexpr int TB = 64 * HD * 2;  // bytes of a 64-row q / k / v tile
  // shared bytes: alignment slack, each warpgroup's Q tile and slot rows, NS stages of K, V, E
  static size_t smem(int kx) { return 1024 + NWG * (TB + (size_t)64 * kx * 2) + (size_t)NS * (2 * TB + 64 * kx * 2); }
};

template <int HD, bool IN_MERGED, bool OUT_MERGED, bool PRESCALE>
__global__ void __launch_bounds__(NTB) attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                   const bf16* __restrict__ v, const bf16* __restrict__ rh,
                                                   const bf16* __restrict__ rw, const bf16* __restrict__ e,
                                                   bf16* __restrict__ out, int S, int H, int hk, int wk, int ld_in,
                                                   int rld, int kx, float scale) {
  constexpr int NP = Cfg<HD>::NP, TB = Cfg<HD>::TB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // generic address of `base`
  const uint32_t rbytes = 64 * kx * 2;             // one warpgroup's slot rows
  const uint32_t sQ0 = base, sR0 = base + NWG * TB, ring = sR0 + NWG * rbytes;
  const uint32_t stage_bytes = 2 * TB + 64 * kx * 2;

  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, wgi = tid / NT, warp = (tid % NT) / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const uint32_t sQ = sQ0 + wgi * TB, sR = sR0 + wgi * rbytes;  // this warpgroup's 64 rows
  const int hkp = round16(hk), nx = kx / 16;
  const Rows<IN_MERGED> rows(bh, b, h, S, HD, hk, wk, ld_in, rld);
  const bf16 *qp = q + rows.qkv, *kp = k + rows.qkv, *vp = v + rows.qkv;
  const int nk = (S + 63) / 64;

  // K, V and E tiles of key tile kt into its ring stage
  auto load_stage = [&](int kt) {
    const uint32_t sb = ring + (kt % NS) * stage_bytes;
    load_tile(sb, kp, rows.ld, HD, S, 64 * kt, 64, tid, NTB);
    load_tile(sb + TB, vp, rows.ld, HD, S, 64 * kt, 64, tid, NTB);
    load_tile(sb + 2 * TB, e, kx, kx, S, 64 * kt, 64, tid, NTB);
  };
#pragma unroll
  for (int w = 0; w < NWG; ++w) load_tile(sQ0 + w * TB, qp, rows.ld, HD, S, q0 + 64 * w, 64, tid, NTB);
  for (int st = 0; st < NS - 1; ++st) {
    if (st < nk) load_stage(st);
    cp_async_commit();
  }
  // the q tile's slot rows (rel_h ‖ rel_w, zero-padded; zero past S), once
  {
    const bf16 zero = __float2bfloat16_rn(0.0f);
    const int nch = kx / 8;
    for (int i = tid; i < BQ * nch; i += NTB) {
      const int r = i / nch, ch = i - r * nch, row = q0 + r, c0 = 8 * ch;
      const bool in_h = c0 < hkp;
      const bf16* src = in_h ? rh + rows.rh + (size_t)row * rows.ldh : rw + rows.rw + (size_t)row * rows.ldw;
      const int n = in_h ? hk : wk, j0 = in_h ? c0 : c0 - hkp;
      __align__(16) bf16 vals[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] = row < S && j0 + j < n ? src[j0 + j] : zero;
      *reinterpret_cast<uint4*>(gbase + (sR0 - base) + (r / 64) * rbytes + chunk_off(r % 64, ch, 64)) =
          *reinterpret_cast<const uint4*>(vals);
    }
  }
  cp_async_wait<NS - 2>();  // the Q tiles (and key tile 0)
  __syncthreads();
  if (PRESCALE) {
    // q·scale in bf16 (the scale rounded to bf16 first), in place
    const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
    for (int i = tid; i < NWG * 64 * HD / 8; i += NTB) {
      uint4* p = reinterpret_cast<uint4*>(gbase + 16 * i);
      __align__(16) bf16 vals[8];
      *reinterpret_cast<uint4*>(vals) = *p;
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] = __float2bfloat16_rn(__bfloat162float(vals[j]) * scale_t);
      *p = *reinterpret_cast<const uint4*>(vals);
    }
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * 64;
    cp_async_wait<NS - 2>();  // key tile kt has landed
    fence_async_smem();
    __syncthreads();          // for every thread's copies; every warp is done with the stage refilled next
    if (kt + NS - 1 < nk) load_stage(kt + NS - 1);
    cp_async_commit();
    const uint32_t sb = ring + (kt % NS) * stage_bytes;

    // S = Q·Kᵀ, then the rel terms: slot rows · E tileᵀ over the slot
    // chunks this key tile touches (its rows' rel_h slots, every rel_w slot)
    const int c_lo = (k0 / wk) / 16, c_hi = (min(k0 + 63, S - 1) / wk) / 16;
    float s[32], sr[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = sr[i] = 0.0f;
    fence_regs(s);
    arrive();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) mma_ss<64>(s, kdesc(sQ + kk * 64 * 32), kdesc(sb + kk * 64 * 32), kk > 0);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (touched(c, nx, hkp, c_lo, c_hi)) {  // rel terms
        const uint64_t dr = kdesc(sR + c * 64 * 32), de = kdesc(sb + 2 * TB + c * 64 * 32);
        if (PRESCALE) {
          mma_ss<64>(s, dr, de, 1);
        } else {
          mma_ss<64>(sr, dr, de, 1);
        }
      }
    }
    commit();
    wait<0>();
    fence_regs(s);
    if (!PRESCALE) fence_regs(sr);

    // (scale,) mask keys past S, row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 8 * j + 2 * t + (c & 1);
        float x = PRESCALE ? s[4 * j + c] : s[4 * j + c] * scale + sr[4 * j + c];
        if (key >= S) x = -INFINITY;
        s[4 * j + c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
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
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = __expf(s[i] - m[(i >> 1) & 1]);
      ls[(i >> 1) & 1] += s[i];
    }
    uint32_t pa[4][4];
    to_a(pa, s);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P·V, V the MN-major B operand, 4 k steps of 16 keys
    fence_regs(o);
    arrive();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_rs<HD>(o, pa[ks], mndesc(sb + TB + ks * 16 * 32, 64), 1);
    commit();
    wait<0>();
    fence_regs(o);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 64 * wgi + warp * 16 + g + 8 * i;
    const float lt = quad_sum(l[i]);
    if (row < S) {
      bf16* dst = out + out_at<OUT_MERGED>(bh, b, h, S, H, HD, row) + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack(o[4 * j + 2 * i] / lt, o[4 * j + 2 * i + 1] / lt);
    }
  }
}

}  // namespace wgf

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

// bytes of the key-to-slot scratch E a bf16 launch needs (see wgmma.cuh)
inline size_t slots_bytes(int S, int hk, int wk) {
  return (size_t)(S + 63) / 64 * 64 * (wg::round16(hk) + wg::round16(wk)) * sizeof(bf16);
}

// the bf16 (wgmma) instance of one layout at head dim D: fills the E
// scratch (slots_bytes), then runs the kernel
template <int HD, bool IN_MERGED, bool OUT_MERGED, bool PRESCALE>
int launch_wg(const void* q, const void* k, const void* v, const void* rh, const void* rw, void* e, void* out,
              int BH, int S, int H, int hk, int wk, int ld_in, int rld, float scale, void* stream) {
  const int hkp = wg::round16(hk), kx = hkp + wg::round16(wk), s_pad = (S + 63) / 64 * 64;
  cudaStream_t st = (cudaStream_t)stream;
  wg::fill_slots<<<(s_pad * kx / 8 + 255) / 256, 256, 0, st>>>((bf16*)e, S, s_pad, wk, hkp, kx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = wgf::attn_kernel<HD, IN_MERGED, OUT_MERGED, PRESCALE>;
  const size_t smem = wgf::Cfg<HD>::smem(kx);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + wgf::BQ - 1) / wgf::BQ, BH);
  kernel<<<grid, wgf::NTB, smem, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)rh,
                                     (const bf16*)rw, (const bf16*)e, (bf16*)out, S, H, hk, wk, ld_in, rld, kx, scale);
  return (int)cudaGetLastError();
}

// the bf16 (wgmma) or fp32 (SIMT) instance of one layout at head dim D
// (16, 64 or 80; anything else is refused)
template <bool IN_MERGED, bool OUT_MERGED, bool PRESCALE>
int launch_bf16(int D, const void* q, const void* k, const void* v, const void* rh, const void* rw, void* e,
                void* out, int BH, int S, int H, int hk, int wk, int ld_in, int rld, float scale, void* stream) {
  switch (D) {
    case 16:
      return launch_wg<16, IN_MERGED, OUT_MERGED, PRESCALE>(q, k, v, rh, rw, e, out, BH, S, H, hk, wk, ld_in, rld,
                                                           scale, stream);
    case 64:
      return launch_wg<64, IN_MERGED, OUT_MERGED, PRESCALE>(q, k, v, rh, rw, e, out, BH, S, H, hk, wk, ld_in, rld,
                                                           scale, stream);
    case 80:
      return launch_wg<80, IN_MERGED, OUT_MERGED, PRESCALE>(q, k, v, rh, rw, e, out, BH, S, H, hk, wk, ld_in, rld,
                                                           scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
template <bool IN_MERGED, bool OUT_MERGED, bool PRESCALE>
int launch_f32(int D, const void* q, const void* k, const void* v, const void* rh, const void* rw, void* out,
               int BH, int S, int H, int hk, int wk, int ld_in, int rld, float scale, void* stream) {
  switch (D) {
    case 16:
      return launch<float>(simt::attn_kernel<16, IN_MERGED, OUT_MERGED, PRESCALE>, simt::Tile<16>::smem, simt::BQ,
                           simt::NT, q, k, v, rh, rw, out, BH, S, H, hk, wk, ld_in, rld, scale, stream);
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
