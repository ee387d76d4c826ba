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
// compute-bound on the tensor cores (fp32 too). Both kernels are flash-style: one block
// per (q tile, head, batch) streams 64-key tiles of K and V with an online
// softmax, so scores never reach device memory.
//   bf16: attn_ws.cuh (one instance per softmax mode): a pre-pass
//   (fill_slots_rel) writes each query row's slot rows (rel_h ‖ rel_w, formed
//   from the biased, unscaled q) and k + bk, v + bv into scratch; then a TMA
//   producer thread fills a 5-stage ring of 64-key K, V and key-to-slot (E)
//   tiles, and two consumer warpgroups of 64 query rows issue in turns, with
//   Q and the slot rows in registers. The rel terms enter the score product
//   as more wgmma k steps (slot rows · E over the slot chunks a key tile
//   touches): no per-score lookup or division. The JAX kernel feeds its rel
//   terms through the same 0/1 expansion (`eh`/`ew`). The exponentials of
//   one key tile run beside the PV of the one before. It replaced a
//   synchronous wgmma loop (attn_flash.cuh's kernel in a qkv-rel instance,
//   which ran each key tile in order: products, wait, exponentials, PV, wait).
//   Times (CUDA events, H100 80GB HBM3 at 700 W, clamp; ms a launch, the
//   new body against the old): ViT-L B = 8 0.453 against 0.681 (the two
//   pre-passes 0.076 of it), B = 32 1.667 against 2.553, 8 heads (a rank of
//   the two-rank split) 0.246 against 0.376; Painter's 14×14 windows
//   (S = 196) at 64 rows 0.214 against 0.221, at 128 rows 0.400 against
//   0.424.
//   fp32: 4 warps × 16 query rows (64 rows, two
//   blocks per SM) and both products in split TF32 (tf32x3.cuh: three
//   mma.sync m16n8k8 .tf32 per product, fp32-accurate to a few ulps, the
//   route of PyTorch's fp32 memory-efficient attention). S and O stay in
//   registers; P feeds PV from the S accumulator with PV's k order taken
//   as tf32x3::to_a gives it, so V's fragments read keys 2t and 2t+1 of
//   each 8-key group. p uses the exact expf. K and V are used as loaded:
//   the k bias enters as (q·scale)·bk, a constant of each row's scores
//   that starts its accumulator, and the v bias as bv·(Σp / r) on the
//   output (fp32 sums in another order than k + bk, v + bv first: a few
//   ulps). The rel terms are one dot product a thread on the FP32 units
//   (~3% of the work). Bound at ViT-L: 3·FLOPs at the 495 TF/s TF32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "attn_flash.cuh"
#include "attn_ws.cuh"
#include "tf32x3.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 64;      // head dim (the only one these kernels take)
constexpr int BK = 64;      // keys per step
constexpr int SLOTS = 64;   // padded rel-table key slots

using flash::quad_max;
using flash::quad_sum;
using flash::STABLE;
using flash::CLAMP;

// FAST_EXP: the hardware exp2 (__expf, relative error ~1e-5 at |s| ≤ 80)
template <bool FAST_EXP>
__device__ __forceinline__ float softmax_p(float s, float m, int softmax) {
  const float x = softmax == STABLE ? s - m : (softmax == CLAMP ? fminf(s, 80.0f) : s);
  return FAST_EXP ? __expf(x) : expf(x);
}

// ======================= fp32: split-TF32 mma.sync =======================

namespace f32 {

constexpr int NW = 4;           // warps per block (two blocks per SM)
constexpr int NT = NW * 32;
constexpr int BQ = 16 * NW;     // query rows per block
constexpr int LD = HD + 4;      // q/k/v tile row stride (floats): the fragment loads of both products are conflict-free
constexpr int RLD = BQ + 4;     // rel-term stride (floats): one row per table slot, a column per query row

// the column of query row r (local) in the rel-term rows: the two rows of a
// thread (g and g + 8 of a warp's 16) are adjacent, one 8-byte load
__device__ __forceinline__ int rel_col(int r) { return (r & ~15) + 2 * (r & 7) + ((r >> 3) & 1); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  // invalid rows are zero-filled (src-size 0)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(wg::smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// 2 stages of K and V tiles, then the rel rows; the q tile lives in the
// second stage until the key loop starts
constexpr size_t smem_bytes() { return (size_t)(4 * BK * LD + 2 * SLOTS * RLD) * sizeof(float); }

// K and V rows [k0, k0 + BK) of this (batch, head) into one stage
__device__ __forceinline__ void load_kv(float* sK, float* sV, const float* base, size_t rs, int C, int S, int k0,
                                        int tid) {
  for (int i = tid; i < 2 * BK * (HD / 4); i += NT) {
    const int which = i / (BK * HD / 4), r = (i / (HD / 4)) % BK, c4 = (i % (HD / 4)) * 4, k = k0 + r;
    const bool valid = k < S;
    const float* src = valid ? base + k * rs + (which + 1) * C + c4 : base;
    cp_async16((which ? sV : sK) + r * LD + c4, src, valid);
  }
}

__global__ void __launch_bounds__(NT, 2) attn_kernel(
    const float* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ rh_tab,
    const float* __restrict__ rw_tab, float* __restrict__ out, int S, int C, int gh, int gw, float scale,
    int softmax) {
  using namespace tf32x3;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // stage i: K at sK + 2i·BK·LD, V after it
  float* sV = sK + BK * LD;
  float* sRh = sK + 4 * BK * LD;
  float* sRw = sRh + SLOTS * RLD;
  float* sQ = sK + 2 * BK * LD;  // q + bias, in the second stage until the key loop overwrites it

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const size_t rs = 3 * (size_t)C;
  const float* base = qkv + (size_t)b * S * rs + (size_t)h * HD;
  const float* bq = bias + h * HD;
  const float* bk = bias + C + h * HD;
  const float* bv = bias + 2 * C + h * HD;

  const int nk = (S + BK - 1) / BK;
  load_kv(sK, sV, base, rs, C, S, 0, tid);
  wg::cp_async_commit();

  // q tile + bias (fp32); rows past S are zero
  for (int i = tid; i < BQ * (HD / 4); i += NT) {
    const int r = i / (HD / 4), c4 = (i % (HD / 4)) * 4, q = q0 + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q < S) {
      const float4 raw = *reinterpret_cast<const float4*>(base + q * rs + c4);
      const float4 bb = *reinterpret_cast<const float4*>(bq + c4);
      x = make_float4(raw.x + bb.x, raw.y + bb.y, raw.z + bb.z, raw.w + bb.w);
    }
    *reinterpret_cast<float4*>(sQ + r * LD + c4) = x;
  }
  for (int i = tid; i < 2 * SLOTS * RLD; i += NT) sRh[i] = 0.0f;  // sRh and sRw
  __syncthreads();

  // rel terms from the unscaled q, on the FP32 units (~3% of the work): one
  // (row, table slot) dot product a thread, q from shared memory and the
  // table row from global memory as float4
  {
    const int n = gh + gw;
    for (int i = tid; i < BQ * n; i += NT) {
      const int r = i / n, j = i % n, q = q0 + r;
      if (q >= S) continue;
      const int y = q / gw, x = q - y * gw;
      const float* tab = j < gh ? rh_tab + ((size_t)y * SLOTS + j) * HD : rw_tab + ((size_t)x * SLOTS + j - gh) * HD;
      const float* qr = sQ + r * LD;
      float a = 0.0f;
#pragma unroll
      for (int c = 0; c < HD; c += 4) {
        const float4 u = *reinterpret_cast<const float4*>(qr + c);
        const float4 w = __ldg(reinterpret_cast<const float4*>(tab + c));
        a = fmaf(u.x, w.x, a);
        a = fmaf(u.y, w.y, a);
        a = fmaf(u.z, w.z, a);
        a = fmaf(u.w, w.w, a);
      }
      if (j < gh) {
        sRh[j * RLD + rel_col(r)] = a;
      } else {
        sRw[(j - gh) * RLD + rel_col(r)] = a;
      }
    }
  }
  __syncthreads();

  // q·scale (rounded in fp32), this warp's 16 rows as A fragment values
  // for the whole key loop (split where used), the head dim in the order
  // of tf32x3::dperm
  float qa[HD / 8][4];
  {
    const float* r0 = sQ + (warp * 16 + g) * LD;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      qa[kk][0] = r0[dperm<HD>(kk, t)] * scale;
      qa[kk][1] = r0[8 * LD + dperm<HD>(kk, t)] * scale;
      qa[kk][2] = r0[dperm<HD>(kk, t + 4)] * scale;
      qa[kk][3] = r0[8 * LD + dperm<HD>(kk, t + 4)] * scale;
    }
  }
  // the k bias as a constant of each row's scores, (q·scale)·bk: the four
  // lanes of a row hold a quarter of its head dim each; it starts each
  // tile's score accumulator, so K is used as loaded
  float cb[2] = {0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float b0 = __ldg(bk + dperm<HD>(kk, t)), b1 = __ldg(bk + dperm<HD>(kk, t + 4));
    cb[0] = fmaf(qa[kk][0], b0, fmaf(qa[kk][2], b1, cb[0]));
    cb[1] = fmaf(qa[kk][1], b0, fmaf(qa[kk][3], b1, cb[1]));
  }
  cb[0] = quad_sum(cb[0]);
  cb[1] = quad_sum(cb[1]);

  const int rA = warp * 16 + g, rB = rA + 8;  // this thread's two rows (local)
  const int cA = rel_col(rA);                 // their rel-term columns: cA, cA + 1
  float m[2] = {softmax == STABLE ? -INFINITY : 0.0f, softmax == STABLE ? -INFINITY : 0.0f};
  float l[2] = {0.0f, 0.0f};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  const float inv_gw = 1.0f / gw;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    float* cK = sK + (kt & 1) * 2 * BK * LD;
    float* cV = sV + (kt & 1) * 2 * BK * LD;
    __syncthreads();  // every warp is done with the stage the next prefetch overwrites (at kt = 0: the q tile)
    if (kt + 1 < nk) {
      load_kv(sK + ((kt + 1) & 1) * 2 * BK * LD, sV + ((kt + 1) & 1) * 2 * BK * LD, base, rs, C, S, k0 + BK, tid);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    __syncthreads();

    // S = (q·scale)·(k + bk)ᵀ, 8 tiles of 8 keys (column n of tile j is key
    // 8j + n), two k steps a 16-byte load of K (zero-filled rows past S are
    // masked below)
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = cb[0], s[j][2] = s[j][3] = cb[1];
#pragma unroll
    for (int p = 0; p < HD / 16; ++p) {
      const FragA q0f = split_a(qa[2 * p][0], qa[2 * p][1], qa[2 * p][2], qa[2 * p][3]);
      const FragA q1f = split_a(qa[2 * p + 1][0], qa[2 * p + 1][1], qa[2 * p + 1][2], qa[2 * p + 1][3]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(cK + (8 * j + g) * LD + pair_col<HD>(p, t));
        mma3(s[j], q0f, split_b(kv.x, kv.y));
        mma3(s[j], q1f, split_b(kv.z, kv.w));
      }
    }

    // + rel terms (the key → (kh, kw) split once per key, for both rows),
    // mask keys past S, row max (stable)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        if (key < S) {
          const int kh = static_cast<int>((key + 0.5f) * inv_gw), kw = key - kh * gw;
          const float2 rh = *reinterpret_cast<const float2*>(sRh + kh * RLD + cA);
          const float2 rw = *reinterpret_cast<const float2*>(sRw + kw * RLD + cA);
          s[j][e] += rh.x + rw.x;
          s[j][2 + e] += rh.y + rw.y;
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
    // p in fp32 with the exact expf (p is not rounded to bf16 here), in s
    float ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = softmax_p<false>(s[j][c], m[c / 2], softmax);
        ls[c / 2] += s[j][c];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];

    // O = O·alpha + P·V. Tile j of P is the A fragment of a k step of 8
    // keys in the order of tf32x3::to_a, so V's B fragment reads keys
    // 8j + 2t and 8j + 2t + 1. The tile's product has its own accumulator,
    // added to O on the FP32 units: the tensor cores' accumulation
    // truncates, and a sum over all S keys inside them would carry S/8·3
    // truncations (588 at S=1568) where one tile carries 24
    float pv[HD / 8][4];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) pv[nt][0] = pv[nt][1] = pv[nt][2] = pv[nt][3] = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const FragA pa = to_a(s[j]);
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const float* vr = cV + (8 * j + 2 * t) * LD + 8 * nt + g;
        mma3(pv[nt], pa, split_b(vr[0], vr[LD]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) o[nt][c] = fmaf(o[nt][c], alpha[c / 2], pv[nt][c]);
    }
  }

  // out = Σ p·(v + bv) / r = (P·V) / r + bv·(Σ p / r), with V used as loaded
  // (Σ p / r is 1 under the stable softmax, whose r is Σ p)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + (i ? rB : rA);
    const float ls = quad_sum(l[i]), lt = ls + (softmax == STABLE ? 0.0f : 1e-30f), wb = ls / lt;
    if (q < S) {
      float* dst = out + ((size_t)b * S + q) * C + (size_t)h * HD + 2 * t;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bv + 8 * nt + 2 * t));
        *reinterpret_cast<float2*>(dst + 8 * nt) =
            make_float2(o[nt][2 * i] / lt + bb.x * wb, o[nt][2 * i + 1] / lt + bb.y * wb);
      }
    }
  }
}

}  // namespace f32

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

// qkv (B, S, 3, C) with C = H·64, bias (3, C), rh (gh, 64, 64), rw (gw, 64,
// 64), S = gh·gw with gh, gw <= 64 → out (B, S, C); all bf16; softmax 0
// stable, 1 clamp, 2 fast; scratch: e, flash::slots_bytes(S, gh, gw);
// slots, (B·H, S, KX) bf16; kv, (2, B·H, S, 64) bf16
extern "C" int attn_qkv_rel_bf16(const void* qkv, const void* bias, const void* rh, const void* rw, void* e,
                                 void* slots, void* kv, void* out, int B, int S, int C, int H, int gh, int gw, float scale,
                                 int softmax, void* stream) {
  if (C != H * HD || !flash::shape_ok(B * H, S, H, gh, gw)) return (int)cudaErrorInvalidValue;
  switch (softmax) {
    case flash::STABLE:
      return flash::ws::launch<flash::STABLE>(qkv, bias, rh, rw, e, slots, kv, out, B, S, H, gh, gw, scale, stream);
    case flash::CLAMP:
      return flash::ws::launch<flash::CLAMP>(qkv, bias, rh, rw, e, slots, kv, out, B, S, H, gh, gw, scale, stream);
    case flash::FAST:
      return flash::ws::launch<flash::FAST>(qkv, bias, rh, rw, e, slots, kv, out, B, S, H, gh, gw, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the same contract in fp32 (e unused)
extern "C" int attn_qkv_rel_f32(const void* qkv, const void* bias, const void* rh, const void* rw, void*,
                                void* out, int B, int S, int C, int H, int gh, int gw, float scale,
                                int softmax, void* stream) {
  return launch<float>(f32::attn_kernel, f32::smem_bytes(), f32::BQ, f32::NT, qkv, bias, rh, rw, out,
                       B, S, C, H, gh, gw, scale, softmax, stream);
}
