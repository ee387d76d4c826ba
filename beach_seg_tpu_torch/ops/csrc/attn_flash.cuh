// Flash-style attention with decomposed rel-pos terms, for Hopper (sm_90a):
// the device code of three kernels that differ in where they read and
// write and in one rounding point.
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
// The users (one source each, one shared library each):
//   attn_packed.cu   IN false, OUT true,  PRESCALE  (TPU `_kernel_packed`)
//   attn_qkv.cu      IN true,  OUT true,  PRESCALE  (TPU `_kernel_qkv`)
//   attn_fused.cu    IN false, OUT false, !PRESCALE (TPU `_kernel`)
// attn_qkv_rel.cu (#1) takes the softmax modes, quad_max, quad_sum, MAXG and
// shape_ok from here too; its bf16 body is attn_ws.cuh.
//
// What bounds it: at S=1568 the two S×S×D products per head are ~5e8 FLOP
// against ~1 MB of q, k, v, rel terms and output, so it is compute-bound on
// the tensor cores. One block per (q tile, batch·head) streams 64-key tiles
// of K and V with an online softmax, so scores never reach device memory,
// and stores its rows straight into the output layout.
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
//   fp32 (namespace tc32): 4 warps × 16 query rows (two blocks an SM), both
//   products in split TF32 on the tensor cores (tf32x3.cuh: three mma.sync
//   m16n8k8 .tf32 a product, fp32 to a few ulps), the design of #1's fp32
//   instance (attn_qkv_rel.cu): S and O in registers, q in registers with
//   the head dim in dperm order, P fed to PV from the S accumulator, one PV
//   accumulator per 64-key tile added to O in fp32, a cp.async
//   double-buffered K/V ring, the q tile's rel rows staged once slot-major
//   (Hk + Wk rows) and added per score, the exact expf. Bound: 3·FLOPs at
//   the 495 TF/s TF32 rate.
// Head dims 16, 64 and 80 are template instances (the wrappers pad 8 to 16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;        // keys per step
constexpr int MAXG = 64;      // largest Hk and Wk, and the rel slot width of the merged layout

// the qkv-rel attention's softmax modes (cuda_attn.SOFTMAX_MODES order): #1's
// bf16 body (attn_ws.cuh) and its fp32 instance (attn_qkv_rel.cu)
enum Softmax { STABLE = 0, CLAMP = 1, FAST = 2 };

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

// rows [r0, r0 + 64) of a bf16 matrix (row stride ld, `cols` columns, a
// multiple of 16) into a 64-row panel tile by cp.async, as load_tile, with
// the threads walking the tile in shared-memory order: the 8 threads of a
// quarter-warp write 128 contiguous bytes (no bank conflicts), and a thread
// can revisit its own chunks (chunk c = tid + i·NTB) after its
// cp_async_wait without a barrier. Rows at or past n read as zero.
__device__ __forceinline__ void load_tile64(uint32_t tile, const bf16* src, size_t ld, int cols, int n, int r0,
                                            int tid) {
  for (int c = tid; c < 8 * cols; c += NTB) {
    int r, ch;
    chunk_at(c, r, ch);
    const bool valid = r0 + r < n;
    cp_async16(tile + 16 * c, valid ? src + (size_t)(r0 + r) * ld + 8 * ch : src, valid);
  }
}

// rh, rw: the rel terms. At most 128 registers a thread, so two blocks fit
// an SM (their shared memory does at the ViT grid)
template <int HD, bool IN_MERGED, bool OUT_MERGED, bool PRESCALE>
__global__ void __launch_bounds__(NTB, 2) attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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
    load_tile64(sb, kp, rows.ld, HD, S, 64 * kt, tid);
    load_tile64(sb + TB, vp, rows.ld, HD, S, 64 * kt, tid);
    load_tile64(sb + 2 * TB, e, kx, kx, S, 64 * kt, tid);
  };
#pragma unroll
  for (int w = 0; w < NWG; ++w) load_tile64(sQ0 + w * TB, qp, rows.ld, HD, S, q0 + 64 * w, tid);
  for (int st = 0; st < NS - 1; ++st) {
    if (st < nk) load_stage(st);
    cp_async_commit();
  }
  // the q tile's slot rows (rel_h ‖ rel_w, zero-padded; zero past S), once
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
    const uint32_t sb = ring + (kt % NS) * stage_bytes;
    cp_async_wait<NS - 2>();  // key tile kt has landed
    fence_async_smem();
    __syncthreads();          // for every thread's copies; every warp is done with the stage refilled next
    if (kt + NS - 1 < nk) load_stage(kt + NS - 1);
    cp_async_commit();

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
    // at |x| ≤ 80; p is rounded to bf16)
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

// ==================== fp32: split TF32 on the tensor cores ====================

namespace tc32 {

using namespace tf32x3;

constexpr int NT = 128;       // 4 warps × 16 query rows
constexpr int BQ = 64;        // query rows per block
constexpr int RLD = BQ + 4;   // rel-row stride (floats): one row per slot, a column per query row

template <int HD>
struct Cfg {
  static constexpr int LD = HD + 4;  // q / k / v tile row stride (floats)
  // 2 stages of K and V tiles, then the q tile's rel rows (Hk + Wk slots);
  // the q tile lives in the second stage until the key loop starts
  static size_t smem(int nslots) { return (size_t)(4 * BK * LD + nslots * RLD) * sizeof(float); }
};

// the column of query row r (local) in the rel rows: the two rows of a
// thread (g and g + 8 of a warp's 16) are adjacent, one 8-byte load
__device__ __forceinline__ int rel_col(int r) { return (r & ~15) + 2 * (r & 7) + ((r >> 3) & 1); }

// rows [r0, r0 + 64) of an fp32 matrix (row stride ld, HD columns) into a
// tile of row stride LD by cp.async; rows at or past n read as zero
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, size_t ld, int n, int r0, int tid) {
  constexpr int LD = Cfg<HD>::LD, NC = HD / 4;
  for (int i = tid; i < BK * NC; i += NT) {
    const int r = i / NC, c4 = 4 * (i - r * NC), row = r0 + r;
    const bool valid = row < n;
    wg::cp_async16(wg::smem_u32(dst + r * LD + c4), valid ? src + (size_t)row * ld + c4 : src, valid);
  }
}

template <int HD, bool IN_MERGED, bool OUT_MERGED, bool PRESCALE>
__global__ void __launch_bounds__(NT, 2) attn_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ rh, const float* __restrict__ rw, float* __restrict__ out, int S, int H, int hk,
    int wk, int ld_in, int rld, float scale) {
  constexpr int LD = Cfg<HD>::LD, NO = HD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // stage i: K at sK + 2i·BK·LD, V after it
  float* sRel = sK + 4 * BK * LD;              // rel_h slots [0, hk), then rel_w slots [hk, hk + wk)
  float* sQ = sK + 2 * BK * LD;                // the q tile, in the second stage until the key loop

  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const Rows<IN_MERGED> rows(bh, b, h, S, HD, hk, wk, ld_in, rld);
  const float *qp = q + rows.qkv, *kp = k + rows.qkv, *vp = v + rows.qkv;
  const int nk = (S + BK - 1) / BK;

  load_rows<HD>(sK, kp, rows.ld, S, 0, tid);
  load_rows<HD>(sK + BK * LD, vp, rows.ld, S, 0, tid);
  load_rows<HD>(sQ, qp, rows.ld, S, q0, tid);
  wg::cp_async_commit();
  // the q tile's rel rows, slot-major (zero past S)
  const int nslots = hk + wk;
  for (int i = tid; i < BQ * nslots; i += NT) {
    const int r = i / nslots, j = i - r * nslots, row = q0 + r;
    float x = 0.0f;
    if (row < S) x = j < hk ? rh[rows.rh + (size_t)row * rows.ldh + j] : rw[rows.rw + (size_t)row * rows.ldw + j - hk];
    sRel[j * RLD + rel_col(r)] = x;
  }
  wg::cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 rows of q (PRESCALE: q·scale, rounded in fp32) as A
  // fragment values for the whole key loop (split where used), the head
  // dim in the order of tf32x3::dperm
  float qa[NO][4];
  {
    const float* r0 = sQ + (warp * 16 + g) * LD;
    const float sc = PRESCALE ? scale : 1.0f;
#pragma unroll
    for (int kk = 0; kk < NO; ++kk) {
      qa[kk][0] = r0[dperm<HD>(kk, t)] * sc;
      qa[kk][1] = r0[8 * LD + dperm<HD>(kk, t)] * sc;
      qa[kk][2] = r0[dperm<HD>(kk, t + 4)] * sc;
      qa[kk][3] = r0[8 * LD + dperm<HD>(kk, t + 4)] * sc;
    }
  }

  const int rA = warp * 16 + g;  // this thread's rows (local): rA, rA + 8
  const int cA = rel_col(rA);    // their rel-row columns: cA, cA + 1
  const float inv_wk = 1.0f / wk;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    const float* cK = sK + (kt & 1) * 2 * BK * LD;
    const float* cV = cK + BK * LD;
    __syncthreads();  // every warp is done with the stage the next prefetch overwrites (at kt = 0: the q tile)
    if (kt + 1 < nk) {
      float* nK = sK + ((kt + 1) & 1) * 2 * BK * LD;
      load_rows<HD>(nK, kp, rows.ld, S, k0 + BK, tid);
      load_rows<HD>(nK + BK * LD, vp, rows.ld, S, k0 + BK, tid);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    __syncthreads();

    // S = q·kᵀ, 8 tiles of 8 keys (column n of tile j is key 8j + n), two
    // k steps a 16-byte load of K (zero-filled rows past S are masked below)
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
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

    // (scale,) + the rel terms (the key → (kh, kw) split once per key, for
    // both rows), mask keys past S, row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        if (key < S) {
          const int kh = static_cast<int>((key + 0.5f) * inv_wk), kw = key - kh * wk;
          const float2 rh2 = *reinterpret_cast<const float2*>(sRel + kh * RLD + cA);
          const float2 rw2 = *reinterpret_cast<const float2*>(sRel + (hk + kw) * RLD + cA);
          if (PRESCALE) {
            s[j][e] = (s[j][e] + rh2.x) + rw2.x;
            s[j][2 + e] = (s[j][2 + e] + rh2.y) + rw2.y;
          } else {
            s[j][e] = s[j][e] * scale + (rh2.x + rw2.x);
            s[j][2 + e] = s[j][2 + e] * scale + (rh2.y + rw2.y);
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
      alpha[i] = expf(m[i] - mnew);  // 0 on the first step (m = -inf)
      m[i] = mnew;
    }
    // p = exp(s - max) in fp32 with the exact expf, in s
    float ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = expf(s[j][c] - m[c / 2]);
        ls[c / 2] += s[j][c];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];

    // O = O·alpha + P·V. Tile j of P is the A fragment of a k step of 8
    // keys in the order of tf32x3::to_a, so V's B fragment reads keys
    // 8j + 2t and 8j + 2t + 1. The tile's product has its own accumulator,
    // added to O on the FP32 units (the tensor cores' accumulation
    // truncates: one tile carries 24 truncations, a sum over all S keys
    // S/8·3)
    float pv[NO][4];
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) pv[nt][0] = pv[nt][1] = pv[nt][2] = pv[nt][3] = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const FragA pa = to_a(s[j]);
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        const float* vr = cV + (8 * j + 2 * t) * LD + 8 * nt + g;
        mma3(pv[nt], pa, split_b(vr[0], vr[LD]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) o[nt][c] = fmaf(o[nt][c], alpha[c / 2], pv[nt][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rA + 8 * i;
    const float lt = quad_sum(l[i]);
    if (row < S) {
      float* dst = out + out_at<OUT_MERGED>(bh, b, h, S, H, HD, row) + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
        *reinterpret_cast<float2*>(dst + 8 * nt) = make_float2(o[nt][2 * i] / lt, o[nt][2 * i + 1] / lt);
    }
  }
}

}  // namespace tc32

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
                                     (const bf16*)rw, (const bf16*)e, (bf16*)out, S, H, hk, wk, ld_in, rld, kx,
                                     scale);
  return (int)cudaGetLastError();
}

// the bf16 (wgmma) or fp32 (split TF32) instance of one layout at head dim
// D (16, 64 or 80; anything else is refused)
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
      return launch<float>(tc32::attn_kernel<16, IN_MERGED, OUT_MERGED, PRESCALE>, tc32::Cfg<16>::smem(hk + wk),
                           tc32::BQ, tc32::NT, q, k, v, rh, rw, out, BH, S, H, hk, wk, ld_in, rld, scale, stream);
    case 64:
      return launch<float>(tc32::attn_kernel<64, IN_MERGED, OUT_MERGED, PRESCALE>, tc32::Cfg<64>::smem(hk + wk),
                           tc32::BQ, tc32::NT, q, k, v, rh, rw, out, BH, S, H, hk, wk, ld_in, rld, scale, stream);
    case 80:
      return launch<float>(tc32::attn_kernel<80, IN_MERGED, OUT_MERGED, PRESCALE>, tc32::Cfg<80>::smem(hk + wk),
                           tc32::BQ, tc32::NT, q, k, v, rh, rw, out, BH, S, H, hk, wk, ld_in, rld, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

inline bool shape_ok(int BH, int S, int H, int hk, int wk) {
  return H > 0 && BH % H == 0 && hk * wk == S && hk > 0 && wk > 0 && hk <= MAXG && wk <= MAXG;
}

}  // namespace flash
