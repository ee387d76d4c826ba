// The bf16 qkv-rel attention (#1, attn_qkv_rel.cu) warp-specialized for
// Hopper (sm_90a): the body that attn_qkv_rel_bf16 launches at every shape,
// and, as attn_kernel<SOFTMAX, false> without rel terms, EVA-02's RoPE
// attention (attn_qkv_rope.cu).
// It computes attn_qkv_rel.cu's function at the TPU kernel's rounding
// points: q, k, v + the qkv bias rounded to bf16, the rel terms formed from
// the biased unscaled q and rounded, round(q·scale), fp32 scores, p rounded
// to bf16 before PV, the division after PV; the softmax a template mode
// (stable, clamp, fast).
//
// Why: the body it replaced (wgf, attn_flash.cuh's wgmma kernel in a
// qkv-rel instance) ran each key tile in strict order (S = QKᵀ
// + rel k steps, wait, exponentials, PV, wait), every thread copying and
// adding the k/v biases and one block-wide barrier a tile; at ViT-L (B = 8)
// it took 0.68 ms against a 0.084 ms operations bound.
//
// Three launches:
//   fill_slots: the 0/1 key-to-slot matrix E (wgmma.cuh);
//   fill_slots_rel: the slot rows of every query row (rel_h ‖ rel_w) and
//   k + bk, v + bv, rounded, into scratch; one block per grid row or grid
//   column of a head, so each table row is read once a head;
//   attn_kernel, 384 threads a block of 128 query rows, one block an SM:
//   - a producer warpgroup (setmaxnreg down to 24) whose one thread issues
//     every TMA load: Q's two 64-row tiles and their slot rows once, then
//     each 64-key tile's K, V and E rows into a ring of NS = 5 stages with
//     full / empty mbarriers. 3-D tensor maps, so rows past S arrive as
//     zeros;
//   - two consumer warpgroups (setmaxnreg up to 240), 64 query rows each:
//     q + bq, then ·scale, in place; each warp's 16 rows of Q and of the
//     slot rows into registers, the A operands of every score product (RS
//     wgmma: per product only K, E or V is read from shared memory). Key
//     tile j: issue S(j) = Q·K(j)ᵀ + slot rows · E(j)ᵀ (the slot chunks the
//     tile touches) and PV(j - 1), two commit groups; wait for S(j); mask,
//     (row max,) exponentials and row sums of tile j while PV(j - 1) runs
//     on the tensor cores; wait for PV(j - 1), hand its stage back,
//     (rescale O,) P(j) to bf16 registers. The two warpgroups take turns
//     issuing (named barriers 1 and 2).
// The tail (S = 1568 is 12.25 blocks of 128 rows): a block whose second
// warpgroup has no row below S runs its first alone (no turns; the empty
// barriers count one warpgroup's warps), a 64-row last unit.
//
// The designs measured on the way (H100, 700 W, ViT-L, B = 8, clamp; ms a
// launch, wgf 0.68): the rel terms formed in the kernel by wgf's prologue,
// 0.73: with one block an SM it stood before every key loop (0.23 of it);
// the rel terms added to each score from the slot rows in shared memory
// instead of E's k steps, 1.11 (two shared loads a score on the
// exponentials' path); k and v used as loaded, with the biases as
// (q·scale)·bk and bv·(Σp/r) as #1's fp32 instance does, missed the bf16
// error-norm limit (4.8e-3 against 2^-8); the producer's three other warps
// adding the k/v biases to each landed stage cost 0.095 of 0.51 (shared
// memory bandwidth the products need), more than writing biased copies in
// the pre-pass (0.024); 128-key tiles (m64n128 score products), 0.51 with
// spills; S(j + 1) issued before the exponentials of tile j into a second
// accumulator, 0.543, because ptxas serialized the wgmmas (C7515); the ring's
// stage count at run time, 0.045 more than as a constant (a division and a
// remainder a tile and thread).

#pragma once

#include <cuda.h>

#include "attn_flash.cuh"
#include "gemm_sm90.cuh"

namespace flash {
namespace ws {

using namespace wg;
using g90::bar_arrive;
using g90::bar_expect_tx;
using g90::bar_init;
using g90::bar_wait;
using g90::tma_load;

constexpr int HD = 64;
constexpr int NWG = 2;            // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * NWG;      // query rows per block
constexpr int NTB = NT * (NWG + 1);
constexpr int NS = 5;             // ring stages, as many as fit at KX = 128; a constant, so a stage's
                                  // index and parity take no division
constexpr int TB = 64 * HD * 2;   // bytes of a 64-row tile of 64 columns: q, k, v
constexpr int PANEL = 64 * 32;        // a 16-column panel of a 64-row tile
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
// the register count every thread must launch with so that the consumers'
// setmaxnreg.inc finds its registers: 128·24 + 256·240 = 384·168
constexpr int LAUNCH_REGS = (NT * PRODUCER_REGS + NWG * NT * CONSUMER_REGS) / NTB;
constexpr int BAR_TURN = 1, BAR_WG = 3;  // named barriers (0 is __syncthreads): turns 1, 2; a warpgroup's own 3, 4

// shared bytes: alignment slack, the Q tiles and slot rows, NS stages of K,
// V and E (214,016 at KX = 128, of the 232,448 a block may have)
inline size_t smem(int kx) { return 1024 + NWG * ((size_t)TB + 128 * kx) + (size_t)NS * (2 * TB + 128 * kx); }

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {  // bf16x2 a + b, rounded
  __nv_bfloat162 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  x = __hadd2(x, y);
  memcpy(&a, &x, 4);
  return a;
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d += a · b, mma.sync m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void wg_sync(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

// one TMA box of a 3-D tensor map at element coordinates (c0 innermost, c1, c2)
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// d (32 floats) [+]= A·B, m64n64k16, A from registers (the layout of
// mma.sync m16n8k16's A, ldmatrix.x4), B K-major from shared memory
__device__ __forceinline__ void mma_rs_k(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// The pre-pass of every launch, one block of 4 warps per grid row y
// (blockIdx.x < Gh) or grid column x of a head:
// - the slot rows of every query row, (B·H, S, KX) bf16: rel_h ‖ rel_w,
//   each zero-padded to a multiple of 16, rel_h[r, j] = Σ_c q[r,c]·Rh[y(r),
//   j, c] and rel_w[r, j] = Σ_c q[r,c]·Rw[x(r), j, c] with q + bq rounded
//   to bf16, fp32 sums (mma.sync m16n8k16) rounded to bf16. A grid row's
//   block takes its Wk consecutive rows against Rh[y], a grid column's its
//   Gh rows (Wk apart) against Rw[x]: each table row is read once a head.
//   Formed inside the attention (as wgf's prologue did), a 128-row block
//   reads every Rw row for the few rows of each column it holds, and with
//   one block an SM that stood before every key loop (18.7 of a block's 49
//   µs at ViT-L, B = 8);
// - a grid row's block also writes its rows' k + bk and v + bv, rounded to
//   bf16 (the TPU kernel's rounding point), into kv (2, B·H, S, 64): the attention then
//   uses K and V as loaded, where a pass over each landed stage in shared
//   memory competed with the products for its bandwidth (0.095 of 0.51 ms).
constexpr int SLD = HD + 8;  // row stride (bf16) of the q and table rows: conflict-free fragment loads
__global__ void __launch_bounds__(NT) fill_slots_rel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                                                 const bf16* __restrict__ rh, const bf16* __restrict__ rw,
                                                 bf16* __restrict__ slots, bf16* __restrict__ kv, int S, int H, int hk,
                                                 int wk, int kx) {
  __shared__ __align__(16) bf16 sq[64 * SLD], st[64 * SLD];
  const int bh = blockIdx.y, b = bh / H, h = bh % H, C = H * HD, gh = S / wk, tid = threadIdx.x;
  const bool is_h = (int)blockIdx.x < gh;
  const int idx = is_h ? blockIdx.x : blockIdx.x - gh, hkp = round16(hk);
  const int nrows = is_h ? wk : gh, nslots = is_h ? hk : wk, r_first = is_h ? idx * wk : idx, r_step = is_h ? 1 : wk;
  const int col0 = is_h ? 0 : hkp, ncols = is_h ? hkp : kx - hkp;  // the slot columns this block writes
  const bf16* table = (is_h ? rh : rw) + (size_t)idx * MAXG * HD;
  const bf16* qp = qkv + (size_t)b * S * 3 * C + (size_t)h * HD;
  for (int i = tid; i < 64 * HD / 8; i += NT) {
    const int r = i / (HD / 8), c8 = 8 * (i % (HD / 8));
    uint4 qv = make_uint4(0u, 0u, 0u, 0u), tv = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) {
      const bf16* row = qp + (size_t)(r_first + r * r_step) * 3 * C + c8;
#pragma unroll
      for (int w = 0; w < 3; ++w) {  // q, k, v
        if (w > 0 && !is_h) break;
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(row + w * C));
        const uint4 bb = __ldg(reinterpret_cast<const uint4*>(bias + w * C + h * HD + c8));
        const uint4 y = make_uint4(add2(x.x, bb.x), add2(x.y, bb.y), add2(x.z, bb.z), add2(x.w, bb.w));
        if (w == 0)
          qv = y;
        else
          *reinterpret_cast<uint4*>(kv + (((size_t)(w - 1) * gridDim.y + bh) * S + r_first + r) * HD + c8) = y;
      }
    }
    if (r < nslots) tv = __ldg(reinterpret_cast<const uint4*>(table + r * HD + c8));
    *reinterpret_cast<uint4*>(sq + r * SLD + c8) = qv;
    *reinterpret_cast<uint4*>(st + r * SLD + c8) = tv;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  if (16 * warp >= nrows) return;
  uint32_t a[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(a[kk], smem_u32(sq + (16 * warp + lane % 16) * SLD + 16 * kk + 8 * (lane / 16)));
  for (int n0 = 0; n0 < ncols; n0 += 8) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (n0 < nslots) {  // slot rows past nslots are zero
      const bf16* tb = st + (n0 + g) * SLD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma16816(acc, a[kk], *reinterpret_cast<const uint32_t*>(tb + 16 * kk),
                 *reinterpret_cast<const uint32_t*>(tb + 16 * kk + 8));
    }
    // acc[e]: row 16·warp + g + 8 (e / 2), slot n0 + 2t + e % 2
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * warp + g + 8 * i;
      if (row < nrows)
        *reinterpret_cast<uint32_t*>(slots + ((size_t)bh * S + r_first + row * r_step) * kx + col0 + n0 + 2 * t) =
            pack(acc[2 * i], acc[2 * i + 1]);
    }
  }
}

// mq: the (B, S, 3C) qkv tensor, dims (3C, S, B); mkv: kv, dims (64, S,
// 2·B·H); mslots: the slot rows, dims (KX, S, B·H); me: E (S_pad, KX);
// boxes of 16 columns × 64 rows, each one panel in TMA's 32-byte swizzle.
// REL false (EVA-02's RoPE instance, attn_qkv_rope.cu): no rel terms
// (kx = 0, mq, mslots, me and bias unread); mkv holds q, k, v already
// biased, rotated and rounded, dims (64, S, 3·B·H), so Q is loaded from its
// first B·H planes and only scaled in place, and the key loop issues Q·Kᵀ
// alone.
template <int SOFTMAX, bool REL = true>
__global__ void __launch_bounds__(NTB, 1) attn_kernel(const __grid_constant__ CUtensorMap mq,
                                                   const __grid_constant__ CUtensorMap mkv,
                                                   const __grid_constant__ CUtensorMap mslots,
                                                   const __grid_constant__ CUtensorMap me,
                                                   const bf16* __restrict__ bias, bf16* __restrict__ out, int S,
                                                   int H, int hk, int wk, int kx, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NS], empty[NS], qfull;
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // generic address of `base`
  const uint32_t rbytes = 64 * kx * 2;             // one warpgroup's slot rows, or a stage's E tile
  const uint32_t sQ0 = base, sR0 = base + NWG * TB, ring = sR0 + NWG * rbytes;
  const uint32_t stage_bytes = 2 * TB + rbytes;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nk = (S + 63) / 64;
  const int nwg = q0 + 64 < S ? NWG : 1;  // consumer warpgroups with a row below S
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      bar_init(smem_u32(&full[s]), 1);
      bar_init(smem_u32(&empty[s]), 4 * nwg);  // the working consumers' warps
    }
    bar_init(smem_u32(&qfull), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < NT) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      // the loads: Q and the slot rows once, then each key tile into its
      // stage once the consumers have handed that stage back
      const uint32_t qb = smem_u32(&qfull);
      bar_expect_tx(qb, NWG * (TB + rbytes));
      for (int w = 0; w < NWG; ++w) {
        if constexpr (REL) {
          for (int p = 0; p < HD / 16; ++p) tma_load3(sQ0 + w * TB + p * PANEL, &mq, h * HD + 16 * p, q0 + 64 * w, b, qb);
          for (int p = 0; p < kx / 16; ++p) tma_load3(sR0 + w * rbytes + p * PANEL, &mslots, 16 * p, q0 + 64 * w, bh, qb);
        } else {
          for (int p = 0; p < HD / 16; ++p) tma_load3(sQ0 + w * TB + p * PANEL, &mkv, 16 * p, q0 + 64 * w, bh, qb);
        }
      }
      const int kplane = REL ? bh : gridDim.y + bh;  // K's plane of mkv; V's is gridDim.y further
      for (int i = 0; i < nk; ++i) {
        const int s = i % NS;
        bar_wait(smem_u32(&empty[s]), ((i / NS) & 1) ^ 1);
        const uint32_t fb = smem_u32(&full[s]), sb = ring + s * stage_bytes;
        bar_expect_tx(fb, stage_bytes);
        for (int p = 0; p < HD / 16; ++p) {
          tma_load3(sb + p * PANEL, &mkv, 16 * p, 64 * i, kplane, fb);
          tma_load3(sb + TB + p * PANEL, &mkv, 16 * p, 64 * i, gridDim.y + kplane, fb);
        }
        if constexpr (REL)
          for (int p = 0; p < kx / 16; ++p) tma_load(sb + 2 * TB + p * PANEL, &me, 16 * p, 64 * i, fb);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int ctid = threadIdx.x - NT, cw = ctid / NT;  // this consumer warpgroup: rows 64·cw of the block
  if (cw >= nwg) return;                              // the last block's second warpgroup: no row below S
  const int wtid = ctid % NT, warp = wtid / 32, lane = ctid % 32, g = lane >> 2, t = lane & 3;
  const uint32_t sQ = sQ0 + cw * TB, sR = sR0 + cw * rbytes;
  const int hkp = round16(hk), nx = kx / 16;

  // this warpgroup's q tile + bq (the pre-pass added it in the RoPE
  // instance), then ·scale, each rounded to bf16 (the scale rounded first),
  // in place
  bar_wait(smem_u32(&qfull), 0);
  {
    const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
    unsigned char* q = gbase + cw * TB;
    for (int c = wtid; c < 8 * HD; c += NT) {
      int r, ch;
      chunk_at(c, r, ch);
      uint4 x = *reinterpret_cast<const uint4*>(q + 16 * c);
      if constexpr (REL) {
        const uint4 bb = __ldg(reinterpret_cast<const uint4*>(bias + h * HD + 8 * ch));
        x = make_uint4(add2(x.x, bb.x), add2(x.y, bb.y), add2(x.z, bb.z), add2(x.w, bb.w));
      }
      __align__(16) bf16 vals[8];
      *reinterpret_cast<uint4*>(vals) = x;
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] = __float2bfloat16_rn(__bfloat162float(vals[j]) * scale_t);
      *reinterpret_cast<uint4*>(q + 16 * c) = *reinterpret_cast<const uint4*>(vals);
    }
  }
  wg_sync(BAR_WG + cw);

  // this warp's 16 rows of q·scale and of the slot rows as A fragments, for
  // the whole key loop
  const int rA = warp * 16 + g;  // this thread's rows: rA, rA + 8
  uint32_t qa[HD / 16][4], ra[8][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qa[kk], sQ + chunk_off(warp * 16 + lane % 16, 2 * kk + lane / 16, 64));
  if constexpr (REL) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < nx) ldsm_x4(ra[c], sR + chunk_off(warp * 16 + lane % 16, 2 * c + lane / 16, 64));
  }

  const bool turns = nwg == NWG;
  auto turn_wait = [&] {
    if (turns) named_sync(BAR_TURN + cw);
  };
  auto turn_pass = [&] {
    if (turns) named_arrive(BAR_TURN + (cw ^ 1));
  };
  const bool signals = lane == 0;
  auto hand_back = [&](int j) {
    if (signals) bar_arrive(smem_u32(&empty[j % NS]));
  };

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float o[HD / 2], s[32];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;

  // S(j) = Q·K(j)ᵀ + the rel terms (slot rows · E(j)ᵀ over the slot chunks
  // key tile j touches), into s
  auto issue_s = [&](int j) {
    const uint32_t sb = ring + (j % NS) * stage_bytes;
    int c_lo = 0, c_hi = 0;
    if constexpr (REL) {
      const int k0 = 64 * j;
      c_lo = (k0 / wk) / 16, c_hi = (min(k0 + 63, S - 1) / wk) / 16;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) mma_rs_k(s, qa[kk], kdesc(sb + kk * PANEL), kk > 0);
    if constexpr (REL) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (touched(c, nx, hkp, c_lo, c_hi)) mma_rs_k(s, ra[c], kdesc(sb + 2 * TB + c * PANEL), 1);
    }
    commit();
  };
  // O += P(j)·V(j), V the MN-major B operand, 4 k steps of 16 keys
  auto issue_pv = [&](int j) {
    const uint32_t sb = ring + (j % NS) * stage_bytes;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_rs<HD>(o, pa[ks], mndesc(sb + TB + ks * 16 * 32, 64), 1);
    commit();
  };
  // tile j's scores in s → p (fp32, in s): the tail mask, (the row max and
  // O's factor alpha,) l = l·alpha + Σp
  auto softmax = [&](int j, float (&alpha)[2]) {
    const int k0 = 64 * j;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 8 * j8 + 2 * t + (c & 1);
        float x = s[4 * j8 + c];
        if (key >= S) x = -INFINITY;
        s[4 * j8 + c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    alpha[0] = alpha[1] = 1.0f;
    if (SOFTMAX == STABLE) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mnew = fmaxf(m[i], quad_max(mx[i]));
        alpha[i] = __expf(m[i] - mnew);  // 0 on the first tile (m = -inf)
        m[i] = mnew;
      }
    }
    // p = exp(s - max) | exp(min(s, 80)) | exp(s) with the hardware exp2
    float ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = s[i];
      s[i] = __expf(SOFTMAX == STABLE ? x - m[(i >> 1) & 1] : SOFTMAX == CLAMP ? fminf(x, 80.0f) : x);
      ls[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
  };

  // Key tile j: issue S(j) and PV(j - 1) (two commit groups, in this
  // warpgroup's turn), wait for S(j); its exponentials run while PV(j - 1)
  // does; wait for PV(j - 1), hand its stage back, (rescale O,) P(j) to bf16
  // registers. (Issuing S(j + 1) before the exponentials of tile j, into a
  // second accumulator, made ptxas serialize the wgmmas (C7515): 0.543 ms a
  // launch against this order's 0.466 at ViT-L, B = 8.)
  if (turns && cw == 1) named_arrive(BAR_TURN);  // the first warpgroup issues first
  float alpha[2];
  bar_wait(smem_u32(&full[0]), 0);
  turn_wait();
  fence_regs(s);
  arrive();
  issue_s(0);
  turn_pass();
  wait<0>();
  fence_regs(s);
  softmax(0, alpha);
  to_a(pa, s);
  for (int j = 1; j < nk; ++j) {
    bar_wait(smem_u32(&full[j % NS]), (j / NS) & 1);
    turn_wait();
    fence_regs(s);
    fence_regs(o);
    arrive();
    issue_s(j);
    issue_pv(j - 1);
    turn_pass();
    wait<1>();  // S(j) is done; PV(j - 1) runs on
    fence_regs(s);
    softmax(j, alpha);
    fence_regs(s);
    fence_regs(l);
    wait<0>();
    fence_regs(o);
    fence_regs(s);
    hand_back(j - 1);
    if (SOFTMAX == STABLE) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
    to_a(pa, s);
  }
  turn_wait();
  fence_regs(o);
  arrive();
  issue_pv(nk - 1);
  turn_pass();
  wait<0>();
  fence_regs(o);
  hand_back(nk - 1);
  if (turns && cw == 0) turn_wait();  // the second warpgroup's last pass

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 64 * cw + rA + 8 * i;
    const float lt = quad_sum(l[i]) + (SOFTMAX == STABLE ? 0.0f : 1e-30f);
    if (row < S) {
      bf16* dst = out + ((size_t)b * S + row) * (size_t)(H * HD) + (size_t)h * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack(o[4 * j + 2 * i] / lt, o[4 * j + 2 * i + 1] / lt);
    }
  }
}

// a row-major bf16 tensor of `rank` dims (dims[0] innermost, in elements;
// strides of dims 1.. in bytes), boxes of 16 × 64 (× 1), TMA's 32-byte
// swizzle, out-of-bounds elements read as zero
inline bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims, const cuuint64_t* strides) {
  g90::EncodeTiled fn = g90::encode_fn();
  if (!fn) return false;
  const cuuint32_t box[3] = {16, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// qkv (B, S, 3C), bias (3, C), the tables Rh, Rw, out (B, S, C); C = H·64;
// scratch: e, flash::slots_bytes; slots, (B·H, S, KX) bf16; kv, (2, B·H, S,
// 64) bf16. Three launches: E, the pre-pass, the attention
template <int SOFTMAX>
int launch(const void* qkv, const void* bias, const void* rh, const void* rw, void* e, void* slots, void* kv,
           void* out, int B, int S, int H, int hk, int wk, float scale, void* stream) {
  const int hkp = round16(hk), kx = hkp + round16(wk), s_pad = (S + 63) / 64 * 64, C = H * HD;
  cudaStream_t st = (cudaStream_t)stream;
  fill_slots<<<(s_pad * kx / 8 + 255) / 256, 256, 0, st>>>((bf16*)e, S, s_pad, wk, hkp, kx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fill_slots_rel<<<dim3(S / wk + wk, B * H), NT, 0, st>>>((const bf16*)qkv, (const bf16*)bias, (const bf16*)rh,
                                                          (const bf16*)rw, (bf16*)slots, (bf16*)kv, S, H, hk, wk, kx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = attn_kernel<SOFTMAX>;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  // fewer registers at launch and setmaxnreg.inc would wait for ever
  if (attr.numRegs != LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = smem(kx);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mkv, mslots, me;
  const cuuint64_t qdims[3] = {(cuuint64_t)3 * C, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t qstrides[2] = {(cuuint64_t)3 * C * 2, (cuuint64_t)S * 3 * C * 2};
  const cuuint64_t kdims[3] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)2 * B * H};
  const cuuint64_t kstrides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)S * HD * 2};
  const cuuint64_t rdims[3] = {(cuuint64_t)kx, (cuuint64_t)S, (cuuint64_t)B * H};
  const cuuint64_t rstrides[2] = {(cuuint64_t)kx * 2, (cuuint64_t)S * kx * 2};
  const cuuint64_t edims[2] = {(cuuint64_t)kx, (cuuint64_t)s_pad};
  const cuuint64_t estrides[1] = {(cuuint64_t)kx * 2};
  if (!encode(&mq, qkv, 3, qdims, qstrides) || !encode(&mkv, kv, 3, kdims, kstrides) ||
      !encode(&mslots, slots, 3, rdims, rstrides) || !encode(&me, e, 2, edims, estrides))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, NTB, bytes, st>>>(mq, mkv, mslots, me, (const bf16*)bias, (bf16*)out, S, H, hk, wk, kx, scale);
  return (int)cudaGetLastError();
}

}  // namespace ws
}  // namespace flash
