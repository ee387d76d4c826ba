// Hopper warpgroup products (wgmma) on bf16 tiles in shared memory, for the
// bf16 attention kernels (attn_flash.cuh, attn_bwd.cu); the LN→MLP products
// (gemm_sm90.cuh) take its fences, descriptor and pack with TMA's 128-byte
// swizzle.
//
// Tile layout. A tile of R rows × W columns (W a multiple of 16) is stored
// as W/16 panels, panel p holding columns [16p, 16p + 16) of every row as
// 32-byte rows, with the 32-byte swizzle (the second 16-byte chunk of a row
// swaps with the first in rows 4-7 of every 8: byte-address bit 4 ^= bit 7,
// CUTLASS's Swizzle<1,4,3>, the layout TMA's SWIZZLE_32B writes). Panels
// start on 256-byte boundaries. The same tile is then a wgmma operand both
//   K-major  (contraction over its columns: S = Q·Kᵀ, 16 columns = one panel
//            a k step; the descriptor's stride between 8-row groups is 256 B)
//   MN-major (contraction over its rows: O += P·V, 16 rows a k step at
//            512 B; the output columns run across panels R·32 B apart)
// so a K or V tile loaded once serves every product of a step. Every
// descriptor of these tiles is layout type 3 (32-byte swizzle), base offset 0.
//
// Accumulators of m64nNk16 (f32): thread t of the warpgroup, warp w = t/32,
// lane = 4g + c: d[4j + e] is row 16w + g (e = 0, 1) or 16w + g + 8 (e = 2,
// 3), column 8j + 2c + (e & 1) — per 8-column tile the layout of
// mma.sync m16n8. A register A operand of one k step (16 columns) has the
// layout of mma.sync m16n8k16's A, so accumulator tiles 2s and 2s + 1 are
// the A fragment of k step s (to_a).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace wg {

typedef __nv_bfloat16 bf16;

constexpr int NT = 128;  // one warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `ch` (columns 8ch..8ch+7) of row r in a tile of `rows` rows
__device__ __forceinline__ uint32_t chunk_off(int r, int ch, int rows) {
  return (uint32_t)((ch >> 1) * rows * 32 + r * 32 + (((ch & 1) ^ ((r >> 2) & 1)) << 4));
}
// The 16-byte chunk c of a 64-row panel tile, in shared-memory order (its
// byte offset is 16·c; chunk_off's inverse): row r, columns 8·ch..8·ch + 7.
__device__ __forceinline__ void chunk_at(int c, int& r, int& ch) {
  const int w = c % 128;  // 128 chunks a panel
  r = w / 2;
  ch = 2 * (c / 128) + ((w & 1) ^ ((r >> 2) & 1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // invalid rows are zero-filled (src-size 0)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// rows [r0, r0 + rows) of a bf16 matrix (row stride ld elements, `cols`
// columns, a multiple of 8) into a panel tile by cp.async; rows at or past
// `n` read as zero. All `nthreads` threads of the block take part.
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* src, size_t ld, int cols, int n, int r0,
                                          int rows, int tid, int nthreads = NT) {
  const int ch_row = cols / 8;
  for (int i = tid; i < rows * ch_row; i += nthreads) {
    const int r = i / ch_row, ch = i - r * ch_row, row = r0 + r;
    const bool valid = row < n;
    cp_async16(tile + chunk_off(r, ch, rows), valid ? src + (size_t)row * ld + 8 * ch : src, valid);
  }
}

// generic-proxy writes (cp.async, st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// a shared-memory matrix descriptor: start address, leading and stride byte
// offsets, layout type (3: 32-byte swizzle, 1: 128-byte swizzle)
constexpr uint64_t SWIZZLE_32B = 3, SWIZZLE_128B = 1;
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout = SWIZZLE_32B) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (layout << 62);
}
// K-major operand: 64 rows from `addr` (a row inside a panel), one k step
__device__ __forceinline__ uint64_t kdesc(uint32_t addr) { return desc(addr, 16, 256); }
// MN-major operand: 16 rows (k) from `addr`, output columns across the
// panels of a tile of `rows` rows
__device__ __forceinline__ uint64_t mndesc(uint32_t addr, int rows) { return desc(addr, rows * 32, 256); }

__device__ __forceinline__ void arrive() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// keeps the compiler from touching accumulators across an in-flight wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}
// a 64-column accumulator (32 floats) as the A fragments of 4 k steps
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[s][i] = pack(d[8 * s + 2 * i], d[8 * s + 2 * i + 1]);
  }
}
// the bf16 rounding residues of the same (hi + lo carry 16 significant bits)
__device__ __forceinline__ void to_a_residue(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = d[8 * s + 2 * i], y = d[8 * s + 2 * i + 1];
      a[s][i] = pack(x - __bfloat162float(__float2bfloat16_rn(x)), y - __bfloat162float(__float2bfloat16_rn(y)));
    }
  }
}

// d (N/2 floats) = [d +] A·B, m64nNk16, bf16 in, fp32 accumulate.
// mma_ss: A and B from shared memory, both K-major.
// mma_rs: A from registers, B from shared memory MN-major.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate);
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


// The rel-term slot layout shared by the bf16 kernels: a (·, KX) row holds
// rel_h's Hk terms in slots [0, Hk), zeros to HKP = Hk rounded up to 16, then
// rel_w's Wk terms from HKP, zeros to KX = HKP + Wk rounded up to 16. The 0/1
// key-to-slot matrix E (S_pad rows, a multiple of 64, by KX) has E[key][key / Wk]
// = E[key][HKP + key % Wk] = 1 for key < S and zero rows after, so a row of
// slot terms times E's row of a key is rel_h[kh] + rel_w[kw] — the rel terms
// of a score as one more product on the tensor cores (the JAX `_kernel`'s
// `ehw` expansion), and dS times E gives drh and drw.
__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) / 16 * 16; }

// whether slot chunk c (16 slots) reaches a 64-key tile through E: the
// tile's rel_h slots lie in chunks [c_lo, c_hi] (its first and last keys'
// rows / 16), every rel_w slot in chunks from HKP / 16 up to KX / 16 = nx
__device__ __forceinline__ bool touched(int c, int nx, int hkp, int c_lo, int c_hi) {
  return c < nx && (16 * c >= hkp || (c >= c_lo && c <= c_hi));
}

__global__ void fill_slots(bf16* __restrict__ e, int S, int s_pad, int wk, int hkp, int kx) {
  const int nch = kx / 8;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < s_pad * nch; i += gridDim.x * blockDim.x) {
    const int key = i / nch, c0 = 8 * (i - key * nch);
    const int kh = key / wk, kw = hkp + key - kh * wk;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 2 * j;
      const bool in = key < S;
      w[j] = ((in && (c == kh || c == kw)) ? 0x3F80u : 0u) | ((in && (c + 1 == kh || c + 1 == kw)) ? 0x3F800000u : 0u);
    }
    *reinterpret_cast<uint4*>(e + (size_t)key * kx + c0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

}  // namespace wg
