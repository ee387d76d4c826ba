// Warp-specialized TMA + wgmma products for Hopper (sm_90a), bf16 in, fp32
// accumulate, for the LN→MLP kernels (ln_mlp.cu, ln_mlp_dx.cu).
//
// One block computes a 128 × BN tile of out = Σ_p A_p · B_p (one product, or
// two side by side into two accumulators, NPROD = 2) over K in steps of 64:
//   - A_p is an (N, K) bf16 matrix, K-major (row-major, rows the output rows);
//   - B_p is a weight matrix as the model stores it: MN-major when it is
//     (K, NOUT) row-major (W1 for ln·W1, W2 for h·W2), K-major when it is
//     (NOUT, K) row-major (W2 for g·W2ᵀ, W1 for dh·W1ᵀ). No transposed copy.
// Warp roles: warpgroup 0 is the producer (setmaxnreg down to 40; one thread
// issues every TMA load), warpgroups 1 and 2 the consumers (setmaxnreg up to
// 232), rows 0-63 and 64-127 of the tile. They share a ring of NS entries
// in shared memory, each one k step of one product: a 128 × 64 A tile and a
// 64 × BN B tile, with a full and an empty mbarrier per entry (the
// producer's expect_tx arrival and TMA's byte count fill it; one arrival
// per consumer warp empties it once that warp's wgmma on it has completed).
// Each consumer issues four m64nBNk16 wgmma a ring entry, both operands from
// shared memory, and keeps one group in flight while it waits for the next
// entry. The epilogue (a functor of the including source) turns the fp32
// accumulators into the output in registers, stages it in the ring's shared
// memory and writes whole rows with 16-byte stores, masked at N and NOUT.
//
// Layout: every tile is as TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B:
// rows of 128 bytes (64 bf16), 16-byte chunk j of row r at chunk j ^ (r % 8),
// 8-row groups 1024 bytes apart, each tile 1024-byte aligned. That is
// wgmma's 128-byte-swizzle canonical layout (layout type 1) both ways:
//   K-major  (A, and B as (NOUT, K) rows): a row is one output row's 64 k;
//            stride between 8-row groups (SBO) 1024 B; a k16 step is +32 B
//            inside the swizzle row;
//   MN-major (B as (K, NOUT) rows): TMA boxes of 64 k × 64 output columns,
//            panels 8192 B apart (LBO), a k row of 64 columns is 128 B, 8-k
//            groups 1024 B apart (SBO); a k16 step is +2048 B.
// Both are wgmma.cuh's descriptor with layout type 1 (the attention kernels'
// cp.async tiles keep its 32-byte swizzle, type 3); the fences, commits and
// waits are wgmma.cuh's too. Rows at or past N arrive as zeros (TMA's
// out-of-bounds fill); the epilogue's stores skip them. Columns at or past
// NOUT (the last tile of a width not a multiple of BN) are formed as column
// NOUT − 2 is, so that no epilogue reads a bias past its end, and never stored.
//
// The TMA descriptors are encoded on the host at each call
// (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint, so no
// -lcuda) and passed as __grid_constant__ kernel parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace g90 {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;           // rows of a block's tile (two consumer warpgroups of 64)
constexpr int BK = 64;            // k of a ring entry: one 128-byte swizzle row of bf16
constexpr int NT = 384;           // a producer warpgroup and two consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;
constexpr int PANEL = 64 * BK * 2;  // an MN-major 64 k × 64 column box
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// the register count every thread must launch with so that the consumers'
// setmaxnreg.inc finds its registers: 128·40 + 256·232 = 384·168
constexpr int LAUNCH_REGS = (128 * PRODUCER_REGS + 256 * CONSUMER_REGS) / NT;

using wg::smem_u32;

// ----------------------------------------------------------------- mbarriers

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// wait for the phase of parity `parity` to complete. A wait that never ends
// (a fault of the pipeline: no load takes seconds) traps after 4 s, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 4000000000ull) {
      __trap();
    }
  }
}

// one TMA box of a 2-D tensor map into shared memory at `dst`, at element
// coordinates (c0 innermost, c1), completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------- wgmma

// K-major operand at `addr` (a 1024-aligned tile plus the k16 step's 32 B)
__device__ __forceinline__ uint64_t kdesc128(uint32_t addr) { return wg::desc(addr, 16, 1024, wg::SWIZZLE_128B); }
// MN-major operand at `addr` (a 1024-aligned tile plus the k16 step's 2048 B)
__device__ __forceinline__ uint64_t mndesc128(uint32_t addr) { return wg::desc(addr, PANEL, 1024, wg::SWIZZLE_128B); }

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, float2 v) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v.x), "f"(v.y) : "memory");
}

// d (N/2 floats) [+]= A·B, m64nNk16, A K-major, B MN-major when MN
template <int N, bool MN>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void mma_ss<128, false>(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<128, true>(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<256, false>(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<256, true>(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}


// ------------------------------------------------------------------ kernel

// bytes an output column takes (an epilogue's Out holds a column pair)
template <class Epi>
__host__ __device__ constexpr int out_bytes() {
  return (int)sizeof(typename Epi::Out) / 2;
}

template <int BN, int NPROD, int NS, class Epi>
struct Cfg {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the ring, or the staged output tile (128 rows padded by 16 bytes) if larger
  static constexpr int STAGED = BM * (BN * out_bytes<Epi>() + 16);
  static constexpr size_t SMEM = (size_t)(NS * STAGE > STAGED ? NS * STAGE : STAGED) + 1024;  // + alignment slack
};

// the four k16 products of one ring entry, committed as one group
template <int BN, bool MN>
__device__ __forceinline__ void ring_step(float (&acc)[BN / 2], uint32_t sa, uint32_t sb) {
  wg::arrive();
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
    mma_ss<BN, MN>(acc, kdesc128(sa + ks * 32), MN ? mndesc128(sb + ks * 2048) : kdesc128(sb + ks * 32), 1);
  wg::commit();
}

// out tile (blockIdx.y: 128 rows, blockIdx.x: BN columns); KB ring entries
// of each product (K / 64). Epi: Out epi(col, v), the output of columns col
// and col + 1 (a bf16 pair, or two floats) from v[p][0..1], the fp32 sums of
// product p there, col < NOUT; epi.out (row stride epi.ld elements) takes
// rows < N and columns < NOUT of it.
template <int BN, int NPROD, bool MN0, bool MN1, int NS, class Epi>
__global__ void __launch_bounds__(NT, 1) gemm_kernel(const __grid_constant__ CUtensorMap ta0,
                                                     const __grid_constant__ CUtensorMap tb0,
                                                     const __grid_constant__ CUtensorMap ta1,
                                                     const __grid_constant__ CUtensorMap tb1, int N, int NOUT, int KB,
                                                     const Epi epi) {
  using C = Cfg<BN, NPROD, NS, Epi>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NS], empty[NS];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x / 128, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int total = KB * NPROD;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      bar_init(smem_u32(&full[s]), 1);
      bar_init(smem_u32(&empty[s]), 8);  // the eight consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ring entry i: product i % NPROD, k step i / NPROD, into stage i % NS
  // once the consumers have emptied it
  auto load_entry = [&](int i) {
    const int s = i % NS, p = NPROD == 1 ? 0 : i % NPROD, k0 = (i / NPROD) * BK;
    bar_wait(smem_u32(&empty[s]), ((i / NS) & 1) ^ 1);
    const uint32_t fb = smem_u32(&full[s]), sa = base + s * C::STAGE, sb = sa + A_BYTES;
    bar_expect_tx(fb, C::STAGE);
    tma_load(sa, p ? &ta1 : &ta0, k0, m0, fb);
    if (p ? MN1 : MN0) {
#pragma unroll
      for (int q = 0; q < BN / 64; ++q) tma_load(sb + q * PANEL, p ? &tb1 : &tb0, n0 + 64 * q, k0, fb);
    } else {
      tma_load(sb, p ? &tb1 : &tb0, k0, n0, fb);
    }
  };

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0)
      for (int i = 0; i < total; ++i) load_entry(i);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = wg - 1;  // this consumer warpgroup: rows 64·cw of the tile
  float acc[NPROD][BN / 2];
#pragma unroll
  for (int p = 0; p < NPROD; ++p)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[p][j] = 0.0f;
  const uint32_t arow = cw * 64 * 128;
  const bool signals = threadIdx.x % 32 == 0;
  for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
    for (int p = 0; p < NPROD; ++p) {
      const int i = kb * NPROD + p, s = i % NS;
      bar_wait(smem_u32(&full[s]), (i / NS) & 1);
      const uint32_t sa = base + s * C::STAGE + arow, sb = base + s * C::STAGE + A_BYTES;
      if (p == 0)
        ring_step<BN, MN0>(acc[0], sa, sb);
      else
        ring_step<BN, MN1>(acc[NPROD - 1], sa, sb);
      // hand back the stage whose products are done: the previous entry's
      // (one group stays in flight), or with one stage this entry's
      int done = i - 1;
      if (NS == 1) {
        wg::wait<0>();
        done = i;
      } else {
        wg::wait<1>();
      }
      if (done >= 0 && signals) bar_arrive(smem_u32(&empty[done % NS]));
    }
  }
  wg::wait<0>();
#pragma unroll
  for (int p = 0; p < NPROD; ++p) wg::fence_regs(acc[p]);

  // epilogue through shared memory: the ring's stages are free once both
  // consumer warpgroups' last products are done (the producer has no load
  // left), so each warpgroup stages its 64 rows there (rows padded by 16
  // bytes: conflict-free), then writes whole rows with 16-byte stores.
  // accumulator element 4j + e: row 16·warp + g + 8·(e / 2), column 8j + 2c + e % 2
  constexpr int OB = out_bytes<Epi>(), ROWB = BN * OB + 16;  // bytes a column, a staged row
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int t = threadIdx.x % 128, warp = t / 32, g = (t % 32) / 4, c = t % 4;
  const uint32_t stage = base + cw * 64 * ROWB;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t srow = stage + (16 * warp + g + 8 * h) * ROWB;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float v[NPROD][2];
#pragma unroll
      for (int p = 0; p < NPROD; ++p) {
        v[p][0] = acc[p][4 * j + 2 * h];
        v[p][1] = acc[p][4 * j + 2 * h + 1];
      }
      // a clamp, not a branch: every bias load stays unconditional, so the
      // compiler issues them together (a branch here cost lin1_gelu 30%)
      st_shared(srow + (8 * j + 2 * c) * OB, epi(min(n0 + 8 * j + 2 * c, NOUT - 2), v));
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
  constexpr int CHUNKS = BN * OB / 16;  // 16-byte chunks a row
  char* out = reinterpret_cast<char*>(epi.out);
  for (int i = t; i < 64 * CHUNKS; i += 128) {
    const int r = i / CHUNKS, ch = i % CHUNKS, row = m0 + cw * 64 + r, col = n0 + ch * 16 / OB;
    if (row < N && col < NOUT) {
      uint4 u;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                   : "r"(stage + r * ROWB + ch * 16));
      *reinterpret_cast<uint4*>(out + ((size_t)row * epi.ld + col) * OB) = u;
    }
  }
}

// --------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// a (rows, cols) row-major bf16 matrix, boxes of box_cols (64: one 128-byte
// swizzle row) × box_rows, out-of-bounds elements read as zero
inline bool encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one product's operands: A (N, K) and B
struct Operands {
  const void* a;
  const void* b;
};

// launch out = Σ_p A_p · B_p (ops[0..NPROD)) over a (ceil(NOUT / BN), ceil(N / 128)) grid.
// A_p: (N, K); B_p: (K, NOUT) when MN_p, else (NOUT, K). K % 64 == 0.
template <int BN, int NPROD, bool MN0, bool MN1, int NS, class Epi>
int launch_gemm(const Operands* ops, int N, int NOUT, int K, const Epi& epi, cudaStream_t stream) {
  using C = Cfg<BN, NPROD, NS, Epi>;
  auto kernel = gemm_kernel<BN, NPROD, MN0, MN1, NS, Epi>;
  if (K % BK || NOUT % 8) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  // fewer registers at launch and setmaxnreg.inc would wait for ever
  if (attr.numRegs != LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[4];
  const bool mn[2] = {MN0, MN1};
  for (int p = 0; p < NPROD; ++p) {
    if (!encode(&maps[2 * p], ops[p].a, N, K, BM)) return (int)cudaErrorInvalidValue;
    const bool ok = mn[p] ? encode(&maps[2 * p + 1], ops[p].b, K, NOUT, BK) : encode(&maps[2 * p + 1], ops[p].b, NOUT, K, BN);
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  if (NPROD == 1) maps[2] = maps[0], maps[3] = maps[1];
  const dim3 grid((NOUT + BN - 1) / BN, (N + BM - 1) / BM);
  kernel<<<grid, NT, C::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], N, NOUT, K / BK, epi);
  return (int)cudaGetLastError();
}

}  // namespace g90
