// Split-TF32 ("3xTF32") products on the tensor cores, for the fp32 kernels.
//
// An fp32 operand x is split into two TF32 values (10 stored mantissa bits):
//   big   = x rounded to TF32, to nearest with ties away from zero: the
//           result of cvt.rna.tf32.f32, formed with an integer add and mask
//   small = x - big, exact in fp32; the tensor cores read a .tf32 operand's
//           top 19 bits, so small enters truncated to TF32
// and a product a·b is formed as small_a·big_b + big_a·small_b + big_a·big_b
// on mma.sync m16n8k8 .tf32 with fp32 accumulation (the two small terms
// first, so they are not absorbed by the large partial sum). Each TF32
// product is exact in fp32; the terms left out are small_a·small_b and the
// truncation of the two small parts, each ≤ 2^-21 of |a·b|, so each product
// carries ~2^-21 relative error where one TF32 product carries 2^-11. The
// tensor cores' fp32 accumulation truncates, so a long sum is taken in steps
// whose results are added on the FP32 units. So this is fp32
// arithmetic to within a few ulps, not TF32: the port's device rule (TF32
// off for fp32, three decimal digits are not enough) holds. A 0/1 operand
// is exact in TF32 (its small part is 0): mma2 drops the two terms with it.
// This is the arithmetic of CUTLASS's OpMultiplyAddFastF32, which PyTorch's
// memory-efficient attention takes for fp32 on sm_80 and later.
// The split runs for every operand a warp loads, so its cost shows: on an
// H100 at ViT-L shapes the fp32 attention backward takes 14.6 ms with
// cvt.rna for both parts, 10.0 with the integer rounding of both, and 9.4
// as here (scripts/ablate_torch_kernels.py fp32).
//
// Fragments of mma.sync.aligned.m16n8k8.row.col (lane = 4·g + t):
//   A (16×8, row-major):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8×8,  k × n):      b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C/D (16×8):           c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// A C fragment is an A fragment of the next product when the k order of
// that product is taken as (2t, 2t+1) → (t, t+4): the thread's c0, c2, c1, c3
// are its a0, a1, a2, a3, and the B operand reads rows 2t and 2t+1 of each
// 8-row k group (to_a, and the B loads of the kernels that use it).

#pragma once

#include <stdint.h>

namespace tf32x3 {

// cvt.rna.tf32.f32 for finite x: half an ulp of TF32 added to the
// magnitude bits (a carry runs into the exponent), the 13 low bits cleared
__device__ __forceinline__ uint32_t round_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = round_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}
__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
  return f;
}
// an accumulator tile (c0..c3) as the A fragment of the next product (the
// k order above)
__device__ __forceinline__ FragA to_a(const float (&c)[4]) { return split_a(c[0], c[2], c[1], c[3]); }

// The head-dim index of k step kk, k index kappa (0..7), in a product that
// contracts over the head dim (S = q·kᵀ, dP = g·vᵀ and their transposes).
// Any order of that contraction will do; this one puts a thread's values of
// k steps 2p and 2p + 1 (kappa = t, t + 4) in 4 adjacent floats, one 16-byte
// shared load at pair_col (its quarter-warps on distinct banks at a row
// stride ≡ 4 mod 32 floats). A head dim of 32n + 16 ends in a 16-wide block.
template <int HD>
__device__ __forceinline__ int dperm(int kk, int kappa) {
  const int blk = kk / 4, base = 32 * blk + 2 * (kk % 2) + kappa / 4;
  return 32 * blk < HD - 16 ? base + 8 * (kappa % 4) + 4 * ((kk / 2) % 2) : base + 4 * (kappa % 4);
}
template <int HD>
__device__ __forceinline__ int pair_col(int p, int t) {
  return dperm<HD>(2 * p, t);
}

// d += a · b, one TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a · b in split TF32: the small terms, then big · big
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.small, b.big);
  mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

// d += a · e for an operand e that is exact in TF32 (0/1 values)
__device__ __forceinline__ void mma2(float (&d)[4], const FragA& a, const uint32_t (&e)[2]) {
  mma(d, a.small, e);
  mma(d, a.big, e);
}

}  // namespace tf32x3
