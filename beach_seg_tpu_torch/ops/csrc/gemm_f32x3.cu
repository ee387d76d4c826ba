// The fp32 model's linear products (x·W and the input gradient dy·Wᵀ) in
// split TF32 on Hopper's tensor cores (sm_90a), fp32 in, fp32 out.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA's
// fp32 dot. On the card they were cuBLAS's SGEMMs with TF32 off, which run
// on the FP32 units (67 TF/s); the tune cell spent half its device time in
// them. This kernel forms each product a·b as small_a·big_b + big_a·small_b
// + big_a·big_b (tf32x3.cuh's split: big = a rounded to TF32, small = a −
// big), three wgmma products on the tensor cores, so its ceiling is 495 / 3
// = 165 TF/s and its result is fp32 to within a few ulps, not TF32.
//
// What bounds it: 3 TF32 products per multiply-add against 4 bytes an
// activation and 8 bytes a weight element (its big and small parts) read,
// 128 × 128 outputs a block: ~21 FLOP per byte from L2, so the tensor
// cores, given a deep enough ring.
//
// Operands: out (M, N) = A (M, K) · Bᵀ, with B given as its two TF32 parts,
// each (N, K) row-major: wgmma reads .tf32 operands from shared memory
// K-major only, so the caller passes the weight's parts in that orientation
// (Wᵀ's for x·W, W's as stored for dy·Wᵀ; ops/cuda_gemm.py makes them once
// per weight and keeps them). A is the activation as it is: fp32, K-major.
//
// Structure (gemm_sm90.cuh's, with fp32 tiles): warpgroup 0 is the producer
// (one thread issues the TMA loads of a ring of NS stages, each a 128 × 32
// A tile and the two 128 × 32 B parts, 48 KB, with the 128-byte swizzle),
// warpgroups 1 and 2 the consumers, rows 0-63 and 64-127 of the block's
// 128 × 128 output tile. A consumer reads its A fragment of each k step of 8
// from shared memory (the A register layout of m64nNk8: thread 4g + c of
// warp w holds rows 16w + g, 16w + g + 8 at k = c, c + 4), splits it in
// registers and issues m64n128k8 .tf32 wgmma with A from registers: the two
// small terms of the stage's four k steps first, then the four big ones.
//
// Accumulation: the tensor cores' fp32 accumulation truncates, so a stage's
// products (K = 32: 12 wgmma, 12 truncations) go into an accumulator of
// their own, which is then added into the fp32 sum on the FP32 units. A sum
// over K = 5120 inside the tensor cores would carry 1920 truncations.
//
// Tails: rows past M and k past K arrive as zeros (TMA's out-of-bounds
// fill); columns past N are formed from zero B rows and never stored. K and
// N must be multiples of 4 (TMA's 16-byte row strides). Blocks walk the
// output in groups of GROUP_M row tiles, so that a group's blocks share the
// weight's tiles in L2 (the decoder embed's parts are 671 MB at ViT-H).
//
// The bias (optional) is added in the epilogue: out = sum + bias[col], the
// same two fp32 roundings as a product followed by an add.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"
#include "tf32x3.cuh"

namespace {

using g90::bar_arrive;
using g90::bar_expect_tx;
using g90::bar_init;
using g90::bar_wait;
using g90::kdesc128;
using g90::tma_load;
using wg::smem_u32;

constexpr int BM = 128;       // rows of a block's tile (two consumer warpgroups of 64)
constexpr int BN = 128;       // columns of a block's tile
constexpr int BK = 32;        // k of a stage: one 128-byte swizzle row of fp32
constexpr int NS = 4;         // ring stages
constexpr int GROUP_M = 8;    // row tiles a group of blocks shares
constexpr int NT = g90::NT;   // a producer warpgroup and two consumer warpgroups
constexpr int TILE = BM * BK * 4;  // an A tile or one B part (BN == BM): 16 KB
constexpr int STAGE = 3 * TILE;
constexpr int ROWB = BN * 4 + 32;  // a staged output row: 8-word pad, so g's rows fall on distinct banks
constexpr size_t SMEM = (size_t)NS * STAGE + 1024;  // + alignment slack
static_assert(2 * 64 * ROWB <= NS * STAGE, "the staged output tile must fit in the ring");

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// tf32x3::split, safe at the top of the range: where rounding to nearest
// would overflow (|x| within half a TF32 ulp of the largest float), big is
// x truncated instead, so big + small == x for every finite x (the split
// ops/cuda_gemm.py gives the weights)
__device__ __forceinline__ void split_finite(float x, uint32_t& big, uint32_t& small) {
  const uint32_t u = __float_as_uint(x), r = tf32x3::round_tf32(x);
  big = ((r << 1) == 0xFF000000u && (u << 1) < 0xFF000000u) ? (u & 0xFFFFE000u) : r;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d (64 floats) [+]= A·B, m64n128k8 .tf32: A this thread's 4 registers, B
// from shared memory, K-major
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// out (M, N) = A (M, K) · Bᵀ [+ bias]: B's TF32 parts big and small, each
// (N, K); a 1-D grid of m_tiles · n_tiles blocks, KB = ceil(K / BK) stages
__global__ void __launch_bounds__(NT, 1) gemm_f32x3_kernel(const __grid_constant__ CUtensorMap ta,
                                                           const __grid_constant__ CUtensorMap tbig,
                                                           const __grid_constant__ CUtensorMap tsmall,
                                                           const float* __restrict__ bias, float* __restrict__ out,
                                                           int M, int N, int KB) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NS], empty[NS];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // block → (row tile, column tile): GROUP_M row tiles, column tile by column tile
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int per_group = GROUP_M * n_tiles, group = blockIdx.x / per_group, in_group = blockIdx.x % per_group;
  const int first = group * GROUP_M, rows = min(m_tiles - first, GROUP_M);
  const int m0 = (first + in_group % rows) * BM, n0 = (in_group / rows) * BN;
  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      bar_init(smem_u32(&full[s]), 1);
      bar_init(smem_u32(&empty[s]), 8);  // the eight consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(g90::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < KB; ++kb) {
        const int s = kb % NS;
        bar_wait(smem_u32(&empty[s]), ((kb / NS) & 1) ^ 1);
        const uint32_t fb = smem_u32(&full[s]), sa = base + s * STAGE;
        bar_expect_tx(fb, STAGE);
        tma_load(sa, &ta, kb * BK, m0, fb);
        tma_load(sa + TILE, &tbig, kb * BK, n0, fb);
        tma_load(sa + 2 * TILE, &tsmall, kb * BK, n0, fb);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(g90::CONSUMER_REGS));
  const int cw = wgi - 1, t = threadIdx.x % 128, warp = t / 32, g = (t % 32) / 4, c = t % 4;
  // byte offset in an A tile of row 64·cw + 16·warp + g at k ≡ c (mod 4); the
  // 128-byte swizzle puts 16-byte chunk j of row r at chunk j ^ (r % 8), and
  // r % 8 = g for this row and the one 8 below it (+1024 bytes)
  const uint32_t arow = (64 * cw + 16 * warp + g) * 128 + 4 * c;
  float acc[64], sum[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = sum[j] = 0.0f;
  for (int kb = 0; kb < KB; ++kb) {
    const int s = kb % NS;
    bar_wait(smem_u32(&full[s]), (kb / NS) & 1);
    const uint32_t sa = base + s * STAGE + arow, sbig = base + s * STAGE + TILE, ssmall = sbig + TILE;
    uint32_t big[4][4], small[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t lo = ((2 * ks) ^ g) << 4, hi = ((2 * ks + 1) ^ g) << 4;
      split_finite(lds(sa + lo), big[ks][0], small[ks][0]);
      split_finite(lds(sa + 1024 + lo), big[ks][1], small[ks][1]);
      split_finite(lds(sa + hi), big[ks][2], small[ks][2]);
      split_finite(lds(sa + 1024 + hi), big[ks][3], small[ks][3]);
    }
    wg::arrive();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      mma_rs(acc, small[ks], kdesc128(sbig + ks * 32), ks);  // the stage's first product starts the accumulator
      mma_rs(acc, big[ks], kdesc128(ssmall + ks * 32), 1);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_rs(acc, big[ks], kdesc128(sbig + ks * 32), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc);
    if (t % 32 == 0) bar_arrive(smem_u32(&empty[s]));
#pragma unroll
    for (int j = 0; j < 64; ++j) sum[j] += acc[j];
  }

  // epilogue through shared memory (the ring is free once both consumer
  // warpgroups are past their last stage): each warpgroup stages its 64
  // rows, then writes whole rows with 16-byte stores, masked at M and N.
  // accumulator element 4j + e: row 16·warp + g + 8·(e / 2), column 8j + 2c + e % 2
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const uint32_t stage = base + cw * 64 * ROWB;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t srow = stage + (16 * warp + g + 8 * h) * ROWB;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float2 v = make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
      if (bias) {
        // a clamp keeps the load inside the bias; those columns are never stored
        const float2 b = *reinterpret_cast<const float2*>(bias + min(n0 + 8 * j + 2 * c, N - 2));
        v.x += b.x;
        v.y += b.y;
      }
      g90::st_shared(srow + (8 * j + 2 * c) * 4, v);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
  constexpr int CHUNKS = BN * 4 / 16;  // 16-byte chunks a row
  for (int i = t; i < 64 * CHUNKS; i += 128) {
    const int r = i / CHUNKS, ch = i % CHUNKS, row = m0 + cw * 64 + r, col = n0 + ch * 4;
    if (row < M && col < N) {
      uint4 u;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                   : "r"(stage + r * ROWB + ch * 16));
      *reinterpret_cast<uint4*>(out + (size_t)row * N + col) = u;
    }
  }
}

// a (rows, cols) row-major fp32 matrix, boxes of 32 columns (one 128-byte
// swizzle row) × box_rows, out-of-bounds elements read as zero
bool encode_f32(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  g90::EncodeTiled fn = g90::encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// out (M, N) = a (M, K) · bᵀ [+ bias], b given as its TF32 parts b_big and
// b_small, each (N, K) row-major; bias (N,) or null. Every pointer 16-byte
// aligned, K % 4 == 0, N % 4 == 0.
extern "C" int gemm_f32x3(const void* a, const void* b_big, const void* b_small, const void* bias, void* out, int M,
                          int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 4) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gemm_f32x3_kernel);
  if (err != cudaSuccess) return (int)err;
  // fewer registers at launch and setmaxnreg.inc would wait for ever
  if (attr.numRegs != g90::LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(gemm_f32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap ta, tbig, tsmall;
  if (!encode_f32(&ta, a, M, K, BM) || !encode_f32(&tbig, b_big, N, K, BN) || !encode_f32(&tsmall, b_small, N, K, BN))
    return (int)cudaErrorInvalidValue;
  const int blocks = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  gemm_f32x3_kernel<<<blocks, NT, SMEM, (cudaStream_t)stream>>>(ta, tbig, tsmall, (const float*)bias, (float*)out, M,
                                                                N, (K + BK - 1) / BK);
  return (int)cudaGetLastError();
}
