// Attention read in place from the fused (B, S, 3C) qkv layout, with the
// decomposed rel-pos terms precomputed in per-head 64-slot layout, merged
// (B, S, C) output, for Hopper (sm_90a): the library's `fused_attention_qkv`
// forward.
//
// Replaces the TPU kernel `_kernel_qkv` (beach_seg_tpu/ops/pallas_attn.py:224,
// wrapper `_pallas_attention_qkv`). Per (batch b, head h), with q, k, v the
// head's columns h·D of the three C-wide thirds of qkv, and rel_h, rel_w the
// first Hk / Wk entries of the head's 64-slot at h·64 of rel_h64, rel_w64
// (B, S, nH·64), all in the compute type:
//
//   s[r,k] = (round(q·scale)[r]·k[k] + rel_h[r, k / Wk]) + rel_w[r, k % Wk]   (fp32)
//   out[b, r, h·D : (h+1)·D] = round((Σ_k round(p[r,k])·v[k]) / Σ_k p[r,k])
//
// with p = exp(s - rowmax): the function of `_kernel_packed` (attn_packed.cu)
// with no head-split copy in front of it and none for the rel terms. The
// TPU kernel processes a pair of 64-wide heads per block to fill 128-lane
// stores; here each block takes one head's rows by stride (a 128-byte
// contiguous run per row in bf16). The device code, its bound and design
// are in attn_flash.cuh (this file is its merged-in, merged-out, prescaled
// instance).

#include "attn_flash.cuh"

// qkv (B, S, 3C) with C = H·D, D 64; rel_h64, rel_w64 (B, S, H·64), S =
// hk·wk, hk, wk <= 64 → out (B, S, C); all bf16; e:
// flash::slots_bytes(S, hk, wk) of scratch
extern "C" int attn_qkv_bf16(const void* qkv, const void* rh64, const void* rw64, void* e, void* out, int B, int S,
                             int D, int H, int hk, int wk, float scale, void* stream) {
  if (D != 64 || !flash::shape_ok(B * H, S, H, hk, wk)) return (int)cudaErrorInvalidValue;
  const size_t C = (size_t)H * D;
  const flash::bf16* q = (const flash::bf16*)qkv;
  return flash::launch_wg<64, true, true, true>(q, q + C, q + 2 * C, rh64, rw64, e, out, B * H, S, H, hk, wk,
                                                (int)(3 * C), H * flash::MAXG, scale, stream);
}

// the same contract in fp32 (e unused)
extern "C" int attn_qkv_f32(const void* qkv, const void* rh64, const void* rw64, void*, void* out, int B, int S,
                            int D, int H, int hk, int wk, float scale, void* stream) {
  if (D != 64 || !flash::shape_ok(B * H, S, H, hk, wk)) return (int)cudaErrorInvalidValue;
  const size_t C = (size_t)H * D;
  const float* q = (const float*)qkv;
  return flash::launch_f32<true, true, true>(64, q, q + C, q + 2 * C, rh64, rw64, out, B * H, S, H, hk, wk,
                                             (int)(3 * C), H * flash::MAXG, scale, stream);
}
