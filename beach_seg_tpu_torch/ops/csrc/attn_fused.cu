// The basic fused attention with precomputed decomposed rel-pos terms,
// head-split in and out, for Hopper (sm_90a): the library's
// `fused_attention` forward.
//
// Replaces the TPU kernel `_kernel` (beach_seg_tpu/ops/pallas_attn.py:53,
// wrapper `_pallas_attention`). Per (batch·head), with q, k, v (S, D),
// rel_h (S, Hk), rel_w (S, Wk), S = Hk·Wk, all in the compute type:
//
//   s[r,k] = (q[r]·k[k])·scale + (rel_h[r, k / Wk] + rel_w[r, k % Wk])   (fp32)
//   out[bh, r] = round(Σ_k round(p[r,k])·v[k])                           (fp32 sums)
//
// with p = softmax(s) (stable). Unlike `_kernel_packed`, q·scale is not
// rounded first: the scale multiplies the fp32 scores, and the rel terms
// are summed before they are added, as the TPU kernel's one packed 0/1
// expansion matmul adds them. The TPU kernel normalizes p before PV, which
// needs each row's sum before the first PV product; this kernel is one
// flash-style pass with an online softmax, so it rounds exp(s - running
// max) to the compute type for PV and divides the fp32 sum after it. In
// fp32 the two orders differ by a few ulps; in bf16 by at most a bf16 step
// of the output (the same trade `_kernel_packed`'s port makes for its
// running max). The device code, its bound and design are in
// attn_flash.cuh (this file is its head-split-in, head-split-out,
// post-scaled instance).

#include "attn_flash.cuh"

// q, k, v (BH, S, D), rel_h (BH, S, hk), rel_w (BH, S, wk), S = hk·wk,
// hk, wk <= 64, D 16, 64 or 80 → out (BH, S, D); all bf16; e:
// flash::slots_bytes(S, hk, wk) of scratch
extern "C" int attn_fused_bf16(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                               void* e, void* out, int BH, int S, int D, int hk, int wk, float scale,
                               void* stream) {
  if (!flash::shape_ok(BH, S, 1, hk, wk)) return (int)cudaErrorInvalidValue;
  return flash::launch_bf16<false, false, false>(D, q, k, v, rh, rw, e, out, BH, S, 1, hk, wk, 0, 0, scale,
                                                 stream);
}

// the same contract in fp32 (e unused)
extern "C" int attn_fused_f32(const void* q, const void* k, const void* v, const void* rh, const void* rw, void*,
                              void* out, int BH, int S, int D, int hk, int wk, float scale, void* stream) {
  if (!flash::shape_ok(BH, S, 1, hk, wk)) return (int)cudaErrorInvalidValue;
  return flash::launch_f32<false, false, false>(D, q, k, v, rh, rw, out, BH, S, 1, hk, wk, 0, 0, scale, stream);
}
