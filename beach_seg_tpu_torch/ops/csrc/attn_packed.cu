// Attention over head-split q, k, v with precomputed decomposed rel-pos
// terms, merged-head output, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_packed` (beach_seg_tpu/ops/pallas_attn.py:126,
// wrapper `_pallas_attention_packed`), the attention the model takes when
// the qkv-rel kernel's head_dim-64 precondition fails (ViT-H: head_dim 80).
// Per (batch·head) bh = b·H + h, with q, k, v (S, D), rel_h (S, Hk), rel_w
// (S, Wk), S = Hk·Wk, all in the compute type:
//
//   s[r,k]   = (round(q·scale)[r]·k[k] + rel_h[r, k / Wk]) + rel_w[r, k % Wk]   (fp32)
//   p        = exp(s - rowmax)                                      (stable)
//   out[b, r, h·D : (h+1)·D] = round((Σ_k round(p[r,k])·v[k]) / Σ_k p[r,k])
//
// where round() is to the compute type (bf16 or fp32): the TPU kernel's
// rounding points. Its packed contraction ([q·scale ‖ rel_h] against
// [k ‖ onehot(k / Wk)]) and the 0/1 expansion matmul for rel_w fill MXU
// lanes; the bf16 instance here extends the score product the same way
// (slot rows against the 0/1 key-to-slot matrix E).
// The device code, its bound and design are in attn_flash.cuh (this file is
// its head-split-in, merged-out, prescaled instance).

#include "attn_flash.cuh"

// q, k, v (BH, S, D), rel_h (BH, S, hk), rel_w (BH, S, wk), S = hk·wk,
// hk, wk <= 64, D 16, 64 or 80, BH = B·H → out (B, S, H·D); all bf16; e:
// flash::slots_bytes(S, hk, wk) of scratch
extern "C" int attn_packed_bf16(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                                void* e, void* out, int BH, int S, int D, int H, int hk, int wk, float scale,
                                void* stream) {
  if (!flash::shape_ok(BH, S, H, hk, wk)) return (int)cudaErrorInvalidValue;
  return flash::launch_bf16<false, true, true>(D, q, k, v, rh, rw, e, out, BH, S, H, hk, wk, 0, 0, scale, stream);
}

// the same contract in fp32 (e unused)
extern "C" int attn_packed_f32(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                               void*, void* out, int BH, int S, int D, int H, int hk, int wk, float scale,
                               void* stream) {
  if (!flash::shape_ok(BH, S, H, hk, wk)) return (int)cudaErrorInvalidValue;
  return flash::launch_f32<false, true, true>(D, q, k, v, rh, rw, out, BH, S, H, hk, wk, 0, 0, scale, stream);
}
