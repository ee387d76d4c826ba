"""Resizes, the attention oracle, and the hand-written CUDA kernels
(``cuda_attn``, ``cuda_mlp``; sources in ``csrc/``, built by ``build``).
The names below are the JAX package's ``ops`` exports. Its ``pallas_attn``
and ``pallas_mlp`` modules are TPU-only and have no module of that name here
(``cuda_attn`` / ``cuda_mlp`` hold their counterparts); its ``sharding``
comes with multi-GPU (ROADMAP.md §A 3)."""

from beach_seg_tpu_torch.ops.attention import attention_reference, get_rel_pos, rel_pos_terms
from beach_seg_tpu_torch.ops.cuda_attn import fused_attention
from beach_seg_tpu_torch.ops.resize import resize_1d, resize_2d, resize_matrix, resize_pil_uint8

__all__ = [
    "attention_reference",
    "fused_attention",
    "get_rel_pos",
    "rel_pos_terms",
    "resize_1d",
    "resize_2d",
    "resize_matrix",
    "resize_pil_uint8",
]
