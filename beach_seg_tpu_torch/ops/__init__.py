"""Resizes, the attention oracle, and the hand-written CUDA kernels
(``cuda_attn``, ``cuda_mlp``; sources in ``csrc/``, built by ``build``)."""
