"""Seeded Painter weights, made on the device in one draw.

The layout is ``traffic/weights.py``'s (the port's parameter names, ``x @ W``
kernels, the qkv kernel (C, 3, C), the decoder conv HWIO) with Painter's
two differences, read from the configuration alone: a windowed block's
rel-pos tables span its window (2·w − 1, hd) and a global block's the grid,
and the embedding holds no type tokens (``type_tokens`` false). The draw is
``traffic/weights.py``'s: one ``torch.randn`` on a generator seeded with the
run's seed, cut in the shapes' order; matrices and tokens N(0, std²)
clipped at ±2σ, biases N(0, std²), LayerNorm scales 1 + N(0, std²) and
shifts N(0, std²), the decoder head's kernel at ``head_std``.
"""

from __future__ import annotations

import torch

from portbench.traffic.weights import param_shapes


def block_window(m: dict, i: int) -> int:
    """Block ``i``'s window side, 0 for a global block (or without windows)."""
    return 0 if i in m.get("global_attn_indexes", ()) else int(m.get("window_size", 0))


def painter_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    shapes = param_shapes(m)
    if not m.get("type_tokens", True):
        for t in ("type_token_semantic", "type_token_instance"):
            del shapes[f"embeddings.{t}"]
    hd = m["hidden_size"] // m["num_attention_heads"]
    for i in range(m["num_hidden_layers"]):
        win = block_window(m, i)
        if win:
            shapes[f"encoder.layers_{i}.attention.rel_pos_h"] = (2 * win - 1, hd)
            shapes[f"encoder.layers_{i}.attention.rel_pos_w"] = (2 * win - 1, hd)
    return shapes


def make_weights(m: dict, init: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """fp32 weights of the configuration ``m`` on ``device`` from ``seed``."""
    std, head_std = float(init["std"]), float(init["head_std"])
    shapes = painter_shapes(m)
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for (name, shape), chunk in zip(shapes.items(), torch.split(flat, sizes)):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            t = 1.0 + std * chunk
        elif leaf.endswith("bias"):
            t = std * chunk
        elif name == "decoder.head_kernel":
            t = head_std * chunk
        else:
            t = (std * chunk).clamp(-2 * std, 2 * std)
        out[name] = t.reshape(shape)
    return out
