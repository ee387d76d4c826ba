"""Seeded EVA-02 painter weights, made on the device in one draw.

The layout is ``traffic/weights.py``'s (the port's parameter names, ``x @ W``
kernels, the qkv kernel (C, 3, C), the decoder conv HWIO) with EVA-02's block
in place of SegGPT's, read from the configuration alone: no rel-pos tables,
the q and v biases as one (2, C) ``qv_bias``, the attention's inner
LayerNorm over C, and the SwiGLU MLP (``w1``, ``w2`` (C, M), the
``ffn_layernorm`` over M, ``w3`` (M, C)). The draw is ``traffic/weights.py``'s:
one ``torch.randn`` on a generator seeded with the run's seed, cut in the
shapes' order; matrices and tokens N(0, std²) clipped at ±2σ, biases N(0,
std²), LayerNorm scales 1 + N(0, std²) and shifts N(0, std²), the decoder
head's kernel at ``head_std``.
"""

from __future__ import annotations

import torch

from portbench.traffic.weights import param_shapes


def eva02_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    base = param_shapes(m)
    c, mlp = m["hidden_size"], m["mlp_dim"]
    shapes = {k: v for k, v in base.items() if not k.startswith(("encoder.layers_", "decoder."))}
    for i in range(m["num_hidden_layers"]):
        b = f"encoder.layers_{i}"
        for ln in ("layernorm_before", "layernorm_after"):
            shapes[f"{b}.{ln}.scale"] = (c,)
            shapes[f"{b}.{ln}.bias"] = (c,)
        shapes[f"{b}.attention.qkv_kernel"] = (c, 3, c)
        shapes[f"{b}.attention.qv_bias"] = (2, c)
        shapes[f"{b}.attention.inner_layernorm.scale"] = (c,)
        shapes[f"{b}.attention.inner_layernorm.bias"] = (c,)
        shapes[f"{b}.attention.proj_kernel"] = (c, c)
        shapes[f"{b}.attention.proj_bias"] = (c,)
        for lin in ("w1", "w2"):
            shapes[f"{b}.mlp.{lin}_kernel"] = (c, mlp)
            shapes[f"{b}.mlp.{lin}_bias"] = (mlp,)
        shapes[f"{b}.mlp.ffn_layernorm.scale"] = (mlp,)
        shapes[f"{b}.mlp.ffn_layernorm.bias"] = (mlp,)
        shapes[f"{b}.mlp.w3_kernel"] = (mlp, c)
        shapes[f"{b}.mlp.w3_bias"] = (c,)
    shapes.update((k, v) for k, v in base.items() if k.startswith("decoder."))
    return shapes


def make_weights(m: dict, init: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """fp32 weights of the configuration ``m`` on ``device`` from ``seed``."""
    std, head_std = float(init["std"]), float(init["head_std"])
    shapes = eva02_shapes(m)
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
