"""Seeded SegGPT weights, made on the device in one draw.

The layout is the one the benchmark hands both the port and the reference:
the port's parameter names, ``x @ W`` kernels (in, out), the qkv kernel
(C, 3, C), the rel-pos tables (2·g - 1, hd), the decoder conv HWIO. It is
worked out here from the configuration's sizes alone, so the reference
needs nothing of the port to read it.

Every tensor comes from one ``torch.randn`` on a generator seeded with the
run's seed: matrices and tokens N(0, std²) clipped at ±2σ, biases N(0, std²),
LayerNorm scales 1 + N(0, std²) and shifts N(0, std²). The decoder head's
kernel takes ``head_std``: at the init's 0.02 the painted canvas is nearly
one color and the palette decode returns one class everywhere, which no
comparison of classes can read.
"""

from __future__ import annotations

import torch


def param_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    c = m["hidden_size"]
    mlp = m.get("mlp_dim") or 4 * c
    p = m["patch_size"]
    hd = c // m["num_attention_heads"]
    gh, gw = m["image_size"][0] // p, m["image_size"][1] // p
    pre = m["pretrain_image_size"] // p
    dh = m["decoder_hidden_size"]
    shapes: dict[str, tuple[int, ...]] = {}
    for t in ("mask_token", "segment_token_input", "segment_token_prompt", "type_token_semantic",
              "type_token_instance"):
        shapes[f"embeddings.{t}"] = (1, 1, 1, c)
    shapes["embeddings.position_embeddings"] = (1, pre * pre + 1, c)
    shapes["embeddings.patch_embeddings.kernel"] = (p * p * 3, c)
    shapes["embeddings.patch_embeddings.bias"] = (c,)
    shapes["encoder.layernorm.scale"] = (c,)
    shapes["encoder.layernorm.bias"] = (c,)
    for i in range(m["num_hidden_layers"]):
        b = f"encoder.layers_{i}"
        for ln in ("layernorm_before", "layernorm_after"):
            shapes[f"{b}.{ln}.scale"] = (c,)
            shapes[f"{b}.{ln}.bias"] = (c,)
        shapes[f"{b}.attention.qkv_kernel"] = (c, 3, c)
        shapes[f"{b}.attention.qkv_bias"] = (3, c)
        shapes[f"{b}.attention.rel_pos_h"] = (2 * gh - 1, hd)
        shapes[f"{b}.attention.rel_pos_w"] = (2 * gw - 1, hd)
        shapes[f"{b}.attention.proj_kernel"] = (c, c)
        shapes[f"{b}.attention.proj_bias"] = (c,)
        shapes[f"{b}.mlp.lin1_kernel"] = (c, mlp)
        shapes[f"{b}.mlp.lin1_bias"] = (mlp,)
        shapes[f"{b}.mlp.lin2_kernel"] = (mlp, c)
        shapes[f"{b}.mlp.lin2_bias"] = (c,)
    n_int = len(m["intermediate_hidden_state_indices"])
    shapes["decoder.embed_kernel"] = (c * n_int, p * p * dh)
    shapes["decoder.embed_bias"] = (p * p * dh,)
    shapes["decoder.conv_kernel"] = (3, 3, dh, dh)
    shapes["decoder.conv_bias"] = (dh,)
    shapes["decoder.layernorm.scale"] = (dh,)
    shapes["decoder.layernorm.bias"] = (dh,)
    shapes["decoder.head_kernel"] = (dh, 3)
    shapes["decoder.head_bias"] = (3,)
    return shapes


def make_weights(m: dict, init: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """fp32 weights of the configuration ``m`` on ``device`` from ``seed``."""
    std, head_std = float(init["std"]), float(init["head_std"])
    shapes = param_shapes(m)
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
