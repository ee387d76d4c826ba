"""Plain EVA-02-L painter in float32 PyTorch: the yardstick of an EVA-02 cell.

Written from the published block (EVA-02, "EVA-02: A Visual Representation
for Neon Genesis", arXiv:2303.11331; github.com/baaivision/EVA, ``EVA-02/``:
``Attention`` with ``VisionRotaryEmbeddingFast``, ``SwiGLU``, ``Block``),
not from the port: no kernel, no fused op, no cache. A block, pre-LN:

- ``x = x + Attn(LN1(x))``: q = x·Wq + bq, k = x·Wk (no k bias), v = x·Wv +
  bv; q and k turn by the 2D rotary embedding, EVA's ``t·cos + rotate_half(t)·sin``
  with ``rotate_half`` over interleaved pairs ((a, b) → (−b, a)), the
  frequencies θ^(−2i/32) (θ = 10000, i < 16) of a 32-dim half repeated
  twice, the first half of the head dims at the token's row position and
  the second at its column position, t = index · the pretrain grid's side /
  the grid's width on both axes (``pt_seq_len`` over ``ft_seq_len``);
  softmax(q·kᵀ·hd^−0.5)·v; the inner LayerNorm over C (``inner_attn_ln``);
  the out projection;
- ``x = x + MLP(LN2(x))``: silu(x·W1 + b1) ⊙ (x·W2 + b2), the LayerNorm over
  the hidden width (``ffn_ln``), ·W3 + b3.

The painter around the blocks is SegGPT's (``reference/seggpt.py``'s
embedding with its type tokens, stream merge, intermediates and decoder;
``reference/painter.py``'s order of forward), with the grid of 14-pixel
patches. Departures from the published code, all of layout: NHWC in place
of NCHW, ``x @ W`` kernels (in, out), the qkv kernel (C, 3, C) with the q
and v biases as one (2, C) tensor (``qv_bias``), the port's parameter names
(``inner_layernorm``, ``w1``/``w2``/``w3``, ``ffn_layernorm``), no cls token
in the sequence (so no position of the RoPE is skipped). ``scores`` and
``loss_and_grad`` switch TF32 off (``painter.tf32_off``); ``Precision``
lowers every product's operands for the fp8 control.

``scores`` is ``reference/predict.py``'s and ``loss_and_grad``
``reference/train.py``'s step, each on this forward.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

from portbench.reference import augment, predict, seggpt
from portbench.reference.painter import tf32_off
from portbench.reference.seggpt import FP32, Precision, _drop, _ln, _mm
from portbench.reference.train import smooth_l1

THETA = 10000.0


def rope_cos_sin(gh: int, gw: int, step: float, hd: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """EVA's ``VisionRotaryEmbeddingFast`` tables over a (gh, gw) grid:
    (S, hd) cos and sin, float32."""
    dim = hd // 2
    freqs = 1.0 / (THETA ** (torch.arange(0, dim, 2, device=device)[: dim // 2].float() / dim))
    fy = (torch.arange(gh, device=device).float() * step)[:, None] * freqs  # (gh, dim/2)
    fx = (torch.arange(gw, device=device).float() * step)[:, None] * freqs
    fy, fx = fy.repeat_interleave(2, -1), fx.repeat_interleave(2, -1)  # '... n -> ... (n r)', r = 2
    grid = torch.cat([fy[:, None, :].expand(gh, gw, dim), fx[None, :, :].expand(gh, gw, dim)], dim=-1)
    return grid.cos().reshape(gh * gw, hd), grid.sin().reshape(gh * gw, hd)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """EVA's ``rotate_half``: pairs (d r) with r = 2, (x1, x2) → (−x2, x1)."""
    x = x.unflatten(-1, (-1, 2))
    return torch.stack((-x[..., 1], x[..., 0]), dim=-1).flatten(-2)


def attention(x: torch.Tensor, w: dict, p: str, m: dict, prec: Precision) -> torch.Tensor:
    b, gh, gw, c = x.shape
    nh = m["num_attention_heads"]
    hd = c // nh
    s = gh * gw
    qv = w[f"{p}.qv_bias"]
    bias = torch.cat([qv[0], torch.zeros_like(qv[0]), qv[1]])
    qkv = _mm(x.reshape(b, s, c), w[f"{p}.qkv_kernel"].reshape(c, 3 * c), prec) + bias
    qkv = qkv.reshape(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)  # (3, B, nH, S, hd)
    q, k, v = qkv[0], qkv[1], qkv[2]
    pt_seq_len = m["pretrain_image_size"] // m["patch_size"]
    cos, sin = rope_cos_sin(gh, gw, pt_seq_len / gw, hd, x.device)
    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin
    probs = torch.softmax(_mm(q * hd**-0.5, k.transpose(-1, -2), prec), dim=-1)
    out = _mm(probs, v, prec).permute(0, 2, 1, 3).reshape(b, gh, gw, c)
    out = _ln(out, w, f"{p}.inner_layernorm", m["layer_norm_eps"])
    return _mm(out, w[f"{p}.proj_kernel"], prec) + w[f"{p}.proj_bias"]


def mlp(x: torch.Tensor, w: dict, p: str, m: dict, prec: Precision) -> torch.Tensor:
    h = F.silu(_mm(x, w[f"{p}.w1_kernel"], prec) + w[f"{p}.w1_bias"]) * (_mm(x, w[f"{p}.w2_kernel"], prec) + w[f"{p}.w2_bias"])
    h = _ln(h, w, f"{p}.ffn_layernorm", m["layer_norm_eps"])
    return _mm(h, w[f"{p}.w3_kernel"], prec) + w[f"{p}.w3_bias"]


def block(x, w: dict, i: int, m: dict, rate: float, keeps, prec: Precision) -> torch.Tensor:
    p = f"encoder.layers_{i}"
    eps = m["layer_norm_eps"]
    x = x + _drop(attention(_ln(x, w, f"{p}.layernorm_before", eps), w, f"{p}.attention", m, prec), rate, keeps[0])
    return x + _drop(mlp(_ln(x, w, f"{p}.layernorm_after", eps), w, f"{p}.mlp", m, prec), rate, keeps[1])


def forward(w: dict, m: dict, query: torch.Tensor, prompt: torch.Tensor, prompt_mask: torch.Tensor,
            labels: torch.Tensor | None = None, drop_keeps: list | None = None, prec: Precision = FP32,
            checkpoint: bool = False) -> torch.Tensor:
    """Normalized NHWC images (B, H, W, 3) → the painted query half (B, H, W, 3);
    ``drop_keeps`` as ``seggpt.forward`` takes them."""
    pixel_canvas = torch.cat([prompt, query], dim=1)
    mask_canvas = torch.cat([prompt_mask, labels if labels is not None else prompt_mask], dim=1)
    x = seggpt.embed(w, m, pixel_canvas, mask_canvas, prec)
    rates = seggpt.drop_rates(m)
    feats = []
    for i in range(m["num_hidden_layers"]):
        keeps = drop_keeps[i] if drop_keeps is not None else (None, None)
        if checkpoint and torch.is_grad_enabled():
            x = _checkpoint(block, x, w, i, m, rates[i], keeps, prec, use_reentrant=False)
        else:
            x = block(x, w, i, m, rates[i], keeps, prec)
        if i == m["merge_index"]:
            half = x.shape[0] // 2
            x = (x[:half] + x[half:]) * 0.5
        if i in m["intermediate_hidden_state_indices"]:
            feats.append(_ln(x, w, "encoder.layernorm", m["layer_norm_eps"]))
    painted = seggpt.decode(w, m, torch.cat(feats, dim=-1), prec)
    return painted[:, painted.shape[1] // 2:]


def loss_and_grad(w: dict, model: dict, run: dict, aug: dict, pixels: torch.Tensor, prompt_masks, prompt_nodata,
                  batch: dict, draws: dict, prec: Precision = FP32):
    """→ (loss, d loss / d pixels) of one prompt-tuning step on ``batch``
    under ``draws``, as ``reference/train.py``'s ``loss_and_grad`` on this
    forward, TF32 off."""
    tf32_off()
    palette = draws["palette"]
    q_img, q_mask, _ = augment.train_augment(batch["image"], batch["mask"], batch["nodata"], draws["aug_q"], aug)
    q_mask = torch.where(batch["valid"][:, None, None], q_mask, torch.zeros_like(q_mask))
    labels = seggpt.normalize(seggpt.paint(palette, q_mask))
    idx = draws["prompt_idx"].long()
    with torch.enable_grad():
        leaf = pixels.detach().clone().requires_grad_(True)
        p_img, p_mask, _ = augment.train_augment(leaf[idx], prompt_masks[idx], prompt_nodata[idx], draws["aug_p"], aug)
        p_color = seggpt.normalize(seggpt.paint(palette, p_mask))
        pred = forward(w, model, q_img, p_img, p_color, labels=labels, drop_keeps=draws["drop_masks"], prec=prec,
                       checkpoint=True)
        keep = (q_mask != 0).float()[..., None]
        loss = (smooth_l1(pred - labels, run["loss_beta"]) * keep).sum() / (keep.sum() * 3).clamp(min=1.0)
        (grad,) = torch.autograd.grad(loss, leaf)
    return loss.detach(), grad


def scores(w: dict, m: dict, run: dict, batch: dict, prompts: tuple, device, prec: Precision = FP32) -> torch.Tensor:
    """(B, out, out, N) class scores of ``batch``'s crops at the served
    pixels, as ``reference/predict.py``'s ``scores`` on this forward, TF32
    off."""
    tf32_off()
    size, out = run["inpt_size"], run["crop_size"]
    q = torch.as_tensor(predict.resize_bicubic_u8(batch["image_u8"], size), device=device).float() / 255.0
    idx = torch.as_tensor(batch["crop_idx"], device=device).long()
    px, pm, _ = (torch.as_tensor(a, device=device) for a in prompts)
    palette = seggpt.painter_palette(len(run["classes"]) - 1).to(device)
    pal = palette[None].expand(len(idx), *palette.shape)
    p_color = seggpt.normalize(seggpt.paint(pal, pm[idx]))
    with torch.inference_mode():
        painted = forward(w, m, seggpt.normalize(q), seggpt.normalize(px[idx].float()), p_color, prec=prec)
        s = seggpt.palette_scores(painted, seggpt.normalize(pal.float() / 255.0))
    sel = torch.as_tensor((np.arange(out) * size) // out, device=device)
    return s.index_select(1, sel).index_select(2, sel)
