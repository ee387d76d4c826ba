"""Plain SegGPT in float32 PyTorch: the yardstick the port is held to.

Written from the published model (SegGPT, arXiv:2304.03284; the layer
equations of ``transformers``' ``modeling_seggpt.py``), not from the port:
no kernel, no fused op, no cache. It takes the benchmark's weights in the
layout the benchmark hands both sides (``x @ W`` kernels (in, out), the qkv
kernel (C, 3, C), NHWC images, the port's parameter names). Departures from
HF, all of layout: NHWC in place of NCHW, the query half of the painted
canvas is what callers read.

``Precision`` lowers every product's operands for the controls: ``fp8``
rounds both operands of each matrix product to float8 e4m3 with a scale per
tensor (amax to 448), as a bf16 model served in fp8 would; TF32 is switched
on by the caller through ``torch.backends``.

Blocks can be recomputed in the backward (``checkpoint=True``) so that a
ViT-H train step fits beside its score matrices; that changes no number.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint


class Precision:
    """Operand rounding of every product: ``None`` (fp32) or ``"fp8"``."""

    def __init__(self, kind: str | None = None):
        if kind not in (None, "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind is None:
            return x
        amax = x.detach().abs().amax().clamp(min=1e-12)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


FP32 = Precision()


def _mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec(a) @ prec(b)


def _ln(x: torch.Tensor, w: dict, name: str, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w[f"{name}.scale"] + w[f"{name}.bias"]


def _rel_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """(2·size-1, hd) → (size, size, hd): entry [i, j] = rel_pos[i - j + size - 1]."""
    idx = torch.arange(size)[:, None] - torch.arange(size)[None, :] + size - 1
    return rel_pos[idx.to(rel_pos.device)]


def attention(x: torch.Tensor, w: dict, p: str, m: dict, prec: Precision) -> torch.Tensor:
    """Global attention with decomposed relative positions (HF
    SegGptAttention): softmax(q·kᵀ/√hd + rel_h + rel_w)·v, the rel terms from
    the unscaled q."""
    b, gh, gw, c = x.shape
    nh = m["num_attention_heads"]
    hd = c // nh
    s = gh * gw
    qkv = _mm(x.reshape(b, s, c), w[f"{p}.qkv_kernel"].reshape(c, 3 * c), prec) + w[f"{p}.qkv_bias"].reshape(3 * c)
    qkv = qkv.reshape(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)  # (3, B, nH, S, hd)
    q, k, v = qkv[0], qkv[1], qkv[2]
    scores = _mm(q * hd**-0.5, k.transpose(-1, -2), prec)  # (B, nH, S, S)
    rh = _rel_table(w[f"{p}.rel_pos_h"], gh)  # (gh, gh, hd)
    rw = _rel_table(w[f"{p}.rel_pos_w"], gw)
    q5 = q.reshape(b, nh, gh, gw, hd)
    rel_h = torch.einsum("bnyxc,ykc->bnyxk", prec(q5), prec(rh))
    rel_w = torch.einsum("bnyxc,xkc->bnyxk", prec(q5), prec(rw))
    scores = scores.reshape(b, nh, gh, gw, gh, gw) + rel_h[..., :, None] + rel_w[..., None, :]
    probs = torch.softmax(scores.reshape(b, nh, s, s), dim=-1)
    out = _mm(probs, v, prec).permute(0, 2, 1, 3).reshape(b, gh, gw, c)
    return _mm(out, w[f"{p}.proj_kernel"], prec) + w[f"{p}.proj_bias"]


def mlp(x: torch.Tensor, w: dict, p: str, prec: Precision) -> torch.Tensor:
    h = F.gelu(_mm(x, w[f"{p}.lin1_kernel"], prec) + w[f"{p}.lin1_bias"])
    return _mm(h, w[f"{p}.lin2_kernel"], prec) + w[f"{p}.lin2_bias"]


def _drop(x: torch.Tensor, rate: float, keep: torch.Tensor | None) -> torch.Tensor:
    if keep is None or rate == 0.0:
        return x
    return x / (1.0 - rate) * keep.to(x.dtype).reshape(-1, 1, 1, 1)


def block(x, w: dict, i: int, m: dict, rate: float, keeps, prec: Precision) -> torch.Tensor:
    p = f"encoder.layers_{i}"
    eps = m["layer_norm_eps"]
    x = x + _drop(attention(_ln(x, w, f"{p}.layernorm_before", eps), w, f"{p}.attention", m, prec), rate, keeps[0])
    return x + _drop(mlp(_ln(x, w, f"{p}.layernorm_after", eps), w, f"{p}.mlp", prec), rate, keeps[1])


def drop_rates(m: dict) -> list[float]:
    """Stochastic depth rising linearly from 0 over the layers (HF)."""
    n = m["num_hidden_layers"]
    r = m["drop_path_rate"]
    return [r * i / (n - 1) if n > 1 else 0.0 for i in range(n)]


def embed(w: dict, m: dict, pixel_canvas: torch.Tensor, mask_canvas: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Patch embedding of both canvases, the mask token over the query half
    of the mask stream, interpolated absolute positions, segment and
    (instance) type tokens; streams stacked [pixel, mask] on the batch."""
    p = m["patch_size"]
    c = m["hidden_size"]

    def patches(x):
        b, h, wd, ch = x.shape
        t = x.reshape(b, h // p, p, wd // p, p, ch).permute(0, 1, 3, 2, 4, 5).reshape(b, h // p, wd // p, p * p * ch)
        return _mm(t, w["embeddings.patch_embeddings.kernel"], prec) + w["embeddings.patch_embeddings.bias"]

    pix, msk = patches(pixel_canvas), patches(mask_canvas)
    b, gh, gw, _ = pix.shape
    query_rows = torch.arange(gh, device=pix.device)[None, :, None, None] >= gh // 2
    msk = torch.where(query_rows, w["embeddings.mask_token"].reshape(1, 1, 1, c), msk)
    pre = m["pretrain_image_size"] // p
    pos = w["embeddings.position_embeddings"][0, 1:].reshape(1, pre, pre, c).permute(0, 3, 1, 2)
    if (pre, pre) != (gh, gw):
        pos = F.interpolate(pos, size=(gh, gw), mode="bicubic", align_corners=False)
    pos = pos.permute(0, 2, 3, 1)
    kind = w["embeddings.type_token_instance"]
    pix = pix + w["embeddings.segment_token_input"] + pos + kind
    msk = msk + w["embeddings.segment_token_prompt"] + pos + kind
    return torch.cat([pix, msk], dim=0)


def decode(w: dict, m: dict, feats: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Linear → pixel shuffle → 3×3 conv → LN → GELU → 1×1 head (HF
    SegGptDecoder), over the whole canvas."""
    p, dh = m["patch_size"], m["decoder_hidden_size"]
    b, gh, gw, _ = feats.shape
    h = _mm(feats, w["decoder.embed_kernel"], prec) + w["decoder.embed_bias"]
    h = h.reshape(b, gh, gw, p, p, dh).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * p, gw * p, dh)
    h = F.conv2d(prec(h.permute(0, 3, 1, 2)), prec(w["decoder.conv_kernel"].permute(3, 2, 0, 1)), padding=1)
    h = h.permute(0, 2, 3, 1) + w["decoder.conv_bias"]
    h = F.gelu(_ln(h, w, "decoder.layernorm", m["layer_norm_eps"]))
    return _mm(h, w["decoder.head_kernel"], prec) + w["decoder.head_bias"]


def forward(w: dict, m: dict, query: torch.Tensor, prompt: torch.Tensor, prompt_mask: torch.Tensor,
            labels: torch.Tensor | None = None, drop_keeps: list | None = None, prec: Precision = FP32,
            checkpoint: bool = False) -> torch.Tensor:
    """Normalized NHWC images (B, H, W, 3) → the painted query half (B, H, W, 3).
    ``drop_keeps``: per layer an (attention, MLP) pair of (rows,) keep masks,
    rows = 2B up to the merge; None runs without stochastic depth."""
    pixel_canvas = torch.cat([prompt, query], dim=1)
    mask_canvas = torch.cat([prompt_mask, labels if labels is not None else prompt_mask], dim=1)
    x = embed(w, m, pixel_canvas, mask_canvas, prec)
    rates = drop_rates(m)
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
    painted = decode(w, m, torch.cat(feats, dim=-1), prec)
    return painted[:, painted.shape[1] // 2:]


def palette_scores(painted: torch.Tensor, palette_norm: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) painted colors, (B, N, 3) normalized palette → (B, H, W, N)
    negative squared distances: the class with the highest score is the
    nearest color."""
    d = painted[..., None, :] - palette_norm[:, None, None, :, :]
    return -(d * d).sum(-1)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def painter_palette(num_labels: int) -> torch.Tensor:
    """Painter's fixed palette (SegGPT's inference colors): (num_labels + 1, 3)
    uint8, black first, then a grid of colors stepping down from white."""
    base = int(num_labels ** (1 / 3)) + 1
    margin = 256 // base
    rows = [(0, 0, 0)]
    for i in range(num_labels):
        rows.append((255 - i // base**2 * margin, 255 - (i % base**2) // base * margin, 255 - i % base * margin))
    return torch.tensor(rows, dtype=torch.uint8)


def paint(palette: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Class ids (B, H, W) through per-row palettes (B, N, 3) uint8 → colors in
    [0, 1] (B, H, W, 3)."""
    b = ids.shape[0]
    rows = torch.arange(b, device=ids.device)[:, None, None]
    return palette.to(ids.device)[rows, ids.long()].float() / 255.0
