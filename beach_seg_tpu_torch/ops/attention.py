"""Global self-attention with MViTv2 decomposed relative position bias
(counterpart of ``beach_seg_tpu/ops/attention.py``).

``attention_reference`` (fp32 softmax) is the numerics oracle for every
attention kernel of the port. The bias decomposes as
``bias[q, k] = q·Rh[qh, kh] + q·Rw[qw, kw]``: two small terms per query row.

``attention_packed_plain`` is the plain version of the JAX package's
``_kernel_packed`` (``beach_seg_tpu/ops/pallas_attn.py:126``), the
attention the model takes when the qkv-rel kernel's preconditions fail (any
head_dim other than 64, such as ViT-H's 80). Its CUDA port is
``ops.cuda_attn.attn_packed``; the model reaches both through
``ops.cuda_attn.packed_attention``, with the JAX package's custom VJP.

``attention_bwd_plain`` is the plain version of the backward kernel
``_bwd_kernel`` (``pallas_attn.py:722``), whose CUDA port is
``ops.cuda_attn.attn_bwd``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from beach_seg_tpu_torch.ops.resize import resize_1d


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(L, head_dim) table → (q_size, k_size, head_dim) lookup.

    Matches HF modeling_seggpt.py:237-267: linear-interpolate the table to
    2*max(q,k)-1 entries, then index by scaled relative coordinates (fp32
    coordinates truncated to int, as the JAX package computes them).
    """
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize_1d(rel_pos, max_rel_dist, "linear_torch")
    q_coords = torch.arange(q_size, dtype=torch.float32)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, dtype=torch.float32)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.to(torch.int64).to(rel_pos.device)]


def rel_pos_terms(
    q: torch.Tensor,
    rel_pos_h: torch.Tensor,
    rel_pos_w: torch.Tensor,
    q_hw: tuple[int, int],
    k_hw: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B*, S_q, head_dim) → rel_h (B*, Hq, Wq, Hk), rel_w (B*, Hq, Wq, Wk)."""
    hq, wq = q_hw
    hk, wk = k_hw
    rh = get_rel_pos(hq, hk, rel_pos_h)
    rw = get_rel_pos(wq, wk, rel_pos_w)
    # an interpolated table comes back in fp32; promote as JAX does
    dt = torch.promote_types(q.dtype, rh.dtype)
    qr = q.reshape(q.shape[0], hq, wq, q.shape[-1]).to(dt)
    rel_h = torch.einsum("bhwc,hkc->bhwk", qr, rh.to(dt))
    rel_w = torch.einsum("bhwc,wkc->bhwk", qr, rw.to(dt))
    return rel_h, rel_w


def rel_tables_padded(
    rel_pos_h: torch.Tensor,
    rel_pos_w: torch.Tensor,
    q_hw: tuple[int, int],
    k_hw: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Interpolated rel-pos lookup tables zero-padded to 64 key slots — the
    operands of the qkv-rel attention kernel. Returns (Hq, 64, hd), (Wq, 64, hd)."""
    hq, wq = q_hw
    hk, wk = k_hw
    if hk > 64 or wk > 64:
        raise ValueError(f"key grid {(hk, wk)} exceeds the 64 padded slots")
    rh = get_rel_pos(hq, hk, rel_pos_h)  # (hq, hk, hd)
    rw = get_rel_pos(wq, wk, rel_pos_w)  # (wq, wk, hd)
    return F.pad(rh, (0, 0, 0, 64 - hk)), F.pad(rw, (0, 0, 0, 64 - wk))


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: torch.Tensor | None,
    rel_w: torch.Tensor | None,
    scale: float,
) -> torch.Tensor:
    """q/k/v: (B*, S, head_dim); rel terms from :func:`rel_pos_terms`.

    Softmax is computed in fp32 whatever the input dtype (parity with HF
    modeling_seggpt.py:332)."""
    b, s_q, _ = q.shape
    s_k = k.shape[1]
    attn = torch.einsum("bqc,bkc->bqk", q * scale, k)
    if rel_h is not None:
        hq, wq, hk = rel_h.shape[1], rel_h.shape[2], rel_h.shape[3]
        wk = rel_w.shape[3]
        attn = attn.reshape(b, hq, wq, hk, wk)
        attn = attn + rel_h[..., :, None] + rel_w[..., None, :]
        attn = attn.reshape(b, s_q, s_k)
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    return torch.einsum("bqk,bkc->bqc", attn, v)


def attention_packed_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    scale: float,
    num_heads: int,
) -> torch.Tensor:
    """Plain version of ``_kernel_packed``: q/k/v (B·H, S, D), rel_h
    (B·H, S, Hk), rel_w (B·H, S, Wk) → merged heads (B, S, H·D).

    Rounding points of the TPU kernel: q·scale in the input dtype, the rel
    terms cast to it, fp32 scores, stable softmax with p rounded to v's dtype
    before PV and the row-sum division after it."""
    bh, s, d = q.shape
    wk = rel_w.shape[-1]
    dt = q.dtype
    kidx = torch.arange(s, device=q.device)
    qs = q * torch.tensor(scale, dtype=dt)
    scores = (
        qs.float() @ k.float().transpose(-1, -2)
        + rel_h.to(dt).float()[..., kidx // wk]
        + rel_w.to(dt).float()[..., kidx % wk]
    )
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    out = (p.to(v.dtype).float() @ v.float()) / p.sum(-1, keepdim=True)
    b = bh // num_heads
    return out.to(dt).reshape(b, num_heads, s, d).transpose(1, 2).reshape(b, s, num_heads * d)


def attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    g: torch.Tensor,
    scale: float,
) -> tuple[torch.Tensor, ...]:
    """Plain version of the TPU backward kernel ``_bwd_kernel``
    (``beach_seg_tpu/ops/pallas_attn.py:722``): q/k/v/g (B·H, S, D), rel_h
    (B·H, S, Hk), rel_w (B·H, S, Wk) with S = Hk·Wk → dq (q's dtype), dk, dv
    (fp32), drh, drw (the rel terms' dtype).

    Its math (``pallas_attn.py:743-786``), all in fp32: scores = (q·kᵀ)·scale
    + rel_h[kh] + rel_w[kw]; a stable softmax (whatever mode the forward
    took); dV = Pᵀg; dP = gVᵀ; dS = P∘(dP − rowsum(dP∘P)); dQ = dS·K·scale;
    dK = dSᵀ·Q·scale; drh/drw sum dS over the keys of each row / column."""
    bh, s, _ = q.shape
    hk, wk = rel_h.shape[-1], rel_w.shape[-1]
    kidx = torch.arange(s, device=q.device)
    kf = k.float()
    qf = q.float()
    scores = (qf @ kf.transpose(-1, -2)) * scale
    scores = scores + (rel_h.float()[..., kidx // wk] + rel_w.float()[..., kidx % wk])
    u = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = u / u.sum(-1, keepdim=True)
    gf = g.float()
    dv = p.transpose(-1, -2) @ gf
    dp = gf @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = ((ds @ kf) * scale).to(q.dtype)
    dk = (ds.transpose(-1, -2) @ qf) * scale
    ds4 = ds.reshape(bh, s, hk, wk)
    return dq, dk, dv, ds4.sum(-1).to(rel_h.dtype), ds4.sum(-2).to(rel_w.dtype)

