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

``attention_fused_plain`` and ``attention_qkv_plain`` are the plain versions
of the library's other two attention kernels, ``_kernel`` (``:53``, behind
``fused_attention``) and ``_kernel_qkv`` (``:224``, behind
``fused_attention_qkv``); their CUDA ports are ``ops.cuda_attn.attn_fused``
and ``ops.cuda_attn.attn_qkv``. ``rel_pos_terms_heads``,
``rel_pos_terms_split`` and ``pack_rel_terms`` produce the rel-term layouts
those entries take.

``rope_tables`` and ``rope_rotate`` are EVA-02's 2D rotary positions
(``VisionRotaryEmbeddingFast``), which take the rel-pos bias's place in the
``rope`` block: no JAX counterpart.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from beach_seg_tpu_torch.ops.resize import resize_1d
from beach_seg_tpu_torch.utils.device import device_constant


def _rel_pos_index(q_size: int, k_size: int) -> np.ndarray:
    """(q_size, k_size) int64 table rows of :func:`get_rel_pos`: scaled
    relative coordinates in fp32, truncated to int, as the JAX package
    computes them."""
    q_coords = torch.arange(q_size, dtype=torch.float32)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, dtype=torch.float32)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel.to(torch.int64).numpy()


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(L, head_dim) table → (q_size, k_size, head_dim) lookup.

    Matches HF modeling_seggpt.py:237-267: linear-interpolate the table to
    2*max(q,k)-1 entries, then index by scaled relative coordinates
    (:func:`_rel_pos_index`). The index is copied to the table's device once
    per sizes and device (:func:`device_constant`: read-only, no autograd
    history); the gather runs there.
    """
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize_1d(rel_pos, max_rel_dist, "linear_torch")
    return rel_pos[device_constant(_rel_pos_index, q_size, k_size, device=rel_pos.device)]


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


def rel_pos_terms_heads(
    q4: torch.Tensor,
    rel_pos_h: torch.Tensor,
    rel_pos_w: torch.Tensor,
    q_hw: tuple[int, int],
    k_hw: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """The rel terms straight from the fused qkv layout: q4 (B, Hq, Wq, nH,
    head_dim), a reshape of the qkv product's q columns with no head
    transpose → rel_h (B, nH, S, Hk), rel_w (B, nH, S, Wk)."""
    hq, wq = q_hw
    hk, wk = k_hw
    b, _, _, nh, _ = q4.shape
    rh = get_rel_pos(hq, hk, rel_pos_h)
    rw = get_rel_pos(wq, wk, rel_pos_w)
    dt = torch.promote_types(q4.dtype, rh.dtype)
    q4 = q4.to(dt)
    rel_h = torch.einsum("byxnc,ykc->bnyxk", q4, rh.to(dt))
    rel_w = torch.einsum("byxnc,xkc->bnyxk", q4, rw.to(dt))
    return rel_h.reshape(b, nh, hq * wq, hk), rel_w.reshape(b, nh, hq * wq, wk)


def rel_pos_terms_split(
    q4: torch.Tensor,
    rel_pos_h: torch.Tensor,
    rel_pos_w: torch.Tensor,
    q_hw: tuple[int, int],
    k_hw: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """The rel terms in ``fused_attention_qkv``'s per-head 64-slot layout:
    q4 (B, Hq, Wq, nH, head_dim) → ``rel_h64``, ``rel_w64``, each
    (B, S, nH·64), head n's slot holding its Hk (Wk) terms zero-padded to
    64. The padding rides the lookup tables, so each einsum writes its
    output once, in (b, y, x, n, k) order."""
    hq, wq = q_hw
    hk, wk = k_hw
    b, _, _, nh, _ = q4.shape
    rh, rw = rel_tables_padded(rel_pos_h, rel_pos_w, q_hw, k_hw)
    dt = torch.promote_types(q4.dtype, rh.dtype)
    q4 = q4.to(dt)
    rel_h = torch.einsum("byxnc,ykc->byxnk", q4, rh.to(dt))
    rel_w = torch.einsum("byxnc,xkc->byxnk", q4, rw.to(dt))
    return rel_h.reshape(b, hq * wq, nh * 64), rel_w.reshape(b, hq * wq, nh * 64)


def pack_rel_terms(rel_h: torch.Tensor, rel_w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, nH, S, Hk) and (B, nH, S, Wk) → the two (B, S, nH·64) slot
    arrays of :func:`rel_pos_terms_split`."""
    b, nh, s, hk = rel_h.shape
    wk = rel_w.shape[-1]
    rh = F.pad(rel_h, (0, 64 - hk)).transpose(1, 2)
    rw = F.pad(rel_w, (0, 64 - wk)).transpose(1, 2)
    return rh.reshape(b, s, nh * 64), rw.reshape(b, s, nh * 64)


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


def attention_fused_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """Plain version of ``_kernel`` (``pallas_attn.py:53-77``): q/k/v
    (B·H, S, D), rel_h (B·H, S, Hk), rel_w (B·H, S, Wk) → (B·H, S, D).

    Rounding points of the TPU kernel: scores (q·kᵀ)·scale in fp32 (q·scale
    is not rounded first), the rel terms summed and added in fp32, a stable
    softmax normalized before PV with the probabilities rounded to v's
    dtype, PV summed in fp32 and rounded to q's dtype."""
    s = q.shape[1]
    wk = rel_w.shape[-1]
    kidx = torch.arange(s, device=q.device)
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale
    scores = scores + (rel_h.float()[..., kidx // wk] + rel_w.float()[..., kidx % wk])
    p = torch.softmax(scores, dim=-1)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def split_qkv(qkv: torch.Tensor, num_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S, 3C) → q, k, v, each (B·nH, S, head_dim)."""
    b, s, c3 = qkv.shape
    hd = c3 // 3 // num_heads
    split = qkv.reshape(b, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4).reshape(3, b * num_heads, s, hd)
    return split[0], split[1], split[2]


def unpack_rel_slots(rel64: torch.Tensor, num_heads: int, n: int) -> torch.Tensor:
    """(B, S, nH·64) slot array → (B·nH, S, n): each head's first n terms."""
    b, s, _ = rel64.shape
    return rel64.reshape(b, s, num_heads, 64)[..., :n].transpose(1, 2).reshape(b * num_heads, s, n)


def attention_qkv_plain(
    qkv: torch.Tensor,
    rel_h64: torch.Tensor,
    rel_w64: torch.Tensor,
    scale: float,
    hk: int,
    wk: int,
    num_heads: int,
) -> torch.Tensor:
    """Plain version of ``_kernel_qkv`` (``pallas_attn.py:224-273``): qkv
    (B, S, 3C) with no bias, rel_h64 / rel_w64 (B, S, nH·64) from
    :func:`rel_pos_terms_split` → merged (B, S, C).

    Its rounding points are ``_kernel_packed``'s (q·scale in the dtype, the
    slot terms cast to it, fp32 scores, a stable softmax with p rounded to
    v's dtype before PV and the row-sum division after), so it is
    :func:`attention_packed_plain` of the unpacked heads."""
    q, k, v = split_qkv(qkv, num_heads)
    rel_h = unpack_rel_slots(rel_h64, num_heads, hk)
    rel_w = unpack_rel_slots(rel_w64, num_heads, wk)
    return attention_packed_plain(q, k, v, rel_h, rel_w, scale, num_heads)


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



def rope_tables(grid: tuple[int, int], step: float, head_dim: int) -> np.ndarray:
    """EVA-02's 2D RoPE angles as (2, S, head_dim / 2) float32 cos and sin,
    one column a pair of head dims: pair j < head_dim / 4 (dims 2j, 2j+1)
    turns by the token's row position, the rest by its column position, at
    t·10000^(−2i / (head_dim / 2)) for the axis's pair i, t = index · step."""
    gh, gw = grid
    n = head_dim // 4
    freqs = 10000.0 ** (-2.0 * np.arange(n) / (head_dim // 2))
    ty = np.repeat(np.arange(gh) * step, gw)[:, None] * freqs
    tx = np.tile(np.arange(gw) * step, gh)[:, None] * freqs
    angle = np.concatenate([ty, tx], axis=1)
    return np.stack([np.cos(angle), np.sin(angle)]).astype(np.float32)


def rope_rotate(x: torch.Tensor, tables: torch.Tensor, sign: float = 1.0) -> torch.Tensor:
    """x (..., S, head_dim) rotated pair by pair, (a, b) at dims (2j, 2j+1) →
    (a·cos − b·sin, b·cos + a·sin) (EVA's ``rotate_half`` over interleaved
    pairs), in fp32 and rounded to x's dtype; ``sign`` −1 turns back (the
    transpose, for a gradient)."""
    cos, sin = tables[0], sign * tables[1]
    xf = x.float().unflatten(-1, (-1, 2))
    a, b = xf[..., 0], xf[..., 1]
    return torch.stack((a * cos - b * sin, b * cos + a * sin), dim=-1).flatten(-2).to(x.dtype)
