"""The attention entries and their gradients (counterparts of
``pallas_attn.fused_attention_qkv_rel`` and ``fused_attention_merged``, which
the model calls, and of the library's ``fused_attention`` and
``fused_attention_qkv``, with their custom VJPs).

Six CUDA kernels, each with a plain PyTorch version:

- :func:`attn_qkv_rel` (``csrc/attn_qkv_rel.cu``) replaces the TPU forward
  kernel ``_kernel_qkv_rel`` (``beach_seg_tpu/ops/pallas_attn.py:389``).
  It is compute-bound at ViT-L (two S×S×64 products per head against ~13 MB
  of qkv and output per image).
- :func:`attn_packed` (``csrc/attn_packed.cu``) replaces ``_kernel_packed``
  (``pallas_attn.py:126``): attention over head-split q, k, v with
  precomputed rel terms, merged-head output; head_dim 8 (padded to 16), 16
  (the debug backbone), 64 or 80 (ViT-H). Its plain version is
  ``ops.attention.attention_packed_plain``.
- :func:`attn_bwd` (``csrc/attn_bwd.cu``) replaces the TPU backward kernel
  ``_bwd_kernel`` (``pallas_attn.py:722``), bf16 or fp32, the same head
  dims; its plain version is ``ops.attention.attention_bwd_plain``.
- :func:`attn_fused` (``csrc/attn_fused.cu``) replaces ``_kernel``
  (``pallas_attn.py:53``): head-split in and out, the scale on the fp32
  scores; plain version ``ops.attention.attention_fused_plain``.
- :func:`attn_qkv` (``csrc/attn_qkv.cu``) replaces ``_kernel_qkv``
  (``pallas_attn.py:224``): q, k, v read in place from the (B, S, 3C) qkv
  tensor, the rel terms in per-head 64-slot layout, merged output; plain
  version ``ops.attention.attention_qkv_plain``.
- :func:`attn_qkv_rope` (``csrc/attn_qkv_rope.cu``) replaces no TPU
  kernel: EVA-02's attention (2D RoPE on q and k, q/v-only bias, no rel
  terms) as a pre-pass and #1's warp-specialized body, bf16, head_dim 64;
  plain version :func:`attn_qkv_rope_plain`, differentiable entry
  :func:`rope_attention` (backward through :func:`attn_bwd`).

Each wrapper launches its kernel for CUDA tensors and takes its plain version
only for CPU tensors; ``<wrapper>.launches`` counts kernel launches.
:func:`qkv_rel_attention` (head_dim 64) and :func:`packed_attention` (other
head dims) are the differentiable entries the model calls: a forward kernel,
and in backward the port of ``_qkv_rel_bwd`` (``pallas_attn.py:625-673``)
or of ``_merged_bwd`` (``:696-706``) around the backward kernel.
:func:`fused_attention` and :func:`fused_attention_qkv` are the library's
entries with the JAX signatures: :func:`attn_fused` or :func:`attn_qkv`
forward, :func:`attn_bwd` backward (``pallas_attn.py:840-850`` and
``_qkv_bwd`` ``:356-383``). Every entry looks its wrappers up when called,
so they can be swapped for their plain versions.
"""

from __future__ import annotations

import ctypes
import os

import torch

import torch.nn.functional as F

from beach_seg_tpu_torch.ops import build
from beach_seg_tpu_torch.ops.attention import (
    attention_bwd_plain,
    attention_fused_plain,
    attention_packed_plain,
    attention_qkv_plain,
    rope_rotate,
    split_qkv,
    unpack_rel_slots,
)
from beach_seg_tpu_torch.utils.env import env_flag
from beach_seg_tpu_torch.utils.profiling import spanned

SOFTMAX_MODES = ("stable", "clamp", "fast")

_P = ctypes.c_void_p
_I = ctypes.c_int
_PROTO = [_P] * 6 + [_I] * 6 + [ctypes.c_float, _I, _P]
_PROTO_BF16 = [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P]  # + ws's slot rows and biased k, v
_ENTRY = {torch.bfloat16: "attn_qkv_rel_bf16", torch.float32: "attn_qkv_rel_f32"}
_BWD_ENTRY = {torch.bfloat16: "attn_bwd_bf16", torch.float32: "attn_bwd_f32"}
_BWD_PROTO = [_P] * 14 + [_I, _I, _I, _I, _I, ctypes.c_float, _P]
_PACKED_ENTRY = {torch.bfloat16: "attn_packed_bf16", torch.float32: "attn_packed_f32"}
_PACKED_PROTO = [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P]
_FUSED_ENTRY = {torch.bfloat16: "attn_fused_bf16", torch.float32: "attn_fused_f32"}
_FUSED_PROTO = [_P] * 7 + [_I] * 5 + [ctypes.c_float, _P]
_QKV_ENTRY = {torch.bfloat16: "attn_qkv_bf16", torch.float32: "attn_qkv_f32"}
_QKV_PROTO = [_P] * 5 + [_I] * 6 + [ctypes.c_float, _P]
_ROPE_ENTRY = "attn_qkv_rope_bf16"
_ROPE_PROTO = [_P] * 5 + [_I] * 3 + [ctypes.c_float, _I, _P]
# head dims the packed, fused and backward attention kernels take: 16, 64 and
# 80 are instances; 8 is zero-padded to 16 (as the TPU kernel pads its
# contraction): zero columns change no score, and the extra output columns
# are dropped
HEAD_DIMS = (8, 16, 64, 80)
_PADDED_HEAD_DIM = {8: 16}


def resolve_softmax(dtype: torch.dtype) -> str:
    """The qkv-rel attention's softmax mode, in the JAX package's priority
    (``pallas_attn._resolve_softmax``): ``BEACH_SEG_TPU_ATTN_SOFTMAX`` =
    stable | clamp | fast, then ``BEACH_SEG_TPU_ATTN_NO_MAX`` (→ fast), then
    the dtype: ``clamp`` under bf16 (exact while row-max logits stay below
    80, one pass), ``stable`` otherwise."""
    mode = os.environ.get("BEACH_SEG_TPU_ATTN_SOFTMAX", "")
    if mode in SOFTMAX_MODES:
        return mode
    if env_flag("BEACH_SEG_TPU_ATTN_NO_MAX"):
        return "fast"
    return "clamp" if dtype == torch.bfloat16 else "stable"


def pad_head_dim(x: torch.Tensor, d: int) -> torch.Tensor:
    """x (..., D) zero-padded to (..., d), contiguous."""
    return F.pad(x, (0, d - x.shape[-1])).contiguous()


def _check_operands(name: str, ref: torch.Tensor, operands, cast=()) -> None:
    """Raise the ``name`` kernel's ``TypeError`` unless ``ref`` is bf16 or
    fp32, and its ``ValueError`` unless each (operand, tensor, shape) of
    ``operands`` is on ``ref``'s device in ``ref``'s dtype with that shape,
    contiguous and 16-byte aligned; those of ``cast`` need only the device
    and the shape (the wrapper casts them to the dtype and copies them
    contiguous)."""
    dt = ref.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel takes bf16 or fp32, got {dt}")
    for op, t, shape in operands:
        if t.device != ref.device or t.dtype != dt or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name} kernel takes its operands all bf16 or all fp32; {op}: want {tuple(shape)} {dt} on "
                f"{ref.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs contiguous, 16-byte aligned inputs ({op})")
    for op, t, shape in cast:
        if t.device != ref.device or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name} kernel: {op}: want {tuple(shape)} on {ref.device}, got {tuple(t.shape)} on {t.device}"
            )


def _ptrs(scratch: tuple[torch.Tensor, ...], n: int) -> list:
    """The scratch tensors' pointers, or ``n`` null pointers where there are
    none (the fp32 instances take none); the caller keeps the tensors alive
    across the launch."""
    return [t.data_ptr() for t in scratch] if scratch else [None] * n


def _slots_scratch(s: int, hk: int, wk: int, device, rows: int = 0) -> tuple[torch.Tensor, ...]:
    """The bf16 kernels' rel-slot scratch (``csrc/wgmma.cuh``): the 0/1
    key-to-slot matrix (S rounded up to 64, KX) and, for ``rows`` > 0, the
    packed slot rows (rows, KX); KX is Hk and Wk each rounded up to 16."""
    kx = -(-hk // 16) * 16 + -(-wk // 16) * 16
    e = torch.empty((-(-s // 64) * 64, kx), dtype=torch.bfloat16, device=device)
    return (e, torch.empty((rows, kx), dtype=torch.bfloat16, device=device)) if rows else (e,)


def _ws_scratch(b: int, h: int, s: int, hk: int, wk: int, device) -> tuple[torch.Tensor, ...]:
    """#1 bf16's scratch (``csrc/attn_ws.cuh``): E, the slot rows of every
    query row (B·H·S, KX) and the biased k and v (2, B·H, S, 64)."""
    return (*_slots_scratch(s, hk, wk, device, rows=b * h * s),
            torch.empty((2, b * h, s, 64), dtype=torch.bfloat16, device=device))


def attn_qkv_rel_plain(
    qkv4: torch.Tensor,
    qkv_bias: torch.Tensor,
    rh_tab: torch.Tensor,
    rw_tab: torch.Tensor,
    scale: float,
    gw: int,
    num_heads: int,
    softmax: str | None = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the TPU kernel's rounding
    points (``pallas_attn.py:425-486``): q/k/v + bias in the dtype, rel terms
    summed in fp32 then rounded, q·scale in the dtype, fp32 scores, p rounded
    to v's dtype before PV, division after PV.

    qkv4 (B, S, 3, C), qkv_bias (3, C), rh_tab (Gh, 64, hd), rw_tab
    (Gw, 64, hd) → (B, S, C) merged heads."""
    softmax = softmax or resolve_softmax(qkv4.dtype)
    b, s, _, c = qkv4.shape
    dt = qkv4.dtype
    hd = c // num_heads
    gh = s // gw
    qkv = qkv4 + qkv_bias.to(dt)
    q, k, v = (qkv[:, :, i].reshape(b, s, num_heads, hd).transpose(1, 2) for i in range(3))
    q5 = q.reshape(b, num_heads, gh, gw, hd).float()
    slots = rh_tab.shape[1]
    rel_h = torch.einsum("bnyxc,ykc->bnyxk", q5, rh_tab.float()).to(dt).float().reshape(b, num_heads, s, slots)
    rel_w = torch.einsum("bnyxc,xkc->bnyxk", q5, rw_tab.float()).to(dt).float().reshape(b, num_heads, s, slots)
    kidx = torch.arange(s, device=qkv4.device)
    qs = q * torch.tensor(scale, dtype=dt)
    scores = qs.float() @ k.float().transpose(-1, -2) + rel_h[..., kidx // gw] + rel_w[..., kidx % gw]
    return _softmax_pv(scores, v, softmax).transpose(1, 2).reshape(b, s, c)


def _softmax_pv(scores: torch.Tensor, v: torch.Tensor, softmax: str) -> torch.Tensor:
    """fp32 scores → softmax(scores)·v in v's dtype, with the kernels'
    rounding points: p rounded to v's dtype before PV, the division after."""
    if softmax == "stable":
        p = torch.exp(scores - scores.amax(-1, keepdim=True))
        r = p.sum(-1, keepdim=True)
    elif softmax in ("clamp", "fast"):
        p = torch.exp(torch.clamp(scores, max=80.0) if softmax == "clamp" else scores)
        r = p.sum(-1, keepdim=True) + 1e-30
    else:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got {softmax!r}")
    out = (p.to(v.dtype).float() @ v.float()) / r
    return out.to(v.dtype)


@spanned("bst.kernel.attn_qkv_rel")
def attn_qkv_rel(
    qkv4: torch.Tensor,
    qkv_bias: torch.Tensor,
    rh_tab: torch.Tensor,
    rw_tab: torch.Tensor,
    scale: float,
    gw: int,
    num_heads: int,
    softmax: str | None = None,
) -> torch.Tensor:
    """Same contract as :func:`attn_qkv_rel_plain`. CUDA tensors launch the
    kernel (bf16 or fp32, head_dim 64, Gh, Gw ≤ 64); CPU tensors take the
    plain version. The softmax mode defaults to :func:`resolve_softmax`."""
    softmax = softmax or resolve_softmax(qkv4.dtype)
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got {softmax!r}")
    if qkv4.device.type == "cpu":
        return attn_qkv_rel_plain(qkv4, qkv_bias, rh_tab, rw_tab, scale, gw, num_heads, softmax)
    if qkv4.device.type != "cuda":
        raise ValueError(f"attn_qkv_rel takes CPU or CUDA tensors, got {qkv4.device}")
    b, s, three, c = qkv4.shape
    dt = qkv4.dtype
    hd = c // num_heads
    gh = s // gw
    if three != 3 or hd != 64 or hd * num_heads != c or gh * gw != s or gh > 64 or gw > 64:
        raise ValueError(f"attn_qkv_rel kernel needs head_dim 64 and a ≤64×64 grid: {tuple(qkv4.shape)}, {num_heads=}, {gw=}")
    _check_operands("attn_qkv_rel", qkv4, [("qkv4", qkv4, qkv4.shape), ("qkv_bias", qkv_bias, (3, c)),
                                           ("rh_tab", rh_tab, (gh, 64, hd)), ("rw_tab", rw_tab, (gw, 64, hd))])
    lib = build.load("attn_qkv_rel", {_ENTRY[torch.bfloat16]: _PROTO_BF16, _ENTRY[torch.float32]: _PROTO})
    out = torch.empty((b, s, c), dtype=dt, device=qkv4.device)
    scratch = _ws_scratch(b, num_heads, s, gh, gw, qkv4.device) if dt == torch.bfloat16 else ()
    err = getattr(lib, _ENTRY[dt])(
        qkv4.data_ptr(), qkv_bias.data_ptr(), rh_tab.data_ptr(), rw_tab.data_ptr(), *_ptrs(scratch, 1), out.data_ptr(),
        b, s, c, num_heads, gh, gw, float(scale), SOFTMAX_MODES.index(softmax),
        torch.cuda.current_stream(qkv4.device).cuda_stream,
    )
    build.check(err, "attn_qkv_rel launch")
    attn_qkv_rel.launches += 1
    return out


attn_qkv_rel.launches = 0


def _rope_qkv(qkv4: torch.Tensor, qv_bias: torch.Tensor, tables: torch.Tensor, num_heads: int):
    """q + bq and k rotated by the RoPE tables, v + bv, each rounded to
    qkv4's dtype, as (B, nH, S, hd) heads: the RoPE kernel's pre-pass."""
    b, s, _, c = qkv4.shape
    dt = qkv4.dtype
    heads = lambda t: t.reshape(b, s, num_heads, c // num_heads).transpose(1, 2)  # noqa: E731
    q = rope_rotate(heads(qkv4[:, :, 0] + qv_bias[0].to(dt)), tables)
    k = rope_rotate(heads(qkv4[:, :, 1]), tables)
    return q, k, heads(qkv4[:, :, 2] + qv_bias[1].to(dt))


def attn_qkv_rope_plain(
    qkv4: torch.Tensor,
    qv_bias: torch.Tensor,
    tables: torch.Tensor,
    scale: float,
    num_heads: int,
    softmax: str | None = None,
) -> torch.Tensor:
    """The RoPE attention kernel's function in plain PyTorch, at its rounding
    points: q + bq, k, v + bv in the dtype; q and k rotated in fp32
    (``ops.attention.rope_rotate``) and rounded; q·scale in the dtype; fp32
    scores; p rounded before PV, the division after.

    qkv4 (B, S, 3, C), qv_bias (2, C) (the q and v biases; k has none),
    tables (2, S, hd/2) fp32 cos and sin → (B, S, C) merged heads."""
    softmax = softmax or resolve_softmax(qkv4.dtype)
    b, s, _, c = qkv4.shape
    q, k, v = _rope_qkv(qkv4, qv_bias, tables, num_heads)
    qs = q * torch.tensor(scale, dtype=qkv4.dtype)
    return _softmax_pv(qs.float() @ k.float().transpose(-1, -2), v, softmax).transpose(1, 2).reshape(b, s, c)


@spanned("bst.kernel.attn_qkv_rope")
def attn_qkv_rope(
    qkv4: torch.Tensor,
    qv_bias: torch.Tensor,
    tables: torch.Tensor,
    scale: float,
    num_heads: int,
    softmax: str | None = None,
) -> torch.Tensor:
    """Same contract as :func:`attn_qkv_rope_plain`. CUDA tensors launch
    the kernel (``csrc/attn_qkv_rope.cu``: a pre-pass, then #1's
    warp-specialized body without rel terms; bf16, head_dim 64); CPU
    tensors take the plain version."""
    softmax = softmax or resolve_softmax(qkv4.dtype)
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got {softmax!r}")
    if qkv4.device.type == "cpu":
        return attn_qkv_rope_plain(qkv4, qv_bias, tables, scale, num_heads, softmax)
    if qkv4.device.type != "cuda":
        raise ValueError(f"attn_qkv_rope takes CPU or CUDA tensors, got {qkv4.device}")
    b, s, three, c = qkv4.shape
    if three != 3 or c != 64 * num_heads or qkv4.dtype != torch.bfloat16:
        raise ValueError(f"attn_qkv_rope kernel needs bf16 and head_dim 64: {tuple(qkv4.shape)} {qkv4.dtype}, {num_heads=}")
    _check_operands("attn_qkv_rope", qkv4, [("qkv4", qkv4, qkv4.shape), ("qv_bias", qv_bias, (2, c))],
                    cast=[("tables", tables, (2, s, 32))])
    tables = tables.float().contiguous()
    lib = build.load("attn_qkv_rope", {_ROPE_ENTRY: _ROPE_PROTO})
    out = torch.empty((b, s, c), dtype=qkv4.dtype, device=qkv4.device)
    scratch = torch.empty((3, b * num_heads, s, 64), dtype=qkv4.dtype, device=qkv4.device)  # q, k, v rotated and biased
    err = getattr(lib, _ROPE_ENTRY)(
        qkv4.data_ptr(), qv_bias.data_ptr(), tables.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, s, num_heads,
        float(scale), SOFTMAX_MODES.index(softmax), torch.cuda.current_stream(qkv4.device).cuda_stream,
    )
    build.check(err, "attn_qkv_rope launch")
    attn_qkv_rope.launches += 1
    return out


attn_qkv_rope.launches = 0


def _check_grid(name: str, tpu: str, d: int, head_dims, s: int, hk: int, wk: int, shape) -> None:
    if d not in head_dims or hk * wk != s or hk > 64 or wk > 64:
        raise ValueError(
            f"{name} kernel (port of {tpu}) takes head_dim {' or '.join(map(str, head_dims))} and "
            f"S = Hk·Wk with Hk, Wk <= 64: {tuple(shape)}, {hk=}, {wk=}"
        )


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, nH·D) merged heads → (B·nH, S, D), contiguous."""
    b, s, c = x.shape
    hd = c // num_heads
    return x.reshape(b, s, num_heads, hd).transpose(1, 2).reshape(b * num_heads, s, hd).contiguous()


def _merge_qkv_grads(dq, dk, dv, b: int, num_heads: int, dt: torch.dtype) -> torch.Tensor:
    """dq, dk, dv (B·nH, S, D) → (B, S, 3, nH·D) in dt, the qkv layout."""
    _, s, hd = dq.shape
    return (
        torch.stack([dq.to(dt), dk.to(dt), dv.to(dt)])
        .reshape(3, b, num_heads, s, hd)
        .permute(1, 3, 0, 2, 4)
        .reshape(b, s, 3, num_heads * hd)
    )


@spanned("bst.kernel.attn_packed")
def attn_packed(q, k, v, rel_h, rel_w, scale: float, num_heads: int) -> torch.Tensor:
    """Same contract as ``ops.attention.attention_packed_plain``: q/k/v
    (B·H, S, D), rel_h (B·H, S, Hk), rel_w (B·H, S, Wk) → (B, S, H·D). CUDA
    tensors launch the kernel (bf16 or fp32, head_dim 8, 16, 64 or 80, S =
    Hk·Wk with Hk, Wk ≤ 64; the rel terms are cast to q's dtype, the
    kernel's rounding point); CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, rel_h, rel_w, scale, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"attn_packed takes CPU or CUDA tensors, got {q.device}")
    bh, s, d = q.shape
    hk, wk = rel_h.shape[-1], rel_w.shape[-1]
    dt = q.dtype
    _check_grid("attn_packed", "_kernel_packed", d, HEAD_DIMS, s, hk, wk, q.shape)
    if d in _PADDED_HEAD_DIM:
        dp = _PADDED_HEAD_DIM[d]
        out = attn_packed(*(pad_head_dim(t, dp) for t in (q, k, v)), rel_h, rel_w, scale, num_heads)
        return out.reshape(bh // num_heads, s, num_heads, dp)[..., :d].reshape(bh // num_heads, s, num_heads * d)
    if bh % num_heads:
        raise ValueError(f"attn_packed: B·H = {bh} is not a multiple of {num_heads=}")
    _check_operands("attn_packed", q, [("q", q, (bh, s, d)), ("k", k, (bh, s, d)), ("v", v, (bh, s, d))],
                    cast=[("rel_h", rel_h, (bh, s, hk)), ("rel_w", rel_w, (bh, s, wk))])
    rel_h, rel_w = rel_h.to(dt).contiguous(), rel_w.to(dt).contiguous()
    lib = build.load("attn_packed", {fn: _PACKED_PROTO for fn in _PACKED_ENTRY.values()})
    out = torch.empty((bh // num_heads, s, num_heads * d), dtype=dt, device=q.device)
    scratch = _slots_scratch(s, hk, wk, q.device) if dt == torch.bfloat16 else ()
    err = getattr(lib, _PACKED_ENTRY[dt])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), *_ptrs(scratch, 1), out.data_ptr(),
        bh, s, d, num_heads, hk, wk, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "attn_packed launch")
    attn_packed.launches += 1
    return out


attn_packed.launches = 0


@spanned("bst.kernel.attn_bwd")
def attn_bwd(q, k, v, rel_h, rel_w, g, scale: float) -> tuple[torch.Tensor, ...]:
    """Same contract as ``ops.attention.attention_bwd_plain``. CUDA tensors
    launch the kernel (all six inputs bf16, or all fp32; head_dim 8, 16, 64
    or 80, S = Hk·Wk with Hk, Wk ≤ 64); CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, rel_h, rel_w, g, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attn_bwd takes CPU or CUDA tensors, got {q.device}")
    bh, s, d = q.shape
    hk, wk = rel_h.shape[-1], rel_w.shape[-1]
    _check_grid("attn_bwd", "_bwd_kernel", d, HEAD_DIMS, s, hk, wk, q.shape)
    if d in _PADDED_HEAD_DIM:
        dp = _PADDED_HEAD_DIM[d]
        dq, dk, dv, drh, drw = attn_bwd(*(pad_head_dim(t, dp) for t in (q, k, v)), rel_h, rel_w, pad_head_dim(g, dp), scale)
        return dq[..., :d].contiguous(), dk[..., :d].contiguous(), dv[..., :d].contiguous(), drh, drw
    dt = q.dtype
    _check_operands("attn_bwd", q, [("q", q, (bh, s, d)), ("k", k, (bh, s, d)), ("v", v, (bh, s, d)),
                                    ("g", g, (bh, s, d)), ("rel_h", rel_h, (bh, s, hk)), ("rel_w", rel_w, (bh, s, wk))])
    lib = build.load("attn_bwd", {fn: _BWD_PROTO for fn in _BWD_ENTRY.values()})
    dq = torch.empty_like(q)
    dk = torch.empty((bh, s, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    drh, drw = torch.empty_like(rel_h), torch.empty_like(rel_w)
    stats = torch.empty((3, bh, s), dtype=torch.float32, device=q.device)  # row max, row sum or its inverse, rowsum(dP∘P)
    scratch = _slots_scratch(s, hk, wk, q.device, rows=bh * s) if dt == torch.bfloat16 else ()
    err = getattr(lib, _BWD_ENTRY[dt])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), g.data_ptr(), *_ptrs(scratch, 2),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), drh.data_ptr(), drw.data_ptr(), stats.data_ptr(),
        bh, s, d, hk, wk, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "attn_bwd launch")
    attn_bwd.launches += 1
    return dq, dk, dv, drh, drw


attn_bwd.launches = 0


@spanned("bst.kernel.attn_fused")
def attn_fused(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """Same contract as ``ops.attention.attention_fused_plain``: q/k/v
    (B·H, S, D), rel_h (B·H, S, Hk), rel_w (B·H, S, Wk) → (B·H, S, D). CUDA
    tensors launch the kernel (bf16 or fp32, the rel terms in q's dtype,
    head_dim 8, 16, 64 or 80, S = Hk·Wk with Hk, Wk ≤ 64); CPU tensors take
    the plain version."""
    if q.device.type == "cpu":
        return attention_fused_plain(q, k, v, rel_h, rel_w, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attn_fused takes CPU or CUDA tensors, got {q.device}")
    bh, s, d = q.shape
    hk, wk = rel_h.shape[-1], rel_w.shape[-1]
    dt = q.dtype
    _check_grid("attn_fused", "_kernel", d, HEAD_DIMS, s, hk, wk, q.shape)
    if d in _PADDED_HEAD_DIM:
        out = attn_fused(*(pad_head_dim(t, _PADDED_HEAD_DIM[d]) for t in (q, k, v)), rel_h, rel_w, scale)
        return out[..., :d].contiguous()
    _check_operands("attn_fused", q, [("q", q, (bh, s, d)), ("k", k, (bh, s, d)), ("v", v, (bh, s, d)),
                                      ("rel_h", rel_h, (bh, s, hk)), ("rel_w", rel_w, (bh, s, wk))])
    lib = build.load("attn_fused", {fn: _FUSED_PROTO for fn in _FUSED_ENTRY.values()})
    out = torch.empty_like(q)
    scratch = _slots_scratch(s, hk, wk, q.device) if dt == torch.bfloat16 else ()
    err = getattr(lib, _FUSED_ENTRY[dt])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), *_ptrs(scratch, 1), out.data_ptr(),
        bh, s, d, hk, wk, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "attn_fused launch")
    attn_fused.launches += 1
    return out


attn_fused.launches = 0


@spanned("bst.kernel.attn_qkv")
def attn_qkv(qkv, rel_h64, rel_w64, scale: float, hk: int, wk: int, num_heads: int) -> torch.Tensor:
    """Same contract as ``ops.attention.attention_qkv_plain``: qkv (B, S, 3C),
    rel_h64 / rel_w64 (B, S, nH·64) → (B, S, C). CUDA tensors launch the
    kernel (bf16 or fp32, head_dim 64, S = Hk·Wk with Hk, Wk ≤ 64; the slot
    terms are cast to qkv's dtype, the kernel's rounding point); CPU tensors
    take the plain version."""
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, rel_h64, rel_w64, scale, hk, wk, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"attn_qkv takes CPU or CUDA tensors, got {qkv.device}")
    b, s, c3 = qkv.shape
    c = c3 // 3
    dt = qkv.dtype
    if c3 != 3 * c or c % num_heads:
        raise ValueError(f"attn_qkv: qkv {tuple(qkv.shape)} is not (B, S, 3·{num_heads}·head_dim)")
    _check_grid("attn_qkv", "_kernel_qkv", c // num_heads, (64,), s, hk, wk, qkv.shape)
    _check_operands("attn_qkv", qkv, [("qkv", qkv, (b, s, c3))],
                    cast=[("rel_h64", rel_h64, (b, s, num_heads * 64)), ("rel_w64", rel_w64, (b, s, num_heads * 64))])
    rel_h64, rel_w64 = rel_h64.to(dt).contiguous(), rel_w64.to(dt).contiguous()
    lib = build.load("attn_qkv", {fn: _QKV_PROTO for fn in _QKV_ENTRY.values()})
    out = torch.empty((b, s, c), dtype=dt, device=qkv.device)
    scratch = _slots_scratch(s, hk, wk, qkv.device) if dt == torch.bfloat16 else ()
    err = getattr(lib, _QKV_ENTRY[dt])(
        qkv.data_ptr(), rel_h64.data_ptr(), rel_w64.data_ptr(), *_ptrs(scratch, 1), out.data_ptr(),
        b, s, c // num_heads, num_heads, hk, wk, float(scale), torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    build.check(err, "attn_qkv launch")
    attn_qkv.launches += 1
    return out


attn_qkv.launches = 0


def _qkv_rel_bwd(qkv4, qkv_bias, rh_tab, rw_tab, g, scale, gw, num_heads, need):
    """``_qkv_rel_bwd`` (``pallas_attn.py:625-673``) around :func:`attn_bwd`:
    head split of qkv + bias, the rel terms recomputed as einsums in the
    dtype, the kernel, then the term cotangents folded onto q and (where
    ``need`` asks) the tables; dbias is the (B, S) sum of dqkv4."""
    b, s, _, c = qkv4.shape
    dt = qkv4.dtype
    hd = c // num_heads
    gh = s // gw
    bh = b * num_heads
    hk, wk = rh_tab.shape[0], rw_tab.shape[0]
    qkv = qkv4.reshape(b, s, 3 * c) + qkv_bias.reshape(3 * c).to(dt)
    q5 = qkv[..., :c].reshape(b, gh, gw, num_heads, hd)
    slots = rh_tab.shape[1]
    rel_h = torch.einsum("byxnc,ykc->bnyxk", q5, rh_tab).reshape(b, num_heads, s, slots)[..., :hk]
    rel_w = torch.einsum("byxnc,xkc->bnyxk", q5, rw_tab).reshape(b, num_heads, s, slots)[..., :wk]
    rel_h = rel_h.reshape(bh, s, hk).to(dt).contiguous()
    rel_w = rel_w.reshape(bh, s, wk).to(dt).contiguous()
    q, k, v = (t.contiguous() for t in split_qkv(qkv, num_heads))
    dq, dk, dv, drh, drw = attn_bwd(q, k, v, rel_h, rel_w, _heads(g.to(dt), num_heads), scale)
    drh5 = drh.reshape(b, num_heads, gh, gw, hk)
    drw5 = drw.reshape(b, num_heads, gh, gw, wk)
    dq_rel = torch.einsum("bnyxk,ykc->bnyxc", drh5, rh_tab[:, :hk]) + torch.einsum(
        "bnyxk,xkc->bnyxc", drw5, rw_tab[:, :wk]
    )
    dq = dq + dq_rel.reshape(bh, s, hd).to(dq.dtype)
    dqkv4 = _merge_qkv_grads(dq, dk, dv, b, num_heads, dt)
    dbias = dqkv4.float().sum((0, 1)).to(qkv_bias.dtype) if need[1] else None
    drh_tab = drw_tab = None
    if need[2]:
        drh_tab = F.pad(torch.einsum("bnyxk,byxnc->ykc", drh5, q5), (0, 0, 0, slots - hk)).to(rh_tab.dtype)
    if need[3]:
        drw_tab = F.pad(torch.einsum("bnyxk,byxnc->xkc", drw5, q5), (0, 0, 0, slots - wk)).to(rw_tab.dtype)
    return dqkv4 if need[0] else None, dbias, drh_tab, drw_tab


class _QkvRelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv4, qkv_bias, rh_tab, rw_tab, scale, gw, num_heads, softmax):
        # the JAX residuals: the kernel's inputs only (pallas_attn.py:620-622)
        ctx.save_for_backward(qkv4, qkv_bias, rh_tab, rw_tab)
        ctx.args = (scale, gw, num_heads)
        return attn_qkv_rel(qkv4, qkv_bias, rh_tab, rw_tab, scale, gw, num_heads, softmax)

    @staticmethod
    def backward(ctx, g):
        grads = _qkv_rel_bwd(*ctx.saved_tensors, g, *ctx.args, ctx.needs_input_grad[:4])
        return (*grads, None, None, None, None)


class _RopeAttention(torch.autograd.Function):
    """:func:`attn_qkv_rope` forward; the backward recomputes the rotated
    q, k and the biased v (the forward's pre-pass, in plain ops), runs
    :func:`attn_bwd` with zero rel terms over the (gh, gw) grid, and turns
    dq and dk back through the rotation's transpose."""

    @staticmethod
    def forward(ctx, qkv4, qv_bias, tables, scale, gw, num_heads, softmax):
        ctx.save_for_backward(qkv4, qv_bias, tables)
        ctx.args = (scale, gw, num_heads)
        return attn_qkv_rope(qkv4, qv_bias, tables, scale, num_heads, softmax)

    @staticmethod
    def backward(ctx, g):
        qkv4, qv_bias, tables = ctx.saved_tensors
        scale, gw, nh = ctx.args
        b, s, _, c = qkv4.shape
        dt = qkv4.dtype
        q, k, v = (t.reshape(b * nh, s, c // nh).contiguous() for t in _rope_qkv(qkv4, qv_bias, tables, nh))
        zh, zw = (torch.zeros((b * nh, s, n), dtype=dt, device=qkv4.device) for n in (s // gw, gw))
        dq, dk, dv, _, _ = attn_bwd(q, k, v, zh, zw, _heads(g.to(dt), nh), scale)
        dq, dk = rope_rotate(dq.float(), tables, -1.0), rope_rotate(dk, tables, -1.0)
        dqkv4 = _merge_qkv_grads(dq, dk, dv, b, nh, dt)
        dbias = None
        if ctx.needs_input_grad[1]:
            dbias = torch.stack([dqkv4[:, :, 0].float().sum((0, 1)), dqkv4[:, :, 2].float().sum((0, 1))])
            dbias = dbias.to(qv_bias.dtype)
        return dqkv4 if ctx.needs_input_grad[0] else None, dbias, None, None, None, None, None


def rope_attention(qkv4, qv_bias, tables, scale: float, gw: int, num_heads: int, softmax: str | None = None):
    """EVA-02's differentiable attention: :func:`attn_qkv_rope` forward,
    :func:`attn_bwd` backward over the (S // gw, gw) grid (the wrappers are
    looked up when called, so they can be swapped for their plain
    versions)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qkv4, qv_bias)):
        return _RopeAttention.apply(qkv4, qv_bias, tables, scale, gw, num_heads, softmax)
    return attn_qkv_rope(qkv4, qv_bias, tables, scale, num_heads, softmax)


def qkv_rel_attention(qkv4, qkv_bias, rh_tab, rw_tab, scale: float, gw: int, num_heads: int, softmax: str | None = None):
    """The model's differentiable attention: :func:`attn_qkv_rel` forward,
    :func:`attn_bwd` backward (the wrappers are looked up when called, so
    they can be swapped for their plain versions)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qkv4, qkv_bias, rh_tab, rw_tab)):
        return _QkvRelAttention.apply(qkv4, qkv_bias, rh_tab, rw_tab, scale, gw, num_heads, softmax)
    return attn_qkv_rel(qkv4, qkv_bias, rh_tab, rw_tab, scale, gw, num_heads, softmax)


class PackedAttention(torch.autograd.Function):
    """``fused_attention_merged`` with its custom VJP (``pallas_attn.py:679-709``):
    :func:`attn_packed` forward; the residuals are the kernel's inputs only;
    the backward un-merges the cotangent and runs :func:`attn_bwd`, with dk
    and dv cast to the inputs' dtype (``_merged_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale: float, num_heads: int):
        ctx.save_for_backward(q, k, v, rel_h, rel_w)
        ctx.scale, ctx.num_heads = scale, num_heads
        return attn_packed(q, k, v, rel_h, rel_w, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, rel_h, rel_w = ctx.saved_tensors
        dq, dk, dv, drh, drw = attn_bwd(q, k, v, rel_h, rel_w, _heads(g, ctx.num_heads), ctx.scale)
        return dq, dk.to(k.dtype), dv.to(v.dtype), drh, drw, None, None


def packed_attention(q, k, v, rel_h, rel_w, scale: float, num_heads: int):
    """The model's differentiable attention for head dims other than 64:
    :func:`attn_packed` forward, :func:`attn_bwd` backward (the wrappers are
    looked up when called, so they can be swapped for their plain
    versions)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rel_h, rel_w)):
        return PackedAttention.apply(q, k, v, rel_h, rel_w, scale, num_heads)
    return attn_packed(q, k, v, rel_h, rel_w, scale, num_heads)


class FusedAttention(torch.autograd.Function):
    """``fused_attention`` with its custom VJP (``pallas_attn.py:833-853``):
    :func:`attn_fused` forward; the residuals are the inputs only; the
    backward runs :func:`attn_bwd`, with dk and dv cast to the inputs'
    dtype."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale: float):
        ctx.save_for_backward(q, k, v, rel_h, rel_w)
        ctx.scale = scale
        return attn_fused(q, k, v, rel_h, rel_w, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, rel_h, rel_w = ctx.saved_tensors
        dq, dk, dv, drh, drw = attn_bwd(q, k, v, rel_h, rel_w, g.contiguous(), ctx.scale)
        return dq, dk.to(k.dtype), dv.to(v.dtype), drh, drw, None


def fused_attention(q, k, v, rel_h, rel_w, scale: float, hk: int, wk: int):
    """The library's fused attention with the JAX signature: q/k/v
    (B·H, S, D), rel_h (B·H, S, hk), rel_w (B·H, S, wk) → (B·H, S, D);
    :func:`attn_fused` forward, :func:`attn_bwd` backward."""
    if (rel_h.shape[-1], rel_w.shape[-1]) != (hk, wk):
        raise ValueError(f"rel terms {tuple(rel_h.shape)}, {tuple(rel_w.shape)} do not match {hk=}, {wk=}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rel_h, rel_w)):
        return FusedAttention.apply(q, k, v, rel_h, rel_w, scale)
    return attn_fused(q, k, v, rel_h, rel_w, scale)


def _qkv_bwd(qkv, rel_h64, rel_w64, g, scale, hk, wk, num_heads):
    """``_qkv_bwd`` (``pallas_attn.py:356-383``) around :func:`attn_bwd`:
    unpack q, k, v, the rel terms and the cotangent to (B·H, S, ·) once, run
    the kernel, restack dqkv and pad drh, drw back to the 64-slot layout.
    The rel terms enter in qkv's dtype, the forward kernel's rounding point
    (one dtype for all six kernel inputs)."""
    b, s, c3 = qkv.shape
    dt = qkv.dtype
    rel_h = unpack_rel_slots(rel_h64, num_heads, hk).to(dt).contiguous()
    rel_w = unpack_rel_slots(rel_w64, num_heads, wk).to(dt).contiguous()
    q, k, v = (t.contiguous() for t in split_qkv(qkv, num_heads))
    dq, dk, dv, drh, drw = attn_bwd(q, k, v, rel_h, rel_w, _heads(g.to(dt), num_heads), scale)
    dqkv = _merge_qkv_grads(dq, dk, dv, b, num_heads, dt).reshape(b, s, c3)
    drh64 = F.pad(drh.reshape(b, num_heads, s, hk).transpose(1, 2), (0, 64 - hk)).reshape(b, s, num_heads * 64)
    drw64 = F.pad(drw.reshape(b, num_heads, s, wk).transpose(1, 2), (0, 64 - wk)).reshape(b, s, num_heads * 64)
    return dqkv, drh64.to(rel_h64.dtype), drw64.to(rel_w64.dtype)


class FusedAttentionQkv(torch.autograd.Function):
    """``fused_attention_qkv`` with its custom VJP (``pallas_attn.py:339-386``):
    :func:`attn_qkv` forward; the residuals are the inputs only."""

    @staticmethod
    def forward(ctx, qkv, rel_h64, rel_w64, scale: float, hk: int, wk: int, num_heads: int):
        ctx.save_for_backward(qkv, rel_h64, rel_w64)
        ctx.args = (scale, hk, wk, num_heads)
        return attn_qkv(qkv, rel_h64, rel_w64, scale, hk, wk, num_heads)

    @staticmethod
    def backward(ctx, g):
        return (*_qkv_bwd(*ctx.saved_tensors, g, *ctx.args), None, None, None, None)


def fused_attention_qkv(qkv, rel_h64, rel_w64, scale: float, hk: int, wk: int, num_heads: int):
    """The library's transpose-free attention with the JAX signature: qkv
    (B, S, 3C) and the (B, S, nH·64) slot terms of
    ``ops.attention.rel_pos_terms_split`` → (B, S, C); :func:`attn_qkv`
    forward, :func:`attn_bwd` backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qkv, rel_h64, rel_w64)):
        return FusedAttentionQkv.apply(qkv, rel_h64, rel_w64, scale, hk, wk, num_heads)
    return attn_qkv(qkv, rel_h64, rel_w64, scale, hk, wk, num_heads)
