"""qkv-rel attention: the CUDA kernel ``csrc/attn_qkv_rel.cu`` and its plain
PyTorch version (counterpart of ``pallas_attn.fused_attention_qkv_rel``).

Replaces the TPU kernel ``_kernel_qkv_rel`` (``beach_seg_tpu/ops/pallas_attn.py:389``).
It is compute-bound at ViT-L (two S×S×64 products per head against ~13 MB of
qkv and output per image); the kernel keeps scores in shared memory and runs
the products on the tensor cores (see the source's header).

:func:`attn_qkv_rel` launches the kernel for CUDA tensors and takes
:func:`attn_qkv_rel_plain` only for CPU tensors. ``attn_qkv_rel.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from beach_seg_tpu_torch.ops import build

SOFTMAX_MODES = ("stable", "clamp", "fast")

_P = ctypes.c_void_p
_I = ctypes.c_int
_PROTO = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
_ENTRY = {torch.bfloat16: "attn_qkv_rel_bf16", torch.float32: "attn_qkv_rel_f32"}


def default_softmax(dtype: torch.dtype) -> str:
    """``clamp`` under bf16 (exact while row-max logits stay below 80, one
    pass), ``stable`` otherwise — the JAX package's default by dtype
    (``pallas_attn._resolve_softmax``)."""
    return "clamp" if dtype == torch.bfloat16 else "stable"


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
    softmax = softmax or default_softmax(qkv4.dtype)
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
    if softmax == "stable":
        p = torch.exp(scores - scores.amax(-1, keepdim=True))
        r = p.sum(-1, keepdim=True)
    elif softmax in ("clamp", "fast"):
        p = torch.exp(torch.clamp(scores, max=80.0) if softmax == "clamp" else scores)
        r = p.sum(-1, keepdim=True) + 1e-30
    else:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got {softmax!r}")
    out = (p.to(dt).float() @ v.float()) / r
    return out.to(dt).transpose(1, 2).reshape(b, s, c)


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
    plain version."""
    softmax = softmax or default_softmax(qkv4.dtype)
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
    if dt not in _ENTRY:
        raise TypeError(f"attn_qkv_rel kernel takes bf16 or fp32, got {dt}")
    if three != 3 or hd != 64 or hd * num_heads != c or gh * gw != s or gh > 64 or gw > 64:
        raise ValueError(f"attn_qkv_rel kernel needs head_dim 64 and a ≤64×64 grid: {tuple(qkv4.shape)}, {num_heads=}, {gw=}")
    for name, t, shape in (("qkv_bias", qkv_bias, (3, c)), ("rh_tab", rh_tab, (gh, 64, hd)), ("rw_tab", rw_tab, (gw, 64, hd))):
        if t.device != qkv4.device or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {shape} {dt} on {qkv4.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (qkv4, qkv_bias, rh_tab, rw_tab)):
        raise ValueError("attn_qkv_rel kernel needs contiguous, 16-byte aligned inputs")
    lib = build.load("attn_qkv_rel", {fn: _PROTO for fn in _ENTRY.values()})
    out = torch.empty((b, s, c), dtype=dt, device=qkv4.device)
    err = getattr(lib, _ENTRY[dt])(
        qkv4.data_ptr(), qkv_bias.data_ptr(), rh_tab.data_ptr(), rw_tab.data_ptr(), out.data_ptr(),
        b, s, c, num_heads, gh, gw, float(scale), SOFTMAX_MODES.index(softmax),
        torch.cuda.current_stream(qkv4.device).cuda_stream,
    )
    build.check(err, "attn_qkv_rel launch")
    attn_qkv_rel.launches += 1
    return out


attn_qkv_rel.launches = 0
