"""Fused LN → Lin1 → GELU → Lin2: the CUDA kernel ``csrc/ln_mlp.cu`` and its
plain PyTorch version (counterpart of ``pallas_mlp.fused_ln_mlp``).

Replaces the TPU kernel ``_kernel`` (``beach_seg_tpu/ops/pallas_mlp.py:37``).
It is compute-bound at ViT-L (4·C·M FLOP per row); the kernel streams the
hidden dimension through shared memory so the (rows, 4C) activations never
reach device memory (see the source's header).

:func:`ln_mlp` launches the kernel for CUDA tensors and takes
:func:`ln_mlp_plain` only for CPU tensors. ``ln_mlp.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from beach_seg_tpu_torch.ops import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_PROTO = {"ln_mlp_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P]}


def _gelu_f32(h: torch.Tensor, approx: bool) -> torch.Tensor:
    """GELU in fp32 with ``jax.nn.gelu``'s formulas (tanh form if ``approx``)."""
    if approx:
        k = 0.7978845608028654  # sqrt(2/pi)
        return h * (0.5 * (1.0 + torch.tanh(k * (h + 0.044715 * h**3))))
    return 0.5 * h * torch.erfc(-h * 0.7071067811865476)


def ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float, approx: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch with the TPU kernel's rounding
    points (``pallas_mlp.py:38-50``): LN in fp32 rounded to x's dtype, both
    products accumulated in fp32, GELU in fp32 rounded to x's dtype."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    ln = ((xf - mean) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()).to(dt)
    h = ln.float() @ w1.float() + b1.float()
    h = _gelu_f32(h, approx).to(dt)
    y = h.float() @ w2.float() + b2.float()
    return y.to(dt)


def ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float, approx: bool) -> torch.Tensor:
    """LN → Lin1 → GELU → Lin2 on (..., C) input; returns the MLP output (no
    residual). CUDA tensors launch the kernel (bf16 x and weights, fp32 LN
    params, C % 256 == 0, C ≤ 1024, M % 128 == 0); CPU tensors take the
    plain version."""
    if x.device.type == "cpu":
        return ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, approx)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mlp takes CPU or CUDA tensors, got {x.device}")
    c = x.shape[-1]
    m = w1.shape[-1]
    if c % 256 or c > 1024 or m % 128:
        raise ValueError(f"ln_mlp kernel needs C % 256 == 0, C <= 1024 and M % 128 == 0, got C={c}, M={m}")
    want = (
        ("x", x, torch.bfloat16, None), ("ln_scale", ln_scale, torch.float32, (c,)),
        ("ln_bias", ln_bias, torch.float32, (c,)), ("w1", w1, torch.bfloat16, (c, m)),
        ("b1", b1, torch.bfloat16, (m,)), ("w2", w2, torch.bfloat16, (m, c)), ("b2", b2, torch.bfloat16, (c,)),
    )
    for name, t, dt, shape in want:
        if t.device != x.device or t.dtype != dt or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{name}: want {shape or 'any shape'} {dt} on {x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"ln_mlp kernel needs contiguous, 32-byte aligned inputs ({name})")
    lib = build.load("ln_mlp", _PROTO)
    n = x.numel() // c
    out = torch.empty_like(x)
    err = lib.ln_mlp_bf16(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, c, m, float(eps), int(approx),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "ln_mlp launch")
    ln_mlp.launches += 1
    return out


ln_mlp.launches = 0
