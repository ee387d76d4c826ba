"""Fused LN → Lin1 → GELU → Lin2 and its input gradient (counterpart of
``pallas_mlp.fused_ln_mlp`` and its custom VJP).

Two CUDA kernels, each with a plain PyTorch version:

- :func:`ln_mlp` (``csrc/ln_mlp.cu``) replaces the TPU kernel ``_kernel``
  (``beach_seg_tpu/ops/pallas_mlp.py:37``). It is compute-bound at ViT-L
  and ViT-H (4·C·M FLOP per row); the hidden dimension streams through
  shared memory so the (rows, 4C) activations never reach device memory.
- :func:`ln_mlp_dx` (``csrc/ln_mlp_dx.cu``) replaces ``_kernel_dx``
  (``pallas_mlp.py:167``): dx only, 6·C·M FLOP per row.

Each wrapper launches its kernel for CUDA tensors and takes its plain version
only for CPU tensors; ``<wrapper>.launches`` counts kernel launches.
:func:`fused_ln_mlp` is the differentiable entry the model calls.
"""

from __future__ import annotations

import ctypes

import torch

from beach_seg_tpu_torch.ops import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_PROTO = {"ln_mlp_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P]}
_DX_PROTO = {"ln_mlp_dx_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P]}


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


def _check_kernel_args(what, x, ln_scale, ln_bias, w1, b1, w2, last):
    """The checks both kernels share; ``last`` is (name, tensor, dtype,
    shape) of the seventh argument (b2 or g)."""
    c = x.shape[-1]
    m = w1.shape[-1]
    if (c % 256 and c not in (64, 128)) or c > 1280 or m % 128:
        raise ValueError(f"{what} kernel needs C % 256 == 0 (or C 64 or 128), C <= 1280 and M % 128 == 0, got C={c}, M={m}")
    want = (
        ("x", x, torch.bfloat16, None), ("ln_scale", ln_scale, torch.float32, (c,)),
        ("ln_bias", ln_bias, torch.float32, (c,)), ("w1", w1, torch.bfloat16, (c, m)),
        ("b1", b1, torch.bfloat16, (m,)), ("w2", w2, torch.bfloat16, (m, c)), last,
    )
    for name, t, dt, shape in want:
        if t.device != x.device or t.dtype != dt or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{name}: want {shape or 'any shape'} {dt} on {x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{what} kernel needs contiguous, 32-byte aligned inputs ({name})")
    return c, m


def ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float, approx: bool) -> torch.Tensor:
    """LN → Lin1 → GELU → Lin2 on (..., C) input; returns the MLP output (no
    residual). CUDA tensors launch the kernel (bf16 x and weights, fp32 LN
    params, C % 256 == 0, C ≤ 1280, M % 128 == 0); CPU tensors take the
    plain version."""
    if x.device.type == "cpu":
        return ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, approx)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mlp takes CPU or CUDA tensors, got {x.device}")
    c, m = _check_kernel_args("ln_mlp", x, ln_scale, ln_bias, w1, b1, w2, ("b2", b2, torch.bfloat16, (x.shape[-1],)))
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


def _gelu_grad_f32(h: torch.Tensor, approx: bool) -> torch.Tensor:
    """d/dh gelu(h) in fp32 (``pallas_mlp._gelu_grad_f32``, :155-164)."""
    if approx:
        c = 0.7978845608028654  # sqrt(2/pi)
        t = torch.tanh(c * (h + 0.044715 * (h * h * h)))
        return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * h * h)
    return 0.5 * (1.0 + torch.erf(h * 0.7071067811865476)) + h * torch.exp(-0.5 * h * h) * 0.3989422804014327


def ln_mlp_dx_plain(x, ln_scale, ln_bias, w1, b1, w2, g, eps: float, approx: bool) -> torch.Tensor:
    """dx of :func:`ln_mlp_plain` for output cotangent ``g``, with the TPU
    kernel's rounding points (``pallas_mlp.py:173-199``): LN in fp32 rounded
    to x's dtype before ·w1; hpre = ln·w1 + b1 and gelu′ in fp32;
    dh = (g·w2ᵀ)∘gelu′ rounded before ·w1ᵀ; dln and the LN VJP in fp32; dx
    rounded to x's dtype."""
    dt = x.dtype
    xf = x.float()
    ls = ln_scale.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    ln = (xhat * ls + ln_bias.float()).to(dt)
    hpre = ln.float() @ w1.float() + b1.float()
    dh = (g.float() @ w2.float().transpose(0, 1)) * _gelu_grad_f32(hpre, approx)
    dln = dh.to(dt).float() @ w1.float().transpose(0, 1)
    dxhat = dln * ls
    c = x.shape[-1]
    dx = (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).sum(-1, keepdim=True) / c) * rstd
    return dx.to(dt)


def ln_mlp_dx(x, ln_scale, ln_bias, w1, b1, w2, g, eps: float, approx: bool) -> torch.Tensor:
    """Same contract as :func:`ln_mlp_dx_plain`. CUDA tensors launch the
    kernel (the forward kernel's dtypes and widths, g like x); CPU tensors
    take the plain version."""
    if x.device.type == "cpu":
        return ln_mlp_dx_plain(x, ln_scale, ln_bias, w1, b1, w2, g, eps, approx)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mlp_dx takes CPU or CUDA tensors, got {x.device}")
    c, m = _check_kernel_args("ln_mlp_dx", x, ln_scale, ln_bias, w1, b1, w2, ("g", g, torch.bfloat16, tuple(x.shape)))
    lib = build.load("ln_mlp_dx", _DX_PROTO)
    n = x.numel() // c
    dx = torch.empty_like(x)
    err = lib.ln_mlp_dx_bf16(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), g.data_ptr(), dx.data_ptr(), n, c, m, float(eps), int(approx),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "ln_mlp_dx launch")
    ln_mlp_dx.launches += 1
    return dx


ln_mlp_dx.launches = 0


class _LnMlp(torch.autograd.Function):
    """``fused_ln_mlp``'s custom VJP (``pallas_mlp.py:232-266``): saves the
    inputs only; dx from :func:`ln_mlp_dx`; the LN and weight cotangents,
    only where asked for, by autograd of :func:`ln_mlp_plain`."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, eps, approx):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.args = (eps, approx)
        return ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, approx)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        eps, approx = ctx.args
        need = ctx.needs_input_grad[:7]
        g = g.contiguous()
        dx = ln_mlp_dx(x, *params[:5], g, eps, approx) if need[0] else None
        dparams = [None] * 6
        if any(need[1:]):
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_(n) for p, n in zip(params, need[1:])]
                out = ln_mlp_plain(x.detach(), *leaves, eps, approx)
                wanted = [p for p in leaves if p.requires_grad]
                got = iter(torch.autograd.grad(out, wanted, g))
            dparams = [next(got) if p.requires_grad else None for p in leaves]
        return (dx, *dparams, None, None)


def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float, approx: bool) -> torch.Tensor:
    """The model's differentiable LN→MLP: :func:`ln_mlp` forward,
    :func:`ln_mlp_dx` backward (looked up when called, so they can be
    swapped for their plain versions)."""
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _LnMlp.apply(*args, eps, approx)
    return ln_mlp(*args, eps, approx)
