"""Fused LN → Lin1 → GELU → Lin2 and its input gradient (counterpart of
``pallas_mlp.fused_ln_mlp`` and its custom VJP).

Two kernels, each with a plain PyTorch version:

- :func:`ln_mlp` (``csrc/ln_mlp.cu``) replaces the TPU kernel ``_kernel``
  (``beach_seg_tpu/ops/pallas_mlp.py:37``): 4·C·M FLOP a row,
  compute-bound at ViT-L and ViT-H.
- :func:`ln_mlp_dx` (``csrc/ln_mlp_dx.cu``) replaces ``_kernel_dx``
  (``pallas_mlp.py:167``): dx only, 6·C·M FLOP a row.

For C a multiple of 256 each is a chain of stage kernels: row passes and
warp-specialized TMA + wgmma products (``csrc/gemm_sm90.cuh``), the
intermediates in device memory at the precision the TPU kernel gives them
(ln, h, dh bf16; dln fp32). Every stage has a public wrapper and a plain
twin (``ln_rows``, ``lin1_gelu``, ``lin2``, ``dual_dh``, ``dln``,
``ln_vjp``), and the two plain versions are those chains. C = 64 or 128 (the
debug backbone) takes one narrow SIMT kernel each.

- :func:`swiglu_mlp` (``csrc/swiglu_mlp.cu``) replaces no TPU kernel: EVA-02's
  MLP, LN(C) → silu(ln·W1 + b1) ⊙ (ln·W2 + b2) → LN over the hidden width →
  ·W3 + b3, 6·C·M FLOP a row, as four stage kernels on the same products;
  plain version :func:`swiglu_mlp_plain`, differentiable entry
  :func:`fused_swiglu_mlp` (backward by autograd of the plain version).

Each wrapper launches for CUDA tensors and takes its plain version only for
CPU tensors; ``<wrapper>.launches`` counts its kernel launches
(``ln_mlp.launches`` and ``ln_mlp_dx.launches`` one a call, the stage
wrappers' one a stage kernel, from either path). The wrappers allocate
every output and scratch; a build or launch error raises.
:func:`fused_ln_mlp` is the differentiable entry the model calls.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from beach_seg_tpu_torch.ops import build, cuda_gemm
from beach_seg_tpu_torch.utils.profiling import spanned

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LN_ROWS = {"mlp_ln_rows_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P]}
_NARROW = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]
_PROTO = {
    **_LN_ROWS,
    "mlp_lin1_gelu_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mlp_lin2_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "ln_mlp_narrow_bf16": _NARROW,
}
_DX_PROTO = {
    **_LN_ROWS,
    "mlp_dual_dh_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mlp_dln_f32": [_P, _P, _P, _I, _I, _I, _P],
    "mlp_ln_vjp_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "ln_mlp_dx_narrow_bf16": _NARROW,
}
NARROW_C = (64, 128)
_SWIGLU_PROTO = {
    **_LN_ROWS,
    "swiglu_dual_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "swiglu_ln_wide_bf16": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "swiglu_out_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
}
WIDE_MAX = 2816  # the hidden width the LN over it takes: 11 chunks of 8 a lane


def swiglu_takes(c: int, m: int) -> bool:
    """Whether :func:`swiglu_mlp`'s kernels take width ``c`` and hidden width ``m``."""
    return c % 256 == 0 and c <= 1280 and m <= WIDE_MAX and m % 2 == 0


def _gelu_f32(h: torch.Tensor, approx: bool) -> torch.Tensor:
    """GELU in fp32 with ``jax.nn.gelu``'s formulas (tanh form if ``approx``)."""
    if approx:
        k = 0.7978845608028654  # sqrt(2/pi)
        return h * (0.5 * (1.0 + torch.tanh(k * (h + 0.044715 * h**3))))
    return 0.5 * h * torch.erfc(-h * 0.7071067811865476)


def _gelu_grad_f32(h: torch.Tensor, approx: bool) -> torch.Tensor:
    """d/dh gelu(h) in fp32 (``pallas_mlp._gelu_grad_f32``, :155-164)."""
    if approx:
        c = 0.7978845608028654  # sqrt(2/pi)
        t = torch.tanh(c * (h + 0.044715 * (h * h * h)))
        return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * h * h)
    return 0.5 * (1.0 + torch.erf(h * 0.7071067811865476)) + h * torch.exp(-0.5 * h * h) * 0.3989422804014327


# ------------------------------------------------------------- plain stages


def ln_rows_plain(x, ln_scale, ln_bias, eps: float):
    """LN with fp32 two-pass statistics, rounded to x's dtype; returns (ln,
    mean, rstd), mean and rstd fp32 of shape ``x.shape[:-1]``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    ln = ((xf - mean) * rstd * ln_scale.float() + ln_bias.float()).to(x.dtype)
    return ln, mean[..., 0], rstd[..., 0]


def lin1_gelu_plain(ln, w1, b1, approx: bool):
    """h = gelu(ln·w1 + b1): fp32 product and GELU, rounded to ln's dtype."""
    return _gelu_f32(ln.float() @ w1.float() + b1.float(), approx).to(ln.dtype)


def lin2_plain(h, w2, b2):
    """out = h·w2 + b2 in fp32, rounded to h's dtype."""
    return (h.float() @ w2.float() + b2.float()).to(h.dtype)


def dual_dh_plain(ln, g, w1, b1, w2, approx: bool):
    """dh = (g·w2ᵀ) ∘ gelu′(ln·w1 + b1) in fp32, rounded to ln's dtype."""
    hpre = ln.float() @ w1.float() + b1.float()
    return ((g.float() @ w2.float().transpose(0, 1)) * _gelu_grad_f32(hpre, approx)).to(ln.dtype)


def dln_plain(dh, w1):
    """dln = dh·w1ᵀ in fp32 (not rounded)."""
    return dh.float() @ w1.float().transpose(0, 1)


def ln_vjp_plain(dln, x, ln_scale, mean, rstd):
    """The LN VJP in fp32 from dln, rounded to x's dtype."""
    mean, rstd = mean[..., None], rstd[..., None]
    xhat = (x.float() - mean) * rstd
    dxhat = dln * ln_scale.float()
    c = x.shape[-1]
    dx = (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).sum(-1, keepdim=True) / c) * rstd
    return dx.to(x.dtype)


def ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float, approx: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch with the TPU kernel's rounding
    points (``pallas_mlp.py:38-50``), as the chain of its stages: LN in fp32
    rounded to x's dtype, both products accumulated in fp32, GELU in fp32
    rounded to x's dtype."""
    ln, _, _ = ln_rows_plain(x, ln_scale, ln_bias, eps)
    return lin2_plain(lin1_gelu_plain(ln, w1, b1, approx), w2, b2)


def ln_mlp_dx_plain(x, ln_scale, ln_bias, w1, b1, w2, g, eps: float, approx: bool) -> torch.Tensor:
    """dx of :func:`ln_mlp_plain` for output cotangent ``g``, with the TPU
    kernel's rounding points (``pallas_mlp.py:173-199``), as the chain of its
    stages: LN in fp32 rounded to x's dtype before ·w1; hpre = ln·w1 + b1 and
    gelu′ in fp32; dh = (g·w2ᵀ)∘gelu′ rounded before ·w1ᵀ; dln and the LN VJP
    in fp32; dx rounded to x's dtype."""
    ln, mean, rstd = ln_rows_plain(x, ln_scale, ln_bias, eps)
    dh = dual_dh_plain(ln, g, w1, b1, w2, approx)
    return ln_vjp_plain(dln_plain(dh, w1), x, ln_scale, mean, rstd)


def swiglu_dual_plain(ln, w1, b1, w2, b2):
    """h = silu(ln·w1 + b1) ⊙ (ln·w2 + b2): fp32 products and gate, rounded to ln's dtype."""
    g = ln.float() @ w1.float() + b1.float()
    return (F.silu(g) * (ln.float() @ w2.float() + b2.float())).to(ln.dtype)


def swiglu_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, ffn_scale, ffn_bias, w3, b3, eps: float) -> torch.Tensor:
    """The SwiGLU kernel chain's function in plain PyTorch, at its rounding
    points: W1, b1, W2, b2, W3 and b3 rounded to x's dtype, as the kernels
    take them; LN over C in fp32 rounded to x's dtype; both products and
    silu(g)·u in fp32, rounded; the LN over the hidden width in fp32 (two-pass
    statistics over exactly M columns), rounded; the last product in fp32
    plus b3, rounded."""
    w1, b1, w2, b2, w3, b3 = (t.to(x.dtype) for t in (w1, b1, w2, b2, w3, b3))
    ln, _, _ = ln_rows_plain(x, ln_scale, ln_bias, eps)
    h, _, _ = ln_rows_plain(swiglu_dual_plain(ln, w1, b1, w2, b2), ffn_scale, ffn_bias, eps)
    return lin2_plain(h, w3, b3)


# ------------------------------------------------------------ device stages


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _need(what: str, device, *specs) -> None:
    """Each (name, tensor, dtype, shape) on ``device``, of that dtype and
    shape (None: any), contiguous and 32-byte aligned, or raise."""
    for name, t, dt, shape in specs:
        if t.device != device or t.dtype != dt or (shape is not None and tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{what}: {name} wants {shape or 'any shape'} {dt} on {device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{what} kernel needs contiguous, 32-byte aligned inputs ({name})")


def _cuda_or_cpu(what: str, t: torch.Tensor) -> bool:
    """True for CUDA tensors; False for CPU ones (the plain version); raise otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} takes CPU or CUDA tensors, got {t.device}")
    return t.device.type == "cuda"


def _launch_ln_rows(lib, x, ln_scale, ln_bias, eps):
    c = x.shape[-1]
    n = x.numel() // c
    ln = torch.empty_like(x)
    mean = torch.empty(x.shape[:-1], device=x.device)
    rstd = torch.empty_like(mean)
    err = lib.mlp_ln_rows_bf16(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), ln.data_ptr(), mean.data_ptr(),
                               rstd.data_ptr(), n, c, float(eps), _stream(x))
    build.check(err, "ln_rows launch")
    ln_rows.launches += 1
    return ln, mean, rstd


def _launch_lin1_gelu(lib, ln, w1, b1, approx):
    c, m = w1.shape
    h = torch.empty((*ln.shape[:-1], m), device=ln.device, dtype=ln.dtype)
    err = lib.mlp_lin1_gelu_bf16(ln.data_ptr(), w1.data_ptr(), b1.data_ptr(), h.data_ptr(), ln.numel() // c, c, m,
                                 int(approx), _stream(ln))
    build.check(err, "lin1_gelu launch")
    lin1_gelu.launches += 1
    return h


def _launch_lin2(lib, h, w2, b2):
    m, c = w2.shape
    out = torch.empty((*h.shape[:-1], c), device=h.device, dtype=h.dtype)
    err = lib.mlp_lin2_bf16(h.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), h.numel() // m, m, c, _stream(h))
    build.check(err, "lin2 launch")
    lin2.launches += 1
    return out


def _launch_dual_dh(lib, ln, g, w1, b1, w2, approx):
    c, m = w1.shape
    dh = torch.empty((*ln.shape[:-1], m), device=ln.device, dtype=ln.dtype)
    err = lib.mlp_dual_dh_bf16(ln.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dh.data_ptr(),
                               ln.numel() // c, c, m, int(approx), _stream(ln))
    build.check(err, "dual_dh launch")
    dual_dh.launches += 1
    return dh


def _launch_dln(lib, dh, w1):
    c, m = w1.shape
    out = torch.empty((*dh.shape[:-1], c), device=dh.device)
    err = lib.mlp_dln_f32(dh.data_ptr(), w1.data_ptr(), out.data_ptr(), dh.numel() // m, m, c, _stream(dh))
    build.check(err, "dln launch")
    dln.launches += 1
    return out


def _launch_ln_vjp(lib, dln_, x, ln_scale, mean, rstd):
    c = x.shape[-1]
    dx = torch.empty_like(x)
    err = lib.mlp_ln_vjp_bf16(dln_.data_ptr(), x.data_ptr(), ln_scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                              dx.data_ptr(), x.numel() // c, c, _stream(x))
    build.check(err, "ln_vjp launch")
    ln_vjp.launches += 1
    return dx


def _check_width(what: str, c: int, m: int = 128, narrow: bool = True) -> None:
    if (c % 256 and not (narrow and c in NARROW_C)) or c > 1280 or m % 128:
        want = "C % 256 == 0 (or C 64 or 128)" if narrow else "C % 256 == 0"
        raise ValueError(f"{what} kernel needs {want}, C <= 1280 and M % 128 == 0, got C={c}, M={m}")


def ln_rows(x, ln_scale, ln_bias, eps: float):
    """Stage 1 of both kernels: (ln, mean, rstd) as :func:`ln_rows_plain`.
    CUDA: bf16 x, fp32 LN params, C % 256 == 0, C ≤ 1280."""
    if not _cuda_or_cpu("ln_rows", x):
        return ln_rows_plain(x, ln_scale, ln_bias, eps)
    c = x.shape[-1]
    _check_width("ln_rows", c, narrow=False)
    _need("ln_rows", x.device, ("x", x, torch.bfloat16, None), ("ln_scale", ln_scale, torch.float32, (c,)),
          ("ln_bias", ln_bias, torch.float32, (c,)))
    return _launch_ln_rows(build.load("ln_mlp", _PROTO), x, ln_scale, ln_bias, eps)


def lin1_gelu(ln, w1, b1, approx: bool):
    """Stage 2 of :func:`ln_mlp` as :func:`lin1_gelu_plain`; CUDA: bf16, w1 (C, M) as stored."""
    if not _cuda_or_cpu("lin1_gelu", ln):
        return lin1_gelu_plain(ln, w1, b1, approx)
    c, m = w1.shape
    _check_width("lin1_gelu", c, m, narrow=False)
    _need("lin1_gelu", ln.device, ("ln", ln, torch.bfloat16, None), ("w1", w1, torch.bfloat16, (c, m)),
          ("b1", b1, torch.bfloat16, (m,)))
    if ln.shape[-1] != c:
        raise ValueError(f"lin1_gelu: ln has {ln.shape[-1]} channels, w1 {c}")
    return _launch_lin1_gelu(build.load("ln_mlp", _PROTO), ln, w1, b1, approx)


def lin2(h, w2, b2):
    """Stage 3 of :func:`ln_mlp` as :func:`lin2_plain`; CUDA: bf16, w2 (M, C) as stored."""
    if not _cuda_or_cpu("lin2", h):
        return lin2_plain(h, w2, b2)
    m, c = w2.shape
    _check_width("lin2", c, m, narrow=False)
    _need("lin2", h.device, ("h", h, torch.bfloat16, None), ("w2", w2, torch.bfloat16, (m, c)),
          ("b2", b2, torch.bfloat16, (c,)))
    if h.shape[-1] != m:
        raise ValueError(f"lin2: h has {h.shape[-1]} units, w2 {m}")
    return _launch_lin2(build.load("ln_mlp", _PROTO), h, w2, b2)


def dual_dh(ln, g, w1, b1, w2, approx: bool):
    """Stage 2 of :func:`ln_mlp_dx` as :func:`dual_dh_plain`; CUDA: bf16, w1 and w2 as stored."""
    if not _cuda_or_cpu("dual_dh", ln):
        return dual_dh_plain(ln, g, w1, b1, w2, approx)
    c, m = w1.shape
    _check_width("dual_dh", c, m, narrow=False)
    _need("dual_dh", ln.device, ("ln", ln, torch.bfloat16, None), ("g", g, torch.bfloat16, tuple(ln.shape)),
          ("w1", w1, torch.bfloat16, (c, m)), ("b1", b1, torch.bfloat16, (m,)), ("w2", w2, torch.bfloat16, (m, c)))
    if ln.shape[-1] != c:
        raise ValueError(f"dual_dh: ln has {ln.shape[-1]} channels, w1 {c}")
    return _launch_dual_dh(build.load("ln_mlp_dx", _DX_PROTO), ln, g, w1, b1, w2, approx)


def dln(dh, w1):
    """Stage 3 of :func:`ln_mlp_dx` as :func:`dln_plain`; CUDA: bf16 dh, w1 (C, M) as stored, fp32 out."""
    if not _cuda_or_cpu("dln", dh):
        return dln_plain(dh, w1)
    c, m = w1.shape
    _check_width("dln", c, m, narrow=False)
    _need("dln", dh.device, ("dh", dh, torch.bfloat16, None), ("w1", w1, torch.bfloat16, (c, m)))
    if dh.shape[-1] != m:
        raise ValueError(f"dln: dh has {dh.shape[-1]} units, w1 {m}")
    return _launch_dln(build.load("ln_mlp_dx", _DX_PROTO), dh, w1)


def ln_vjp(dln_, x, ln_scale, mean, rstd):
    """Stage 4 of :func:`ln_mlp_dx` as :func:`ln_vjp_plain`; CUDA: fp32 dln, bf16 x, fp32 statistics."""
    if not _cuda_or_cpu("ln_vjp", x):
        return ln_vjp_plain(dln_, x, ln_scale, mean, rstd)
    c = x.shape[-1]
    _check_width("ln_vjp", c, narrow=False)
    _need("ln_vjp", x.device, ("dln", dln_, torch.float32, tuple(x.shape)), ("x", x, torch.bfloat16, None),
          ("ln_scale", ln_scale, torch.float32, (c,)), ("mean", mean, torch.float32, tuple(x.shape[:-1])),
          ("rstd", rstd, torch.float32, tuple(x.shape[:-1])))
    return _launch_ln_vjp(build.load("ln_mlp_dx", _DX_PROTO), dln_, x, ln_scale, mean, rstd)


for _fn in (ln_rows, lin1_gelu, lin2, dual_dh, dln, ln_vjp):
    _fn.launches = 0

# ----------------------------------------------------------------- the pair


def _check_kernel_args(what, x, ln_scale, ln_bias, w1, b1, w2, last):
    """The checks both kernels share; ``last`` is (name, tensor, dtype,
    shape) of the seventh argument (b2 or g)."""
    c = x.shape[-1]
    m = w1.shape[-1]
    _check_width(what, c, m)
    _need(what, x.device, ("x", x, torch.bfloat16, None), ("ln_scale", ln_scale, torch.float32, (c,)),
          ("ln_bias", ln_bias, torch.float32, (c,)), ("w1", w1, torch.bfloat16, (c, m)),
          ("b1", b1, torch.bfloat16, (m,)), ("w2", w2, torch.bfloat16, (m, c)), last)
    return c, m


def _narrow(lib, entry, x, ln_scale, ln_bias, w1, b1, w2, last, eps, approx):
    c, m = w1.shape
    out = torch.empty_like(x)
    err = getattr(lib, entry)(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                              w2.data_ptr(), last.data_ptr(), out.data_ptr(), x.numel() // c, c, m, float(eps),
                              int(approx), _stream(x))
    build.check(err, f"{entry} launch")
    return out


@spanned("bst.kernel.ln_mlp")
def ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float, approx: bool) -> torch.Tensor:
    """LN → Lin1 → GELU → Lin2 on (..., C) input; returns the MLP output (no
    residual). CUDA tensors launch the kernels (bf16 x and weights, fp32 LN
    params, C % 256 == 0 or C 64 / 128, C ≤ 1280, M % 128 == 0): three stage
    kernels, or the narrow one; CPU tensors take the plain version."""
    if not _cuda_or_cpu("ln_mlp", x):
        return ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, approx)
    c, _ = _check_kernel_args("ln_mlp", x, ln_scale, ln_bias, w1, b1, w2, ("b2", b2, torch.bfloat16, (x.shape[-1],)))
    lib = build.load("ln_mlp", _PROTO)
    if x.numel() == 0:
        out = torch.empty_like(x)
    elif c in NARROW_C:
        out = _narrow(lib, "ln_mlp_narrow_bf16", x, ln_scale, ln_bias, w1, b1, w2, b2, eps, approx)
    else:
        ln, _, _ = _launch_ln_rows(lib, x, ln_scale, ln_bias, eps)
        out = _launch_lin2(lib, _launch_lin1_gelu(lib, ln, w1, b1, approx), w2, b2)
    ln_mlp.launches += 1
    return out


ln_mlp.launches = 0


@spanned("bst.kernel.ln_mlp_dx")
def ln_mlp_dx(x, ln_scale, ln_bias, w1, b1, w2, g, eps: float, approx: bool) -> torch.Tensor:
    """Same contract as :func:`ln_mlp_dx_plain`. CUDA tensors launch the
    kernels (the forward's dtypes and widths, g like x): four stage kernels,
    or the narrow one; CPU tensors take the plain version."""
    if not _cuda_or_cpu("ln_mlp_dx", x):
        return ln_mlp_dx_plain(x, ln_scale, ln_bias, w1, b1, w2, g, eps, approx)
    c, _ = _check_kernel_args("ln_mlp_dx", x, ln_scale, ln_bias, w1, b1, w2, ("g", g, torch.bfloat16, tuple(x.shape)))
    lib = build.load("ln_mlp_dx", _DX_PROTO)
    if x.numel() == 0:
        dx = torch.empty_like(x)
    elif c in NARROW_C:
        dx = _narrow(lib, "ln_mlp_dx_narrow_bf16", x, ln_scale, ln_bias, w1, b1, w2, g, eps, approx)
    else:
        ln, mean, rstd = _launch_ln_rows(lib, x, ln_scale, ln_bias, eps)
        dh = _launch_dual_dh(lib, ln, g, w1, b1, w2, approx)
        del ln
        dx = _launch_ln_vjp(lib, _launch_dln(lib, dh, w1), x, ln_scale, mean, rstd)
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


# --------------------------------------------------------------- SwiGLU


def _operand(t: torch.Tensor, dtype: torch.dtype, n: int, dim: int) -> torch.Tensor:
    """``t`` in ``dtype``, zero-padded along ``dim`` to length ``n`` in one
    copy, kept while ``t`` is unchanged (``cuda_gemm.kept``): a frozen weight
    is rounded and padded once, not on every call."""
    def make() -> torch.Tensor:
        shape = list(t.shape)
        shape[dim] = n
        out = torch.zeros(shape, dtype=dtype, device=t.device)
        out.narrow(dim, 0, t.shape[dim]).copy_(t.detach())
        return out

    out, made = cuda_gemm.kept(t, ("swiglu", dtype, n, dim), make)
    swiglu_mlp.operand_builds += made
    return out


@spanned("bst.kernel.swiglu_mlp")
def swiglu_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, ffn_scale, ffn_bias, w3, b3, eps: float) -> torch.Tensor:
    """LN → SwiGLU → LN over the hidden width → W3 on (..., C) input (no
    residual), as :func:`swiglu_mlp_plain`. CUDA tensors launch four stage
    kernels (bf16 x, fp32 LN params, C % 256 == 0, C ≤ 1280, M ≤ 2816):
    ``ln_rows`` (counted in ``ln_rows.launches``, as #2's stage); the dual
    product ln·W1 ‖ ln·W2 with the silu·mul epilogue; the LN over exactly M
    columns; the product with W3 and b3. The weights and biases may come in
    any float dtype (the model hands its fp32 parameters): the kernels take
    them rounded to bf16, and the hidden width zero-padded to a multiple of
    64 (Mp) for the products' k steps and TMA's 16-byte row strides: W1, W2,
    b1, b2 and the LN's parameters get zero columns and W3 zero rows, so the
    padded units are 0 through every stage. Each rounded, padded operand is
    made once per source tensor (:func:`_operand`; ``swiglu_mlp.operand_builds``
    counts the copies). CPU tensors take the plain version."""
    if not _cuda_or_cpu("swiglu_mlp", x):
        return swiglu_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, ffn_scale, ffn_bias, w3, b3, eps)
    c = x.shape[-1]
    m = w1.shape[-1]
    if not swiglu_takes(c, m):
        raise ValueError(f"swiglu_mlp kernel needs C % 256 == 0, C <= 1280 and an even hidden width <= {WIDE_MAX}, "
                         f"got C={c}, M={m}")
    bf, f32 = torch.bfloat16, torch.float32
    mp = -(-m // 64) * 64
    shapes = [("w1", w1, (c, m)), ("b1", b1, (m,)), ("w2", w2, (c, m)), ("b2", b2, (m,)), ("ffn_scale", ffn_scale, (m,)),
              ("ffn_bias", ffn_bias, (m,)), ("w3", w3, (m, c)), ("b3", b3, (c,))]
    for name, t, shape in shapes:
        if tuple(t.shape) != shape or not t.is_floating_point() or t.device != x.device:
            raise ValueError(f"swiglu_mlp: {name} wants {shape} floats on {x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    w1p, w2p = _operand(w1, bf, mp, 1), _operand(w2, bf, mp, 1)
    b1p, b2p = _operand(b1, bf, mp, 0), _operand(b2, bf, mp, 0)
    fs, fb = _operand(ffn_scale, f32, mp, 0), _operand(ffn_bias, f32, mp, 0)
    w3p, b3p = _operand(w3, bf, mp, 0), _operand(b3, bf, c, 0)
    _need("swiglu_mlp", x.device, ("x", x, bf, None), ("ln_scale", ln_scale, f32, (c,)), ("ln_bias", ln_bias, f32, (c,)))
    lib = build.load("swiglu_mlp", _SWIGLU_PROTO)
    n = x.numel() // c
    out = torch.empty_like(x)
    if n:
        st = _stream(x)
        ln, _, _ = _launch_ln_rows(lib, x, ln_scale, ln_bias, eps)
        h = torch.empty((n, mp), device=x.device, dtype=bf)
        build.check(lib.swiglu_dual_bf16(ln.data_ptr(), w1p.data_ptr(), b1p.data_ptr(), w2p.data_ptr(), b2p.data_ptr(),
                                         h.data_ptr(), n, c, mp, st), "swiglu dual launch")
        del ln
        hl = torch.empty_like(h)
        build.check(lib.swiglu_ln_wide_bf16(h.data_ptr(), fs.data_ptr(), fb.data_ptr(), hl.data_ptr(), n, m, mp,
                                            float(eps), st), "swiglu ln_wide launch")
        del h
        build.check(lib.swiglu_out_bf16(hl.data_ptr(), w3p.data_ptr(), b3p.data_ptr(), out.data_ptr(), n, mp, c, st),
                    "swiglu out launch")
    swiglu_mlp.launches += 1
    return out


swiglu_mlp.launches = 0
swiglu_mlp.operand_builds = 0


class _SwiGluMlp(torch.autograd.Function):
    """:func:`swiglu_mlp` forward, saving the inputs only; every cotangent
    asked for by autograd of :func:`swiglu_mlp_plain` (no tuned backward
    kernel yet)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, ffn_scale, ffn_bias, w3, b3, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2, ffn_scale, ffn_bias, w3, b3)
        ctx.eps = eps
        return swiglu_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, ffn_scale, ffn_bias, w3, b3, eps)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:11]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = swiglu_mlp_plain(*leaves, ctx.eps)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(got) if t.requires_grad else None for t in leaves), None)


def fused_swiglu_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, ffn_scale, ffn_bias, w3, b3, eps: float) -> torch.Tensor:
    """The model's differentiable EVA-02 MLP: :func:`swiglu_mlp` forward,
    autograd of :func:`swiglu_mlp_plain` backward (looked up when called, so
    the forward can be swapped for its plain version)."""
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2, ffn_scale, ffn_bias, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SwiGluMlp.apply(*args, eps)
    return swiglu_mlp(*args, eps)
