"""The fp32 model's linear products in split TF32 on the tensor cores
(``csrc/gemm_f32x3.cu``), forward (``x @ W``) and input gradient
(``dy @ Wᵀ``).

Replaces no TPU kernel: the JAX package leaves these products to XLA's fp32
dot, and the port left them to cuBLAS's SGEMMs with TF32 off, on the FP32
units. The kernel forms every product as three TF32 products of the
operands' parts (``tf32x3.cuh``: big = the value rounded to TF32, small = the
rest), each stage's sum added on the FP32 units, so the result stays fp32 to
within a few ulps where one TF32 product keeps three decimal digits.

The weights are frozen (the model is built with ``requires_grad_(False)``
and prompt tuning asks for the prompt pixels' gradient only), so their parts
are made once, in the orientation the kernel reads (K-major: ``Wᵀ`` for the
forward, ``W`` as stored for the input gradient), and kept on the weight's
base tensor, stamped with its version counter and data pointer: an in-place
write (``load_state_dict``'s ``copy_``) or a new storage makes them anew.
``linear_f32.cache_builds`` counts the parts made (zero across a warm call);
``linear_f32.launches`` counts kernel launches.

:func:`linear` is the model's product: :func:`linear_f32` where
:func:`takes` says the kernel takes it (fp32 CUDA operands, K and N multiples
of 4), through an autograd Function whose backward is the kernel again;
anything else is ``x @ w`` (and ``+ bias``) as before, so CPU tensors and
bf16 never reach the wrapper. :func:`linear_f32` itself launches for CUDA
tensors and takes its plain version for CPU ones. No weight gradient is
formed: the wrapper raises on a weight or bias that requires one.
"""

from __future__ import annotations

import ctypes

import torch

from beach_seg_tpu_torch.ops import build
from beach_seg_tpu_torch.utils.profiling import spanned

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTO = {"gemm_f32x3": [_P, _P, _P, _P, _P, _I, _I, _I, _P]}
_KEPT = "_kept_copies"  # the attribute of a weight's base tensor that keeps what is made from it


def takes(device_type: str, dtype: torch.dtype, k: int, n: int) -> bool:
    """The dispatch rule: the kernel takes a product of fp32 operands on the
    card whose contraction K and output width N are multiples of 4 (TMA's
    16-byte row strides). Every ViT-L, ViT-H and Painter encoder, patch-embed
    and decoder-embed product qualifies; the decoder head (N = 3) does not."""
    return device_type == "cuda" and dtype == torch.float32 and k > 0 and n > 0 and k % 4 == 0 and n % 4 == 0


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small), each contiguous like ``x``: big = ``x`` rounded to TF32
    (``tf32x3.cuh``'s ``round_tf32``: half a TF32 ulp added to the bit
    pattern, the 13 low bits cleared; where that would overflow, within half
    a TF32 ulp of the largest float, ``x`` truncated instead, as the kernel
    splits its activations), small = ``x`` − big, exact in fp32, so
    big + small == x for every finite x."""
    x = x.contiguous()
    u = x.view(torch.int32)
    r = (u + 0x1000) & -0x2000
    overflow = ((r & 0x7FFFFFFF) == 0x7F800000) & ((u & 0x7FFFFFFF) < 0x7F800000)
    big = torch.where(overflow, u & -0x2000, r).view(torch.float32)
    return big, x - big


def kept(w: torch.Tensor, what: tuple, make):
    """``make()``'s copy of ``w``, made once and kept on ``w``'s base tensor
    under ``what`` and ``w``'s view while ``w``'s version counter and data
    pointer stay the same; returns it and whether it was made now. An
    inference tensor has no version counter to stamp a copy with: it makes
    one each call."""
    if w.is_inference():
        return make(), True
    base = w if w._base is None else w._base
    key = (what, w.storage_offset(), tuple(w.shape), tuple(w.stride()))
    stamp = (w._version, w.data_ptr())
    store = base.__dict__.setdefault(_KEPT, {})
    entry = store.get(key)
    if entry is not None and entry[0] == stamp:
        return entry[1], False
    store[key] = (stamp, make())
    return store[key][1], True


def weight_parts(w: torch.Tensor, transposed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The TF32 parts of ``w.t()`` (``transposed``: the forward's K-major
    operand) or of ``w`` as stored (the input gradient's), kept (:func:`kept`)."""
    parts, made = kept(w, ("tf32", transposed), lambda: split_tf32(w.t() if transposed else w))
    linear_f32.cache_builds += made
    return parts


def linear_f32_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                     transposed: bool = False) -> torch.Tensor:
    """``x @ w`` (``x @ w.t()`` when ``transposed``), plus ``bias`` if given."""
    y = x @ (w.t() if transposed else w)
    return y if bias is None else y + bias


def _check(x, w, bias, k, n) -> None:
    if x.dtype != torch.float32 or w.dtype != torch.float32 or (bias is not None and bias.dtype != torch.float32):
        raise TypeError(f"linear_f32 kernel takes fp32 operands, got x {x.dtype}, w {w.dtype}")
    if not takes(x.device.type, x.dtype, k, n):
        raise ValueError(f"linear_f32 kernel needs K and N multiples of 4, got K={k}, N={n}")
    if x.shape[-1] != k or w.device != x.device or (bias is not None and (bias.device != x.device or tuple(bias.shape) != (n,))):
        raise ValueError(f"linear_f32: x {tuple(x.shape)} on {x.device}, w {tuple(w.shape)} on {w.device}, bias "
                         f"{None if bias is None else (tuple(bias.shape), bias.device)} do not make a product")
    if w.requires_grad or (bias is not None and bias.requires_grad):
        raise ValueError("linear_f32 forms no weight gradient: its weight and bias must not require grad")
    for name, t in (("x", x), ("bias", bias)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"linear_f32 kernel needs contiguous, 16-byte aligned inputs ({name})")


@spanned("bst.kernel.linear_f32")
def linear_f32(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
               transposed: bool = False) -> torch.Tensor:
    """``x @ w`` (+ ``bias``) on (..., K) input with ``w`` (K, N), or with
    ``transposed`` the input gradient ``x @ w.t()`` with ``w`` (N, K) as
    stored. CUDA tensors launch the kernel (fp32, K and N multiples of 4,
    ``x`` and ``bias`` contiguous and 16-byte aligned, ``w`` any view that
    requires no grad); CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return linear_f32_plain(x, w, bias, transposed)
    if x.device.type != "cuda":
        raise ValueError(f"linear_f32 takes CPU or CUDA tensors, got {x.device}")
    n, k = w.shape if transposed else (w.shape[1], w.shape[0])
    _check(x, w, bias, k, n)
    big, small = weight_parts(w, transposed=not transposed)
    out = torch.empty((*x.shape[:-1], n), device=x.device)
    m = x.numel() // k
    if m == 0:
        return out
    lib = build.load("gemm_f32x3", _PROTO)
    err = lib.gemm_f32x3(x.data_ptr(), big.data_ptr(), small.data_ptr(), None if bias is None else bias.data_ptr(),
                         out.data_ptr(), m, n, k, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "linear_f32 launch")
    linear_f32.launches += 1
    return out


linear_f32.launches = 0
linear_f32.cache_builds = 0


class _LinearF32(torch.autograd.Function):
    """The kernel forward and, for the input's gradient, the kernel on
    ``dy`` and ``w.t()``; the weight and bias are frozen (no gradient)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(w)
        return linear_f32(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return linear_f32(g.contiguous(), w, transposed=True), None, None


def linear(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """The model's differentiable ``x @ w (+ bias)``: :func:`linear_f32`
    (looked up when called) where :func:`takes` the operands, else the
    product as it was. The dtypes are tested first, so that a bf16 product
    pays one comparison on the host."""
    if x.dtype is torch.float32 and w.dtype is torch.float32 and takes(x.device.type, x.dtype, *w.shape):
        if torch.is_grad_enabled() and x.requires_grad:
            return _LinearF32.apply(x.contiguous(), w, bias)
        return linear_f32(x.contiguous(), w, bias)
    y = x @ w
    return y if bias is None else y + bias
