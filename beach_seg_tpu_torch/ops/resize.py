"""Separable matrix resizes with exact PIL / cv2 / torch kernel parity
(counterpart of ``beach_seg_tpu/ops/resize.py``).

For static sizes a separable resize is two small dense products
``W_h @ img @ W_w.T``. The weight matrices are built on the host in numpy,
bit for bit as the JAX package builds them; the products run in fp32 on the
tensor's device (TF32 is off on the card, see ``utils.device``).

Kernel conventions:
  - ``cubic`` with parameter ``a``: torch/cv2 use a=-0.75, PIL/GDAL a=-0.5.
  - ``linear``/``triangle``: torch F.interpolate(mode="linear").
  - ``lanczos3``: GDAL-style.
  - antialias: PIL widens the kernel when downscaling; torch/cv2 do not.
  - nearest: "pil" convention floor((i+0.5)*scale); "floor" convention
    floor(i*scale) (cv2/torch).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from beach_seg_tpu_torch.utils.device import device_constant


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    return w


def _linear(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, 1.0 - ax, 0.0)


def _lanczos(x: np.ndarray, taps: int = 3) -> np.ndarray:
    ax = np.abs(x)
    w = np.sinc(x) * np.sinc(x / taps)
    return np.where(ax < taps, w, 0.0)


_KERNELS = {
    "bicubic_torch": (functools.partial(_cubic, a=-0.75), 2.0),
    "bicubic_cv2": (functools.partial(_cubic, a=-0.75), 2.0),
    "bicubic_pil": (functools.partial(_cubic, a=-0.5), 2.0),
    "bicubic_gdal": (functools.partial(_cubic, a=-0.5), 2.0),
    "linear_torch": (_linear, 1.0),
    "bilinear_pil": (_linear, 1.0),
    "lanczos3": (functools.partial(_lanczos, taps=3), 3.0),
}


@functools.lru_cache(maxsize=256)
def resize_matrix(
    in_size: int,
    out_size: int,
    method: str = "bicubic_torch",
    antialias: bool | None = None,
    align_corners: bool = False,
) -> np.ndarray:
    """Dense (out_size, in_size) float32 resampling matrix for one axis.

    ``antialias=None`` picks the library default for the method: PIL methods
    antialias on downscale; torch/cv2 methods do not.
    """
    if method == "nearest_pil":
        m = _nearest_matrix(in_size, out_size, half_pixel=True)
        m.setflags(write=False)  # cached — guard against caller mutation
        return m
    if method == "nearest_torch":
        m = _nearest_matrix(in_size, out_size, half_pixel=False, fp32_scale=True)
        m.setflags(write=False)
        return m
    if method in ("nearest_floor", "nearest_cv2"):
        m = _nearest_matrix(in_size, out_size, half_pixel=False)
        m.setflags(write=False)
        return m
    kernel, support = _KERNELS[method]
    if antialias is None:
        antialias = method.endswith("_pil") or method.endswith("_gdal")

    scale = in_size / out_size
    filt_scale = max(scale, 1.0) if antialias else 1.0
    sup = support * filt_scale

    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        centers = out_idx * (in_size - 1) / (out_size - 1)
    else:
        centers = (out_idx + 0.5) * scale - 0.5

    lo = np.floor(centers - sup + 0.5).astype(np.int64)
    n_taps = int(np.ceil(sup * 2.0)) + 1
    taps = lo[:, None] + np.arange(n_taps)[None, :]
    dist = (centers[:, None] - taps) / filt_scale
    weights = kernel(dist)

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if method.endswith("_pil") or method.endswith("_gdal"):
        # PIL border handling: clip the window to the valid range and
        # renormalize over in-range taps only.
        valid = (taps >= 0) & (taps < in_size)
        weights = np.where(valid, weights, 0.0)
        weights = weights / np.maximum(weights.sum(axis=1, keepdims=True), 1e-12)
        taps_c = np.clip(taps, 0, in_size - 1)
    else:
        # torch/cv2 border handling: normalize the full window, then clamp
        # out-of-range taps to the edge (replicate), folding their weights.
        weights = weights / np.maximum(weights.sum(axis=1, keepdims=True), 1e-12)
        taps_c = np.clip(taps, 0, in_size - 1)
    np.add.at(mat, (np.repeat(np.arange(out_size), n_taps), taps_c.ravel()), weights.ravel())
    out = mat.astype(np.float32)
    out.setflags(write=False)  # cached — guard against caller mutation
    return out


def _nearest_matrix(
    in_size: int, out_size: int, half_pixel: bool, fp32_scale: bool = False
) -> np.ndarray:
    scale = in_size / out_size
    if half_pixel:
        # PIL's ImagingScaleAffine accumulates the source coordinate in a
        # running double (xo = a2 + a0*0.5; xo += a0 per pixel), so exact-
        # integer ties depend on accumulated fp error. Reproduce bit-for-bit.
        src = np.empty(out_size, dtype=np.int64)
        xo = scale * 0.5
        for i in range(out_size):
            src[i] = int(xo)
            xo += scale
    elif fp32_scale:
        # torch F.interpolate(mode="nearest") computes floorf(dst * scale)
        # with a FLOAT scale (aten nearest_neighbor_compute_source_index).
        src = np.floor(
            np.arange(out_size, dtype=np.float32) * np.float32(np.float32(in_size) / np.float32(out_size))
        ).astype(np.int64)
    else:
        src = np.floor(np.arange(out_size, dtype=np.float64) * scale).astype(np.int64)
    src = np.clip(src, 0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    mat[np.arange(out_size), src] = 1.0
    return mat


def _matrix(
    in_size: int,
    out_size: int,
    method: str,
    device: torch.device,
    antialias: bool | None = None,
    align_corners: bool = False,
) -> torch.Tensor:
    """:func:`resize_matrix` on ``device``, copied there once per sizes,
    method, options and device (:func:`device_constant`): read-only, no
    autograd history."""
    return device_constant(resize_matrix, in_size, out_size, method, antialias, align_corners, device=device)


def nearest_indices(in_size: int, out_size: int, method: str = "nearest_pil") -> np.ndarray:
    """Source-index vector of a nearest resize: device resizes become exact
    gathers (the matrices are one-hot row selectors)."""
    return resize_matrix(in_size, out_size, method).argmax(1)


def resize_2d(x: torch.Tensor, out_hw: tuple[int, int], method: str = "bicubic_torch", **kw) -> torch.Tensor:
    """Resize the last two axes of ``x`` (any leading dims) in fp32."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    wh = _matrix(h_in, out_hw[0], method, x.device, **kw)
    ww = _matrix(w_in, out_hw[1], method, x.device, **kw)
    orig_dtype = x.dtype
    y = torch.einsum("oh,...hw->...ow", wh, x.float())
    y = torch.einsum("pw,...hw->...hp", ww, y)
    if not orig_dtype.is_floating_point:
        y = torch.round(y)
    return y.to(orig_dtype) if method.startswith("nearest") else y


def resize_pil_uint8(img: np.ndarray, out_hw: tuple[int, int], method: str = "bicubic_pil") -> np.ndarray:
    """PIL's uint8 resize pipeline on the host, pass by pass: horizontal pass
    → round and clip to uint8 → vertical pass → round and clip (PIL
    resamples into an 8-bit image between its two passes). Pillow itself,
    where it is installed and the method is its default BICUBIC, is exact by
    definition and is used instead. (H, W[, C]) uint8 → (h, w[, C]) uint8."""
    if method == "bicubic_pil" and img.dtype == np.uint8 and img.ndim in (2, 3):
        try:
            from PIL import Image
        except ImportError:
            pass
        else:
            return np.asarray(Image.fromarray(img).resize((out_hw[1], out_hw[0]), Image.BICUBIC))
    mw = resize_matrix(img.shape[1], out_hw[1], method)
    mh = resize_matrix(img.shape[0], out_hw[0], method)
    x = np.einsum("pw,hw...->hp...", mw, img.astype(np.float64))
    x = np.clip(np.round(x), 0, 255)
    x = np.einsum("oh,hw...->ow...", mh, x)
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def resize_pil_uint8_device(
    img: torch.Tensor, out_hw: tuple[int, int], method: str = "bicubic_pil"
) -> torch.Tensor:
    """PIL's uint8 resize pipeline on the tensor's device: fp32 products with
    PIL's uint8 rounding between the two passes (horizontal first).
    (…, H, W, C) → (…, h, w, C), float32 in [0, 255]."""
    mh = _matrix(img.shape[-3], out_hw[0], method, img.device)
    mw = _matrix(img.shape[-2], out_hw[1], method, img.device)
    x = torch.einsum("pw,...hwc->...hpc", mw, img.float())
    x = torch.clamp(torch.round(x), 0, 255)
    x = torch.einsum("oh,...hwc->...owc", mh, x)
    return torch.clamp(torch.round(x), 0, 255)


def resize_1d(x: torch.Tensor, out_size: int, method: str = "linear_torch", **kw) -> torch.Tensor:
    """Resize the second-to-last axis in fp32 (rel-pos table interpolation,
    torch F.interpolate(mode='linear') at HF modeling_seggpt.py:255)."""
    mat = _matrix(x.shape[-2], out_size, method, x.device, **kw)
    return torch.einsum("ol,...lc->...oc", mat, x.float())
