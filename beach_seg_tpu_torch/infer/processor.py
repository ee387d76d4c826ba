"""SegGPT image-processor equivalents, HF image_processing_seggpt.py parity
(counterpart of ``beach_seg_tpu/infer/processor.py``).

``preprocess_image``/``preprocess_mask`` reproduce SegGptImageProcessor
.preprocess: PIL-BICUBIC resize to the model size + rescale + ImageNet
normalize for images; painter-palette colorize + PIL-NEAREST resize +
normalize for prompt masks. ``post_process_semantic`` reproduces
post_process_semantic_segmentation: bottom half → denormalize →
torch-nearest resize to target → palette distance argmin.

The host functions work on numpy arrays through the port's resize matrices
(``ops.resize``); ``normalize_device`` and ``post_process_semantic_device``
are their halves on torch tensors, on whatever device the tensor lies.
"""

from __future__ import annotations

import numpy as np
import torch

from beach_seg_tpu_torch.ops.resize import nearest_indices, resize_matrix, resize_pil_uint8
from beach_seg_tpu_torch.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    build_palette,
)


def _resize_hwc(img: np.ndarray, out_size: int, method: str) -> np.ndarray:
    h, w = img.shape[:2]
    mh = resize_matrix(h, out_size, method)
    mw = resize_matrix(w, out_size, method)
    out = np.einsum("oh,hwc->owc", mh, img.astype(np.float32), optimize=True)
    return np.einsum("pw,hwc->hpc", mw, out, optimize=True)


def preprocess_image(img: np.ndarray, size: int = 448) -> np.ndarray:
    """(H, W, 3) uint8 → (size, size, 3) float32 normalized (HF preprocess:
    PIL-BICUBIC resize — with PIL's uint8 intermediate — rescale 1/255,
    ImageNet normalize).

    This runs host-side only, so uint8 inputs go through PIL itself —
    bit-exact with the HF processor (which converts numpy→PIL→numpy) and
    faster than the matrix fallback. The matrix path stays for float inputs
    and for environments stripped of PIL."""
    if img.dtype == np.uint8:
        try:
            from PIL import Image

            pil = Image.fromarray(img).resize((size, size), Image.BICUBIC)
            out = np.asarray(pil).astype(np.float64) / 255.0
        except ImportError:
            out = resize_pil_uint8(img, (size, size)).astype(np.float64) / 255.0
    else:
        out = _resize_hwc(img, size, "bicubic_pil") / 255.0
    return ((out - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def preprocess_image_u8(img: np.ndarray, size: int = 448) -> np.ndarray:
    """Resize-only half of :func:`preprocess_image`: (H, W, 3) uint8 →
    (size, size, 3) uint8 via PIL (bit-exact with the HF processor's resize).
    Pair with :func:`normalize_device` — staging uint8 instead of normalized
    float32 moves 4× fewer bytes to the device."""
    if img.shape[0] == size and img.shape[1] == size:
        return np.ascontiguousarray(img)
    try:
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize((size, size), Image.BICUBIC))
    except ImportError:
        return resize_pil_uint8(img, (size, size))


def preprocess_mask_u8(mask: np.ndarray, num_labels: int, size: int = 448) -> np.ndarray:
    """Colorize+resize-only half of :func:`preprocess_mask`: (H, W) ids →
    (size, size, 3) uint8 palette colors (NEAREST is a pure selection, so
    the uint8 stays exact)."""
    palette = build_palette(num_labels)
    rgb = palette[mask.astype(np.int64)]
    m = nearest_indices(rgb.shape[0], size, "nearest_pil")
    mw = nearest_indices(rgb.shape[1], size, "nearest_pil")
    return rgb[m][:, mw]


def normalize_device(u8: torch.Tensor) -> torch.Tensor:
    """Device half of the HF preprocess: uint8 → rescale 1/255 → ImageNet
    normalize, in fp32 (≤1 ulp from the host f64 path)."""
    x = u8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def preprocess_mask(mask: np.ndarray, num_labels: int, size: int = 448) -> np.ndarray:
    """(H, W) ids → (size, size, 3) normalized painter-palette colors (HF
    mask_to_rgb + NEAREST resize + rescale + normalize)."""
    palette = build_palette(num_labels)  # (num_labels+1, 3) uint8
    rgb = palette[mask.astype(np.int64)]  # (H, W, 3)
    out = _resize_hwc(rgb, size, "nearest_pil") / 255.0
    return ((out - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def post_process_semantic_device(pred_masks: torch.Tensor, target_size: tuple[int, int], num_labels: int) -> torch.Tensor:
    """Device twin of :func:`post_process_semantic`: (B, 2H, W, 3) painted
    canvases → (B, th, tw) uint8 class ids, so only the id maps cross back
    to the host."""
    h = pred_masks.shape[1] // 2
    dev = pred_masks.device
    masks = pred_masks[:, h:].float()
    masks = masks * torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev) + torch.tensor(
        IMAGENET_MEAN, dtype=torch.float32, device=dev
    )
    th, tw = target_size
    if (th, tw) != tuple(masks.shape[1:3]):
        # nearest matrices are one-hot row selectors → exact gathers
        idx_h = torch.from_numpy(nearest_indices(masks.shape[1], th, "nearest_torch")).to(dev)
        idx_w = torch.from_numpy(nearest_indices(masks.shape[2], tw, "nearest_torch")).to(dev)
        masks = masks.index_select(1, idx_h).index_select(2, idx_w)
    palette = torch.from_numpy(build_palette(num_labels).astype(np.float32)).to(dev)  # (N, 3)
    # HF clips the denormalized colors to the palette range BEFORE the
    # distance argmin (image_processing_seggpt.py: torch.clip(masks*255,0,255))
    scaled = torch.clamp(masks * 255.0, 0.0, 255.0)
    dist = ((scaled[..., None, :] - palette) ** 2).sum(-1)
    return dist.argmin(-1).to(torch.uint8)


def post_process_semantic(
    pred_masks: np.ndarray, target_size: tuple[int, int], num_labels: int
) -> np.ndarray:
    """(B, 2H, W, 3) painted canvases → (B, th, tw) class ids (HF
    post_process_semantic_segmentation:550-612)."""
    h2 = pred_masks.shape[1]
    h = h2 // 2
    masks = np.asarray(pred_masks[:, h:], np.float32)
    # de-normalize back to [0,1] color space
    masks = masks * np.asarray(IMAGENET_STD) + np.asarray(IMAGENET_MEAN)
    th, tw = target_size
    if (th, tw) != masks.shape[1:3]:
        mh = resize_matrix(masks.shape[1], th, "nearest_torch")
        mw = resize_matrix(masks.shape[2], tw, "nearest_torch")
        masks = np.einsum("oh,bhwc->bowc", mh, masks, optimize=True)
        masks = np.einsum("pw,bhwc->bhpc", mw, masks, optimize=True)
    palette = build_palette(num_labels).astype(np.float32)  # raw 0..255 colors
    # HF clips to the palette range before the distance (torch.clip(·,0,255))
    scaled = np.clip(masks * 255.0, 0.0, 255.0)
    dist = ((scaled[..., None, :] - palette) ** 2).sum(-1)  # (B,th,tw,N)
    return dist.argmin(-1).astype(np.int32)
