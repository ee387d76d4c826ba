"""The eval half of the augmentation pipeline (counterpart of
``beach_seg_tpu/transforms/augment.py``): normalization and center crop.
The train augmentations come with the training slice."""

from __future__ import annotations

import torch

from beach_seg_tpu_torch.transforms.palette import IMAGENET_MEAN, IMAGENET_STD


def normalize_imagenet(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """(…, H, W, 3) in [0,1] → normalized, arithmetic in ``x.dtype``."""
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def center_crop(x: torch.Tensor, size: int, spatial_axes: tuple[int, int] = (-3, -2)) -> torch.Tensor:
    """Static center crop on the two spatial axes (kornia K.CenterCrop)."""
    h_ax, w_ax = [a % x.ndim for a in spatial_axes]
    h, w = x.shape[h_ax], x.shape[w_ax]
    top, left = (h - size) // 2, (w - size) // 2
    idx = [slice(None)] * x.ndim
    idx[h_ax] = slice(top, top + size)
    idx[w_ax] = slice(left, left + size)
    return x[tuple(idx)]


def eval_augment(
    image: torch.Tensor,
    mask: torch.Tensor,
    nodata: torch.Tensor,
    size: int,
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
):
    """Eval pipeline: CenterCrop(size) + Normalize (ref data.py:226-234)."""
    img = center_crop(image.float(), size)
    mask = center_crop(mask, size, spatial_axes=(-2, -1))
    nodata = center_crop(nodata, size, spatial_axes=(-2, -1))
    return normalize_imagenet(img, mean, std), mask, nodata
