"""Palette build / colorize / distance-decode — the class↔RGB codec
(counterpart of ``beach_seg_tpu/transforms/palette.py``).

SegGPT paints segmentation as RGB images, so class ids round-trip through a
color palette: ``build_palette`` (deterministic Painter palette), ``random_palette``
(per-sample random LUT for prompt tuning), ``apply_palette`` (ids → RGB), ``normalize_palette`` and
``decode_by_palette`` (squared-distance argmin, first index on ties).
"""

from __future__ import annotations

import numpy as np
import torch

from beach_seg_tpu_torch.utils.profiling import tensor_from_host

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def build_palette(num_labels: int) -> np.ndarray:
    """Deterministic Painter palette: (num_labels + 1, 3) uint8, row 0 black."""
    base = int(num_labels ** (1 / 3)) + 1
    margin = 256 // base
    colors = [(0, 0, 0)]
    for location in range(num_labels):
        num_seq_r = location // base**2
        num_seq_g = (location % base**2) // base
        num_seq_b = location % base
        colors.append(
            (255 - num_seq_r * margin, 255 - num_seq_g * margin, 255 - num_seq_b * margin)
        )
    return np.array(colors, dtype=np.uint8)


def random_palette(generator: torch.Generator, num_labels: int, batch_size: int) -> torch.Tensor:
    """(B, num_labels, 3) uint8 random LUT on ``generator``'s device, entries
    uniform in [0, 256), class 0 forced black (ref src/util/ml_util.py:99-111)."""
    lut = torch.randint(0, 256, (batch_size, num_labels, 3), generator=generator, device=generator.device)
    lut[:, 0] = 0
    return lut.to(torch.uint8)


def apply_palette(palette: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Colorize class ids with a per-sample LUT.

    palette: (B, N, 3) uint8/int; mask: (B, H, W) integer ids → (B, H, W, 3)
    float32 in [0, 1]. An id outside [0, N) paints black, as in the JAX
    package's select loop."""
    ids = mask.to(torch.int64)[..., None]  # (B, H, W, 1)
    pal = palette.float()
    rgb = torch.zeros((*mask.shape, 3), dtype=torch.float32, device=mask.device)
    for cls in range(pal.shape[1]):
        color = pal[:, cls].reshape(pal.shape[0], *([1] * (mask.ndim - 1)), 3)
        rgb = torch.where(ids == cls, color, rgb)
    return rgb / 255.0


def normalize_palette(palette: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """Palette colors through the image normalization: ([0,1] - mean)/std."""
    p = palette.float() / 255.0
    mean = tensor_from_host(mean, dtype=torch.float32, device=p.device)
    std = tensor_from_host(std, dtype=torch.float32, device=p.device)
    return (p - mean) / std


def decode_by_palette(pred_rgb: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """Painted RGB (B, H, W, 3) → (B, H, W) int32 class ids by the argmax of
    2·x·p − |p|² (= the squared-distance argmin); ties go to the first index.
    ``palette``: (B, N, 3) or (N, 3), in the color space of ``pred_rgb``."""
    if palette.ndim == 2:
        palette = palette[None].expand(pred_rgb.shape[0], *palette.shape)
    b, h, w, _ = pred_rgb.shape
    x = pred_rgb.reshape(b, h * w, 3).float()
    p = palette.float()
    scores = torch.einsum("bqc,bnc->bqn", x, p) * 2.0 - (p * p).sum(-1)[:, None, :]
    return torch.argmax(scores, dim=-1).reshape(b, h, w).to(torch.int32)
