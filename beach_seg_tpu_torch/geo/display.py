"""Radiometric → display-RGB recipes and prediction overlays.

Behavioral ports of src/util/multichannel_img.py (SuperDove
8-band recipes), geo_util.tif_image (4-band Dove recipe, geo_util.py:449-470)
and img_util.py (contrast stretchers, overlays, 1-bit PNG).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image, ImageColor

CLASS_COLORS = {"nodata": None, "water": "yellow", "veg": "blue", "sand": "hotpink"}

RGB_BANDS = (5, 3, 1)
NIR_R_G = (7, 5, 3)


def broad_band(all_bands: np.ndarray, no_data: np.ndarray) -> np.ndarray:
    """8-band SuperDove → natural-color log RGB (ref multichannel_img.py:7-29)."""
    red = np.mean(all_bands[5:], axis=0)
    green = np.mean(all_bands[2:5], axis=0)
    blue = np.mean(all_bands[:2], axis=0)
    rgb_log = np.dstack([np.log10(1.0 + red), np.log10(1.0 + green), np.log10(1.0 + blue)])
    mins = np.array([rgb_log[:, :, i][~no_data].min() for i in range(3)])
    rgb_log -= mins
    rgb_log /= rgb_log.max(axis=(0, 1))
    rgb_log[no_data] = 0.0
    return rgb_log


def tristimulus(all_bands: np.ndarray, no_data: np.ndarray) -> np.ndarray:
    """8-band tristimulus recipe (ref multichannel_img.py:33-81)."""
    red = np.log10(1.0 + all_bands[4] * 0.85 + all_bands[5] * (0.12 + 0.9 + 0.04) + all_bands[6] + all_bands[7])
    green = np.log10(
        1.0
        + all_bands[0] * 0.26
        + all_bands[1] * 0.21
        + all_bands[2] * 0.50
        + all_bands[3] * 0.38
        + all_bands[4] * 0.04
        + all_bands[5] * (0.03 + 0.02)
    )
    blue = np.log10(1.0 + all_bands[0] * (0.28 + 1.77) + all_bands[1] * 0.27 + all_bands[2] * 0.16)
    rgb = np.dstack([red, green, blue])
    mins = np.array([rgb[:, :, i][~no_data].min() for i in range(3)])
    rgb[no_data] = mins
    rgb -= mins
    rgb /= rgb.max(axis=(0, 1))
    rgb[no_data] = 0.0
    return rgb


def rgb_log_image(all_bands: np.ndarray, no_data: np.ndarray) -> np.ndarray:
    img = np.array([np.log10(1.0 + all_bands[i]) for i in RGB_BANDS]).transpose(1, 2, 0).copy()
    img -= img[~no_data].min(axis=(0, 1))
    img /= img[~no_data].max(axis=(0, 1))
    img[no_data] = 0.0
    return img


def false_color_log(all_bands: np.ndarray, no_data: np.ndarray) -> np.ndarray:
    img = np.zeros((*no_data.shape, 3), np.float32)
    idx = NIR_R_G if len(all_bands) == 8 else (3, 2, 1)
    for i, b in enumerate(idx):
        img[:, :, i] = all_bands[b]
    img = np.log10(1 + img)
    img -= img[~no_data].min()
    img /= img[~no_data].max()
    img[no_data] = 0.0
    return img


def tif_image(data: np.ndarray, nodata: np.ndarray) -> np.ndarray:
    """(C, H, W) radiometric → (H, W, 3) display uint8 (ref geo_util.py:449-470):
    8-band → broad_band; 4-band Dove → R=b4, G=b3, B=mean(b1,b2), clipped to
    [min, min+3000], per-channel max-normalized, nodata zeroed."""
    c = len(data)
    if c == 8:
        img = broad_band(data, nodata)
    else:
        img = np.zeros((3, *data.shape[1:]), data.dtype)
        img[0] = data[3]
        img[1] = data[2]
        img[2] = data[:2].mean(axis=0)
        min_val = img[:, ~nodata].min()
        img = img.clip(min_val, 3000 + min_val)
        img -= min_val
        # the reference subtracts the valid-pixel min a second time here
        # (geo_util.py:461) — after the clip-to-[min, min+3000] and subtract,
        # that min is exactly 0 (the global min is attained at a valid pixel
        # and clip preserves it), so the pass is skipped bit-identically
        # promote integer rasters (Dove tifs are uint16) before the per-channel
        # normalize: the reference's in-place /= crashes on integer input
        # (geo_util.py:464 UFuncTypeError) — float values are identical
        if not np.issubdtype(img.dtype, np.floating):
            img = img.astype(np.float64)
        for i in range(3):
            img[i] /= img[i].max()
            img[i][nodata] = 0
        img = img.transpose(1, 2, 0).copy()
    if np.issubdtype(img.dtype, np.floating):
        np.multiply(img, 255, out=img)  # in-place: skip the full-frame temp
        return img.astype(np.uint8)
    return np.array(img * 255, dtype=np.uint8)


def color_to_rgba(color: str, alpha: float = 1.0) -> tuple:
    """Color name/hex → (R, G, B, A) 0-255 (ref geo_util.py:473-486)."""
    from matplotlib import colors as mcolors

    rgb = mcolors.to_rgb(color)
    return tuple(int(255 * c) for c in rgb) + (int(255 * alpha),)


def contrast_stretch(image: np.ndarray, p_low: int = 2, p_high: int = 98) -> np.ndarray:
    """Percentile stretch per channel (ref img_util.py:15-33)."""
    image = image.astype(np.float32)
    orig_shape = image.shape
    if image.ndim == 2:
        image = image[None]
    for idx in range(image.shape[0]):
        v_min, v_max = np.percentile(image[idx], (p_low, p_high))
        image[idx] = np.clip((image[idx] - v_min) / (v_max - v_min), 0, 1)
    return image[0] if len(orig_shape) == 2 else image


def masked_contrast_stretch(
    image: np.ndarray, mask: np.ndarray, p_low: int | None = 2, p_high: int = 98
) -> np.ndarray:
    """Stretch using only pixels under ``mask`` (ref img_util.py:36-56)."""
    image = image.astype(np.float32)
    orig_shape = image.shape
    if image.ndim == 2:
        image = image[None]
    for idx in range(image.shape[0]):
        v_min, v_max = np.percentile(image[idx][mask], (p_low if p_low is not None else 0, p_high))
        if p_low is None:
            v_min = 0
        image[idx] = np.clip((image[idx] - v_min) / (v_max - v_min), 0, 1)
    return image[0] if len(orig_shape) == 2 else image


def write_1bit_png(filename: Path, img: np.ndarray) -> None:
    Image.fromarray(img).convert(mode="1", dither=Image.Dither.NONE).save(filename, optimize=True)


def overlay_prediction(img: np.ndarray, pred: np.ndarray, classes: tuple[str, ...]) -> Image.Image:
    """30%-alpha class overlay composited on the mosaic (ref img_util.py:98-116)."""
    h, w, _ = img.shape
    base_img = Image.fromarray(img)
    overlay_rgba = np.zeros((h, w, 4), np.uint8)
    alpha_val = int(255 * 0.3)
    for cls_idx, color_name in enumerate(CLASS_COLORS[c] for c in classes):
        if color_name is None:
            continue
        rgb = ImageColor.getrgb(color_name)
        overlay_rgba[pred == cls_idx] = (*rgb, alpha_val)
    overlay_img = Image.fromarray(overlay_rgba, mode="RGBA")
    return Image.alpha_composite(base_img.convert("RGBA"), overlay_img).convert("RGB")
