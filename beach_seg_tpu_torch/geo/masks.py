"""Mask derivation and windowed crops (ref src/util/geo_util.py:232-371).

``merged_no_data_mask`` is the vectorized form of the reference's per-row scan:
it marks pixels outside the labeled corridor spanned between the water and veg
hand-drawn masks. The crop helpers are boundless (out-of-bounds filled with a
constant) and exactly mirror padded_crop/crop_tif/safe_assign_crop.
"""

from __future__ import annotations

import numpy as np


def merged_no_data_mask(water_mask: np.ndarray, veg_mask: np.ndarray) -> np.ndarray:
    """(H, W) bool: True outside the [water-extent … veg-extent] span per row
    (exact semantics of ref geo_util.py:232-270, vectorized)."""
    h, w = veg_mask.shape
    water = water_mask.astype(bool)
    veg = veg_mask.astype(bool)
    any_w = water.any(axis=1)
    any_v = veg.any(axis=1)

    cols = np.arange(w)
    w_first = np.where(any_w, water.argmax(axis=1), 0)
    w_last = np.where(any_w, w - 1 - water[:, ::-1].argmax(axis=1), 0)
    v_first = np.where(any_v, veg.argmax(axis=1), 0)
    v_last = np.where(any_v, w - 1 - veg[:, ::-1].argmax(axis=1), 0)

    # keep-interval [start, end) per row, replicating each reference branch
    both = any_w & any_v
    only_v = ~any_w & any_v
    only_w = any_w & ~any_v
    # both: veg right of water (veg_start >= water_end) → keep [w_first, v_last+1)
    #       else                                        → keep [v_first, w_last+1)
    veg_right = v_first >= w_last
    start = np.select(
        [only_v, only_w, both & veg_right, both & ~veg_right],
        [v_first, w_first, w_first, v_first],
        default=0,
    )
    end = np.select(
        [only_v, only_w, both & veg_right, both & ~veg_right],
        [v_last + 1, w_last + 1, v_last + 1, w_last + 1],
        default=0,
    )
    active = any_w | any_v
    out = (cols[None, :] < start[:, None]) | (cols[None, :] >= end[:, None])
    out &= active[:, None]
    return out


def padded_crop(
    arr: np.ndarray,
    xmin: int,
    ymin: int,
    xmax: int,
    ymax: int,
    crop_size: int,
    value: int | float = 0,
) -> np.ndarray:
    """Boundless crop with constant fill (ref geo_util.py:316-341)."""
    if arr.ndim == 3:
        h, w, c = arr.shape
        padded = np.full((crop_size, crop_size, c), value, dtype=arr.dtype)
    else:
        h, w = arr.shape
        padded = np.full((crop_size, crop_size), value, dtype=arr.dtype)

    x0, x1 = max(xmin, 0), min(xmax, w)
    y0, y1 = max(ymin, 0), min(ymax, h)
    ystart = y0 - ymin
    xstart = x0 - xmin
    padded[ystart : ystart + (y1 - y0), xstart : xstart + (x1 - x0)] = arr[y0:y1, x0:x1]
    return padded


def crop_tif(
    crop: tuple[int, int, int, int],
    img: np.ndarray,
    nodata: np.ndarray,
    label: np.ndarray | None,
    crop_size: int,
):
    """(img, nodata, label) boundless crops; nodata fills with 1 = missing
    (ref geo_util.py:297-313)."""
    xmin, ymin, xmax, ymax = crop
    crop_img = padded_crop(img, xmin, ymin, xmax, ymax, crop_size)
    crop_nodata = padded_crop(nodata, xmin, ymin, xmax, ymax, crop_size, value=1)
    crop_label = None
    if label is not None:
        crop_label = padded_crop(label, xmin, ymin, xmax, ymax, crop_size)
    return crop_img, crop_nodata, crop_label


def create_per_day_crops(
    crops: list[tuple[int, int, int, int]],
    img: np.ndarray,
    nodata: np.ndarray,
    label: np.ndarray | None,
    crop_size: int,
):
    """Batch crop_tif over a crop list (ref geo_util.py:273-294)."""
    imgs, labels, nodatas = [], [], []
    for crop in crops:
        ci, cn, cl = crop_tif(crop, img, nodata, label, crop_size)
        imgs.append(ci)
        nodatas.append(cn)
        labels.append(cl if cl is not None else np.zeros((crop_size, crop_size), np.uint8))
    return imgs, labels, nodatas


def safe_assign_crop(
    output: np.ndarray,
    crop: np.ndarray,
    ymin: int,
    ymax: int,
    xmin: int,
    xmax: int,
    logic: str = "or",
) -> None:
    """Clipped paste into a mosaic, "or" or ascending-max merge
    (ref geo_util.py:344-371; legacy inference path)."""
    h, w = output.shape
    dy0, dy1 = max(ymin, 0), min(ymax, h)
    dx0, dx1 = max(xmin, 0), min(xmax, w)
    sy0 = dy0 - ymin
    sx0 = dx0 - xmin
    sy1 = sy0 + (dy1 - dy0)
    sx1 = sx0 + (dx1 - dx0)
    if sy1 <= sy0 or sx1 <= sx0:
        return
    if logic == "or":
        output[dy0:dy1, dx0:dx1] |= crop[sy0:sy1, sx0:sx1]
    else:
        src = crop[sy0:sy1, sx0:sx1]
        dst = output[dy0:dy1, dx0:dx1]
        np.maximum(dst, src, out=dst)
