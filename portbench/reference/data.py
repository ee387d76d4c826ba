"""Plain crops of a scene, as a train batch or a prompt holds them.

A crop window (xmin, ymin, xmax, ymax) is cut boundless: pixels outside the
raster are 0 in the image and the class map and 1 (missing) in the nodata
mask. The image goes to the model's input size with Pillow's bicubic filter,
the class map and nodata with its nearest filter; a crop with data but no
label is marked sand where it has data (BeachSeg's stand-in for unlabelled
crops)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def cut(arr: np.ndarray, window: tuple[int, int, int, int], fill) -> np.ndarray:
    xmin, ymin, xmax, ymax = window
    out = np.full((ymax - ymin, xmax - xmin, *arr.shape[2:]), fill, dtype=arr.dtype)
    h, w = arr.shape[:2]
    x0, x1, y0, y1 = max(xmin, 0), min(xmax, w), max(ymin, 0), min(ymax, h)
    if x0 < x1 and y0 < y1:
        out[y0 - ymin:y1 - ymin, x0 - xmin:x1 - xmin] = arr[y0:y1, x0:x1]
    return out


def item(image: np.ndarray, nodata: np.ndarray, label: np.ndarray, window, size: int) -> dict:
    """One crop at the model's input size: image (S, S, 3) fp32 in [0, 1],
    class ids (S, S) int32, nodata (S, S) bool."""
    img = cut(image, window, 0)
    nod = cut(nodata.astype(np.uint8), window, 1)
    lab = cut(label, window, 0)
    img = np.asarray(Image.fromarray(img).resize((size, size), Image.BICUBIC)).astype(np.float32) / 255.0
    nod = np.asarray(Image.fromarray(nod).resize((size, size), Image.NEAREST)).astype(bool)
    lab = np.asarray(Image.fromarray(lab).resize((size, size), Image.NEAREST)).astype(np.int32)
    if not nod.all() and (lab == 0).all():
        lab[~nod] = 1
    return {"image": img, "mask": lab, "nodata": nod}


def epoch_batches(n_items: int, batch: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """The rows of an epoch's batches: the items shuffled by NumPy's
    generator from ``seed``, the last batch padded with its last item; →
    [(item index per row, valid per row)]."""
    order = np.arange(n_items)
    np.random.default_rng(seed).shuffle(order)
    out = []
    for start in range(0, n_items, batch):
        idx = order[start:start + batch]
        valid = np.arange(batch) < len(idx)
        out.append((np.concatenate([idx, np.repeat(idx[-1:], batch - len(idx))]), valid))
    return out
