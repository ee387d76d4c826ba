"""Notebook/exploration helpers (counterpart of
``beach_seg_tpu/geo/notebook_utils.py``; ref src/util/geo_util.py:425-571 and
notebooks/): windowed crop display reads, polygon→mask, matplotlib plots.

These back the interactive workflows (inspect predictions, scene alignment)
— not on any hot path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw

from beach_seg_tpu_torch.geo.display import broad_band
from beach_seg_tpu_torch.geo.geometry import Polygon
from beach_seg_tpu_torch.geo.masks import padded_crop
from beach_seg_tpu_torch.geo.tiff import read
from beach_seg_tpu_torch.ops.resize import resize_matrix


def polygon_to_mask(image_size: tuple[int, int], polygon: Polygon) -> np.ndarray:
    """Shapely-polygon → binary mask via PIL ImageDraw (exact port of ref
    geo_util.py:548-571; note PIL rasterization differs slightly from the
    GDAL center rule — this helper keeps the reference's notebook behavior)."""
    img = Image.new("L", image_size, 0)
    coords = [(float(x), float(y)) for x, y in polygon.exterior]
    ImageDraw.Draw(img).polygon(coords, outline=1, fill=1)
    return np.array(img)


def equalize_adapthist(img: np.ndarray, clip_limit: float = 0.01) -> np.ndarray:
    """CLAHE on a float [0,1] RGB/gray image (skimage equalize_adapthist
    stand-in, implemented with cv2's CLAHE per channel)."""
    import cv2

    x = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    clahe = cv2.createCLAHE(clipLimit=max(clip_limit * 255, 1.0), tileGridSize=(8, 8))
    if x.ndim == 2:
        return clahe.apply(x).astype(np.float32) / 255.0
    out = np.stack([clahe.apply(x[..., i]) for i in range(x.shape[-1])], axis=-1)
    return out.astype(np.float32) / 255.0


def crop_with_mask(pth: Path, win: tuple[int, int, int, int], crop_size: int):
    """Windowed display read: (xmin, ymin, xmax, ymax) pixel window → (RGB
    uint8 crop, invalid mask) (behavioral port of ref geo_util.py:490-545:
    8-band → broad_band; 4-band → log-scaled [4,3,2]; CLAHE at the end)."""
    r = read(pth, dtype=np.float32)
    xmin, ymin, xmax, ymax = win
    size = max(xmax - xmin, ymax - ymin)
    bands = np.stack(
        [padded_crop(b, xmin, ymin, xmin + size, ymin + size, size) for b in r.data]
    )
    valid = padded_crop(
        (r.valid_mask() > 0).astype(np.uint8), xmin, ymin, xmin + size, ymin + size, size
    ).astype(bool)
    mask = ~valid
    if size != crop_size:
        m = resize_matrix(size, crop_size, "bilinear_pil")
        bands = np.einsum("oh,chw->cow", m, np.einsum("pw,chw->chp", m, bands))
        mn = resize_matrix(size, crop_size, "nearest_pil")
        mask = (np.einsum("oh,hw->ow", mn, np.einsum("pw,hw->hp", mn, mask.astype(np.float32))) > 0.5)
    if mask.all():
        return np.zeros((crop_size, crop_size, 3), np.uint8), mask

    if len(bands) == 8:
        img = broad_band(bands, mask)
    else:
        sel = bands[[3, 2, 1]] if len(bands) >= 4 else bands[:3]
        img = np.log10(1 + sel)
        img -= img[:, ~mask].min()
        img /= max(img[:, ~mask].max(), 1e-12)
        img[:, mask] = 0
        img = img.transpose(1, 2, 0).copy()
    img = (equalize_adapthist(img) * 255).astype(np.uint8)
    return img, mask


def align_scene_rotated_bbox(valid_mask: np.ndarray):
    """Rotated-bbox scene alignment (ref notebooks/beach.ipynb cell 5: cv2
    minAreaRect over the valid footprint). Returns (center, (w, h), angle_deg)
    and the 4 box corner points — used to rotate SkySat/Dove scenes upright."""
    import cv2

    pts = cv2.findNonZero(valid_mask.astype(np.uint8))
    rect = cv2.minAreaRect(pts)
    box = cv2.boxPoints(rect)
    return rect, box


def compute_rotation_matrix_for_mask(mask: np.ndarray):
    """Rotation that lays the mask's min-area bbox long side horizontal, with
    bounds expanded so nothing crops (ref notebooks/beach.ipynb cell 5,
    verbatim semantics). Returns (rot_matrix 2×3, (new_w, new_h), angle_deg).
    """
    import cv2

    contours, _ = cv2.findContours(
        mask.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    all_points = np.vstack(contours)
    rect = cv2.minAreaRect(all_points)
    center, size, angle = rect
    if size[0] < size[1]:
        angle += 90
    rot_matrix = cv2.getRotationMatrix2D(center, angle, 1.0)
    h, w = mask.shape[:2]
    cos = np.abs(rot_matrix[0, 0])
    sin = np.abs(rot_matrix[0, 1])
    new_w = int(h * sin + w * cos)
    new_h = int(h * cos + w * sin)
    rot_matrix[0, 2] += (new_w / 2) - center[0]
    rot_matrix[1, 2] += (new_h / 2) - center[1]
    return rot_matrix, (new_w, new_h), angle


def rotate_array(array: np.ndarray, rot_matrix, output_size, interpolation=None):
    """cv2.warpAffine companion to :func:`compute_rotation_matrix_for_mask`."""
    import cv2

    if interpolation is None:
        interpolation = cv2.INTER_LINEAR
    return cv2.warpAffine(array, rot_matrix, output_size, flags=interpolation)


# ------------------------------------------------------------- matplotlib


def plot_line(line, color, ax, linewidth: float = 0.5) -> None:
    """(ref geo_util.py:425-432)"""
    geoms = line.geoms if line.geom_type == "MultiLineString" else [line]
    for g in geoms:
        ax.plot(g.coords[:, 0], g.coords[:, 1], color=color, linewidth=linewidth)


def plot_mask(mask: np.ndarray, color, alpha: float, ax) -> None:
    """(ref geo_util.py:435-439)"""
    from matplotlib import colors as mcolors

    rgba = np.array([*mcolors.to_rgb(color), alpha])
    h, w = mask.shape
    ax.imshow(mask.reshape(h, w, 1) * rgba.reshape(1, 1, -1))


def plot_crops(crops, color, ax) -> None:
    """(ref geo_util.py:442-446)"""
    from matplotlib.patches import Rectangle

    for x1, y1, x2, y2 in crops:
        side = max(x2 - x1, y2 - y1)
        ax.add_patch(
            Rectangle((x1, y1), side, side, linewidth=1, edgecolor=color, facecolor="none")
        )
