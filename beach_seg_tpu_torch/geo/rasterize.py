"""Polygon rasterization — GDAL ``rasterio.features.rasterize`` replacement
(ref src/util/geo_util.py:221-229).

Semantics match GDAL's default (ALL_TOUCHED=FALSE): a pixel is burned when its
CENTER lies inside the polygon, by even-odd scanline counting. Holes are
handled by even-odd within a polygon's ring set; multiple shapes OR together
(for binary masks this equals rasterize(union(shapes)) — the reference unions
first (geo_util.py:42-54), we get the same raster without needing GEOS).
"""

from __future__ import annotations

import numpy as np

from beach_seg_tpu_torch.geo.affine import Affine
from beach_seg_tpu_torch.geo.geometry import Polygon


def _ring_crossings(ring: np.ndarray, n_rows: int) -> list[np.ndarray]:
    """For each pixel row, x-coords (pixel space) where ring edges cross the
    row-center scanline y = row + 0.5."""
    p0 = ring
    p1 = np.roll(ring, -1, axis=0)
    # drop degenerate closing edge if ring is explicitly closed
    keep = ~np.all(p0 == p1, axis=1)
    p0, p1 = p0[keep], p1[keep]
    y0, y1 = p0[:, 1], p1[:, 1]
    x0, x1 = p0[:, 0], p1[:, 0]
    ys = np.arange(n_rows, dtype=np.float64) + 0.5

    lo = np.minimum(y0, y1)
    hi = np.maximum(y0, y1)
    out: list[np.ndarray] = []
    for r in range(n_rows):
        y = ys[r]
        # half-open [lo, hi): counts each vertex crossing once
        sel = (lo <= y) & (y < hi)
        if not sel.any():
            out.append(np.empty(0))
            continue
        t = (y - y0[sel]) / (y1[sel] - y0[sel])
        out.append(x0[sel] + t * (x1[sel] - x0[sel]))
    return out


def _rings_to_pixel(poly: Polygon, transform: Affine | None) -> list[np.ndarray]:
    inv = ~transform if transform is not None else None
    rings_px = []
    for ring in poly.rings:
        if inv is not None:
            xs = inv.a * ring[:, 0] + inv.b * ring[:, 1] + inv.c
            ys = inv.d * ring[:, 0] + inv.e * ring[:, 1] + inv.f
            rings_px.append(np.stack([xs, ys], axis=1))
        else:
            rings_px.append(np.asarray(ring, np.float64))
    return rings_px


def _rasterize_native(rings_px: list[np.ndarray], out_shape: tuple[int, int]) -> np.ndarray:
    import ctypes

    from beach_seg_tpu_torch.native.build import load

    lib = load()
    lib.bst_rasterize.restype = ctypes.c_int
    pts = np.ascontiguousarray(np.vstack(rings_px), np.float64)
    sizes = np.asarray([len(r) for r in rings_px], np.int32)
    out = np.zeros(out_shape, np.uint8)
    lib.bst_rasterize(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(rings_px),
        out_shape[0],
        out_shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def rasterize_polygon(
    poly: Polygon,
    out_shape: tuple[int, int],
    transform: Affine | None = None,
    native: bool = True,
) -> np.ndarray:
    """(H, W) uint8 binary raster of one polygon (with holes)."""
    rings_px = _rings_to_pixel(poly, transform)
    if native:
        try:
            return _rasterize_native(rings_px, out_shape)
        except Exception:  # toolchain missing → numpy fallback
            pass
    h, w = out_shape
    mask = np.zeros((h, w), np.uint8)
    per_ring = [_ring_crossings(r, h) for r in rings_px]
    centers = np.arange(w, dtype=np.float64) + 0.5
    for row in range(h):
        xs = np.concatenate([pr[row] for pr in per_ring]) if per_ring else np.empty(0)
        if xs.size == 0:
            continue
        # even-odd: inside where the count of crossings left of the center is odd
        counts = np.searchsorted(np.sort(xs), centers, side="right")
        mask[row] |= (counts & 1).astype(np.uint8)
    return mask


def rasterize(
    shapes: list[Polygon],
    out_shape: tuple[int, int],
    transform: Affine | None = None,
) -> np.ndarray:
    """Binary OR of polygon rasters (ref rasterize_gdf, geo_util.py:221-229)."""
    out = np.zeros(out_shape, np.uint8)
    for poly in shapes:
        out |= rasterize_polygon(poly, out_shape, transform)
    return out
