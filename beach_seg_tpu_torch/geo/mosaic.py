"""Per-date mosaics: same-CRS reprojection + validity-weighted mean
(ref src/util/geo_util.py:374-422).

The reference calls rasterio ``reproject`` per image (cubic for data, nearest
for validity). All scene TIFFs share one CRS and pixel size (asserted at
extent time, geo_util.py:183-190), so reprojection onto the global grid is an
axis-aligned affine resample — expressed here as two dense sampling-matrix
multiplies per image (the same matrix-resize formulation as ops.resize, GDAL
cubic kernel a=-0.5). For the common integer-offset case the matrices
degenerate to selection matrices and the result is an exact windowed copy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from beach_seg_tpu_torch.geo.affine import Affine
from beach_seg_tpu_torch.geo.display import tif_image
from beach_seg_tpu_torch.geo.tiff import read


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax**3
    return np.where(
        ax <= 1.0,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2.0, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )


def affine_sample_matrix(
    in_size: int, out_size: int, offset: float, scale: float, method: str = "cubic"
) -> tuple[np.ndarray, np.ndarray]:
    """Dense (out, in) sampling matrix for one axis plus an out-of-extent mask.

    Output center i samples source coordinate ``offset + (i + 0.5)·scale - 0.5``.
    Returns (matrix, valid) where ``valid[i]`` is False when the sample center
    falls outside the source extent (dst filled there).
    """
    centers = offset + (np.arange(out_size) + 0.5) * scale - 0.5
    valid = (centers > -0.5) & (centers < in_size - 0.5)
    mat = np.zeros((out_size, in_size), np.float32)
    if method == "nearest":
        src = np.clip(np.floor(centers + 0.5).astype(np.int64), 0, in_size - 1)
        mat[np.arange(out_size), src] = 1.0
        return mat, valid
    # cubic, 4 taps
    lo = np.floor(centers).astype(np.int64) - 1
    taps = lo[:, None] + np.arange(4)[None, :]
    w = _cubic(centers[:, None] - taps)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    taps_c = np.clip(taps, 0, in_size - 1)
    np.add.at(mat, (np.repeat(np.arange(out_size), 4), taps_c.ravel()), w.ravel())
    return mat, valid


def _translate_axis(
    src: np.ndarray, axis: int, out_size: int, offset: float, method: str
) -> tuple[np.ndarray, np.ndarray]:
    """Scale-1 resample along one axis: a constant k-tap stencil shared by
    every output pixel (offset is the same fraction everywhere), O(N·k)
    instead of the dense O(N²) matrix. Returns (resampled, valid mask)."""
    in_size = src.shape[axis]
    centers0 = offset - 0.5 + 0.5  # source coord of output pixel 0 center
    base = int(np.floor(centers0))
    frac = centers0 - base
    if method == "nearest":
        taps = np.array([0])
        weights = np.array([1.0], np.float32)
        base = int(np.floor(centers0 + 0.5))
    else:
        taps = np.arange(4) - 1
        weights = _cubic(frac - taps).astype(np.float32)
        weights /= max(weights.sum(), 1e-12)
    out_shape = list(src.shape)
    out_shape[axis] = out_size
    out = np.zeros(out_shape, np.float32)
    for t, wgt in zip(taps, weights):
        src_lo = base + t  # source index feeding output 0
        o0 = max(0, -src_lo)
        s0 = max(0, src_lo)
        n = min(out_size - o0, in_size - s0)
        if n <= 0:
            continue
        sl_out = [slice(None)] * src.ndim
        sl_src = [slice(None)] * src.ndim
        sl_out[axis] = slice(o0, o0 + n)
        sl_src[axis] = slice(s0, s0 + n)
        # clamp-to-edge for taps that run off the source (torch/GDAL replicate)
        out[tuple(sl_out)] += wgt * src[tuple(sl_src)].astype(np.float32)
        # edge replication for out-of-range taps at the borders
        if s0 == 0 and src_lo < 0:
            sl_e = [slice(None)] * src.ndim
            sl_e[axis] = slice(0, min(-src_lo, out_size))
            sl_s = [slice(None)] * src.ndim
            sl_s[axis] = slice(0, 1)
            out[tuple(sl_e)] += wgt * src[tuple(sl_s)].astype(np.float32)
        if s0 + n == in_size and o0 + n < out_size:
            sl_e = [slice(None)] * src.ndim
            sl_e[axis] = slice(o0 + n, out_size)
            sl_s = [slice(None)] * src.ndim
            sl_s[axis] = slice(in_size - 1, in_size)
            out[tuple(sl_e)] += wgt * src[tuple(sl_s)].astype(np.float32)
    centers = offset + np.arange(out_size)
    valid = (centers > -0.5) & (centers < in_size - 0.5)
    return out, valid


def reproject(
    src: np.ndarray,
    src_transform: Affine,
    dst_shape: tuple[int, int],
    dst_transform: Affine,
    method: str = "cubic",
    fill: float = 0.0,
) -> np.ndarray:
    """Same-CRS affine resample of (C, h, w) → (C, H, W) (rasterio.reproject
    for the axis-aligned equal-CRS case, ref geo_util.py:390-408).

    Scale-1 (equal pixel sizes — the only case this pipeline produces, the
    extent step asserts it) takes an O(H·W) constant-stencil path; unequal
    scales fall back to the dense sampling-matrix formulation.

    INVARIANT: the returned array is always freshly allocated and never
    aliases ``src`` — callers (merge_tifs's fast path) mutate it in place.
    Any future fast path (e.g. a zero-shift identity) must copy rather than
    return ``src`` directly."""
    assert src_transform.b == 0 and src_transform.d == 0, "rotated source grid"
    assert dst_transform.b == 0 and dst_transform.d == 0, "rotated destination grid"
    c, h, w = src.shape
    out_h, out_w = dst_shape
    off_x = (dst_transform.c - src_transform.c) / src_transform.a
    off_y = (dst_transform.f - src_transform.f) / src_transform.e
    sx = dst_transform.a / src_transform.a
    sy = dst_transform.e / src_transform.e

    if (
        abs(sx - 1.0) < 1e-9
        and abs(sy - 1.0) < 1e-9
        and abs(off_x - round(off_x)) < 1e-9
        and abs(off_y - round(off_y)) < 1e-9
    ):
        # integer-shift fast path: every resample kernel (nearest/bilinear/
        # cubic) is exact interpolation at integer offsets, so the result is
        # a pure crop/pad — the overwhelmingly common case (inputs already on
        # the common grid) and a large share of host CPU on small hosts
        ox, oy = int(round(off_x)), int(round(off_y))
        out = np.full((c, out_h, out_w), fill, np.float32)
        ys0, yd0 = max(oy, 0), max(-oy, 0)
        n_y = min(h - ys0, out_h - yd0)
        xs0, xd0 = max(ox, 0), max(-ox, 0)
        n_x = min(w - xs0, out_w - xd0)
        if n_y > 0 and n_x > 0:
            out[:, yd0 : yd0 + n_y, xd0 : xd0 + n_x] = src[:, ys0 : ys0 + n_y, xs0 : xs0 + n_x]
        want = src.dtype if method == "nearest" else np.float32
        # astype always copies — skip it when the dtype already matches (a
        # full-raster copy is a measurable share of merge time on small hosts)
        return out if out.dtype == want else out.astype(want)

    if abs(sx - 1.0) < 1e-9 and abs(sy - 1.0) < 1e-9:
        out, valid_y = _translate_axis(src, 1, out_h, off_y, method)
        out, valid_x = _translate_axis(out, 2, out_w, off_x, method)
    else:
        wx, valid_x = affine_sample_matrix(w, out_w, off_x, sx, method)
        wy, valid_y = affine_sample_matrix(h, out_h, off_y, sy, method)
        out = np.einsum("oh,chw,pw->cop", wy, src.astype(np.float32), wx, optimize=True)
    invalid = ~(valid_y[:, None] & valid_x[None, :])
    out[:, invalid] = fill
    want = src.dtype if method == "nearest" else np.float32
    return out if out.dtype == want else out.astype(want)


def merge_tifs(
    ref_imgs: list[Path],
    out_shape: tuple[int, int],
    out_transform: Affine,
    crs: str | None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-date mosaic → (display-RGB uint8 HWC, nodata bool) — exact
    behavioral port of ref geo_util.py:374-422: cubic-reproject each image,
    nearest-reproject its validity, validity-weighted mean, nodata where no
    image covers, then display-RGB conversion via ``tif_image``."""
    # file decode (native, releases the GIL) + reprojection are independent
    # per image — run them on a thread pool
    from concurrent.futures import ThreadPoolExecutor

    def load_one(p: Path):
        r = read(p, dtype=np.float32)
        if crs is not None and r.crs is not None:
            assert r.crs == crs, f"CRS mismatch: {p}"
        data = reproject(r.data, r.transform, out_shape, out_transform, "cubic")
        yes = r.valid_mask()[None].astype(np.uint8)
        yes = reproject(yes, r.transform, out_shape, out_transform, "nearest", fill=0)[0]
        return data, yes

    # CPU-aware: the decode releases the GIL but the reprojection einsums are
    # CPU-hot — oversubscribing a small host serializes everything through
    # context switches (1-CPU hosts measured 35x slower with thread fan-out)
    import os as _os

    inner = min(8, max(1, len(ref_imgs)), max(1, (_os.cpu_count() or 2)))
    with ThreadPoolExecutor(max_workers=inner) as pool:
        results = list(pool.map(load_one, ref_imgs))
    n_ch = results[0][0].shape[0]
    assert all(d.shape[0] == n_ch for d, _ in results)
    if len(results) == 1:
        # single-image date (the common case): the validity-weighted mean
        # degenerates to "data where covered, 0 elsewhere" — data·1/1 is
        # exact in IEEE, so this is bit-identical to the general path while
        # skipping the stack/multiply/sum/divide full-raster passes
        data, yes = results[0]
        nodata = yes == 0
        data[:, nodata] = 0.0  # fresh reproject output — safe to mutate
        return tif_image(data, nodata), nodata
    dst_data = np.stack([d for d, _ in results])
    dst_yesdata = np.stack([y for _, y in results])

    w = dst_yesdata.astype(np.float32)[:, None]
    weighted_sum = (dst_data * w).sum(axis=0)
    weights = w.sum(axis=0)[0]
    mean = np.divide(
        weighted_sum, weights, out=np.zeros_like(weighted_sum), where=weights != 0
    )
    nodata = ~np.any(dst_yesdata, axis=0)
    img = tif_image(mean, nodata)
    return img, nodata
