"""Marching-squares contour extraction — skimage ``measure.find_contours``
replacement, plus the reference's shoreline cleanup
(ref src/util/geo_util.py:83-156).

``find_contours`` follows skimage conventions: input indexed (row, col),
output contours are (N, 2) float arrays of (row, col) positions, with linear
interpolation to the iso-level on cell edges. Saddle cells are disambiguated
by the cell-mean rule (skimage's default, no ``fully_connected``).
"""

from __future__ import annotations

import numpy as np

from beach_seg_tpu_torch.geo.geometry import LineString, MultiLineString, merge_segments


def _cell_segments(m: np.ndarray, level: float) -> list[tuple[tuple, tuple]]:
    """All marching-squares segments, as ((r, c), (r, c)) float point pairs."""
    m = m.astype(np.float64)
    h, w = m.shape
    tl = m[:-1, :-1]
    tr = m[:-1, 1:]
    bl = m[1:, :-1]
    br = m[1:, 1:]
    case = (
        (tl > level).astype(np.int8) * 8
        + (tr > level).astype(np.int8) * 4
        + (br > level).astype(np.int8) * 2
        + (bl > level).astype(np.int8) * 1
    )
    rows, cols = np.nonzero((case > 0) & (case < 15))
    segs: list[tuple[tuple, tuple]] = []

    def interp(v0: float, v1: float) -> float:
        return 0.5 if v1 == v0 else (level - v0) / (v1 - v0)

    for r, c in zip(rows.tolist(), cols.tolist()):
        v_tl, v_tr = m[r, c], m[r, c + 1]
        v_bl, v_br = m[r + 1, c], m[r + 1, c + 1]
        top = (float(r), c + interp(v_tl, v_tr))
        bottom = (float(r + 1), c + interp(v_bl, v_br))
        left = (r + interp(v_tl, v_bl), float(c))
        right = (r + interp(v_tr, v_br), float(c + 1))
        k = case[r, c]
        if k == 1:
            segs.append((left, bottom))
        elif k == 2:
            segs.append((bottom, right))
        elif k == 3:
            segs.append((left, right))
        elif k == 4:
            segs.append((right, top))
        elif k == 5:  # saddle
            if (v_tl + v_tr + v_bl + v_br) / 4.0 > level:
                segs.append((right, bottom))
                segs.append((left, top))
            else:
                segs.append((left, bottom))
                segs.append((right, top))
        elif k == 6:
            segs.append((bottom, top))
        elif k == 7:
            segs.append((left, top))
        elif k == 8:
            segs.append((top, left))
        elif k == 9:
            segs.append((top, bottom))
        elif k == 10:  # saddle
            if (v_tl + v_tr + v_bl + v_br) / 4.0 > level:
                segs.append((top, right))
                segs.append((bottom, left))
            else:
                segs.append((top, left))
                segs.append((bottom, right))
        elif k == 11:
            segs.append((top, right))
        elif k == 12:
            segs.append((right, left))
        elif k == 13:
            segs.append((right, bottom))
        elif k == 14:
            segs.append((bottom, left))
    return segs


def _cell_segments_native(m: np.ndarray, level: float) -> np.ndarray | None:
    try:
        import ctypes

        from beach_seg_tpu_torch.native.build import load

        lib = load()
    except Exception:
        return None
    lib.bst_marching_squares.restype = ctypes.c_int
    img = np.ascontiguousarray(m, np.float32)
    cap = 4 * (m.shape[0] * m.shape[1] // 16 + 1024)
    while True:
        buf = np.empty((cap, 4), np.float64)
        n = lib.bst_marching_squares(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            m.shape[0],
            m.shape[1],
            ctypes.c_double(level),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cap,
        )
        if n >= 0:
            return buf[:n]
        cap = -n


def _contour_chains(image: np.ndarray, level: float) -> tuple[np.ndarray, np.ndarray]:
    """:func:`find_contours` flat: (points (m, 2) (row, col), offsets (k + 1,))."""
    segs = _cell_segments_native(np.asarray(image), level)
    if segs is None:
        segs = np.asarray(_cell_segments(np.asarray(image), level), np.float64).reshape(-1, 4)
    if not len(segs):
        return np.zeros((0, 2)), np.zeros(1, np.int64)
    return merge_segments(segs[:, :2], segs[:, 2:])


def find_contours(image: np.ndarray, level: float = 0.5) -> list[np.ndarray]:
    """Iso-contours of a 2-D array at ``level`` → list of (N, 2) (row, col)."""
    pts, offsets = _contour_chains(image, level)
    return [pts[a:b] for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]


def _near_nodata(nodata_mask: np.ndarray) -> np.ndarray:
    """``nodata_mask[row - 1 : row + 2, col - 1 : col + 2].any()`` for every
    (row, col): the 3×3 neighbourhood clipped at the far edges, and False in
    row 0 and column 0, where the slice's negative start makes it empty
    (the reference's numpy behavior; so for images at least 3 px wide)."""
    nd = np.asarray(nodata_mask).astype(bool)
    h, w = nd.shape
    pad = np.pad(nd, 1)
    near = np.zeros_like(nd)
    for dr in range(3):
        for dc in range(3):
            near |= pad[dr : dr + h, dc : dc + w]
    near[0, :] = False
    near[:, 0] = False
    return near


def extract_linestring(
    mask: np.ndarray, nodata_mask: np.ndarray, length_threshold: float = 0.3
) -> MultiLineString | LineString | None:
    """Clean boundary line of a binary mask: drop segments touching the image
    edge or within 1 px of nodata, merge, filter short pieces (exact
    behavioral port of ref geo_util.py:83-156; coords come out as (x, y))."""
    h, w = mask.shape
    pts, offsets = _contour_chains(mask.astype(float), 0.5)
    if len(offsets) < 2:
        return None

    # every step p1 → p2 within a contour is kept unless p1 lies on the image
    # edge or the step's midpoint (rounded half to even) lies within 1 px of
    # nodata
    within = np.ones(len(pts) - 1, bool)
    within[offsets[1:-1] - 1] = False  # no step from one contour's end to the next one's start
    p1, p2 = pts[:-1][within], pts[1:][within]
    keep = (p1[:, 0] > 0) & (p1[:, 0] < h - 1) & (p1[:, 1] > 0) & (p1[:, 1] < w - 1)
    p1, p2 = p1[keep], p2[keep]
    mid = (p1 + p2) / 2.0
    rows, cols = np.rint(mid[:, 0]).astype(np.int64), np.rint(mid[:, 1]).astype(np.int64)
    if h >= 3 and w >= 3:
        clear = ~_near_nodata(nodata_mask)[rows, cols]
    else:  # an image under 3 px wide: the reference's slices, one by one
        clear = np.array([not nodata_mask[r - 1 : r + 2, c - 1 : c + 2].any() for r, c in zip(rows, cols)], bool)
    if not clear.any():
        return None
    chains, offsets = merge_segments(p1[clear, ::-1], p2[clear, ::-1])  # (x, y)

    # the chains' lengths, summed per chain (one vectorized pass), pick the
    # candidates; the kept lines' lengths are then LineString.length's own
    # (relative slack 1e-9, far above the two sums' rounding difference)
    step = np.linalg.norm(np.diff(chains, axis=0), axis=1)
    step[offsets[1:-1] - 1] = 0.0
    approx = np.add.reduceat(step, offsets[:-1]) if len(step) else np.zeros(1)
    cut = length_threshold * approx.max() * (1.0 - 1e-9)
    lines = [LineString(chains[offsets[c] : offsets[c + 1]]) for c in np.nonzero(approx >= cut)[0].tolist()]
    max_len = max(line.length for line in lines)
    filtered = [line for line in lines if line.length >= length_threshold * max_len]
    if not filtered:
        return None
    if len(filtered) == 1:
        return filtered[0]
    return MultiLineString(filtered)
