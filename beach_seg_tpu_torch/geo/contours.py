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

from beach_seg_tpu_torch.geo.geometry import LineString, MultiLineString, linemerge


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


def _cell_segments_native(m: np.ndarray, level: float) -> list[tuple[tuple, tuple]] | None:
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
            return [((r0, c0), (r1, c1)) for r0, c0, r1, c1 in buf[:n]]
        cap = -n


def find_contours(image: np.ndarray, level: float = 0.5) -> list[np.ndarray]:
    """Iso-contours of a 2-D array at ``level`` → list of (N, 2) (row, col)."""
    segs = _cell_segments_native(np.asarray(image), level)
    if segs is None:
        segs = _cell_segments(np.asarray(image), level)
    if not segs:
        return []
    lines = [LineString([a, b]) for a, b in segs]
    merged = linemerge(lines)
    if merged is None:
        return []
    if isinstance(merged, LineString):
        return [merged.coords]
    return [g.coords for g in merged.geoms]


def extract_linestring(
    mask: np.ndarray, nodata_mask: np.ndarray, length_threshold: float = 0.3
) -> MultiLineString | LineString | None:
    """Clean boundary line of a binary mask: drop segments touching the image
    edge or within 1 px of nodata, merge, filter short pieces (exact
    behavioral port of ref geo_util.py:83-156; coords come out as (x, y))."""
    h, w = mask.shape
    contours = find_contours(mask.astype(float), level=0.5)
    if not contours:
        return None

    all_segments = []
    for contour in contours:
        for i in range(len(contour) - 1):
            p1 = contour[i]
            p2 = contour[i + 1]
            if p1[0] <= 0 or p1[0] >= h - 1 or p1[1] <= 0 or p1[1] >= w - 1:
                continue
            mid = (p1 + p2) / 2.0
            row, col = int(round(mid[0])), int(round(mid[1]))
            # NOTE: negative slice starts intentionally reproduce the
            # reference's numpy behavior at the top/left borders
            if nodata_mask[row - 1 : row + 2, col - 1 : col + 2].any():
                continue
            all_segments.append((tuple(p1[::-1]), tuple(p2[::-1])))  # (x, y)

    if not all_segments:
        return None

    merged = linemerge([LineString([a, b]) for a, b in all_segments])
    if merged is None:
        return None
    lines = [merged] if isinstance(merged, LineString) else list(merged.geoms)

    max_len = max(line.length for line in lines)
    filtered = [line for line in lines if line.length >= length_threshold * max_len]
    if not filtered:
        return None
    if len(filtered) == 1:
        return filtered[0]
    return MultiLineString(filtered)
