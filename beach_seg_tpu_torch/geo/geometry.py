"""Polyline/polygon geometry — the slice of shapely/GEOS this pipeline uses.

The reference leans on shapely for: LineString length / arc-length
``interpolate`` (crop placement, ref src/util/ml_util.py:20-66), ``linemerge``
of contour segments (ref src/util/geo_util.py:134), and polygon containers
from shapefiles. Geometry is host work (SURVEY.md §2.12), so this is pure
NumPy.

Coordinates are (x, y) float64 throughout, matching shapely.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class LineString:
    coords: np.ndarray  # (N, 2) float64 (x, y)

    def __init__(self, coords):
        arr = np.asarray(coords, np.float64).reshape(-1, 2)
        if len(arr) < 2:
            raise ValueError("LineString needs ≥ 2 points")
        object.__setattr__(self, "coords", arr)

    @property
    def length(self) -> float:
        return float(np.linalg.norm(np.diff(self.coords, axis=0), axis=1).sum())

    def interpolate(self, distance: float) -> tuple[float, float]:
        """Point at arc length ``distance`` (clamped to the ends) — shapely
        ``line.interpolate(d)`` semantics."""
        seg = np.diff(self.coords, axis=0)
        seg_len = np.linalg.norm(seg, axis=1)
        cum = np.concatenate([[0.0], np.cumsum(seg_len)])
        d = float(np.clip(distance, 0.0, cum[-1]))
        i = int(np.searchsorted(cum, d, side="right") - 1)
        i = min(i, len(seg_len) - 1)
        t = 0.0 if seg_len[i] == 0 else (d - cum[i]) / seg_len[i]
        p = self.coords[i] + t * seg[i]
        return (float(p[0]), float(p[1]))

    @property
    def geom_type(self) -> str:
        return "LineString"

    def __len__(self) -> int:
        return len(self.coords)


@dataclass(frozen=True)
class MultiLineString:
    geoms: tuple[LineString, ...]

    def __init__(self, lines):
        object.__setattr__(self, "geoms", tuple(lines))

    @property
    def length(self) -> float:
        return float(sum(g.length for g in self.geoms))

    def interpolate(self, distance: float) -> tuple[float, float]:
        """Arc length measured across the parts in order (shapely semantics)."""
        d = max(0.0, float(distance))
        for g in self.geoms:
            if d <= g.length:
                return g.interpolate(d)
            d -= g.length
        return self.geoms[-1].interpolate(self.geoms[-1].length)

    @property
    def geom_type(self) -> str:
        return "MultiLineString"


@dataclass(frozen=True)
class Polygon:
    """Exterior ring + holes; rings are (N, 2) (x, y), closed or open."""

    exterior: np.ndarray
    holes: tuple[np.ndarray, ...] = field(default_factory=tuple)

    def __init__(self, exterior, holes=()):
        object.__setattr__(self, "exterior", np.asarray(exterior, np.float64).reshape(-1, 2))
        object.__setattr__(self, "holes", tuple(np.asarray(h, np.float64).reshape(-1, 2) for h in holes))

    @property
    def rings(self) -> list[np.ndarray]:
        return [self.exterior, *self.holes]

    @property
    def geom_type(self) -> str:
        return "Polygon"


def _key(p: np.ndarray, decimals: int = 9) -> tuple:
    return (round(float(p[0]), decimals), round(float(p[1]), decimals))


def linemerge(lines: list[LineString]) -> LineString | MultiLineString | None:
    """Merge lines sharing endpoints into maximal chains (shapely
    ``linemerge``): walk from every endpoint of degree ≠ 2, then sweep up
    remaining pure cycles. Branching nodes (degree > 2) break chains."""
    if not lines:
        return None
    # adjacency: endpoint key → list of (line index, end: 0 start / 1 end)
    adj: dict[tuple, list[tuple[int, int]]] = {}
    for i, ln in enumerate(lines):
        for end, p in ((0, ln.coords[0]), (1, ln.coords[-1])):
            adj.setdefault(_key(p), []).append((i, end))

    used = [False] * len(lines)
    merged: list[np.ndarray] = []

    def walk(start_i: int, start_end: int) -> np.ndarray:
        """Consume a chain starting from line ``start_i`` entered at
        ``start_end`` (the free endpoint)."""
        used[start_i] = True
        c = lines[start_i].coords
        chain = list(c if start_end == 0 else c[::-1])
        while True:
            tail = _key(np.asarray(chain[-1]))
            nxt = [(i, e) for (i, e) in adj.get(tail, []) if not used[i]]
            if len(adj.get(tail, [])) != 2 or not nxt:
                break
            i, e = nxt[0]
            used[i] = True
            c = lines[i].coords
            seq = c if e == 0 else c[::-1]
            chain.extend(seq[1:])
        return np.asarray(chain)

    # chains between non-degree-2 nodes
    for key, items in adj.items():
        if len(items) == 2:
            continue
        for i, e in items:
            if not used[i]:
                merged.append(walk(i, e))
    # remaining cycles
    for i in range(len(lines)):
        if not used[i]:
            merged.append(walk(i, 0))

    merged = [m for m in merged if len(m) >= 2]
    if not merged:
        return None
    if len(merged) == 1:
        return LineString(merged[0])
    return MultiLineString([LineString(m) for m in merged])


def generate_square_crops_along_line(
    line: LineString | MultiLineString, crop_size: int, overlap: int
) -> list[tuple[int, int, int, int]]:
    """Square windows centered at fixed arc-length steps along the shoreline
    (exact behavioral port of ref src/util/ml_util.py:20-66)."""
    if not (0 <= overlap < crop_size):
        raise ValueError("`overlap` must be >=0 and < `crop_size`")
    total_length = line.length
    step = crop_size - overlap
    distances = list(np.arange(0, total_length + step, step))
    if distances[-1] < total_length:
        distances.append(total_length)

    boxes = []
    half = crop_size / 2.0
    for d in distances:
        cx, cy = line.interpolate(d)
        # Python 3 round() (banker's) — matches the reference's int(round())
        xmin = int(round(cx - half))
        ymin = int(round(cy - half))
        boxes.append((xmin, ymin, xmin + crop_size, ymin + crop_size))
    return boxes
