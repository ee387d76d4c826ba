"""Shoreline distance metrics (counterpart of
``beach_seg_tpu/geo/line_metrics.py``) — the reference's only quantitative
evaluation beyond F1 (ASD + Hausdorff, ref notebooks/beach.ipynb cell 10).

The notebook bails out (returns -1) on MultiLineString predictions; here both
metrics handle multi-part lines properly (sampling spans the parts, distances
take the nearest part) — the intended semantics.
"""

from __future__ import annotations

import numpy as np

from beach_seg_tpu_torch.geo.geometry import LineString, MultiLineString


def _parts(line) -> list[np.ndarray]:
    if isinstance(line, MultiLineString):
        return [g.coords for g in line.geoms]
    return [line.coords]


def _sample_points(line, num: int) -> np.ndarray:
    dists = np.linspace(0, line.length, num=num)
    return np.asarray([line.interpolate(d) for d in dists])


def _points_to_line_distance(points: np.ndarray, line) -> np.ndarray:
    """Min distance from each point to any segment of ``line`` (vectorized)."""
    best = np.full(len(points), np.inf)
    for coords in _parts(line):
        a = coords[:-1]  # (M, 2)
        b = coords[1:]
        ab = b - a
        denom = np.maximum((ab * ab).sum(axis=1), 1e-300)  # (M,)
        ap = points[:, None, :] - a[None, :, :]  # (N, M, 2)
        t = np.clip((ap * ab[None]).sum(-1) / denom, 0.0, 1.0)  # (N, M)
        proj = a[None] + t[..., None] * ab[None]
        d = np.linalg.norm(points[:, None, :] - proj, axis=-1).min(axis=1)
        best = np.minimum(best, d)
    return best


def average_symmetric_distance(line_pred, line_label, num_samples: int = 1000) -> float:
    """ASD: mean(pred→label distances) and mean(label→pred distances), halved
    (notebook cell 10 formula; units = the lines' coordinate units)."""
    pred_pts = _sample_points(line_pred, num_samples)
    label_pts = _sample_points(line_label, num_samples)
    d_p2l = _points_to_line_distance(pred_pts, line_label)
    d_l2p = _points_to_line_distance(label_pts, line_pred)
    return float((d_p2l.mean() + d_l2p.mean()) / 2.0)


def hausdorff_distance(line_pred, line_label) -> float:
    """Discrete Hausdorff on the vertices (shapely ``hausdorff_distance``
    semantics: vertex-to-geometry distances, max over both directions)."""
    pv = np.vstack(_parts(line_pred))
    lv = np.vstack(_parts(line_label))
    d1 = _points_to_line_distance(pv, line_label).max()
    d2 = _points_to_line_distance(lv, line_pred).max()
    return float(max(d1, d2))
