"""Scene discovery + global raster grid (ref src/util/geo_util.py:27-39,159-218)."""

from __future__ import annotations

import math
from pathlib import Path

from beach_seg_tpu_torch.geo.affine import Affine
from beach_seg_tpu_torch.geo.tiff import read_info


def tif_paths(directory: Path) -> list[Path]:
    return sorted(p for p in directory.iterdir() if p.suffix == ".tif")


def geojson_paths(directory: Path) -> list[Path]:
    return sorted(p for p in directory.iterdir() if p.suffix == ".geojson")


def get_masks(mask_dir: Path, pattern: str) -> list[Path]:
    return sorted(mask_dir.glob(pattern))


def infer_date(mask_paths: list[Path]) -> str:
    """Masks must share a single YYYYMMDD date (ref geo_util.py:200-207)."""
    dates = {p.stem.split("_")[1] for p in mask_paths}
    if len(dates) != 1:
        raise ValueError(f"Inconsistent mask dates: {dates}")
    return dates.pop()


def group_images_by_date(img_paths: list[Path]) -> dict[str, list[Path]]:
    """Group TIFFs by the YYYYMMDD prefix of the stem (ref geo_util.py:210-218)."""
    groups: dict[str, list[Path]] = {}
    for p in img_paths:
        groups.setdefault(p.stem.split("_")[0], []).append(p)
    return groups


def compute_raster_extent(paths: list[Path]) -> tuple[Affine, tuple[int, int], str | None]:
    """Union of GeoTIFF bounds → global north-up grid; asserts identical CRS
    and pixel size across files (ref geo_util.py:159-197)."""
    assert len(paths) > 0
    paths = sorted(paths)
    first = read_info(paths[0])
    left, bottom, right, top = first.bounds
    tx, ty = first.transform.a, -first.transform.e
    base_crs = first.crs
    for p in paths[1:]:
        info = read_info(p)
        if info.crs != base_crs:
            raise ValueError(f"CRS mismatch: {p} has {info.crs}, expected {base_crs}")
        b = info.bounds
        left, bottom = min(left, b[0]), min(bottom, b[1])
        right, top = max(right, b[2]), max(top, b[3])
        assert info.transform.a == tx and info.transform.e == -ty, f"pixel size mismatch: {p}"

    width = int(math.ceil((right - left) / tx))
    height = int(math.ceil((top - bottom) / ty))
    return Affine(tx, 0.0, left, 0.0, -ty, top), (height, width), base_crs
