"""ESRI Shapefile I/O — the slice of fiona/geopandas the pipeline uses.

Read: polygon masks (Mask_*.shp / WaterMask_*.shp → Polygon lists,
ref src/util/geo_util.py:42-54).
Write: shoreline LineString/MultiLineString exports
(ref geo_util.py:574-579; predict_no_prompt.py:157-161).

Self-contained binary implementation of the shapefile spec (.shp/.shx) plus a
minimal .dbf (one FID column — attributes are unused by the pipeline) and a
.prj with the WKT for the raster's EPSG code. CRS handling is a passthrough
string; no datum math is ever needed (all inputs share one CRS, asserted at
extent time).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from beach_seg_tpu_torch.geo.geometry import LineString, MultiLineString, Polygon

SHP_NULL = 0
SHP_POLYLINE = 3
SHP_POLYGON = 5


def _ring_is_clockwise(ring: np.ndarray) -> bool:
    x, y = ring[:, 0], ring[:, 1]
    return float(np.sum((np.roll(x, -1) - x) * (np.roll(y, -1) + y))) > 0


def read_shapefile(path: Path | str) -> tuple[list, str | None]:
    """→ (geometries, crs). Polygons get exterior/hole split by ring winding
    (shapefile spec: outer rings clockwise, holes counter-clockwise)."""
    path = Path(path)
    data = path.read_bytes()
    if len(data) < 100:
        raise OSError(f"truncated shapefile: {path}")
    (shape_type,) = struct.unpack("<i", data[32:36])
    geoms: list = []
    off = 100
    n = len(data)
    while off + 8 <= n:
        _, content_len = struct.unpack(">ii", data[off : off + 8])
        off += 8
        rec_end = off + content_len * 2
        (rtype,) = struct.unpack("<i", data[off : off + 4])
        if rtype == SHP_NULL:
            off = rec_end
            continue
        if rtype in (SHP_POLYLINE, SHP_POLYGON):
            num_parts, num_points = struct.unpack("<ii", data[off + 36 : off + 44])
            parts = np.frombuffer(data, "<i4", num_parts, off + 44)
            pts = np.frombuffer(data, "<f8", num_points * 2, off + 44 + num_parts * 4).reshape(-1, 2)
            starts = list(parts) + [num_points]
            rings = [pts[starts[i] : starts[i + 1]].copy() for i in range(num_parts)]
            rings = [r for r in rings if len(r) >= 2]
            if rtype == SHP_POLYGON:
                # group: each clockwise ring is an exterior; CCW rings are holes
                # assigned to the current exterior (spec ordering)
                current: Polygon | None = None
                ext: np.ndarray | None = None
                holes: list[np.ndarray] = []
                for r in rings:
                    if _ring_is_clockwise(r) or ext is None:
                        if ext is not None:
                            geoms.append(Polygon(ext, holes))
                        ext, holes = r, []
                    else:
                        holes.append(r)
                if ext is not None:
                    geoms.append(Polygon(ext, holes))
            else:
                lines = [LineString(r) for r in rings if len(r) >= 2]
                if len(lines) == 1:
                    geoms.append(lines[0])
                elif lines:
                    geoms.append(MultiLineString(lines))
        off = rec_end
    del shape_type

    crs = None
    prj = path.with_suffix(".prj")
    if prj.exists():
        wkt = prj.read_text()
        # pull an EPSG authority code if present
        import re

        m = re.findall(r'AUTHORITY\["EPSG",\s*"?(\d+)"?\]', wkt)
        if m:
            crs = f"EPSG:{m[-1]}"
    return geoms, crs


def _wkt_for_epsg(epsg: int) -> str:
    """Minimal WKT: UTM northern/southern zones (Planet scenes) + WGS84."""
    if 32601 <= epsg <= 32660 or 32701 <= epsg <= 32760:
        south = epsg > 32700
        zone = epsg - (32700 if south else 32600)
        lon0 = -183 + 6 * zone
        return (
            f'PROJCS["WGS 84 / UTM zone {zone}{"S" if south else "N"}",'
            'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,298.257223563,'
            'AUTHORITY["EPSG","7030"]],AUTHORITY["EPSG","6326"]],'
            'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433],'
            'AUTHORITY["EPSG","4326"]],PROJECTION["Transverse_Mercator"],'
            'PARAMETER["latitude_of_origin",0],'
            f'PARAMETER["central_meridian",{lon0}],'
            'PARAMETER["scale_factor",0.9996],PARAMETER["false_easting",500000],'
            f'PARAMETER["false_northing",{10000000 if south else 0}],'
            'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
            f'AUTHORITY["EPSG","{epsg}"]]'
        )
    if epsg == 4326:
        return (
            'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,298.257223563]],'
            'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433],AUTHORITY["EPSG","4326"]]'
        )
    return f'PROJCS["EPSG:{epsg}",AUTHORITY["EPSG","{epsg}"]]'


def _geometry_parts(geom) -> tuple[int, list[np.ndarray]]:
    if isinstance(geom, Polygon):
        rings = []
        for i, r in enumerate(geom.rings):
            ring = np.asarray(r, np.float64)
            if not np.array_equal(ring[0], ring[-1]):
                ring = np.vstack([ring, ring[:1]])
            cw = _ring_is_clockwise(ring)
            want_cw = i == 0
            if cw != want_cw:
                ring = ring[::-1]
            rings.append(ring)
        return SHP_POLYGON, rings
    if isinstance(geom, MultiLineString):
        return SHP_POLYLINE, [np.asarray(g.coords, np.float64) for g in geom.geoms]
    if isinstance(geom, LineString):
        return SHP_POLYLINE, [np.asarray(geom.coords, np.float64)]
    raise TypeError(f"unsupported geometry {type(geom)}")


def save_shapefile(geoms, out_fp: Path | str, crs: str | int | None) -> None:
    """Write geometries (+ .shx/.dbf/.prj sidecars) — ref geo_util.py:574-579."""
    out_fp = Path(out_fp)
    if not isinstance(geoms, (list, tuple)):
        geoms = [geoms]
    assert geoms, "no geometries"
    parts = [_geometry_parts(g) for g in geoms]
    shape_type = parts[0][0]
    assert all(p[0] == shape_type for p in parts), "mixed geometry types"

    all_pts = np.vstack([np.vstack(rs) for _, rs in parts])
    xmin, ymin = all_pts.min(axis=0)
    xmax, ymax = all_pts.max(axis=0)

    records = b""
    shx_records = b""
    for idx, (_, rings) in enumerate(parts):
        num_points = sum(len(r) for r in rings)
        content = struct.pack("<i", shape_type)
        pts = np.vstack(rings)
        content += struct.pack("<4d", pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max())
        content += struct.pack("<ii", len(rings), num_points)
        start = 0
        for r in rings:
            content += struct.pack("<i", start)
            start += len(r)
        content += pts.astype("<f8").tobytes()
        offset_words = (100 + len(records)) // 2
        shx_records += struct.pack(">ii", offset_words, len(content) // 2)
        records += struct.pack(">ii", idx + 1, len(content) // 2) + content

    def header(total_bytes: int) -> bytes:
        h = struct.pack(">i", 9994) + b"\x00" * 20 + struct.pack(">i", total_bytes // 2)
        h += struct.pack("<ii", 1000, shape_type)
        h += struct.pack("<8d", xmin, ymin, xmax, ymax, 0, 0, 0, 0)
        return h

    out_fp.write_bytes(header(100 + len(records)) + records)
    out_fp.with_suffix(".shx").write_bytes(header(100 + len(shx_records)) + shx_records)

    # minimal dbf: single numeric FID column
    n = len(parts)
    dbf_header = struct.pack("<BBBBIHH20x", 3, 24, 1, 1, n, 33 + 32, 1 + 10)
    field = b"FID\x00\x00\x00\x00\x00\x00\x00\x00" + b"N" + b"\x00" * 4 + bytes([10, 0]) + b"\x00" * 14
    body = b"".join(b" " + str(i).rjust(10).encode() for i in range(n))
    out_fp.with_suffix(".dbf").write_bytes(dbf_header + field + b"\x0d" + body + b"\x1a")

    if crs is not None:
        epsg = int(str(crs).split(":")[-1]) if ":" in str(crs) else int(crs)
        out_fp.with_suffix(".prj").write_text(_wkt_for_epsg(epsg))
