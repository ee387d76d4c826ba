"""Host time of the torch port's contour merge on a per-pixel-noise class map.

    python3 scripts/time_contour_merge.py [--height 2048] [--width 1024] [--linemerge]

Draws a 0/1 map with every pixel set at random (a seeded 0.5 draw: the
speckle a randomly initialized model paints), finds its marching-squares
segments, then times ``geo.geometry.merge_segments`` on them twice: with the
native chain walk (``bst_merge_chains``) and with the Python walk
(``BEACH_SEG_TPU_NO_NATIVE=1``), each after the same NumPy keying; then
``geo.contours.extract_linestring`` on the map with each walk. With
``--linemerge`` it also times ``geo.geometry.linemerge`` on the same
segments, the merge the JAX package runs. Prints one JSON line of seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NO_NATIVE = "BEACH_SEG_TPU_NO_NATIVE"


def timed(fn, native: bool):
    if native:
        os.environ.pop(NO_NATIVE, None)
    else:
        os.environ[NO_NATIVE] = "1"
    try:
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t
    finally:
        os.environ.pop(NO_NATIVE, None)


def main() -> int:
    from beach_seg_tpu_torch.geo import contours, geometry

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=2048)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--linemerge", action="store_true")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    mask = rng.random((args.height, args.width)) < 0.5
    nodata = np.zeros(mask.shape, bool)
    nodata[:, : args.width // 8] = True
    segs = contours._cell_segments_native(mask.astype(float), 0.5)
    res = {"host": platform.processor() or platform.machine(), "cpus": os.cpu_count(),
           "map": list(mask.shape), "segments": len(segs)}

    merged = {}
    for name, native in (("native", True), ("python", False)):
        merged[name], res[f"merge_segments_{name}_s"] = timed(lambda: geometry.merge_segments(segs[:, :2], segs[:, 2:]), native)
    for a, b in zip(merged["native"], merged["python"]):
        assert np.array_equal(a, b), "the two walks differ"
    res["chains"] = len(merged["native"][1]) - 1
    lines = {}
    for name, native in (("native", True), ("python", False)):
        lines[name], res[f"extract_linestring_{name}_s"] = timed(lambda: contours.extract_linestring(mask, nodata), native)
    if args.linemerge:
        pieces = [geometry.LineString(s.reshape(2, 2)) for s in segs]
        _, res["linemerge_s"] = timed(lambda: geometry.linemerge(pieces), True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
