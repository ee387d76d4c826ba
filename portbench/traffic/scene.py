"""A seeded beach scene held in memory: the reference date's display mosaic,
its class map and the crop windows along the shoreline.

The geometry is ``chip_smoke.write_scene``'s, frozen here: a 2048×1024
raster at 3 m, water below a wavy shoreline across the full width,
vegetation above a second wavy line, sand between, with per-pixel noise. The
colors are the display RGB that the port's mosaic makes of such a scene
(water dark blue, sand pale, vegetation green). A strip at the left edge has
no data. The crop windows are ``n_crops`` squares centred on the shoreline at
even steps across the width, as the shoreline walk lays them out at zero
overlap.

Only arrays come out of here, so the reference can cut and resize the same
crops with Pillow and owe the port nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

W, H = 2048, 1024
NODATA_COLS = 24
CLASSES = ("nodata", "sand", "water", "veg")
# display RGB of water, sand and vegetation
COLORS = {"water": (40, 70, 120), "sand": (205, 190, 150), "veg": (60, 110, 50)}


def shoreline_row(x: np.ndarray) -> np.ndarray:
    """The water line's row at column ``x`` (two waves, ±85 rows)."""
    return 0.55 * H + 60 * np.sin(2 * np.pi * x / 700) + 25 * np.sin(2 * np.pi * x / 230 + 1)


def vegetation_row(x: np.ndarray) -> np.ndarray:
    return shoreline_row(x) - 220 + 30 * np.cos(2 * np.pi * x / 500)


@dataclass
class SceneArrays:
    image: np.ndarray  # (H, W, 3) uint8
    nodata: np.ndarray  # (H, W) bool
    label: np.ndarray  # (H, W) uint8 class ids, CLASSES order
    crops: list[tuple[int, int, int, int]]  # (xmin, ymin, xmax, ymax)


def make_scene(seed: int, n_crops: int, crop_size: int) -> SceneArrays:
    rng = np.random.default_rng([seed, 3])
    cols = np.arange(W)[None, :]
    rows = np.arange(H)[:, None]
    wet = rows >= shoreline_row(cols)
    green = rows < vegetation_row(cols)
    dry = ~wet & ~green
    nodata = np.zeros((H, W), bool)
    nodata[:, :NODATA_COLS] = True
    label = np.zeros((H, W), np.uint8)
    label[wet] = CLASSES.index("water")
    label[green] = CLASSES.index("veg")
    label[dry] = CLASSES.index("sand")
    label[nodata] = 0
    image = np.zeros((H, W, 3), np.int32)
    for name, where in (("water", wet), ("sand", dry), ("veg", green)):
        image[where] = COLORS[name]
    image += rng.integers(-20, 21, (H, W, 3))
    image = np.clip(image, 0, 255).astype(np.uint8)
    image[nodata] = 0
    half = crop_size // 2
    xs = np.linspace(half, W - half, n_crops)
    crops = []
    for x in xs:
        cx, cy = int(round(x)), int(round(float(shoreline_row(np.asarray(x)))))
        crops.append((cx - half, cy - half, cx - half + crop_size, cy - half + crop_size))
    return SceneArrays(image, nodata, label, crops)
