"""Vote-mosaic accumulator: overlapping crop predictions → per-date outputs.

Behavioral port of the two reference accumulators
(src/predict.py:55-159 and src/predict_no_prompt.py:109-186):
one-hot votes are added into a per-date (H, W, C) counter with clipped crop
pastes; on save the argmax mosaic is exported as overlay PNG, raw mask PNG,
georeferenced mask GeoTIFF, and (optionally) per-class shoreline shapefiles in
world coordinates.

Fixes quirk #10 (SURVEY.md): the reference uses uint8 counters which wrap
after 255 overlapping crops; votes here are int32.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
from PIL import Image

from beach_seg_tpu_torch.geo.affine import Affine
from beach_seg_tpu_torch.geo.contours import extract_linestring
from beach_seg_tpu_torch.geo.display import overlay_prediction
from beach_seg_tpu_torch.geo.geometry import LineString, MultiLineString
from beach_seg_tpu_torch.geo.shapefile import save_shapefile
from beach_seg_tpu_torch.geo.tiff import write as write_tiff

logger = logging.getLogger(__name__)


def transform_line(line, transform: Affine):
    """Pixel-space line → world coordinates (ref predict_no_prompt.py:160)."""

    def tx(coords: np.ndarray) -> np.ndarray:
        x = transform.a * coords[:, 0] + transform.b * coords[:, 1] + transform.c
        y = transform.d * coords[:, 0] + transform.e * coords[:, 1] + transform.f
        return np.stack([x, y], axis=1)

    if isinstance(line, LineString):
        return LineString(tx(line.coords))
    return MultiLineString([LineString(tx(g.coords)) for g in line.geoms])


class VoteAccumulator:
    """Context manager; feed crops via ``update``, flushes per date."""

    def __init__(
        self,
        out_shape: tuple[int, int],
        save_dir: Path,
        out_transform: Affine,
        crs: str | None,
        classes: tuple[str, ...],
        export_lines: bool = False,
        dtype=np.int32,
    ):
        self.out_shape = out_shape
        self.num_classes = len(classes)
        self.out_transform = out_transform
        self.crs = crs
        self.classes = classes
        self.export_lines = export_lines
        self.dtype = dtype  # int32 votes, or float32 for overlap-blend

        self.img_dir = save_dir / "images"
        self.mask_dir = save_dir / "masks"
        self.tif_dir = save_dir / "tif"
        for d in (self.img_dir, self.mask_dir, self.tif_dir):
            d.mkdir(parents=True, exist_ok=True)
        if export_lines:
            self.line_dir = save_dir / "lines"
            self.line_dir.mkdir(parents=True, exist_ok=True)

        self.current_date: str | None = None
        self.current_img: np.ndarray | None = None
        self.current_nodata: np.ndarray | None = None
        self.current_pred_counter: np.ndarray | None = None
        self.saved_dates: list[str] = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.current_date is not None:
            self.save_current()

    def _initialize(self, date: str, img: np.ndarray | None, nodata: np.ndarray | None):
        self.current_date = date
        self.current_img = (
            img.copy() if img is not None else np.zeros((*self.out_shape, 3), np.uint8)
        )
        self.current_nodata = nodata if nodata is not None else np.zeros(self.out_shape, bool)
        self.current_pred_counter = np.zeros((*self.out_shape, self.num_classes), self.dtype)

    def update(
        self,
        date: str,
        crop: tuple[int, int, int, int],
        one_hot_pred: np.ndarray,
        img_crop: np.ndarray | None = None,
        date_img: np.ndarray | None = None,
        date_nodata: np.ndarray | None = None,
    ) -> None:
        """Add one crop's one-hot votes. ``img_crop`` paints the display canvas
        crop-by-crop (predict.py path); ``date_img`` seeds the full mosaic on
        the first crop of a date (predict_no_prompt.py path)."""
        if date != self.current_date:
            if self.current_date is not None:
                self.save_current()
            self._initialize(date, date_img, date_nodata)

        h, w = self.out_shape
        xmin, ymin, xmax, ymax = crop
        dy0, dy1 = max(ymin, 0), min(ymax, h)
        dx0, dx1 = max(xmin, 0), min(xmax, w)
        sy0, sx0 = dy0 - ymin, dx0 - xmin
        sy1, sx1 = sy0 + (dy1 - dy0), sx0 + (dx1 - dx0)
        if sy1 <= sy0 or sx1 <= sx0:
            logger.warning("Invalid crop! %s", crop)
            return
        self.current_pred_counter[dy0:dy1, dx0:dx1] += one_hot_pred[sy0:sy1, sx0:sx1]
        if img_crop is not None:
            self.current_img[dy0:dy1, dx0:dx1] = img_crop[sy0:sy1, sx0:sx1]

    def update_ids(
        self,
        date: str,
        crop: tuple[int, int, int, int],
        id_pred: np.ndarray,
        img_crop: np.ndarray | None = None,
        date_img: np.ndarray | None = None,
        date_nodata: np.ndarray | None = None,
    ) -> None:
        """``update`` taking the raw (h, w) class-id crop instead of one-hot.

        Same votes, same clipping — but the vote add runs as ``num_classes``
        boolean compares on the clipped region instead of materializing a
        (h, w, C) one-hot gather per crop (the reference's np.eye indexing,
        predict.py:234 — at B=32×448² that gather allocates ~77 MB per batch
        and was the paste phase's dominant cost on this host)."""
        if date != self.current_date:
            if self.current_date is not None:
                self.save_current()
            self._initialize(date, date_img, date_nodata)

        h, w = self.out_shape
        xmin, ymin, xmax, ymax = crop
        dy0, dy1 = max(ymin, 0), min(ymax, h)
        dx0, dx1 = max(xmin, 0), min(xmax, w)
        sy0, sx0 = dy0 - ymin, dx0 - xmin
        sy1, sx1 = sy0 + (dy1 - dy0), sx0 + (dx1 - dx0)
        if sy1 <= sy0 or sx1 <= sx0:
            logger.warning("Invalid crop! %s", crop)
            return
        ids = id_pred[sy0:sy1, sx0:sx1]
        region = self.current_pred_counter[dy0:dy1, dx0:dx1]
        for c in range(self.num_classes):
            region[..., c] += ids == c
        if img_crop is not None:
            self.current_img[dy0:dy1, dx0:dx1] = img_crop[sy0:sy1, sx0:sx1]

    def save_current(self) -> np.ndarray:
        assert self.current_date is not None
        pred = np.argmax(self.current_pred_counter, axis=2).astype(np.uint8)

        blended = overlay_prediction(self.current_img, pred, self.classes)
        blended.save(self.img_dir / f"{self.current_date}.png")
        Image.fromarray(pred).save(self.mask_dir / f"{self.current_date}.png")
        write_tiff(
            self.tif_dir / f"{self.current_date}.tif",
            pred,
            self.out_transform,
            self.crs,
            compress="lzw",
        )
        if self.export_lines:
            for idx, cls in enumerate(self.classes[1:], 1):
                line = extract_linestring(pred == idx, self.current_nodata)
                if line is not None:
                    save_shapefile(
                        transform_line(line, self.out_transform),
                        self.line_dir / f"{cls}_{self.current_date}.shp",
                        self.crs,
                    )
        self.saved_dates.append(self.current_date)
        self.current_date = None
        return pred
