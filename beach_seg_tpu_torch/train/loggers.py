"""Observability: TensorBoard + CSV metric loggers and image grids
(counterpart of ``beach_seg_tpu/train/loggers.py``, copied: it is host code).

Replaces the reference's Lightning ``TensorBoardLogger`` + ``CSVLogger`` +
``LearningRateMonitor`` stack (ref src/train.py:80-101) and the epoch-end
example grids (ref src/model.py:310-383). tensorboardX writes the event
files when it imports, as in the JAX package; without it the run logs
``metrics.csv`` only. Grids are composed host-side with NumPy/PIL.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
from PIL import Image, ImageColor

from beach_seg_tpu_torch.geo.display import CLASS_COLORS


class MetricsLogger:
    """TB event file + metrics.csv, keyed by step."""

    def __init__(self, run_dir: Path):
        self.run_dir = Path(run_dir)
        self.csv_path = self.run_dir / "metrics.csv"
        self._csv_fields: list[str] = ["step"]
        self._csv_rows: list[dict] = []
        try:
            from tensorboardX import SummaryWriter

            self.tb = SummaryWriter(str(self.run_dir / "tb"))
        except Exception:  # tensorboardX absent or broken: CSV only, as the JAX logger does
            self.tb = None

    @property
    def kind(self) -> str:
        """Which loggers run: "tensorboardX+csv" or "csv"."""
        return "csv" if self.tb is None else "tensorboardX+csv"

    def log_scalars(self, metrics: dict[str, float], step: int) -> None:
        row = {"step": step}
        for k, v in metrics.items():
            row[k] = float(v)
            if k not in self._csv_fields:
                self._csv_fields.append(k)
            if self.tb is not None:
                self.tb.add_scalar(k, float(v), step)
        self._csv_rows.append(row)
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_fields)
            w.writeheader()
            w.writerows(self._csv_rows)

    def log_image(self, tag: str, image_hwc: np.ndarray, step: int) -> None:
        """image_hwc: (H, W, 3) uint8 or float in [0,1]."""
        if self.tb is None:
            return
        img = image_hwc
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        self.tb.add_image(tag, img, step, dataformats="HWC")

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()


def _to_uint8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def draw_class_overlay(
    image: np.ndarray, mask: np.ndarray, classes: tuple[str, ...], alpha: float = 0.5
) -> np.ndarray:
    """(H,W,3) image + (H,W) ids → blended overlay (torchvision
    draw_segmentation_masks equivalent, ref src/model.py:24-37)."""
    out = _to_uint8(image).astype(np.float32)
    for cls_idx, name in enumerate(classes):
        color_name = CLASS_COLORS.get(name)
        if color_name is None:
            continue
        rgb = np.asarray(ImageColor.getrgb(color_name), np.float32)
        sel = mask == cls_idx
        out[sel] = (1 - alpha) * out[sel] + alpha * rgb
    return out.astype(np.uint8)


def example_grid(
    images: np.ndarray,  # (N, H, W, 3) float [0,1] denormalized
    targets: np.ndarray,  # (N, H, W) ids
    preds: np.ndarray,  # (N, H, W) ids
    prompts: np.ndarray,  # (N, H, W, 3) float [0,1]
    classes: tuple[str, ...],
    viz_size: int = 224,
    nodata_idx: int = 0,
) -> np.ndarray:
    """Rows of (input | GT overlay | pred overlay | prompt), matching the
    reference's interleaved epoch-end grid (ref src/model.py:337-383)."""
    rows = []
    preds = preds.copy()
    preds[targets == nodata_idx] = nodata_idx  # mask ignored class like the ref
    for i in range(len(images)):
        cells = [
            _to_uint8(images[i]),
            draw_class_overlay(images[i], targets[i], classes),
            draw_class_overlay(images[i], preds[i], classes),
            _to_uint8(prompts[i]),
        ]
        cells = [
            np.asarray(Image.fromarray(c).resize((viz_size, viz_size), Image.Resampling.BILINEAR))
            for c in cells
        ]
        rows.append(np.concatenate(cells, axis=1))
    return np.concatenate(rows, axis=0)
