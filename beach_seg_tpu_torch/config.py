"""The port's own copy of the framework configuration fields the predict
step reads (counterpart of ``beach_seg_tpu/config.py``; copied, not
imported). ``nodata`` must remain class index 0."""

from __future__ import annotations

from dataclasses import dataclass

CLASSES = (
    "nodata",
    "sand",
    "water",
    "veg",
)


@dataclass(frozen=True)
class BeachSegConfig:
    classes: tuple[str, ...] = CLASSES
    batch_size: int = 1
    crop_size: int = 112
    inpt_size: int = 448
