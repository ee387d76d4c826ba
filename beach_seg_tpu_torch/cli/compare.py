"""Reference-parity harness: mask-agreement IoU between two prediction runs
(BASELINE.md: "IoU ≥ 0.999 agreement vs reference masks").

    python -m beach_seg_tpu_torch.cli.compare <dir_a> <dir_b>

Each dir must contain per-date mask GeoTIFFs (the ``tif/`` output of any
predict run, either package's, or the reference's). Prints per-date
per-class IoU and the mean. It counts a few confusion matrices on the host,
on the CPU, wherever it runs.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from beach_seg_tpu_torch.geo.tiff import read
from beach_seg_tpu_torch.train.metrics import confusion_update, iou_from_confusion


def compare_dirs(dir_a: Path, dir_b: Path, num_classes: int = 4) -> dict:
    a_files = {p.stem: p for p in sorted(Path(dir_a).glob("*.tif"))}
    b_files = {p.stem: p for p in sorted(Path(dir_b).glob("*.tif"))}
    common = sorted(set(a_files) & set(b_files))
    if not common:
        raise SystemExit(f"no common dates between {dir_a} and {dir_b}")
    per_date = {}
    total_cm = np.zeros((num_classes, num_classes), np.int64)
    for date in common:
        a = read(a_files[date]).data[0]
        b = read(b_files[date]).data[0]
        if a.shape != b.shape:
            raise SystemExit(f"{date}: shape mismatch {a.shape} vs {b.shape}")
        cm = confusion_update(torch.from_numpy(b), torch.from_numpy(a), num_classes, ignore_index=None).numpy()
        total_cm += cm
        iou = iou_from_confusion(torch.from_numpy(cm)).numpy()
        present = _present(cm)
        per_date[date] = {
            "iou_per_class": [round(float(v), 6) for v in iou],
            "mean_iou": round(float(iou[present].mean()) if present.any() else 0.0, 6),
        }
    total_iou = iou_from_confusion(torch.from_numpy(total_cm)).numpy()
    present = _present(total_cm)
    return {
        "dates": per_date,
        "overall_iou_per_class": [round(float(v), 6) for v in total_iou],
        "overall_mean_iou": round(float(total_iou[present].mean()) if present.any() else 0.0, 6),
        "pixel_agreement": round(float(np.trace(total_cm) / max(total_cm.sum(), 1)), 6),
    }


def _present(cm: np.ndarray) -> np.ndarray:
    """Classes that appear on either side (standard mIoU excludes absent ones)."""
    return (cm.sum(axis=0) + cm.sum(axis=1)) > 0


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    print(json.dumps(compare_dirs(Path(sys.argv[1]), Path(sys.argv[2])), indent=2))


if __name__ == "__main__":
    main()
