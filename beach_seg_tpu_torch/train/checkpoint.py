"""Prompt exports (counterpart of ``beach_seg_tpu/train/checkpoint.py``'s
``save_prompt_batch`` / ``load_prompt_batch``): a pickle-free npz with the
logical fields of the reference's prompt_batch.pt (crop_idx / date / image /
mask / nodata), in the JAX package's format, so prompt files move both ways
between the packages. The resume of a full training state is ROADMAP.md §A
item 7.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def save_prompt_batch(
    path: Path,
    pixels,
    masks,
    nodata,
    crop_idx,
    dates: list[str],
) -> None:
    """Arrays or tensors on any device."""
    np.savez_compressed(
        path,
        image=_np(pixels).astype(np.float32),
        mask=_np(masks).astype(np.int32),
        nodata=_np(nodata).astype(bool),
        crop_idx=_np(crop_idx).astype(np.int32),
        date=np.asarray(dates),
    )


def load_prompt_batch(path: Path) -> dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
