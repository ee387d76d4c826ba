"""Seeded inputs of the tuned predict step (a frozen copy of
``chip_smoke.main_path_inputs``): P prompts of the model's input size with
blocky class maps, and a pool of batches of raw uint8 crops, each crop
pointing at one of the prompts. The pool is cycled through by the window,
so every seed sends the same sizes in another order of contents."""

from __future__ import annotations

import numpy as np


def prompts(seed: int, n_prompts: int, size: int, n_classes: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pixels (P, S, S, 3) fp32 in [0, 1], class ids (P, S, S) int32 in
    16-pixel cells, nodata (P, S, S) bool, all False)."""
    rng = np.random.default_rng([seed, 1])
    cells = rng.integers(0, n_classes, (n_prompts, size // 16, size // 16))
    return (
        rng.random((n_prompts, size, size, 3), dtype=np.float32),
        np.repeat(np.repeat(cells, 16, axis=1), 16, axis=2).astype(np.int32),
        np.zeros((n_prompts, size, size), bool),
    )


def batches(seed: int, n_batches: int, batch: int, crop: int, n_prompts: int) -> list[dict]:
    """Batches of ``batch`` uint8 crops (crop, crop, 3) and their prompt index."""
    rng = np.random.default_rng([seed, 2])
    return [
        {
            "image_u8": rng.integers(0, 256, (batch, crop, crop, 3), dtype=np.uint8),
            "crop_idx": rng.integers(0, n_prompts, (batch,)).astype(np.int32),
        }
        for _ in range(n_batches)
    ]
