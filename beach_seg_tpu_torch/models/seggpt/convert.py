"""The weights bridge: the JAX package's parameter tree and its npz files →
the port's module state (counterpart of ``beach_seg_tpu/models/seggpt/convert.py``).

The port's parameter names are the flax tree's paths joined by dots, and its
tensors keep the flax layouts, so the bridge only flattens. ``load_npz`` reads
the npz format ``convert.save_params`` writes, on its own: keys are the tree
paths joined by "/", and older files store qkv as (C, 3C)/(3C,).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from beach_seg_tpu_torch.utils.device import resolve_device

_CONFIG_KEY = "__config_json__"


def _qkv3(a: np.ndarray) -> np.ndarray:
    """(…, 3C) qkv weight/bias → (…, 3, C)."""
    return a.reshape(a.shape[:-1] + (3, a.shape[-1] // 3))


def from_jax_params(tree: Mapping[str, Any], device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Nested dict of arrays (as flax ``init`` or ``convert.load_params``
    gives it) → ``{dotted.path: tensor}`` on ``device`` (None → CUDA)."""
    dev = resolve_device(device)
    state: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                state[key] = torch.tensor(np.asarray(v), device=dev)

    walk(tree, "")
    return state


def load_npz(path: Path | str, device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """The port's reader of ``convert.save_params`` files → module state on
    ``device`` (None → CUDA)."""
    dev = resolve_device(device)
    state: dict[str, torch.Tensor] = {}
    with np.load(path) as data:
        for key in data.files:
            if key == _CONFIG_KEY:
                continue
            parts = key.split("/")
            arr = data[key]
            # older checkpoints stored qkv as (C, 3C)/(3C,): reshape to the
            # current (C, 3, C)/(3, C) layout (values identical)
            if parts[-1] == "qkv_kernel" and arr.ndim == 2:
                arr = _qkv3(arr)
            elif parts[-1] == "qkv_bias" and arr.ndim == 1:
                arr = _qkv3(arr)
            state[".".join(parts)] = torch.as_tensor(arr, device=dev)
    return state

