"""Checkpoint / resume and prompt exports (counterpart of
``beach_seg_tpu/train/checkpoint.py``).

- ``save_state`` / ``latest_checkpoint`` / ``restore_state``: the full
  ``PromptState`` (prompt pixels, EMA pixels, the optimizer's moments,
  accumulation buffer and counts, step) under ``checkpoints/step_N/``, for a
  resume after preemption. The JAX package writes these with Orbax; the port
  has its own format, a ``torch.save`` of the fields as CPU tensors and
  ints (``state.pt``), loaded with ``weights_only=True``. So neither package
  reads the other's state checkpoints: a JAX run resumes from a JAX run, a
  port run from a port run.
- ``save_prompt_batch`` / ``load_prompt_batch``: a pickle-free npz with the
  logical fields of the reference's prompt_batch.pt (crop_idx / date / image
  / mask / nodata), in the JAX package's format, so prompt files move both
  ways between the packages.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np
import torch

from beach_seg_tpu_torch.train.prompt_tuner import PromptState

STATE_FILE = "state.pt"


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save_state(run_dir: Path, state: PromptState, step: int | None = None) -> Path:
    """Write ``state`` to ``run_dir/checkpoints/step_<step>`` (default: the
    state's own step). The file is written into a temporary directory that
    is then renamed into place, so a run killed mid-write leaves no partial
    ``step_N``; an existing ``step_N`` is never overwritten (the rename
    fails)."""
    base = Path(run_dir) / "checkpoints"
    path = base / f"step_{int(state.step) if step is None else step}"
    tmp = base / f".{path.name}.tmp-{os.getpid()}"
    tmp.mkdir(parents=True)
    try:
        torch.save(
            {
                "prompt_pixels": _cpu(state.prompt_pixels),
                "ema_pixels": _cpu(state.ema_pixels),
                "opt_state": _cpu(state.opt_state),
                "step": int(state.step),
            },
            tmp / STATE_FILE,
        )
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def latest_checkpoint(run_dir: Path) -> Path | None:
    base = Path(run_dir) / "checkpoints"
    if not base.exists():
        return None
    steps = sorted(
        (int(p.name.split("_")[1]), p) for p in base.iterdir() if p.name.startswith("step_")
    )
    return steps[-1][1] if steps else None


def _like(saved, template, where: str):
    """``saved`` moved onto ``template``'s devices and dtypes, checked
    against its structure and shapes."""
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape:
            raise ValueError(f"checkpoint field {where}: {getattr(saved, 'shape', saved)} does not fit {tuple(template.shape)}")
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"checkpoint field {where}: keys {sorted(saved) if isinstance(saved, dict) else saved} "
                             f"do not fit {sorted(template)}")
        return {k: _like(saved[k], template[k], f"{where}.{k}") for k in template}
    return type(template)(saved)


def restore_state(path: Path, template: PromptState) -> PromptState:
    """The ``PromptState`` saved at ``path`` (a ``step_N`` directory), on
    ``template``'s devices and dtypes; raises ``ValueError`` where its fields
    do not fit the template's (another prompt set or optimizer)."""
    saved = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
    return PromptState(
        prompt_pixels=_like(saved["prompt_pixels"], template.prompt_pixels, "prompt_pixels"),
        ema_pixels=_like(saved["ema_pixels"], template.ema_pixels, "ema_pixels"),
        opt_state=_like(saved["opt_state"], template.opt_state, "opt_state"),
        step=int(saved["step"]),
    )


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
