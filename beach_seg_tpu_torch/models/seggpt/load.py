"""Model weight loading (counterpart of ``beach_seg_tpu/models/seggpt/load.py``).

Resolution order for ``checkpoint``:
  1. ``"random"`` → the port's seeded random weights (``model.random_state``);
  2. a ``.npz`` file written by ``convert.save_params`` (either package's);
  3. a local directory holding an HF torch SegGPT checkpoint
     (``model.safetensors`` or ``pytorch_model.bin``), converted on the fly.

Anything else raises ``FileNotFoundError``: the JAX package falls back to a
hub download, which the port never attempts.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig
from beach_seg_tpu_torch.models.seggpt.convert import convert_torch_state_dict, from_jax_params, load_npz
from beach_seg_tpu_torch.models.seggpt.model import random_state
from beach_seg_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# the JAX package's name for the seeded random weights (its init_random
# takes the flax module; the port's random_state takes the config)
init_random = random_state


def _torch_state_dict(local_dir: Path) -> dict:
    st = local_dir / "model.safetensors"
    if st.exists():
        from safetensors.torch import load_file

        return load_file(str(st))
    bin_path = local_dir / "pytorch_model.bin"
    if bin_path.exists():
        return torch.load(str(bin_path), map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no torch checkpoint under {local_dir}")


def load_model_params(checkpoint: str | Path, cfg: SegGPTConfig, device=None) -> dict[str, torch.Tensor]:
    """→ module state (``{dotted.path: tensor}``, fp32) for a SegGPT of
    ``cfg`` on ``device`` (None → CUDA, raising if absent); all frozen, as
    in the reference (ml_util.py:9-10)."""
    dev = resolve_device(device)
    ckpt = str(checkpoint)
    if ckpt == "random":
        logger.warning("using RANDOM SegGPT weights (checkpoint='random')")
        return {k: v.to(dev, copy=True) for k, v in random_state(cfg).items()}
    path = Path(ckpt)
    if path.suffix == ".npz" and path.exists():
        return load_npz(path, dev)
    if path.is_dir():
        return from_jax_params(convert_torch_state_dict(_torch_state_dict(path), cfg), dev)
    raise FileNotFoundError(
        f"cannot resolve checkpoint {ckpt!r}: not an npz and not a local HF directory (the port fetches "
        "nothing from the hub). Use checkpoint=random for random weights."
    )
