"""The model half of the training runtime (counterpart of
``beach_seg_tpu/train/loop.py``): which SegGPT a ``BeachSegConfig`` runs.

Only :func:`model_for_config` (with :func:`config_for`) is ported so far; the
epoch loop, the Orbax-style resume and the loggers are ROADMAP.md §A item 7.
"""

from __future__ import annotations

from pathlib import Path

import torch

from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig, huge_config
from beach_seg_tpu_torch.models.seggpt.convert import load_config
from beach_seg_tpu_torch.models.seggpt.model import SegGPT, build_model


def config_for(conf: BeachSegConfig) -> SegGPTConfig:
    """The topology ``conf`` selects: a ``.npz`` checkpoint that stores its
    own topology wins (it describes the weights), else the ``debug``
    miniature, else ``conf.backbone``: ``"huge"`` (ViT-H: C=1280, 32 layers,
    16 heads of 80), and ViT-L for ``"large"`` or any other name, as in the
    JAX package — on a (2·inpt_size, inpt_size) canvas."""
    ckpt = Path(str(conf.checkpoint))
    if ckpt.suffix == ".npz" and ckpt.exists():
        stored = load_config(ckpt)
        if stored is not None:
            return stored
    image_size = (2 * conf.inpt_size, conf.inpt_size)
    if conf.debug:
        # miniature topology for smoke runs, same control flow
        return SegGPTConfig(
            hidden_size=64,
            num_hidden_layers=4,
            num_attention_heads=4,
            image_size=image_size,
            pretrain_image_size=64,
            decoder_hidden_size=16,
            merge_index=1,
            intermediate_hidden_state_indices=(1, 3),
        )
    if conf.backbone == "huge":
        return huge_config(image_size=image_size)
    return SegGPTConfig(image_size=image_size)


def model_for_config(conf: BeachSegConfig, device=None, state: dict | None = None, seed: int = 0) -> tuple[SegGPT, SegGPTConfig]:
    """The SegGPT of :func:`config_for` (``build_model``: on CUDA unless
    ``device`` says otherwise, ``state`` or seeded random weights, bf16 when
    ``conf.compute_dtype`` is ``"bfloat16"``) and its config. ``conf.remat``
    changes only the backward and is not acted on yet (ROADMAP.md §A item 3)."""
    dtype = torch.bfloat16 if conf.compute_dtype == "bfloat16" else torch.float32
    cfg = config_for(conf)
    return build_model(cfg, dtype, device=device, state=state, seed=seed), cfg
