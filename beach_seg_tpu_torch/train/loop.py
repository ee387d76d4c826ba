"""The model half of the training runtime (counterpart of
``beach_seg_tpu/train/loop.py``): which SegGPT a ``BeachSegConfig`` trains.

Only :func:`model_for_config` is ported so far; the epoch loop, checkpoints
and loggers are still to come.
"""

from __future__ import annotations

import torch

from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig, huge_config
from beach_seg_tpu_torch.models.seggpt.model import SegGPT, build_model


def model_for_config(conf: BeachSegConfig, device=None, state: dict | None = None, seed: int = 0) -> tuple[SegGPT, SegGPTConfig]:
    """The SegGPT (``build_model``: on CUDA unless ``device`` says otherwise,
    ``state`` or seeded random weights, bf16 when ``conf.compute_dtype`` is
    ``"bfloat16"``) and its config for ``conf``: the ``debug`` miniature,
    else ``conf.backbone``: ``"huge"`` (ViT-H: C=1280, 32 layers, 16 heads
    of 80), and ViT-L for ``"large"`` or any other name, as in the JAX
    package — on a (2·inpt_size, inpt_size) canvas.

    The JAX package also lets a converted npz checkpoint that stores its own
    topology override these presets; that waits for the port's checkpoint
    loader, so the weights come from ``state`` here."""
    dtype = torch.bfloat16 if conf.compute_dtype == "bfloat16" else torch.float32
    image_size = (2 * conf.inpt_size, conf.inpt_size)
    if conf.debug:
        # miniature topology for smoke runs, same control flow
        cfg = SegGPTConfig(
            hidden_size=64,
            num_hidden_layers=4,
            num_attention_heads=4,
            image_size=image_size,
            pretrain_image_size=64,
            decoder_hidden_size=16,
            merge_index=1,
            intermediate_hidden_state_indices=(1, 3),
        )
    elif conf.backbone == "huge":
        cfg = huge_config(image_size=image_size)
    else:
        cfg = SegGPTConfig(image_size=image_size)
    return build_model(cfg, dtype, device=device, state=state, seed=seed), cfg
