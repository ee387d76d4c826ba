"""The port's own copy of the framework configuration fields the predict and
train steps read (counterpart of ``beach_seg_tpu/config.py``; copied, not
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
    # compute dtype for the frozen backbone; params stay fp32
    compute_dtype: str = "float32"  # "float32" | "bfloat16"

    epochs: int = 1
    # miniature topology for smoke runs (train.loop.model_for_config)
    debug: bool = False
    world_size: int = 1
    grad_accum_steps: int = 1
    batch_size: int = 1

    crop_size: int = 112
    inpt_size: int = 448

    # --- augmentation probabilities/magnitudes (ref src/config.py:50-68) ---
    horizontal_flip: float = 0.5
    vertical_flip: float = 0.5
    hue: float = 0.1
    saturation: float = 0.1
    contrast: float = 0.1
    brightness: float = 0.1
    scale: tuple[float, float] = (0.4, 1.0)
    sharpness: float = 1.0
    sharpness_p: float = 0.2
    erasing_scale: tuple[float, float] = (0.02, 0.05)
    erasing_p: float = 0.1
    gauss_mean: float = 0.0
    gauss_std: float = 0.1
    gauss_p: float = 0.1
    channel_shift_limit: float = 0.01
    channel_shift_p: float = 0.2
    mosaic_p: float = 0.0
    jigsaw_grid: tuple[int, int] = (2, 2)
    jigsaw_p: float = 0.0

    # --- optimizer (ref src/config.py:70-78) ---
    lr: float = 1e-3
    loss_beta: float = 0.01
    base_lr_batch_size: int = 1
    warmup_epochs: int = 0
    init_lr: float = 5e-4
    min_lr: float = 5e-4
    optimizer: str = "adamw"
    scheduler: str = "cosine"
    ema_alpha: float = 0.99
    # probability of zeroing a sample's prompt pixels for a step; 0 = off
    prompt_dropout: float = 0.0
    # "nodata" | "nodata_ref" | "hf" | "dice_bce" (see train.prompt_tuner)
    loss_variant: str = "nodata"
    # backbone preset: "large" = ViT-L (BAAI/seggpt-vit-large topology);
    # "huge" = ViT-H-class scale-up for 8-band SuperDove work
    backbone: str = "large"
