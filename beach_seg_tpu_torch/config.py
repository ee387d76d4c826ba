"""Framework configuration: the port's own copy of ``beach_seg_tpu/config.py``
(copied, not imported), field for field with the same names and defaults, so a
JAX run's ``conf.yaml`` merges into it (``utils.confix.merge_yaml_into``).

The mesh fields and ``platform`` have a device meaning here (below).
``nodata`` must remain class index 0 (asserted by the data layer, ref
data.py:153).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

CLASSES = (
    "nodata",
    "sand",
    "water",
    "veg",
)

# Resample names follow PIL semantics; the reference stores a PIL enum
# (src/config.py:48). We keep strings to stay YAML/CLI friendly.
RESAMPLE_BICUBIC = "bicubic"
RESAMPLE_NEAREST = "nearest"


@dataclass(frozen=True)
class BeachSegConfig:
    project: str = "beach_seg"
    seed: int = 42
    data: Path = Path("/data/BorderField")
    model_training_root: Path = Path("/data/results")
    classes: tuple[str, ...] = CLASSES

    # --- runtime ---
    # mesh shape (data axis × model axis) over the torch.distributed ranks,
    # one process a device (parallel.mesh.make_mesh): mesh_data -1 = the
    # ranks mesh_model leaves; data × model must be the number of ranks
    mesh_data: int = -1
    mesh_model: int = 1
    # compute dtype for the frozen backbone matmuls; params stay fp32.
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    # device rule: "" or "gpu" = the CUDA device (raising without one),
    # "cpu" = the CPU; anything else raises (utils.device.device_for_platform)
    platform: str = ""
    deterministic: bool = False
    # observability (SURVEY.md §5: absent in the reference, first-class here)
    profile: bool = False  # profiler trace → <run_dir>/profile
    # fail fast on a NaN: run_training checks each step's loss, prompt
    # gradient and updated pixels and raises FloatingPointError; the engines
    # ignore the field, as the JAX engines do
    debug_nans: bool = False
    # recompute each encoder block in the backward (torch.utils.checkpoint):
    # less activation memory for more FLOPs; the predict path never runs it
    remat: bool = False
    num_viz_images: int = 9
    viz_size: int = 224

    epochs: int = 1
    debug: bool = False
    world_size: int = 1  # number of host processes
    grad_accum_steps: int = 1
    log_every_n_steps: int = 10
    precision: str = "32-true"  # kept for CLI compat; see compute_dtype
    workers: int = -1
    batch_size: int = 1

    checkpoint: str = "BAAI/seggpt-vit-large"
    # resume a preempted run: path to a previous train run dir — restores the
    # full PromptState (pixels, EMA, optimizer, step) from its latest
    # checkpoint (the port's own format, train.checkpoint) and continues from
    # the next epoch
    resume_from: Path | None = None

    monitor_metric: str = "val/f1"
    monitor_mode: str = "max"

    crop_size: int = 112
    inpt_size: int = 448
    resample: str = RESAMPLE_BICUBIC

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
    # NOTE: in the reference this field lacks a type annotation, so OmegaConf
    # silently drops it from the structured config (src/config.py:78). We keep
    # it as a real field — divergence is intentional and documented.
    ema_alpha: float = 0.99
    # legacy trainer's prompt dropout: probability of zeroing a sample's
    # prompt pixels for a step (ref src/old/train.py:141-143); 0 = off.
    prompt_dropout: float = 0.0
    # training loss: "nodata" = the reference's nodata-masked smooth-L1
    # (src/model.py:40-64, intended B>1 semantics); "nodata_ref" = bug-for-bug
    # port INCLUDING the unsqueeze(1) broadcast at src/model.py:61 that mixes
    # samples pairwise when B>1 (identical to "nodata" at the reference's only
    # used batch size, B=1); "hf" = SegGPT's internal masked-patch loss, used
    # by the legacy trainer (src/old/train.py:163); "dice_bce" = Dice+BCE on
    # soft palette-decoded class probabilities (segmentation-standard
    # objective; BASELINE.json config #2).
    loss_variant: str = "nodata"
    # reproduce the reference's accidental epoch multiplier: Trainer
    # max_epochs = conf.epochs * len(prompt_batch) where prompt_batch is a
    # DICT with 5 keys (src/train.py:98) — so the reference actually trains
    # 5× the configured epochs while the cosine period stays conf.epochs.
    epochs_compat: bool = False
    # backbone preset: "large" = ViT-L (BAAI/seggpt-vit-large topology);
    # "huge" = ViT-H-class scale-up for 8-band SuperDove work
    # (BASELINE.json config #5); "painter" = Painter ViT-L; "eva02" =
    # EVA-02-L/14's block at patch 14 (port-only, models/seggpt/config.py).
    backbone: str = "large"


@dataclass(frozen=True)
class PredictionConfig(BeachSegConfig):
    """Prompt-tuned inference overlay (ref: src/predict.py:24-33)."""

    train_run_dir: Path | None = None
    prediction_root: Path | None = None
    overlap: int = 0
    # crop merging: "vote" = the reference's one-hot vote counting
    # (predict.py:120-157); "blend" = feathered soft-probability blending
    # (overlap-blend mosaic; smoother seams on overlapping crops)
    merge: str = "vote"
    # predict from the EMA-smoothed prompt export (prompt_batch_ema.npz)
    # instead of the raw tuned pixels — the reference's legacy trainer saves
    # EMA-smoothed prompts (src/old/train.py:168,255-258)
    use_ema: bool = False
    # reference CLI alias (src/predict.py:33): path to a train run's conf.yaml;
    # equivalent to train_run_dir=<its parent>
    config_path: Path | None = None

    def __post_init__(self):
        if self.config_path is not None and self.train_run_dir is None:
            object.__setattr__(self, "train_run_dir", Path(self.config_path).parent)


@dataclass(frozen=True)
class LegacyConfig(BeachSegConfig):
    """Legacy ensemble inference overlay (ref: src/old/beach_seg.py:89-95).

    50%-overlap crops, semantic embedding, buffer-trimmed ascending merge,
    per-class 1-bit GeoTIFF + shapefile outputs."""

    prediction_root: Path | None = None
    prompt_ckpt: Path | None = None
    buffer_factor: float = 0.125
    n_prompts: int = 2
    # legacy default crop size (ref old/beach_seg.py:90)
    crop_size: int = 224


@dataclass(frozen=True)
class PredConfig(BeachSegConfig):
    """Zero-shot ensemble inference overlay (ref: src/predict_no_prompt.py:36-44)."""

    prediction_root: Path | None = None
    n_prompts: int = 2
    zero_shot_crop_size: int = 336
    feature_ensemble: bool = True
    # bug-for-bug prompt "ranking": the reference compares a uint8 ARRAY to
    # the STRING "sand" (predict_no_prompt.py:250), which numpy collapses to
    # one scalar — every sort key is equal, so prompts are taken in original
    # crop order. True reproduces that (required for mask-level parity with
    # the reference); False ranks by labeled class-1 coverage (the intent).
    rank_compat: bool = False
    # reference CLI alias (src/predict_no_prompt.py:39)
    results_dir: Path | None = None

    def __post_init__(self):
        if self.results_dir is not None and self.prediction_root is None:
            object.__setattr__(self, "prediction_root", Path(self.results_dir))


def cpu_count() -> int:
    cnt = os.cpu_count()
    return 0 if cnt is None else cnt


def num_workers(conf: BeachSegConfig) -> int:
    """Host worker threads per process (ref: src/config.py:81-91)."""
    nd = max(1, conf.world_size)
    per_proc = cpu_count() // nd
    if conf.workers == -1:
        return per_proc
    return min(per_proc, conf.workers)

