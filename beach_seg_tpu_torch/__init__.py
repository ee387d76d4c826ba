"""beach_seg_tpu_torch — the PyTorch/CUDA port of beach_seg_tpu for NVIDIA Hopper.

The package mirrors ``beach_seg_tpu``'s layout module for module, so each
counterpart is easy to find, and keeps the JAX package's public layouts (NHWC
images, (B, S, 3, C) qkv, ``x @ W`` weights) so the two can be compared on the
same inputs. It imports torch and numpy only, never JAX or ``beach_seg_tpu``.
Public surface:

    beach_seg_tpu_torch.config          structured configs (BeachSegConfig, …)
    beach_seg_tpu_torch.geo             host geo/raster data plane (native codec)
    beach_seg_tpu_torch.models.seggpt   SegGPT nn.Module, weights bridge
    beach_seg_tpu_torch.ops             resizes, attention oracle, CUDA kernels
    beach_seg_tpu_torch.transforms      palettes + batched augmentations
    beach_seg_tpu_torch.data            scene → fixed-shape batches
    beach_seg_tpu_torch.train           PromptTuner, run_training, metrics,
                                        checkpoints, loggers
    beach_seg_tpu_torch.infer           predict / zero-shot / legacy engines
    beach_seg_tpu_torch.utils           configs, run dirs, tracing, device rule

Not ported yet, each deliberately absent:

    parallel                  device mesh and shardings (multi-GPU, ROADMAP.md §A 3)
    cli                       command-line entry points (ROADMAP.md §A 4)
    geo.notebook_utils        notebook helpers (ROADMAP.md §A 2)
    ops.pallas_attn, ops.pallas_mlp, ops.sharding
                              TPU-only: the Pallas kernels' counterparts are
                              ops.cuda_attn / ops.cuda_mlp, the sharding
                              rules come with multi-GPU

Entry points (model builder, weight loaders, steps, run_training and the
engines) run on the CUDA device unless the caller passes ``device="cpu"``; see
``utils.device``.
"""

__version__ = "0.1.0"

from beach_seg_tpu_torch.config import (  # noqa: F401
    CLASSES,
    BeachSegConfig,
    LegacyConfig,
    PredConfig,
    PredictionConfig,
)
