"""beach_seg_tpu_torch — the PyTorch/CUDA port of beach_seg_tpu for NVIDIA Hopper.

The package mirrors ``beach_seg_tpu``'s layout module for module, so each
counterpart is easy to find, and keeps the JAX package's public layouts (NHWC
images, (B, S, 3, C) qkv, ``x @ W`` weights) so the two can be compared on the
same inputs. It imports torch and numpy only, never JAX or ``beach_seg_tpu``.
Public surface:

    beach_seg_tpu_torch.config          structured configs (BeachSegConfig, …)
    beach_seg_tpu_torch.geo             host geo/raster data plane (native codec)
    beach_seg_tpu_torch.geo.notebook_utils  the notebooks' helpers
    beach_seg_tpu_torch.models.seggpt   SegGPT nn.Module, weights bridge
    beach_seg_tpu_torch.ops             resizes, attention oracle, CUDA kernels
    beach_seg_tpu_torch.ops.sharding    collectives of the (data, model) mesh
    beach_seg_tpu_torch.parallel        the mesh over torch.distributed ranks,
                                        tensor-parallel shards, process start
    beach_seg_tpu_torch.transforms      palettes + batched augmentations
    beach_seg_tpu_torch.data            scene → fixed-shape batches
    beach_seg_tpu_torch.train           PromptTuner, run_training, metrics,
                                        checkpoints, loggers
    beach_seg_tpu_torch.infer           predict / zero-shot / legacy engines
    beach_seg_tpu_torch.cli             python -m beach_seg_tpu_torch.cli.<name>
    beach_seg_tpu_torch.utils           configs, run dirs, tracing, device rule

Deliberately absent:

    ops.pallas_attn, ops.pallas_mlp   TPU-only: the Pallas kernels' counterparts
                                      are ops.cuda_attn / ops.cuda_mlp
    utils.profiling.enable_compilation_cache
                                      no XLA compilation cache: the kernels
                                      are built once into _build/

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
