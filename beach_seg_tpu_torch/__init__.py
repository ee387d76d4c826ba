"""beach_seg_tpu_torch — the PyTorch/CUDA port of beach_seg_tpu for NVIDIA Hopper.

The package mirrors ``beach_seg_tpu``'s layout module for module, so each
counterpart is easy to find, and keeps the JAX package's public layouts (NHWC
images, (B, S, 3, C) qkv, ``x @ W`` weights) so the two can be compared on the
same inputs. It imports torch and numpy only, never JAX or ``beach_seg_tpu``.

Ported so far (the prompt-tuned inference forward):

    beach_seg_tpu_torch.config          CLASSES and the predict step's config fields
    beach_seg_tpu_torch.models.seggpt   SegGPT nn.Module, weights bridge
    beach_seg_tpu_torch.ops             resizes, attention oracle, CUDA kernels
    beach_seg_tpu_torch.transforms      palette codec, eval augmentation
    beach_seg_tpu_torch.train           PromptTuner.predict_step

Entry points (model builder, weight loaders, predict step) run on the CUDA
device unless the caller passes ``device="cpu"``; see ``utils.device``.
"""

__version__ = "0.1.0"
