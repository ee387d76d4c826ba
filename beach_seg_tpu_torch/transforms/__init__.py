from beach_seg_tpu_torch.transforms.augment import (
    AugmentParams,
    center_crop,
    eval_augment,
    normalize_imagenet,
    sample_draws,
    train_augment,
)
from beach_seg_tpu_torch.transforms.palette import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    apply_palette,
    build_palette,
    decode_by_palette,
    normalize_palette,
    random_palette,
)

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "AugmentParams",
    "apply_palette",
    "build_palette",
    "center_crop",
    "decode_by_palette",
    "eval_augment",
    "normalize_imagenet",
    "normalize_palette",
    "random_palette",
    "sample_draws",
    "train_augment",
]
