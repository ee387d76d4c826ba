from beach_seg_tpu_torch.transforms.augment import (
    AugmentParams,
    center_crop,
    denormalize_imagenet,
    eval_augment,
    normalize_imagenet,
    random_resized_crop,
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
    "denormalize_imagenet",
    "eval_augment",
    "normalize_imagenet",
    "normalize_palette",
    "random_palette",
    "random_resized_crop",
    "sample_draws",
    "train_augment",
]
