"""Every random number of one prompt-tuning step, made by the benchmark
from its own generator and handed to the port as ``train_step(draws=...)``
and to the reference alike.

The distributions are the augmentation's documented ones (the BeachSeg
configuration's probabilities and ranges); the keys are the port's
``draws`` interface: a random palette per row, the prompt each row takes,
one draw dict for the query's augmentation and one for the prompt's, the
prompt dropout gate and the stochastic-depth keep masks (2B rows up to the
stream merge, B after)."""

from __future__ import annotations

import math

import torch


def augment_draws(gen: torch.Generator, b: int, h: int, w: int, aug: dict) -> dict:
    dev = gen.device

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand((b, *shape), generator=gen, device=dev)

    def bernoulli(p):
        return torch.rand((b,), generator=gen, device=dev) < p

    def randint(hi):
        return torch.randint(0, hi, (b,), generator=gen, device=dev)

    return {
        "vflip": bernoulli(aug["vertical_flip"]),
        "hflip": bernoulli(aug["horizontal_flip"]),
        "brightness": uniform(max(0.0, 1 - aug["brightness"]), 1 + aug["brightness"]),
        "contrast": uniform(max(0.0, 1 - aug["contrast"]), 1 + aug["contrast"]),
        "saturation": uniform(max(0.0, 1 - aug["saturation"]), 1 + aug["saturation"]),
        "hue": uniform(-aug["hue"], aug["hue"]),
        "sharp_factor": uniform(0.0, aug["sharpness"]),
        "sharp_apply": bernoulli(aug["sharpness_p"]),
        "erase_area": uniform(*aug["erasing_scale"]),
        "erase_log_r": uniform(math.log(aug["erasing_ratio"][0]), math.log(aug["erasing_ratio"][1])),
        "erase_top": randint(h),
        "erase_left": randint(w),
        "erase_apply": bernoulli(aug["erasing_p"]),
        "noise": torch.randn((b, h, w, 3), generator=gen, device=dev),
        "noise_apply": bernoulli(aug["gauss_p"]),
        "shift": uniform(-aug["channel_shift_limit"], aug["channel_shift_limit"], 3),
        "shift_apply": bernoulli(aug["channel_shift_p"]),
    }


def step_draws(gen: torch.Generator, b: int, size: int, n_prompts: int, n_classes: int, aug: dict,
               model: dict) -> dict:
    dev = gen.device
    palette = torch.randint(0, 256, (b, n_classes, 3), generator=gen, device=dev)
    palette[:, 0] = 0  # class 0 (nodata) paints black
    n = model["num_hidden_layers"]
    rate = model["drop_path_rate"]
    keeps = []
    for i in range(n):
        r = rate * i / (n - 1) if n > 1 else 0.0
        rows = 2 * b if model["merge_index"] >= i else b
        if r == 0.0:
            keeps.append((None, None))
            continue
        d = torch.rand((2, rows), generator=gen, device=dev) < 1.0 - r
        keeps.append((d[0], d[1]))
    return {
        "palette": palette.to(torch.uint8),
        "prompt_idx": torch.randint(0, n_prompts, (b,), generator=gen, device=dev),
        "aug_q": augment_draws(gen, b, size, size, aug),
        "aug_p": augment_draws(gen, b, size, size, aug),
        "prompt_drop": torch.zeros((b,), dtype=torch.bool, device=dev),
        "drop_masks": keeps,
    }
