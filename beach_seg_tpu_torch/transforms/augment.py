"""Batched augmentations (counterpart of ``beach_seg_tpu/transforms/augment.py``).

Train = VFlip → HFlip → (Jigsaw) → (ResizedCrop) → (ChannelShift) →
ColorJiggle → Sharpness → Erasing → GaussianNoise → Normalize on a batch,
with an optional batch mosaic first; eval = CenterCrop → Normalize. Geometric ops move masks and
nodata too; intensity ops touch the image only.

Where the JAX package draws from a PRNG key inside each op, the port's ops
take their random draws as arguments, one entry per sample, so a test can
feed them the numbers JAX drew. :func:`sample_draws` makes them from a
``torch.Generator``; :func:`train_augment` calls it when no draws are given.
The JAX ops are vmapped over samples; the port writes the batch dimension
out. Clips are ``minimum(maximum(x, 0), 1)``, whose gradient at an exact 0 or
1 is 0.5 as in ``jnp.clip`` (``torch.clamp`` would give 1), and the HSV
extrema are ``amax``/``amin``, which split the gradient over ties as JAX's
reductions do.

``random_resized_crop`` resamples with weight matrices built as
``jax.image.scale_and_translate`` builds them (triangle weights renormalised
over the in-bounds source pixels), not with ``F.interpolate``, whose edge
handling differs; no configuration sets ``resized_crop_p``
(``from_config``), as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from beach_seg_tpu_torch.transforms.palette import IMAGENET_MEAN, IMAGENET_STD
from beach_seg_tpu_torch.utils.profiling import tensor_from_host


@dataclass(frozen=True)
class AugmentParams:
    """Train-time augmentation knobs (ref src/config.py:50-68)."""

    vertical_flip: float = 0.5
    horizontal_flip: float = 0.5
    hue: float = 0.1
    saturation: float = 0.1
    contrast: float = 0.1
    brightness: float = 0.1
    sharpness: float = 1.0
    sharpness_p: float = 0.2
    erasing_scale: tuple[float, float] = (0.02, 0.05)
    erasing_ratio: tuple[float, float] = (0.3, 3.3)
    erasing_p: float = 0.1
    gauss_mean: float = 0.0
    gauss_std: float = 0.1
    gauss_p: float = 0.1
    channel_shift_limit: float = 0.01
    channel_shift_p: float = 0.0
    scale: tuple[float, float] = (0.4, 1.0)
    resized_crop_p: float = 0.0
    jigsaw_grid: tuple[int, int] = (2, 2)
    jigsaw_p: float = 0.0
    mosaic_p: float = 0.0

    @classmethod
    def from_config(cls, conf) -> "AugmentParams":
        return cls(
            vertical_flip=conf.vertical_flip,
            horizontal_flip=conf.horizontal_flip,
            hue=conf.hue,
            saturation=conf.saturation,
            contrast=conf.contrast,
            brightness=conf.brightness,
            sharpness=conf.sharpness,
            sharpness_p=conf.sharpness_p,
            erasing_scale=tuple(conf.erasing_scale),
            erasing_p=conf.erasing_p,
            gauss_mean=conf.gauss_mean,
            gauss_std=conf.gauss_std,
            gauss_p=conf.gauss_p,
            channel_shift_limit=conf.channel_shift_limit,
            channel_shift_p=conf.channel_shift_p,
            scale=tuple(conf.scale),
            jigsaw_grid=tuple(conf.jigsaw_grid),
            jigsaw_p=conf.jigsaw_p,
            mosaic_p=conf.mosaic_p,
        )


def normalize_imagenet(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """(…, H, W, 3) in [0,1] → normalized, arithmetic in ``x.dtype``."""
    mean = tensor_from_host(mean, dtype=x.dtype, device=x.device)
    std = tensor_from_host(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def denormalize_imagenet(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """Inverse of :func:`normalize_imagenet`, arithmetic in ``x.dtype``."""
    return x * tensor_from_host(std, dtype=x.dtype, device=x.device) + tensor_from_host(mean, dtype=x.dtype, device=x.device)


def center_crop(x: torch.Tensor, size: int, spatial_axes: tuple[int, int] = (-3, -2)) -> torch.Tensor:
    """Static center crop on the two spatial axes (kornia K.CenterCrop)."""
    h_ax, w_ax = [a % x.ndim for a in spatial_axes]
    h, w = x.shape[h_ax], x.shape[w_ax]
    top, left = (h - size) // 2, (w - size) // 2
    idx = [slice(None)] * x.ndim
    idx[h_ax] = slice(top, top + size)
    idx[w_ax] = slice(left, left + size)
    return x[tuple(idx)]


# --------------------------------------------------------------------------
# batched ops (image: (B, H, W, 3) float in [0,1]; draws: one entry per sample)
# --------------------------------------------------------------------------


def _per_sample(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) → (B, 1, …, 1) with ``ndim`` dims, for broadcasting."""
    return t.reshape(t.shape[0], *([1] * (ndim - 1)))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: min/max, so the gradient at an exact bound is 0.5."""
    lo_t = tensor_from_host(lo, dtype=x.dtype, device=x.device)
    hi_t = tensor_from_host(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    v = maxc
    delta = maxc - minc
    tiny = tensor_from_host(1e-12, dtype=rgb.dtype, device=rgb.device)
    zero = torch.zeros((), dtype=rgb.dtype, device=rgb.device)
    s = torch.where(maxc > 0, delta / torch.maximum(maxc, tiny), zero)
    safe_delta = torch.maximum(delta, tiny)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(opts):
        out = opts[5]
        for n in (4, 3, 2, 1, 0):
            out = torch.where(i == n, opts[n], out)
        return out

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]), pick([p, p, t, v, v, q])], dim=-1)


def _gray(img: torch.Tensor) -> torch.Tensor:
    w = tensor_from_host([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    return (img * w).sum(-1, keepdim=True)


def color_jiggle(img: torch.Tensor, draws: dict, p: AugmentParams) -> torch.Tensor:
    """brightness → contrast → saturation → hue with per-sample factors
    ``draws["brightness"|"contrast"|"saturation"]`` (B,) around 1 and hue
    shift ``draws["hue"]`` (B,) (kornia K.ColorJiggle family)."""
    if p.brightness > 0:
        img = _clip(img * _per_sample(draws["brightness"], 4), 0.0, 1.0)
    if p.contrast > 0:
        f = _per_sample(draws["contrast"], 4)
        mean = _gray(img).mean(dim=(1, 2, 3), keepdim=True)
        img = _clip((img - mean) * f + mean, 0.0, 1.0)
    if p.saturation > 0:
        g = _gray(img)
        img = _clip(g + (img - g) * _per_sample(draws["saturation"], 4), 0.0, 1.0)
    if p.hue > 0:
        hsv = _rgb_to_hsv(img)
        hue = torch.remainder(hsv[..., 0] + _per_sample(draws["hue"], 3), 1.0)
        img = _clip(_hsv_to_rgb(torch.stack([hue, hsv[..., 1], hsv[..., 2]], dim=-1)), 0.0, 1.0)
    return img


def random_sharpness(img: torch.Tensor, factor: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """Unsharp-style blend with the torchvision 3×3 smoothing kernel
    ([[1,1,1],[1,5,1],[1,1,1]]/13, 1-px border unblended); ``factor`` (B,),
    ``apply`` (B,) bool (kornia K.RandomSharpness)."""
    b, h, w, c = img.shape
    kernel = tensor_from_host([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=img.dtype, device=img.device) / 13.0
    x = img.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    smooth = F.conv2d(x, kernel[None, None], padding=1).reshape(b, c, h, w).permute(0, 2, 3, 1)
    smooth = _clip(smooth, 0.0, 1.0)
    ys = torch.arange(h, device=img.device)[:, None, None]
    xs = torch.arange(w, device=img.device)[None, :, None]
    interior = (ys > 0) & (ys < h - 1) & (xs > 0) & (xs < w - 1)
    smooth = torch.where(interior, smooth, img)
    out = _clip(img + _per_sample(factor, 4) * (img - smooth), 0.0, 1.0)
    return torch.where(_per_sample(apply, 4), out, img)


def random_erasing(img: torch.Tensor, draws: dict) -> torch.Tensor:
    """Zero a rectangle per sample: area fraction ``draws["erase_area"]``,
    log aspect ``draws["erase_log_r"]``, corner ``draws["erase_top"|
    "erase_left"]`` (int), gate ``draws["erase_apply"]`` (kornia
    K.RandomErasing)."""
    b, h, w, _ = img.shape
    area = draws["erase_area"].to(img.dtype) * h * w
    aspect = torch.exp(draws["erase_log_r"].to(img.dtype))
    eh = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1, h).to(torch.int32)
    ew = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1, w).to(torch.int32)
    top = torch.minimum(draws["erase_top"].to(torch.int32), h - eh)
    left = torch.minimum(draws["erase_left"].to(torch.int32), w - ew)
    ys = torch.arange(h, device=img.device)[None, :, None, None]
    xs = torch.arange(w, device=img.device)[None, None, :, None]
    top, left, eh, ew = (_per_sample(t, 4) for t in (top, left, eh, ew))
    inside = (ys >= top) & (ys < top + eh) & (xs >= left) & (xs < left + ew)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    return torch.where(_per_sample(draws["erase_apply"], 4) & inside, zero, img)


def random_gaussian_noise(img: torch.Tensor, z: torch.Tensor, apply: torch.Tensor, p: AugmentParams) -> torch.Tensor:
    """img + mean + std·z where ``apply`` (B,); ``z`` (B, H, W, 3) standard normal."""
    noise = p.gauss_mean + p.gauss_std * z.to(img.dtype)
    return torch.where(_per_sample(apply, 4), img + noise, img)


def _linear_weights(n: int, scale: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(B, n_in, n_out) fp32 weights of ``jax.image.scale_and_translate``'s
    "linear" method (antialias on) for per-sample ``scale`` and
    ``translation`` (B,): triangle weights at the sample points, divided by
    their in-bounds sum, zero where a sample point lies outside the input."""
    inv = 1.0 / scale
    kernel_scale = torch.clamp(inv, min=1.0)
    pos = torch.arange(n, dtype=torch.float32, device=scale.device)
    sample_f = (pos + 0.5)[None, :] * inv[:, None] - (translation * inv)[:, None] - 0.5  # (B, n_out)
    x = (sample_f[:, None, :] - pos[None, :, None]).abs() / kernel_scale[:, None, None]
    w = torch.clamp(1 - x, min=0)
    total = w.sum(1, keepdim=True)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), zero)
    inside = (sample_f >= -0.5) & (sample_f <= n - 0.5)
    return torch.where(inside[:, None, :], w, zero)


def random_resized_crop(img, mask, nodata, draws: dict):
    """Crop a square area fraction ``draws["crop_area"]`` (B,) ~ U(scale) at
    ``draws["crop_top"|"crop_left"]`` (B,) ~ U(0, 1) of the free range and
    resize it back to full size, where ``draws["crop_apply"]`` (B,)
    (``augment.py:241-285``, kornia RandomResizedCrop with the config's
    ``scale``): linear for the image (clipped to [0, 1]), nearest for mask
    and nodata, by the JAX function's index gather."""
    b, h, w = img.shape[:3]
    side = torch.sqrt(draws["crop_area"].float())
    ch, cw = side * h, side * w
    top = draws["crop_top"].float() * (h - ch)
    left = draws["crop_left"].float() * (w - cw)
    sy, sx = h / ch, w / cw
    ty, tx = -top * sy, -left * sx
    wy, wx = _linear_weights(h, sy, ty), _linear_weights(w, sx, tx)
    img_c = _clip(torch.einsum("bijc,bio,bjp->bopc", img.float(), wy, wx), 0.0, 1.0)

    def index(n, s, t):
        pos = torch.arange(n, dtype=torch.float32, device=img.device)
        return torch.clamp(torch.round((pos[None, :] + 0.5 - t[:, None]) / s[:, None] - 0.5).to(torch.int64), 0, n - 1)

    yi, xi = index(h, sy, ty), index(w, sx, tx)

    def nearest(x):
        rows = torch.gather(x, 1, yi[:, :, None].expand(b, h, x.shape[2]))
        return torch.gather(rows, 2, xi[:, None, :].expand(b, h, w))

    apply = draws["crop_apply"]
    return (
        torch.where(_per_sample(apply, 4), img_c, img),
        torch.where(_per_sample(apply, 3), nearest(mask), mask),
        torch.where(_per_sample(apply, 3), nearest(nodata), nodata),
    )


def random_channel_shift(img: torch.Tensor, shift: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """Per-channel additive ``shift`` (B, 3) where ``apply`` (B,) (kornia
    RandomRGBShift)."""
    shifted = _clip(img + shift[:, None, None, :].to(img.dtype), 0.0, 1.0)
    return torch.where(_per_sample(apply, 4), shifted, img)


def random_jigsaw(img, mask, nodata, perm: torch.Tensor, apply: torch.Tensor, p: AugmentParams):
    """Shuffle a grid of tiles jointly across image/mask/nodata; ``perm``
    (B, gh·gw) per-sample tile order, ``apply`` (B,) (kornia RandomJigsaw)."""
    gh, gw = p.jigsaw_grid
    b, h, w = img.shape[:3]
    th, tw = h // gh, w // gw

    def shuffle(x):
        c = tuple(x.shape[3:])
        tiles = x.reshape(b, gh, th, gw, tw, *c).transpose(2, 3).reshape(b, gh * gw, th, tw, *c)
        idx = perm.to(torch.int64).reshape(b, gh * gw, *([1] * (2 + len(c)))).expand(b, gh * gw, th, tw, *c)
        tiles = torch.gather(tiles, 1, idx).reshape(b, gh, gw, th, tw, *c)
        out = tiles.transpose(2, 3).reshape(b, h, w, *c)
        return torch.where(_per_sample(apply, x.ndim), out, x)

    return shuffle(img), shuffle(mask), shuffle(nodata)


def batch_mosaic(img, mask, nodata, perms: torch.Tensor, apply: torch.Tensor):
    """2×2 mosaic: each quadrant from the sample ``perms[q]`` (4, B) names,
    where ``apply`` (B,) (kornia RandomMosaic spirit). Batch-level op."""
    h, w = img.shape[1:3]
    h2, w2 = h // 2, w // 2
    perms = perms.to(torch.int64)

    def mix(x):
        top = torch.cat([x[perms[0], :h2, :w2], x[perms[1], :h2, w2:]], dim=2)
        bot = torch.cat([x[perms[2], h2:, :w2], x[perms[3], h2:, w2:]], dim=2)
        return torch.where(_per_sample(apply, x.ndim), torch.cat([top, bot], dim=1), x)

    return mix(img), mix(mask), mix(nodata)


# --------------------------------------------------------------------------
# draws and pipelines
# --------------------------------------------------------------------------


def sample_draws(generator: torch.Generator, shape: tuple[int, int, int], p: AugmentParams) -> dict:
    """Every random number :func:`train_augment` takes for a (B, H, W) batch,
    drawn from ``generator`` on its device (the same distributions as the
    JAX package's key-based draws, not the same numbers)."""
    b, h, w = shape
    dev = generator.device

    def uniform(lo, hi, *sh):
        return lo + (hi - lo) * torch.rand((b, *sh), generator=generator, device=dev)

    def bernoulli(prob):
        return torch.rand((b,), generator=generator, device=dev) < prob

    def randint(hi):
        return torch.randint(0, hi, (b,), generator=generator, device=dev)

    def perm(n):
        return torch.argsort(torch.rand((b, n), generator=generator, device=dev), dim=1)

    draws = {
        "vflip": bernoulli(p.vertical_flip),
        "hflip": bernoulli(p.horizontal_flip),
        "brightness": uniform(max(0.0, 1 - p.brightness), 1 + p.brightness),
        "contrast": uniform(max(0.0, 1 - p.contrast), 1 + p.contrast),
        "saturation": uniform(max(0.0, 1 - p.saturation), 1 + p.saturation),
        "hue": uniform(-p.hue, p.hue),
        "sharp_factor": uniform(0.0, p.sharpness),
        "sharp_apply": bernoulli(p.sharpness_p),
        "erase_area": uniform(*p.erasing_scale),
        "erase_log_r": uniform(math.log(p.erasing_ratio[0]), math.log(p.erasing_ratio[1])),
        "erase_top": randint(h),
        "erase_left": randint(w),
        "erase_apply": bernoulli(p.erasing_p),
        "noise": torch.randn((b, h, w, 3), generator=generator, device=dev),
        "noise_apply": bernoulli(p.gauss_p),
        "shift": uniform(-p.channel_shift_limit, p.channel_shift_limit, 3),
        "shift_apply": bernoulli(p.channel_shift_p),
        "jigsaw_perm": perm(p.jigsaw_grid[0] * p.jigsaw_grid[1]),
        "jigsaw_apply": bernoulli(p.jigsaw_p),
    }
    if p.resized_crop_p > 0:
        # the order random_resized_crop uses its keys: area, top, left, apply
        draws["crop_area"] = uniform(*p.scale)
        draws["crop_top"] = uniform(0.0, 1.0)
        draws["crop_left"] = uniform(0.0, 1.0)
        draws["crop_apply"] = bernoulli(p.resized_crop_p)
    if p.mosaic_p > 0:
        draws["mosaic_perms"] = torch.stack(
            [torch.randperm(b, generator=generator, device=dev) for _ in range(4)]
        )
        draws["mosaic_apply"] = bernoulli(p.mosaic_p)
    return draws


def _flip(x: torch.Tensor, dim: int, do: torch.Tensor) -> torch.Tensor:
    return torch.where(_per_sample(do, x.ndim), x.flip(dim), x)


def train_augment(
    image: torch.Tensor,
    mask: torch.Tensor,
    nodata: torch.Tensor,
    params: AugmentParams,
    draws: dict,
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
):
    """Batched train pipeline (``augment.py:350-397``). image (B,H,W,3) in
    [0,1]; mask/nodata (B,H,W). ``draws`` from :func:`sample_draws`. Returns
    (normalized image, mask, nodata); differentiable in the image."""
    p = params
    img = image.float()
    if p.mosaic_p > 0:
        img, mask, nodata = batch_mosaic(img, mask, nodata, draws["mosaic_perms"], draws["mosaic_apply"])
    img, mask, nodata = (_flip(_flip(x, 1, draws["vflip"]), 2, draws["hflip"]) for x in (img, mask, nodata))
    if p.jigsaw_p > 0:
        img, mask, nodata = random_jigsaw(img, mask, nodata, draws["jigsaw_perm"], draws["jigsaw_apply"], p)
    if p.resized_crop_p > 0:
        img, mask, nodata = random_resized_crop(img, mask, nodata, draws)
    if p.channel_shift_p > 0:
        img = random_channel_shift(img, draws["shift"], draws["shift_apply"])
    img = color_jiggle(img, draws, p)
    img = random_sharpness(img, draws["sharp_factor"], draws["sharp_apply"])
    img = random_erasing(img, draws)
    img = random_gaussian_noise(img, draws["noise"], draws["noise_apply"], p)
    return normalize_imagenet(img, mean, std), mask, nodata


def eval_augment(
    image: torch.Tensor,
    mask: torch.Tensor,
    nodata: torch.Tensor,
    size: int,
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
):
    """Eval pipeline: CenterCrop(size) + Normalize (ref data.py:226-234)."""
    img = center_crop(image.float(), size)
    mask = center_crop(mask, size, spatial_axes=(-2, -1))
    nodata = center_crop(nodata, size, spatial_axes=(-2, -1))
    return normalize_imagenet(img, mean, std), mask, nodata
