"""Plain train-time augmentation under given draws, in float32.

The BeachSeg recipe's order: vertical flip, horizontal flip, RGB shift,
color jitter (brightness, contrast, saturation, hue), sharpness, erasing,
Gaussian noise, ImageNet normalization. Flips move the class map and the
nodata mask with the image; the rest touch the image only. Each op is the
textbook definition (kornia's ColorJiggle family, torchvision's 3×3
sharpness kernel, random erasing by area and log aspect), written per
sample so that nothing is shared with a batched implementation. Clips are
min/max, whose gradient at an exact bound is split as ``jnp.clip`` splits
it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.seggpt import normalize


def _clip01(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.ones_like(x))


def _gray(x: torch.Tensor) -> torch.Tensor:
    return 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]


def _rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    r, g, b = x.unbind(-1)
    mx, mn = x.amax(-1), x.amin(-1)
    delta = mx - mn
    s = torch.where(mx > 0, delta / torch.clamp(mx, min=1e-12), torch.zeros_like(mx))
    d = torch.clamp(delta, min=1e-12)
    rc, gc, bc = (mx - r) / d, (mx - g) / d, (mx - b) / d
    h = torch.where(mx == r, bc - gc, torch.where(mx == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return torch.stack([h, s, mx], -1)


def _hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    h, s, v = x.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    sector = torch.remainder(i, 6).long()
    table = torch.stack([
        torch.stack([v, q, p, p, t, v], -1),
        torch.stack([t, v, v, q, p, p], -1),
        torch.stack([p, p, t, v, v, q], -1),
    ], -2)  # (..., 3, 6)
    return torch.gather(table, -1, sector[..., None, None].expand(*sector.shape, 3, 1))[..., 0]


def _one(img, mask, nod, d: dict, i: int, aug: dict):
    """One sample: img (H, W, 3) in [0, 1], mask and nodata (H, W)."""
    if bool(d["vflip"][i]):
        img, mask, nod = img.flip(0), mask.flip(0), nod.flip(0)
    if bool(d["hflip"][i]):
        img, mask, nod = img.flip(1), mask.flip(1), nod.flip(1)
    if aug["channel_shift_p"] > 0 and bool(d["shift_apply"][i]):
        img = _clip01(img + d["shift"][i])
    if aug["brightness"] > 0:
        img = _clip01(img * d["brightness"][i])
    if aug["contrast"] > 0:
        m = _gray(img).mean()
        img = _clip01((img - m) * d["contrast"][i] + m)
    if aug["saturation"] > 0:
        g = _gray(img)
        img = _clip01(g + (img - g) * d["saturation"][i])
    if aug["hue"] > 0:
        hsv = _rgb_to_hsv(img)
        hue = torch.remainder(hsv[..., 0] + d["hue"][i], 1.0)
        img = _clip01(_hsv_to_rgb(torch.stack([hue, hsv[..., 1], hsv[..., 2]], -1)))
    if bool(d["sharp_apply"][i]):
        k = torch.tensor([[1.0, 1, 1], [1, 5, 1], [1, 1, 1]], device=img.device) / 13.0
        blur = F.conv2d(img.permute(2, 0, 1)[:, None], k[None, None], padding=1)[:, 0].permute(1, 2, 0)
        blur = _clip01(blur)
        inner = torch.zeros(img.shape[:2], dtype=torch.bool, device=img.device)
        inner[1:-1, 1:-1] = True
        blur = torch.where(inner[..., None], blur, img)
        img = _clip01(img + d["sharp_factor"][i] * (img - blur))
    if bool(d["erase_apply"][i]):
        h, w = img.shape[:2]
        area = float(d["erase_area"][i]) * h * w
        aspect = float(torch.exp(d["erase_log_r"][i]))
        eh = int(min(max(round((area * aspect) ** 0.5), 1), h))
        ew = int(min(max(round((area / aspect) ** 0.5), 1), w))
        top = min(int(d["erase_top"][i]), h - eh)
        left = min(int(d["erase_left"][i]), w - ew)
        keep = torch.ones(img.shape[:2], dtype=torch.bool, device=img.device)
        keep[top:top + eh, left:left + ew] = False
        img = torch.where(keep[..., None], img, torch.zeros_like(img))
    if bool(d["noise_apply"][i]):
        img = img + aug["gauss_mean"] + aug["gauss_std"] * d["noise"][i]
    return img, mask, nod


def train_augment(img: torch.Tensor, mask: torch.Tensor, nod: torch.Tensor, draws: dict, aug: dict):
    """(B, H, W, 3) images in [0, 1], (B, H, W) class ids and nodata →
    (normalized images, class ids, nodata)."""
    outs = [_one(img[i], mask[i], nod[i], draws, i, aug) for i in range(img.shape[0])]
    return normalize(torch.stack([o[0] for o in outs])), torch.stack([o[1] for o in outs]), \
        torch.stack([o[2] for o in outs])
