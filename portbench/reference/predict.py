"""The plain predict path of one batch, and the gap that judges served ids.

Crops are resized with Pillow's bicubic filter (uint8 in, uint8 out), as
SegGPT's processor resizes them, and normalized with ImageNet's statistics;
the prompt's class map is painted with Painter's fixed palette. The
reference paints the query half in float32 and scores every class at every
pixel by its negative squared distance to the class's color. The served ids
come back at crop size by a nearest pick (source index ⌊i·in/out⌋), so the
scores are read at those pixels.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from portbench.reference import seggpt


def resize_bicubic_u8(crops: np.ndarray, size: int) -> np.ndarray:
    return np.stack([np.asarray(Image.fromarray(c).resize((size, size), Image.BICUBIC)) for c in crops])


def scores(w: dict, m: dict, run: dict, batch: dict, prompts: tuple, device, prec=seggpt.FP32) -> torch.Tensor:
    """(B, out, out, N) class scores of ``batch``'s crops at the served pixels."""
    size, out = run["inpt_size"], run["crop_size"]
    n_classes = len(run["classes"])
    q = torch.as_tensor(resize_bicubic_u8(batch["image_u8"], size), device=device).float() / 255.0
    idx = torch.as_tensor(batch["crop_idx"], device=device).long()
    px, pm, _ = (torch.as_tensor(a, device=device) for a in prompts)
    palette = seggpt.painter_palette(n_classes - 1).to(device)
    pal = palette[None].expand(len(idx), *palette.shape)
    p_color = seggpt.normalize(seggpt.paint(pal, pm[idx]))
    with torch.inference_mode():
        painted = seggpt.forward(w, m, seggpt.normalize(q), seggpt.normalize(px[idx].float()), p_color, prec=prec)
        s = seggpt.palette_scores(painted, seggpt.normalize(pal.float() / 255.0))
    sel = torch.as_tensor((np.arange(out) * size) // out, device=device)
    return s.index_select(1, sel).index_select(2, sel)


def gaps(s: torch.Tensor, ids) -> torch.Tensor:
    """Per pixel: the best class's score minus the served class's."""
    ids = torch.as_tensor(np.asarray(ids), device=s.device).long()
    return s.amax(-1) - s.gather(-1, ids[..., None])[..., 0]


def widest_gap(s: torch.Tensor, ids) -> float:
    """Largest (best score − served class's score) over the pixels."""
    return float(gaps(s, ids).max())
