"""Plain Painter in float32 PyTorch: the yardstick of a Painter cell.

Written from the published model (Painter, "Images Speak in Images: A
Generalist Painter for In-Context Visual Learning", arXiv:2212.02499;
``models_painter.py``, ``painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1``),
not from the port: no kernel, no fused op, no cache. Its block is ViTDet's:

- ``x = LN1(x)``; a windowed block (outside ``global_attn_indexes``) pads
  the (gh, gw) grid with zeros at the bottom and right to a multiple of
  ``window_size``, partitions it into (B·nW, w, w, C) windows and runs the
  decomposed-rel-pos attention within each window with its own tables of
  2·w − 1 rows; the padded tokens are keys with no mask (their q, k, v are
  the qkv bias). Then it unpartitions, crops the pad, adds the residual,
  and the MLP follows as in a global block, whose tables span the grid;
- the embedding is SegGPT's without the type tokens: patch embedding, the
  mask token over the query half of the mask stream, the segment tokens
  (Painter's ``segment_token_x`` / ``_y``) and the absolute positions
  interpolated from the pretrain grid with a cls slot;
- the streams merge as (x[:B] + x[B:]) / 2 after ``merge_index``, the
  intermediates go through the shared final LayerNorm, and the decoder is
  SegGPT's (linear, pixel shuffle, 3×3 conv, LayerNorm, GELU, 1×1 head).

The attention, MLP, LayerNorm, drop-path and decoder are
``reference/seggpt.py``'s (that attention takes its grid from its input, so
a window row calls it as is). Departures from the published code, all of
layout: NHWC in place of NCHW, ``x @ W`` kernels (in, out), the qkv kernel
(C, 3, C), the port's parameter names (``segment_token_input`` /
``_prompt``), the query half of the painted canvas is what callers read.
``scores`` and ``loss_and_grad`` switch TF32 off (``tf32_off``);
``Precision`` lowers every product's operands for the fp8 control.

``scores`` is ``reference/predict.py``'s and ``loss_and_grad``
``reference/train.py``'s step (augmentation under the step's draws, palette
painting, the nodata-masked smooth-L1, its gradient to the prompt pixels
through autograd), each on this forward.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

from portbench.reference import augment, predict, seggpt
from portbench.reference.seggpt import FP32, Precision
from portbench.reference.train import smooth_l1


def window_partition(x: torch.Tensor, win: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """(B, H, W, C) → (B·nW, win, win, C), windows row-major over the grid
    zero-padded at the bottom and right, and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    ph, pw = (win - h % win) % win, (win - w % win) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, c), (hp, wp)


def window_unpartition(x: torch.Tensor, win: int, padded: tuple[int, int], hw: tuple[int, int]) -> torch.Tensor:
    """(B·nW, win, win, C) → (B, H, W, C), the pad cropped."""
    hp, wp = padded
    b = x.shape[0] // ((hp // win) * (wp // win))
    x = x.reshape(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, : hw[0], : hw[1]]


def block_window(m: dict, i: int) -> int:
    """Block ``i``'s window side, 0 for a global block."""
    return 0 if i in m["global_attn_indexes"] else m["window_size"]


def block(x, w: dict, i: int, m: dict, rate: float, keeps, prec: Precision) -> torch.Tensor:
    p = f"encoder.layers_{i}"
    eps = m["layer_norm_eps"]
    h = seggpt._ln(x, w, f"{p}.layernorm_before", eps)
    win = block_window(m, i)
    if win:
        h, padded = window_partition(h, win)
        h = window_unpartition(seggpt.attention(h, w, f"{p}.attention", m, prec), win, padded, x.shape[1:3])
    else:
        h = seggpt.attention(h, w, f"{p}.attention", m, prec)
    x = x + seggpt._drop(h, rate, keeps[0])
    return x + seggpt._drop(seggpt.mlp(seggpt._ln(x, w, f"{p}.layernorm_after", eps), w, f"{p}.mlp", prec), rate,
                            keeps[1])


def embed(w: dict, m: dict, pixel_canvas: torch.Tensor, mask_canvas: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Patch embedding of both canvases, the mask token over the query half
    of the mask stream, the segment tokens and the interpolated absolute
    positions (no type token); streams stacked [pixel, mask] on the batch."""
    p = m["patch_size"]
    c = m["hidden_size"]

    def patches(x):
        b, h, wd, ch = x.shape
        t = x.reshape(b, h // p, p, wd // p, p, ch).permute(0, 1, 3, 2, 4, 5).reshape(b, h // p, wd // p, p * p * ch)
        return seggpt._mm(t, w["embeddings.patch_embeddings.kernel"], prec) + w["embeddings.patch_embeddings.bias"]

    pix, msk = patches(pixel_canvas), patches(mask_canvas)
    b, gh, gw, _ = pix.shape
    query_rows = torch.arange(gh, device=pix.device)[None, :, None, None] >= gh // 2
    msk = torch.where(query_rows, w["embeddings.mask_token"].reshape(1, 1, 1, c), msk)
    pre = m["pretrain_image_size"] // p
    pos = w["embeddings.position_embeddings"][0, 1:].reshape(1, pre, pre, c).permute(0, 3, 1, 2)
    if (pre, pre) != (gh, gw):
        pos = F.interpolate(pos, size=(gh, gw), mode="bicubic", align_corners=False)
    pos = pos.permute(0, 2, 3, 1)
    pix = pix + w["embeddings.segment_token_input"] + pos
    msk = msk + w["embeddings.segment_token_prompt"] + pos
    return torch.cat([pix, msk], dim=0)


def forward(w: dict, m: dict, query: torch.Tensor, prompt: torch.Tensor, prompt_mask: torch.Tensor,
            labels: torch.Tensor | None = None, drop_keeps: list | None = None, prec: Precision = FP32,
            checkpoint: bool = False) -> torch.Tensor:
    """Normalized NHWC images (B, H, W, 3) → the painted query half (B, H, W, 3);
    ``drop_keeps`` as ``seggpt.forward`` takes them."""
    pixel_canvas = torch.cat([prompt, query], dim=1)
    mask_canvas = torch.cat([prompt_mask, labels if labels is not None else prompt_mask], dim=1)
    x = embed(w, m, pixel_canvas, mask_canvas, prec)
    rates = seggpt.drop_rates(m)
    feats = []
    for i in range(m["num_hidden_layers"]):
        keeps = drop_keeps[i] if drop_keeps is not None else (None, None)
        if checkpoint and torch.is_grad_enabled():
            x = _checkpoint(block, x, w, i, m, rates[i], keeps, prec, use_reentrant=False)
        else:
            x = block(x, w, i, m, rates[i], keeps, prec)
        if i == m["merge_index"]:
            half = x.shape[0] // 2
            x = (x[:half] + x[half:]) * 0.5
        if i in m["intermediate_hidden_state_indices"]:
            feats.append(seggpt._ln(x, w, "encoder.layernorm", m["layer_norm_eps"]))
    painted = seggpt.decode(w, m, torch.cat(feats, dim=-1), prec)
    return painted[:, painted.shape[1] // 2:]


def loss_and_grad(w: dict, model: dict, run: dict, aug: dict, pixels: torch.Tensor, prompt_masks, prompt_nodata,
                  batch: dict, draws: dict, prec: Precision = FP32):
    """→ (loss, d loss / d pixels) of one prompt-tuning step on ``batch``
    under ``draws``, as ``reference/train.py``'s ``loss_and_grad`` on
    Painter's forward, TF32 off."""
    tf32_off()
    palette = draws["palette"]
    q_img, q_mask, _ = augment.train_augment(batch["image"], batch["mask"], batch["nodata"], draws["aug_q"], aug)
    q_mask = torch.where(batch["valid"][:, None, None], q_mask, torch.zeros_like(q_mask))
    labels = seggpt.normalize(seggpt.paint(palette, q_mask))
    idx = draws["prompt_idx"].long()
    with torch.enable_grad():
        leaf = pixels.detach().clone().requires_grad_(True)
        p_img, p_mask, _ = augment.train_augment(leaf[idx], prompt_masks[idx], prompt_nodata[idx], draws["aug_p"], aug)
        p_color = seggpt.normalize(seggpt.paint(palette, p_mask))
        pred = forward(w, model, q_img, p_img, p_color, labels=labels, drop_keeps=draws["drop_masks"], prec=prec,
                       checkpoint=True)
        keep = (q_mask != 0).float()[..., None]
        loss = (smooth_l1(pred - labels, run["loss_beta"]) * keep).sum() / (keep.sum() * 3).clamp(min=1.0)
        (grad,) = torch.autograd.grad(loss, leaf)
    return loss.detach(), grad


def tf32_off() -> None:
    """Every float32 product of the reference in full float32 on the card
    (PyTorch's cuDNN convolutions default to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def scores(w: dict, m: dict, run: dict, batch: dict, prompts: tuple, device, prec: Precision = FP32) -> torch.Tensor:
    """(B, out, out, N) class scores of ``batch``'s crops at the served
    pixels, as ``reference/predict.py``'s ``scores`` on Painter's forward,
    TF32 off."""
    tf32_off()
    size, out = run["inpt_size"], run["crop_size"]
    q = torch.as_tensor(predict.resize_bicubic_u8(batch["image_u8"], size), device=device).float() / 255.0
    idx = torch.as_tensor(batch["crop_idx"], device=device).long()
    px, pm, _ = (torch.as_tensor(a, device=device) for a in prompts)
    palette = seggpt.painter_palette(len(run["classes"]) - 1).to(device)
    pal = palette[None].expand(len(idx), *palette.shape)
    p_color = seggpt.normalize(seggpt.paint(pal, pm[idx]))
    with torch.inference_mode():
        painted = forward(w, m, seggpt.normalize(q), seggpt.normalize(px[idx].float()), p_color, prec=prec)
        s = seggpt.palette_scores(painted, seggpt.normalize(pal.float() / 255.0))
    sel = torch.as_tensor((np.arange(out) * size) // out, device=device)
    return s.index_select(1, sel).index_select(2, sel)
