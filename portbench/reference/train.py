"""Plain prompt-tuning steps: the yardstick of a train cell.

One step: the query tiles and the prompts each row takes go through the
augmentation under the step's draws, the class maps are painted with the
row's palette, SegGPT runs with the labels and stochastic depth, the loss is
the nodata-masked smooth-L1 of the painted query half (BeachSeg's default
``nodata`` loss: the mean over the labelled pixels' channels), its gradient
flows to the prompt pixels only, and AdamW (β 0.9 / 0.999, ε 1e-8, weight
decay 1e-4, the square-root batch-scaled learning rate of the run's first
epoch) moves them.

The comparison reads, by the worst leaf (one leaf a prompt): each step's
loss, the first gradient and the change of the pixels after the steps. A
leaf's gap is |‖program‖ − ‖reference‖| over the larger of the reference's
norm of that leaf and of the median leaf. Leaves whose reference gradient is
under a thousandth of the median leaf's (prompts no row took) are left out.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import augment, seggpt

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


def smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    a = diff.abs()
    return torch.where(a < beta, 0.5 * diff * diff / beta, a - 0.5 * beta)


def learning_rate(run: dict) -> float:
    """The first epoch's rate: lr·√(batch / base batch) (no warm-up; the
    cosine starts at its top)."""
    return run["lr"] * math.sqrt(run["batch_size"] / run["base_lr_batch_size"])


def loss_and_grad(w: dict, model: dict, run: dict, aug: dict, pixels: torch.Tensor, prompt_masks, prompt_nodata,
                  batch: dict, draws: dict, prec=seggpt.FP32):
    """→ (loss, d loss / d pixels) of one step on ``batch`` (image (B, S, S, 3)
    in [0, 1], mask, nodata, valid) under ``draws``."""
    palette = draws["palette"]
    q_img, q_mask, _ = augment.train_augment(batch["image"], batch["mask"], batch["nodata"], draws["aug_q"], aug)
    q_mask = torch.where(batch["valid"][:, None, None], q_mask, torch.zeros_like(q_mask))
    labels = seggpt.normalize(seggpt.paint(palette, q_mask))
    idx = draws["prompt_idx"].long()
    with torch.enable_grad():
        leaf = pixels.detach().clone().requires_grad_(True)
        p_img, p_mask, _ = augment.train_augment(leaf[idx], prompt_masks[idx], prompt_nodata[idx], draws["aug_p"], aug)
        p_color = seggpt.normalize(seggpt.paint(palette, p_mask))
        pred = seggpt.forward(w, model, q_img, p_img, p_color, labels=labels, drop_keeps=draws["drop_masks"],
                              prec=prec, checkpoint=True)
        keep = (q_mask != 0).float()[..., None]
        loss = (smooth_l1(pred - labels, run["loss_beta"]) * keep).sum() / (keep.sum() * 3).clamp(min=1.0)
        (grad,) = torch.autograd.grad(loss, leaf)
    return loss.detach(), grad


def adamw(pixels, grad, mu, nu, count: int, lr: float):
    mu = B1 * mu + (1 - B1) * grad
    nu = B2 * nu + (1 - B2) * grad * grad
    count += 1
    mhat = mu / (1 - B1**count)
    nhat = nu / (1 - B2**count)
    return pixels - lr * (mhat / (torch.sqrt(nhat) + EPS) + WEIGHT_DECAY * pixels), mu, nu, count


def run_steps(w, model, run, aug, pixels0, prompt_masks, prompt_nodata, batches, draws_list, prec=seggpt.FP32):
    """The reference's readings over the steps: losses, each step's gradient,
    the pixels after the last."""
    pixels, mu, nu, count = pixels0.clone(), torch.zeros_like(pixels0), torch.zeros_like(pixels0), 0
    lr = learning_rate(run)
    losses, grads = [], []
    for batch, draws in zip(batches, draws_list):
        loss, g = loss_and_grad(w, model, run, aug, pixels, prompt_masks, prompt_nodata, batch, draws, prec)
        losses.append(float(loss))
        grads.append(g)
        pixels, mu, nu, count = adamw(pixels, g, mu, nu, count, lr)
    return {"losses": losses, "grads": grads, "pixels": pixels}


def leaf_norms(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1).double().norm(dim=1)


def worst_leaf_gap(got: torch.Tensor, want: torch.Tensor, gate: torch.Tensor) -> float:
    """Worst |‖got_l‖ − ‖want_l‖| / max(‖want_l‖, median ‖want‖) over the
    leaves whose ``gate`` (the reference's gradient norm) is at least a
    thousandth of its median over the leaves with any gradient."""
    g_norms, w_norms = leaf_norms(got), leaf_norms(want)
    moved = gate[gate > 0]
    if moved.numel() == 0:
        return 0.0
    keep = gate >= 1e-3 * moved.median()
    median = w_norms[keep].median()
    gaps = (g_norms[keep] - w_norms[keep]).abs() / torch.maximum(w_norms[keep], median)
    return float(gaps.max())


def readings(prog: dict, ref: dict, pixels0: torch.Tensor) -> dict:
    """The train cell's compared numbers from the program's readings (losses,
    first gradient, pixels after the steps) and the reference's."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grads"][0]
    grad_gap = worst_leaf_gap(prog["grad1"], g_ref, leaf_norms(g_ref))
    moved = sum(leaf_norms(g) for g in ref["grads"])
    delta_gap = worst_leaf_gap(prog["pixels"] - pixels0, ref["pixels"] - pixels0, moved)
    return {"loss_rel": loss_gap, "grad1_leaf": grad_gap, "delta_leaf": delta_gap}
