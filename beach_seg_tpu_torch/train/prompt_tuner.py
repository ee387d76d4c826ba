"""Prompt tuning and prompt-tuned inference (counterpart of
``beach_seg_tpu/train/prompt_tuner.py``).

The only trainable weights are the prompt pixels: all prompt crops live in one
(P, S, S, 3) array in [0, 1]; each tile takes its prompt by index.

- ``train_step``: random palette → query and prompt augmentation (gradients
  flow into the prompt pixels through it) → colorize → SegGPT with labels and
  drop-path → loss → gradient w.r.t. the prompt pixels only → AdamW (optax
  semantics) → EMA → palette decode → confusion matrix.
- ``eval_step``: eval augmentation, the sample's own prompt, a random palette.
- ``predict_step``: the inference forward: raw uint8 crops (or eval-augmented
  float crops) → SegGPT on the prompt‖query canvas → palette-distance decode
  → optional cv2-nearest back-resize to uint8 ids.
- ``predict_step_probs``: the same forward → soft class probabilities, the
  overlap-blend engine's input, optionally back-resized (cv2 bicubic) and
  multiplied by a feather window on the device.

Random numbers come from an explicit ``torch.Generator``; a test can pass the
draws JAX took instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch

from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt.model import SegGPT, default_bool_masked_pos, seggpt_loss
from beach_seg_tpu_torch.ops.resize import resize_matrix, resize_pil_uint8_device
from beach_seg_tpu_torch.train.metrics import confusion_update
from beach_seg_tpu_torch.transforms import (
    AugmentParams,
    apply_palette,
    build_palette,
    decode_by_palette,
    eval_augment,
    normalize_imagenet,
    normalize_palette,
    random_palette,
    sample_draws,
    train_augment,
)
from beach_seg_tpu_torch.utils.device import resolve_device


def _smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    l1 = diff.abs()
    return torch.where(l1 < beta, 0.5 * diff * diff / beta, l1 - 0.5 * beta)


def prompt_tune_loss(pred_masks, labels, yesdata, beta: float) -> torch.Tensor:
    """Nodata-masked smooth-L1 on the query half (ref src/model.py:40-64,
    intended B>1 semantics). NHWC: pred (B,2H,W,3), labels (B,H,W,3)."""
    h = pred_masks.shape[1] // 2
    loss = _smooth_l1(pred_masks[:, h:].float() - labels.float(), beta)
    keep = yesdata.float()[..., None]
    denom = keep.sum() * pred_masks.shape[-1]
    return (loss * keep).sum() / denom.clamp(min=1.0)


def prompt_tune_loss_ref_compat(pred_masks, labels, yesdata, beta: float, sample_weight=None) -> torch.Tensor:
    """Bug-for-bug port of the reference's loss INCLUDING its ``unsqueeze(1)``
    broadcast (src/model.py:61): at B>1 every (sample_i loss × sample_j keep)
    pair is summed before dividing by keep.sum(). ``sample_weight`` zeroes
    padded rows on both sides of the pair product."""
    h = pred_masks.shape[1] // 2
    loss = _smooth_l1(pred_masks[:, h:].float() - labels.float(), beta)
    keep = yesdata.float()[..., None].expand(loss.shape)
    if sample_weight is not None:
        w = sample_weight.float()[:, None, None, None]
        loss = loss * w
        keep = keep * w
    pair = torch.einsum("ihwc,jhwc->", loss, keep)
    return pair / keep.sum().clamp(min=1.0)


def soft_class_probs(pred_masks, palette_norm, tau: float = 0.05) -> torch.Tensor:
    """Softmax over negative squared palette distances of the painted query
    half: pred (B, 2H, W, 3) → (B, H, W, C)."""
    h = pred_masks.shape[1] // 2
    query = pred_masks[:, h:].float()
    p = palette_norm.float()
    d2 = (
        (query * query).sum(-1)[..., None]
        - 2.0 * torch.einsum("bhwc,bnc->bhwn", query, p)
        + (p * p).sum(-1)[:, None, None, :]
    )
    return torch.softmax(-d2 / tau, dim=-1)


def dice_bce_loss(pred_masks, palette_norm, labels, yesdata, num_classes: int, sample_weight=None) -> torch.Tensor:
    """Dice + BCE on soft class probabilities; labels (B, H, W) int ids,
    masked to yesdata pixels; ``sample_weight`` (B,) zeroes padded rows from
    both terms."""
    probs = soft_class_probs(pred_masks, palette_norm)
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    keep = yesdata.float()[..., None]
    if sample_weight is not None:
        keep = keep * sample_weight.float()[:, None, None, None]
    eps = 1e-6
    lo = torch.tensor(eps, device=probs.device)
    hi = torch.tensor(1 - eps, device=probs.device)
    probs_c = torch.minimum(torch.maximum(probs, lo), hi)  # jnp.clip
    bce = -(onehot * torch.log(probs_c) + (1 - onehot) * torch.log(1 - probs_c))
    bce = (bce * keep).sum() / (keep.sum() * num_classes).clamp(min=1.0)
    inter = (probs * onehot * keep).sum(dim=(1, 2))
    denom = ((probs + onehot) * keep).sum(dim=(1, 2))
    dice = 1.0 - (2 * inter + eps) / (denom + eps)
    if sample_weight is not None:
        w = sample_weight.float()
        return bce + (dice.mean(-1) * w).sum() / w.sum().clamp(min=1.0)
    return bce + dice.mean()


def lr_schedule(conf: BeachSegConfig, steps_per_epoch: int):
    """sqrt-batch-scaled warmup + per-epoch cosine (ref src/model.py:385-428)
    as a function of the update count, in fp32 as the JAX schedule runs."""
    gbs = conf.batch_size * conf.world_size * conf.grad_accum_steps
    ratio = (gbs / conf.base_lr_batch_size) ** 0.5
    lr, init_lr, min_lr = conf.lr * ratio, conf.init_lr * ratio, conf.min_lr * ratio
    warmup, total = conf.warmup_epochs, max(conf.epochs, 1)
    f32 = np.float32

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        if epoch < warmup:
            return float(f32(init_lr) + f32(lr - init_lr) * f32(epoch) / f32(max(warmup, 1)))
        e = f32(max(epoch - warmup, 0))
        return float(f32(min_lr) + f32(0.5 * (lr - min_lr)) * (f32(1) + np.cos(f32(math.pi) * e / f32(total))))

    return schedule


def _pow_f32(base: float, n: int) -> np.float32:
    """base**n in fp32 by squaring, as XLA computes a float to an integer
    power: Adam's 1 - b2**n cancels, so an ulp of the power is 1e-4 of it."""
    r, b = np.float32(1), np.float32(base)
    while n:
        if n & 1:
            r = np.float32(r * b)
        b = np.float32(b * b)
        n >>= 1
    return r


class AdamW:
    """``optax.adamw(schedule)`` (b1 0.9, b2 0.999, eps 1e-8, weight decay
    1e-4), wrapped in ``optax.MultiSteps(k)`` when ``accum_steps`` > 1, on one
    fp32 tensor, with the same arithmetic order: update n (0-based) uses
    lr = schedule(n) and decays the pre-update params; under MultiSteps the
    mean of k gradients makes one update, the steps between return zeros,
    and the inner count advances only on real updates."""

    def __init__(self, schedule, accum_steps: int = 1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
        self.schedule, self.k = schedule, accum_steps
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params: torch.Tensor) -> dict:
        z = torch.zeros_like(params)
        state = {"mu": z, "nu": z.clone(), "count": 0}
        if self.k > 1:
            state.update(acc=z.clone(), mini_step=0)
        return state

    def _adamw(self, g, state, params):
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * g + b1 * state["mu"]
        nu = (1 - b2) * (g * g) + b2 * state["nu"]
        count = state["count"] + 1
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=g.device)  # noqa: E731
        mu_hat = mu / f32(1 - _pow_f32(b1, count))
        nu_hat = nu / f32(1 - _pow_f32(b2, count))
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps) + self.weight_decay * params
        u = f32(-self.schedule(state["count"])) * u
        return u, {"mu": mu, "nu": nu, "count": count}

    def update(self, grads: torch.Tensor, state: dict, params: torch.Tensor) -> tuple[torch.Tensor, dict]:
        if self.k == 1:
            return self._adamw(grads, state, params)
        acc = state["acc"] + (grads - state["acc"]) / (state["mini_step"] + 1)
        if state["mini_step"] < self.k - 1:
            return torch.zeros_like(grads), dict(state, acc=acc, mini_step=state["mini_step"] + 1)
        u, inner = self._adamw(acc, state, params)
        return u, dict(inner, acc=torch.zeros_like(acc), mini_step=0)


def make_optimizer(conf: BeachSegConfig, steps_per_epoch: int) -> AdamW:
    if conf.optimizer != "adamw":
        raise ValueError(f"Unexpected optimizer {conf.optimizer}")
    if conf.scheduler != "cosine":
        raise ValueError(f"Unexpected scheduler {conf.scheduler}")
    return AdamW(lr_schedule(conf, steps_per_epoch), conf.grad_accum_steps)


@dataclass
class PromptState:
    """Training state: the prompt pixels are the only parameters."""

    prompt_pixels: torch.Tensor  # (P, S, S, 3) float32 in [0, 1]
    ema_pixels: torch.Tensor  # EMA of the above (ref src/old/train.py:168)
    opt_state: dict
    step: int


class PromptTuner:
    """Runs the prompt-tuning steps of ``model`` on ``device`` (None → CUDA,
    raising if absent). Inputs may be numpy arrays or tensors on any device;
    they are moved to ``device``. ``steps_per_epoch`` sets the lr schedule."""

    def __init__(self, model: SegGPT, conf: BeachSegConfig, device=None, steps_per_epoch: int = 1):
        self.device = resolve_device(device)
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"model is on {param.device}, the tuner on {self.device}")
        self.model, self.conf, self.steps_per_epoch = model, conf, steps_per_epoch
        self.aug = AugmentParams.from_config(conf)
        self.optimizer = make_optimizer(conf, steps_per_epoch)

    @property
    def num_classes(self) -> int:
        return len(self.conf.classes)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def init_state(self, prompt_pixels) -> PromptState:
        pixels = self._tensor(prompt_pixels).float().clone()
        return PromptState(pixels, pixels.clone(), self.optimizer.init(pixels), 0)

    # ---------------------------------------------------------------- train

    def step_draws(self, batch, n_prompts: int, generator: torch.Generator, draws: dict | None = None) -> dict:
        """Every random number of one train step: those in ``draws`` (any of
        ``palette`` (B, N, 3) uint8, ``prompt_idx`` (B,), ``aug_q`` / ``aug_p``
        (``transforms.sample_draws`` dicts for the query and prompt
        augmentations), ``prompt_drop`` (B,) bool, ``drop_masks``
        (``Encoder.forward``'s keep masks)), the rest drawn from
        ``generator`` (on the tuner's device), all moved to the device."""
        draws = dict(draws or {})
        mask = batch["mask"]
        b, h, w = mask.shape
        dev = generator.device if generator is not None else self.device
        makers = {
            "palette": lambda: random_palette(generator, self.num_classes, b),
            "aug_q": lambda: sample_draws(generator, (b, h, w), self.aug),
            "prompt_idx": lambda: torch.randint(0, n_prompts, (b,), generator=generator, device=dev),
            "aug_p": lambda: sample_draws(generator, (b, self.conf.inpt_size, self.conf.inpt_size), self.aug),
            "prompt_drop": lambda: torch.rand((b,), generator=generator, device=dev) < self.conf.prompt_dropout,
            "drop_masks": lambda: (
                self.model.sample_drop_masks(generator, b)
                if self.model.config.drop_path_rate > 0.0 else None
            ),
        }
        for name, make in makers.items():
            if name not in draws:
                draws[name] = make()
        for name in ("palette", "prompt_idx", "prompt_drop"):
            draws[name] = self._tensor(draws[name])
        for name in ("aug_q", "aug_p"):
            draws[name] = {k: self._tensor(v) for k, v in draws[name].items()}
        if draws["drop_masks"] is not None:
            draws["drop_masks"] = [tuple(None if m is None else self._tensor(m) for m in pair) for pair in draws["drop_masks"]]
        return draws

    def loss_and_grad(self, prompt_pixels: torch.Tensor, prompt_masks, prompt_nodata, batch, draws: dict):
        """The differentiable half of :meth:`train_step` on complete
        ``draws`` (:meth:`step_draws`): → (loss, d loss / d prompt_pixels,
        pred_masks, query mask, normalized palette). Runs with gradients on
        whatever the caller's mode (not under ``inference_mode``)."""
        conf, model = self.conf, self.model
        image = self._tensor(batch["image"]).float()
        b = image.shape[0]
        valid = self._tensor(batch["valid"]) if "valid" in batch else None
        palette = draws["palette"]
        palette_norm = normalize_palette(palette)
        q_img, q_mask, _ = train_augment(image, self._tensor(batch["mask"]), self._tensor(batch["nodata"]), self.aug, draws=draws["aug_q"])
        if valid is not None:
            # padded rows → all nodata (class 0): out of the loss and the confusion update
            q_mask = torch.where(valid[:, None, None], q_mask, torch.zeros_like(q_mask))
        labels_color = normalize_imagenet(apply_palette(palette, q_mask))
        idx = draws["prompt_idx"].to(torch.int64)
        p_mask = self._tensor(prompt_masks).index_select(0, idx)
        p_nod = self._tensor(prompt_nodata).index_select(0, idx)
        with torch.enable_grad():
            leaf = prompt_pixels.detach().requires_grad_(True)
            p_img = leaf.index_select(0, idx)
            if conf.prompt_dropout > 0.0:
                # legacy trainer's prompt dropout (ref src/old/train.py:141-143)
                p_img = torch.where(draws["prompt_drop"][:, None, None, None], torch.zeros_like(p_img), p_img)
            p_img_aug, p_mask_aug, _ = train_augment(p_img, p_mask, p_nod, self.aug, draws=draws["aug_p"])
            p_color = normalize_imagenet(apply_palette(palette, p_mask_aug))
            out = model(
                pixel_values=q_img, prompt_pixel_values=p_img_aug, prompt_masks=p_color, labels=labels_color,
                embedding_type="instance", deterministic=False, decode_query_only=True,
                drop_masks=draws["drop_masks"],
            )
            pred_masks = out["pred_masks"]
            if conf.loss_variant == "hf":
                if valid is None:
                    loss = out["loss"]
                else:
                    bmp = default_bool_masked_pos(model.config, b, self.device)
                    loss = seggpt_loss(model.config, p_color, pred_masks, labels_color, bmp, sample_weight=valid)
            elif conf.loss_variant == "dice_bce":
                loss = dice_bce_loss(pred_masks, palette_norm, q_mask, q_mask != 0, self.num_classes, sample_weight=valid)
            elif conf.loss_variant == "nodata_ref":
                loss = prompt_tune_loss_ref_compat(pred_masks, labels_color, q_mask != 0, conf.loss_beta, sample_weight=valid)
            else:
                loss = prompt_tune_loss(pred_masks, labels_color, q_mask != 0, conf.loss_beta)
            (grads,) = torch.autograd.grad(loss, leaf)
        return loss.detach(), grads, pred_masks.detach(), q_mask, palette_norm

    def train_step(self, state: PromptState, prompt_masks, prompt_nodata, batch, generator=None, draws=None):
        """One prompt-tuning step (ref src/model.py:233-269) → (new state,
        {"loss", "confusion"}). ``state`` is updated in place and returned.
        Random numbers: ``draws`` as :meth:`step_draws` takes them, the rest
        from ``generator``. ``batch["valid"]`` (B,) bool, if present, marks
        padded rows, which drop out of the loss and the confusion matrix."""
        draws = self.step_draws(batch, state.prompt_pixels.shape[0], generator, draws)
        loss, grads, pred_masks, q_mask, palette_norm = self.loss_and_grad(
            state.prompt_pixels, prompt_masks, prompt_nodata, batch, draws
        )
        with torch.no_grad():
            pixels = state.prompt_pixels
            updates, state.opt_state = self.optimizer.update(grads, state.opt_state, pixels)
            state.prompt_pixels = pixels + updates
            state.ema_pixels = self.conf.ema_alpha * state.ema_pixels + (1.0 - self.conf.ema_alpha) * state.prompt_pixels
            state.step += 1
            h = pred_masks.shape[1] // 2
            pred_ids = decode_by_palette(pred_masks[:, h:], palette_norm)
            cm = confusion_update(pred_ids, q_mask, self.num_classes)
        return state, {"loss": loss, "confusion": cm}

    # ----------------------------------------------------------------- eval

    @torch.inference_mode()
    def eval_step(self, prompt_pixels, prompt_masks, prompt_nodata, batch, palette=None, generator=None):
        """Validation (ref src/model.py:271-308): eval augmentation, prompt =
        the sample's own crop, a random palette (``palette`` (B, N, 3) uint8,
        or drawn from ``generator``) → {"loss", "confusion", "pred"}."""
        conf = self.conf
        image = self._tensor(batch["image"])
        b = image.shape[0]
        valid = self._tensor(batch["valid"]) if "valid" in batch else None
        if palette is None:
            palette = random_palette(generator, self.num_classes, b)
        palette = self._tensor(palette)
        palette_norm = normalize_palette(palette)
        q_img, q_mask, _ = eval_augment(image, self._tensor(batch["mask"]), self._tensor(batch["nodata"]), conf.inpt_size)
        if valid is not None:
            q_mask = torch.where(valid[:, None, None], q_mask, torch.zeros_like(q_mask))
        labels_color = normalize_imagenet(apply_palette(palette, q_mask))
        idx = self._tensor(batch["crop_idx"]).to(torch.int64)
        p_img = self._tensor(prompt_pixels).index_select(0, idx)
        p_mask = self._tensor(prompt_masks).index_select(0, idx)
        p_nod = self._tensor(prompt_nodata).index_select(0, idx)
        p_img_aug, p_mask_aug, _ = eval_augment(p_img, p_mask, p_nod, conf.inpt_size)
        p_color = normalize_imagenet(apply_palette(palette, p_mask_aug))
        out = self.model(
            pixel_values=q_img, prompt_pixel_values=p_img_aug, prompt_masks=p_color, labels=labels_color,
            embedding_type="instance", decode_query_only=True,
        )
        pred_masks = out["pred_masks"]
        loss = prompt_tune_loss(pred_masks, labels_color, q_mask != 0, conf.loss_beta)
        h = pred_masks.shape[1] // 2
        pred_ids = decode_by_palette(pred_masks[:, h:], palette_norm)
        return {"loss": loss, "confusion": confusion_update(pred_ids, q_mask, self.num_classes), "pred": pred_ids}

    # -------------------------------------------------------------- predict

    def _query_pixels(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """Normalized query canvas from either batch flavor: ``image_u8``
        (B, S, S, 3) uint8 raw crops → PIL-parity resize on the device +
        normalize; ``image`` (B, inpt, inpt, 3) float → center-crop +
        normalize."""
        conf = self.conf
        if "image_u8" in batch:
            q = self._tensor(batch["image_u8"])
            if q.shape[1] != conf.inpt_size:
                q = resize_pil_uint8_device(q, (conf.inpt_size, conf.inpt_size))
            else:
                q = q.float()
            return normalize_imagenet(q / 255.0)
        q_img, _, _ = eval_augment(
            self._tensor(batch["image"]), self._tensor(batch["mask"]), self._tensor(batch["nodata"]), conf.inpt_size
        )
        return q_img

    @torch.inference_mode()
    def predict_masks(self, prompt_pixels, prompt_masks, prompt_nodata, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """The model half of the predict step: → (pred_masks (B, 2H, W, 3)
        fp32, normalized palette (B, N, 3)). Prompt = the tile's own crop
        index; Painter palette."""
        conf = self.conf
        q_img = self._query_pixels(batch)
        b = q_img.shape[0]
        palette = self._tensor(build_palette(self.num_classes - 1))[None].expand(b, self.num_classes, 3)
        palette_norm = normalize_palette(palette)

        idx = self._tensor(batch["crop_idx"]).to(torch.int64)
        p_img = self._tensor(prompt_pixels).index_select(0, idx)
        p_mask = self._tensor(prompt_masks).index_select(0, idx)
        p_nod = self._tensor(prompt_nodata).index_select(0, idx)
        p_img_aug, p_mask_aug, _ = eval_augment(p_img, p_mask, p_nod, conf.inpt_size)
        p_color = normalize_imagenet(apply_palette(palette, p_mask_aug))

        out = self.model(
            pixel_values=q_img,
            prompt_pixel_values=p_img_aug,
            prompt_masks=p_color,
            embedding_type="instance",
            decode_query_only=True,
        )
        return out["pred_masks"], palette_norm

    @torch.inference_mode()
    def predict_step(self, prompt_pixels, prompt_masks, prompt_nodata, batch, out_size: int | None = None) -> torch.Tensor:
        """Inference forward: (B, S, S) int32 ids, or with ``out_size``
        (B, out, out) uint8 ids back-resized on the device with the
        cv2-nearest selection."""
        pred_masks, palette_norm = self.predict_masks(prompt_pixels, prompt_masks, prompt_nodata, batch)
        h = pred_masks.shape[1] // 2
        ids = decode_by_palette(pred_masks[:, h:], palette_norm)
        if out_size is not None and out_size != ids.shape[1]:
            sel = self._tensor(resize_matrix(ids.shape[1], out_size, "nearest_cv2").argmax(1))
            ids = ids.index_select(1, sel).index_select(2, sel)
        return ids.to(torch.uint8) if out_size is not None else ids

    @torch.inference_mode()
    def predict_step_probs(self, prompt_pixels, prompt_masks, prompt_nodata, batch, out_size: int | None = None,
                           feather=None) -> torch.Tensor:
        """Like :meth:`predict_step` but soft class probabilities (B, S, S, C)
        fp32: a softmax over negative palette distances in place of the hard
        argmin. ``out_size`` back-resizes on the device with the cv2-bicubic
        matrices as two fp32 products, clipped at 0; ``feather`` (out, out, 1)
        is multiplied on the device."""
        pred_masks, palette_norm = self.predict_masks(prompt_pixels, prompt_masks, prompt_nodata, batch)
        probs = soft_class_probs(pred_masks, palette_norm)
        if out_size is not None and out_size != probs.shape[1]:
            m = torch.tensor(resize_matrix(probs.shape[1], out_size, "bicubic_cv2"), device=self.device)
            probs = torch.einsum("oh,bhwc->bowc", m, probs)
            probs = torch.einsum("pw,bhwc->bhpc", m, probs)
            probs = torch.clamp(probs, min=0)
        if feather is not None:
            probs = probs * self._tensor(feather).float()[None]
        return probs
