"""Prompt-tuned inference (counterpart of ``beach_seg_tpu/train/prompt_tuner.py``).

The prompt crops live in one (P, S, S, 3) array in [0, 1]; each tile takes
its prompt by index. ``predict_step`` is the inference forward: raw uint8
crops (or eval-augmented float crops) → SegGPT on the prompt‖query canvas →
palette-distance decode → optional cv2-nearest back-resize to uint8 ids.
``predict_step_probs``, ``train_step`` and ``eval_step`` come with later
slices.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt.model import SegGPT
from beach_seg_tpu_torch.ops.resize import resize_matrix, resize_pil_uint8_device
from beach_seg_tpu_torch.transforms import (
    apply_palette,
    build_palette,
    decode_by_palette,
    eval_augment,
    normalize_imagenet,
    normalize_palette,
)
from beach_seg_tpu_torch.utils.device import resolve_device


class PromptTuner:
    """Runs the prompt-tuned predict step of ``model`` on ``device``
    (None → CUDA, raising if absent). Inputs may be numpy arrays or tensors
    on any device; they are moved to ``device``."""

    def __init__(self, model: SegGPT, conf: BeachSegConfig, device=None):
        self.device = resolve_device(device)
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"model is on {param.device}, the tuner on {self.device}")
        self.model, self.conf = model, conf

    @property
    def num_classes(self) -> int:
        return len(self.conf.classes)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

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
