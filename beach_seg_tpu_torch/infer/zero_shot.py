"""Zero-shot ensemble inference (counterpart of
``beach_seg_tpu/infer/zero_shot.py``; ref src/predict_no_prompt.py).

The pretrained SegGPT is used with NO tuning: every shoreline crop of the
reference date becomes a prompt candidate; crops are ranked by labeled-class
coverage; each query crop runs against an ensemble of ``n_prompts`` prompts
with ``feature_ensemble=True`` and the painted outputs are averaged before the
HF-parity post-process.

Batching: Q queries by P prompts run as one flat group-major model batch of
Q·P rows, the per-query prompt ensemble averaged inside the model
(``ensemble_groups=Q``). The prompts' uint8 stacks live on the device and
are gathered there by a (Q, P) index; normalization and the palette decode
run on the device too, so only uint8 crosses in either direction. Each
date's ids are concatenated on the device and copied into pinned host memory
without blocking (``predict.copy_to_host``); the date is pasted after the
next date's batches are queued (one-date double buffer), so nothing
synchronizes per batch.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from beach_seg_tpu_torch.config import PredConfig
from beach_seg_tpu_torch.data.dataset import create_scene
from beach_seg_tpu_torch.data.prefetch import MosaicPrefetcher
from beach_seg_tpu_torch.geo.display import overlay_prediction
from beach_seg_tpu_torch.geo.extent import group_images_by_date
from beach_seg_tpu_torch.geo.masks import crop_tif
from beach_seg_tpu_torch.geo.mosaic import merge_tifs
from beach_seg_tpu_torch.infer.accumulator import VoteAccumulator
from beach_seg_tpu_torch.infer.predict import copy_to_host, upload, write_timings
from beach_seg_tpu_torch.infer.processor import (
    normalize_device,
    post_process_semantic_device,
    preprocess_image_u8,
    preprocess_mask_u8,
)
from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig
from beach_seg_tpu_torch.models.seggpt.convert import load_config
from beach_seg_tpu_torch.models.seggpt.load import load_model_params
from beach_seg_tpu_torch.models.seggpt.model import SegGPT, build_model
from beach_seg_tpu_torch.ops.sharding import data_sharded_call
from beach_seg_tpu_torch.parallel.distributed import process_index, shared_run_dir
from beach_seg_tpu_torch.parallel.mesh import make_mesh, shard_model
from beach_seg_tpu_torch.utils.device import device_for_platform, resolve_device
from beach_seg_tpu_torch.utils.logging import setup_logger
from beach_seg_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

INPT = 448  # the HF processor always resizes to the pretrain canvas


def rank_prompt_crops(crop_labels: list[np.ndarray], rank_compat: bool) -> np.ndarray:
    """Order prompt candidates "best" first.

    ``rank_compat=False``: rank by labeled class-1 ("sand") coverage — fewest
    non-sand pixels first — the evident INTENT of the reference's sort key.
    ``rank_compat=True``: reproduce the reference's actual behavior
    (predict_no_prompt.py:250): ``(cl != conf.classes[1]).sum()`` compares a
    uint8 array to the string "sand", which numpy collapses to one scalar, so
    every key ties and the stable argsort returns the original crop order.
    Required to match the reference's output masks bit-for-bit.
    """
    if rank_compat:
        return np.arange(len(crop_labels))
    return np.argsort([(cl != 1).sum() for cl in crop_labels])


def zero_shot_config(conf) -> SegGPTConfig:
    """The zero-shot topology: a ``.npz`` checkpoint's stored topology wins;
    else the debug miniature or ViT-L, on the (2·448, 448) canvas."""
    ckpt = Path(str(conf.checkpoint))
    if ckpt.suffix == ".npz" and ckpt.exists():
        stored = load_config(ckpt)
        if stored is not None:
            return stored
    if conf.debug:
        return SegGPTConfig(
            hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
            image_size=(2 * INPT, INPT), pretrain_image_size=224,
            decoder_hidden_size=16, merge_index=1, intermediate_hidden_state_indices=(1, 3),
        )
    return SegGPTConfig(image_size=(2 * INPT, INPT))


def zero_shot_model(conf, device=None) -> tuple[SegGPT, SegGPTConfig]:
    """The zero-shot SegGPT with ``conf.checkpoint``'s weights on ``device``
    (None → CUDA, raising without it), in ``conf.compute_dtype``."""
    cfg = zero_shot_config(conf)
    dev = resolve_device(device)
    dtype = torch.bfloat16 if conf.compute_dtype == "bfloat16" else torch.float32
    return build_model(cfg, dtype, device=dev, state=load_model_params(conf.checkpoint, cfg, dev)), cfg


@torch.inference_mode()
def zero_shot_batch(model: SegGPT, queries_u8: torch.Tensor, prompt_pixels_u8: torch.Tensor,
                    prompt_masks_u8: torch.Tensor, sel: torch.Tensor, crop_size: int, num_classes: int) -> torch.Tensor:
    """Q query ensembles in one model batch of Q·P rows: ``queries_u8``
    (Q, s, s, 3) uint8, the prompt stacks (K, s, s, 3) uint8 gathered by
    ``sel`` (Q, P) into group-major rows; the P painted canvases of each
    query averaged, then decoded → (Q, crop_size, crop_size) uint8 ids."""
    nq, np_ = sel.shape
    flat = sel.reshape(-1).to(torch.int64)
    queries = normalize_device(queries_u8).repeat_interleave(np_, dim=0)
    p_pixels = normalize_device(prompt_pixels_u8.index_select(0, flat))
    p_masks = normalize_device(prompt_masks_u8.index_select(0, flat))
    out = model(queries, p_pixels, p_masks, embedding_type="instance", feature_ensemble=True,
                decode_query_only=True, ensemble_groups=nq)
    pred = out["pred_masks"]
    canvases = pred.reshape(nq, np_, *pred.shape[1:]).mean(dim=1)
    return post_process_semantic_device(canvases, (crop_size, crop_size), num_classes - 1)


def run_zero_shot(conf: PredConfig, device=None) -> Path:
    """Zero-shot predict every non-reference date of ``conf.data`` → the run
    dir (``prompt_w_label.png``, ``prompt.png``, ``images/``, ``masks/``,
    ``tif/``, ``lines/``, ``timings.json``). The device is ``device``, else
    ``conf.platform`` ("" → CUDA, raising without it; "cpu" → the CPU)."""
    t_start = time.perf_counter()
    mesh = make_mesh(conf.mesh_data, conf.mesh_model)
    dev = resolve_device(device) if device is not None else device_for_platform(conf.platform)
    root = Path(conf.prediction_root or conf.model_training_root)
    writer = process_index() == 0
    predict_dir = shared_run_dir(root, conf.project, "predict_no_prompt")
    if writer:
        setup_logger(predict_dir)
    logger.info("saving results to %s (device %s, mesh %s)", predict_dir, dev, tuple(mesh.shape))

    crop_size = conf.zero_shot_crop_size
    scene_conf = dataclasses.replace(conf, crop_size=crop_size)
    scene = create_scene(scene_conf, train=True)  # reference date only
    prompt_img, prompt_nodata = scene.date_merged_imgs[scene.mask_date]
    prompt_img = prompt_img.copy()
    prompt_img[prompt_nodata, 1] = 255  # green-flood nodata (ref :94-95)
    prompt_label = scene.date_masks[scene.mask_date]
    crops = scene.crops
    num_classes = len(conf.classes)
    assert len(crops) >= conf.n_prompts, (
        f"n_prompts({conf.n_prompts}) must be <= number of crops({len(crops)})"
    )

    # prompt viz (ref :218-222)
    if writer:
        overlay_prediction(prompt_img, prompt_label, conf.classes).save(predict_dir / "prompt_w_label.png")
        Image.fromarray(prompt_img).save(predict_dir / "prompt.png")

    # every prompt candidate resized once on the host (PIL-exact), staged as
    # uint8; rescale + normalize run on the device
    prompt_pixels, prompt_masks_rgb, crop_labels = [], [], []
    for crop in crops:
        ci, _, cl = crop_tif(crop, prompt_img, prompt_nodata, prompt_label, crop_size)
        prompt_pixels.append(preprocess_image_u8(ci, INPT))
        prompt_masks_rgb.append(preprocess_mask_u8(cl, num_classes - 1, INPT))
        crop_labels.append(cl)
    # NOTE (quirk): rank_compat=True reproduces the reference's sort key,
    # which compares a uint8 array to the string "sand" and so keeps the crop
    # order (predict_no_prompt.py:250); False ranks by class-1 coverage
    best_crop_idxes = rank_prompt_crops(crop_labels, conf.rank_compat)

    to_run = sorted(group_images_by_date(
        list((Path(conf.data) / "SatelliteImagery").glob("*/*.tif"))
    ).items())
    to_run = [(d, p) for d, p in to_run if d != scene.mask_date]
    if conf.debug:
        to_run = to_run[:2]
    # the first merges start before the model load: pure host work
    merger = MosaicPrefetcher(
        to_run,
        functools.partial(  # picklable for the subprocess-merge path
            merge_tifs, out_shape=scene.out_shape,
            out_transform=scene.out_transform, crs=scene.crs,
        ),
    )

    model, _ = zero_shot_model(conf, dev)
    shard_model(model, mesh)
    pp = upload(np.stack(prompt_pixels), dev)
    pm = upload(np.stack(prompt_masks_rgb), dev)
    q_batch = max(1, conf.batch_size)
    best = best_crop_idxes[: conf.n_prompts]
    # phase timers (same schema as infer/predict.py timings.json), kept by the spans
    timers = dict.fromkeys(("mosaic", "dispatch", "fetch", "paste"), 0.0)
    n_tiles = 0

    def drain(sealed) -> None:
        """Wait for a sealed date's ids and paste/export its outputs; called
        after the next date's batches are queued."""
        date, merged_img, merged_nodata, done, host, event = sealed
        with span("bst.scene.fetch", into=timers):
            if event is not None:
                event.synchronize()
            preds = host.numpy().astype(np.int32)
        # the accumulator writes the date's outputs as it closes: part of the paste
        with span("bst.scene.paste", into=timers), VoteAccumulator(
            scene.out_shape, predict_dir, scene.out_transform, scene.crs,
            conf.classes, export_lines=True,
        ) as acc:
            for crop_idx, pred in zip(done, preds):
                _, crop_nodata, _ = crop_tif(crops[crop_idx], merged_img, merged_nodata, None, crop_size)
                pred = pred.copy()
                pred[crop_nodata.astype(bool)] = 0  # ref :303
                acc.update_ids(date, crops[crop_idx], pred, date_img=merged_img, date_nodata=merged_nodata)

    with torch.inference_mode():
        t_setup = time.perf_counter()
        sealed_prev = None
        merger_it = iter(merger)
        while True:
            with span("bst.scene.mosaic", into=timers):
                nxt = next(merger_it, None)
            if nxt is None:
                break
            date, (merged_img, merged_nodata) = nxt
            merged_img = merged_img.copy()
            merged_img[merged_nodata, 1] = 255
            pending: list[tuple[int, np.ndarray, np.ndarray]] = []
            done: list[int] = []  # crop indices in dispatch order
            results: list[torch.Tensor] = []  # device uint8 id batches

            def dispatch() -> None:
                """Queue one padded ensemble batch on the device; no host sync."""
                nonlocal n_tiles
                if not pending:
                    return
                n = len(pending)
                n_tiles += n
                queries = np.stack([p[1] for p in pending])
                sel = np.stack([p[2] for p in pending])  # (n, P)
                if n < q_batch:  # pad to the batch size: one shape for every batch
                    queries = np.concatenate([queries, np.repeat(queries[-1:], q_batch - n, 0)])
                    sel = np.concatenate([sel, np.repeat(sel[-1:], q_batch - n, 0)])
                # whole query ensembles split over the data ranks
                ids = data_sharded_call(
                    lambda q, s: zero_shot_batch(model, q, pp, pm, s, crop_size, num_classes),
                    (upload(queries, dev), upload(sel, dev)), (True, True), mesh,
                )
                results.append(ids[:n])
                done.extend(p[0] for p in pending)
                pending.clear()

            with span("bst.scene.date"):
                for crop_idx, crop in enumerate(crops):
                    crop_img, crop_nodata, _ = crop_tif(crop, merged_img, merged_nodata, None, crop_size)
                    if np.all(crop_nodata):
                        continue
                    if crop_idx in best:
                        crop_idxes = best.tolist()
                    else:
                        crop_idxes = [crop_idx] + best[: conf.n_prompts - 1].tolist()
                    pending.append((crop_idx, preprocess_image_u8(crop_img, INPT), np.asarray(crop_idxes, np.int64)))
                    if len(pending) == q_batch:
                        with span("bst.scene.dispatch", into=timers):
                            dispatch()
                with span("bst.scene.dispatch", into=timers):
                    dispatch()
                sealed = None
                if results and writer:
                    dcat = torch.cat(results) if len(results) > 1 else results[0]
                    sealed = (date, merged_img, merged_nodata, done, *copy_to_host(dcat))
            # this date's work is queued — now paste the previous date
            if sealed_prev is not None:
                drain(sealed_prev)
            sealed_prev = sealed
        if sealed_prev is not None:
            drain(sealed_prev)
        t_stream = time.perf_counter()

    if writer:
        write_timings(predict_dir, t_setup - t_start, t_stream - t_setup, timers, n_tiles)
    return predict_dir
