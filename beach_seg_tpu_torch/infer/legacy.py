"""Legacy ensemble inference mode (counterpart of
``beach_seg_tpu/infer/legacy.py``; ref src/old/beach_seg.py).

The reference's original pipeline, kept as an inference mode of its own (the
reference's script is stale — wrong call signature and a stray ``break`` —
so this implements its intended behavior):

  - 50 %-overlap shoreline crops (``overlap = crop_size // 2``,
    ref old/beach_seg.py:152);
  - every query runs against the full prompt set of M prompts with
    ``embedding_type="semantic"`` and ``feature_ensemble=True``, duplicated
    queries, first painted canvas taken (ref :53-70);
  - predictions are buffer-trimmed (default ``buffer = crop_size // 8``) and
    merged with ascending max instead of voting (ref :79-83);
  - outputs per class: 1-bit GeoTIFF + shoreline shapefile
    (``WetDryLine`` = water, ``VegLine`` = veg, ref :199-222).

Q queries run as one model batch of Q·M rows, group-major, the prompts'
uint8 stacks on the device; the uint8 ids of a date are copied to pinned
host memory without blocking and pasted after the next date's batches are
queued, as in ``infer/zero_shot.py``.
"""

from __future__ import annotations

import functools
import logging
import time
from pathlib import Path

import numpy as np
import torch

from beach_seg_tpu_torch.config import LegacyConfig
from beach_seg_tpu_torch.data.dataset import create_scene
from beach_seg_tpu_torch.data.prefetch import MosaicPrefetcher
from beach_seg_tpu_torch.geo.contours import extract_linestring
from beach_seg_tpu_torch.geo.extent import group_images_by_date
from beach_seg_tpu_torch.geo.masks import crop_tif, safe_assign_crop
from beach_seg_tpu_torch.geo.mosaic import merge_tifs
from beach_seg_tpu_torch.geo.shapefile import save_shapefile
from beach_seg_tpu_torch.geo.tiff import write as write_tiff
from beach_seg_tpu_torch.infer.accumulator import transform_line
from beach_seg_tpu_torch.infer.predict import copy_to_host, upload, write_timings
from beach_seg_tpu_torch.infer.processor import (
    normalize_device,
    post_process_semantic_device,
    preprocess_image_u8,
    preprocess_mask_u8,
)
from beach_seg_tpu_torch.infer.zero_shot import INPT, zero_shot_model
from beach_seg_tpu_torch.models.seggpt.model import SegGPT
from beach_seg_tpu_torch.train.checkpoint import load_prompt_batch
from beach_seg_tpu_torch.ops.sharding import data_sharded_call
from beach_seg_tpu_torch.parallel.distributed import process_index, shared_run_dir
from beach_seg_tpu_torch.parallel.mesh import make_mesh, shard_model
from beach_seg_tpu_torch.utils.device import device_for_platform, resolve_device
from beach_seg_tpu_torch.utils.logging import setup_logger
from beach_seg_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

CLASS_EXPORT_NAMES = {"water": "WetDryLine", "veg": "VegLine"}


@torch.inference_mode()
def legacy_batch(model: SegGPT, queries_u8: torch.Tensor, prompt_pixels_u8: torch.Tensor,
                 prompt_masks_u8: torch.Tensor, crop_size: int, num_classes: int) -> torch.Tensor:
    """Q queries each against all M prompts in one model batch of Q·M rows
    (group-major), the semantic embedding and the grouped feature ensemble;
    each query's first painted canvas decoded (ref :68) → (Q, crop_size,
    crop_size) uint8 ids."""
    nq, m = queries_u8.shape[0], prompt_pixels_u8.shape[0]
    pp = normalize_device(prompt_pixels_u8).repeat(nq, 1, 1, 1)
    pm = normalize_device(prompt_masks_u8).repeat(nq, 1, 1, 1)
    queries = normalize_device(queries_u8).repeat_interleave(m, dim=0)
    out = model(queries, pp, pm, embedding_type="semantic", feature_ensemble=True,
                decode_query_only=True, ensemble_groups=nq)
    pred = out["pred_masks"]
    canvases = pred.reshape(nq, m, *pred.shape[1:])[:, 0]
    return post_process_semantic_device(canvases, (crop_size, crop_size), num_classes - 1)


def legacy_prompts(conf: LegacyConfig, scene) -> tuple[np.ndarray, np.ndarray]:
    """(M, 448, 448, 3) uint8 prompt pixels and palette-colored masks: a
    tuned export when ``conf.prompt_ckpt`` is set (a train-run directory
    prefers the EMA export, as the reference's legacy trainer saves
    EMA-smoothed prompt pixels, src/old/train.py:168,255-258), else the first
    ``n_prompts`` crops of the reference date."""
    num_classes = len(conf.classes)
    if conf.prompt_ckpt is not None:
        ckpt = Path(conf.prompt_ckpt)
        if ckpt.is_dir():
            ema = ckpt / "prompt_batch_ema.npz"
            ckpt = ema if ema.exists() else ckpt / "prompt_batch_tuned.npz"
        pb = load_prompt_batch(ckpt)
        prompt_pixels = np.asarray((np.clip(pb["image"], 0, 1) * 255).astype(np.uint8), np.uint8)
        n = min(conf.n_prompts, len(prompt_pixels))
        p_pixels = np.stack([preprocess_image_u8(p, INPT) for p in prompt_pixels[:n]])
        p_masks = np.stack([preprocess_mask_u8(m, num_classes - 1, INPT) for m in pb["mask"][:n]])
        return p_pixels, p_masks
    img, nodata = scene.date_merged_imgs[scene.mask_date]
    label = scene.date_masks[scene.mask_date]
    p_pixels, p_masks = [], []
    for crop in scene.crops[: conf.n_prompts]:
        ci, _, cl = crop_tif(crop, img, nodata, label, conf.crop_size)
        p_pixels.append(preprocess_image_u8(ci, INPT))
        p_masks.append(preprocess_mask_u8(cl, num_classes - 1, INPT))
    return np.stack(p_pixels), np.stack(p_masks)


def run_legacy(conf: LegacyConfig, device=None) -> Path:
    """Legacy-predict every non-reference date of ``conf.data`` → the run
    dir (``<WetDryLine|VegLine>_<date>.tif`` and ``.shp``, ``timings.json``).
    The device is ``device``, else ``conf.platform`` ("" → CUDA, raising
    without it; "cpu" → the CPU)."""
    t_start = time.perf_counter()
    mesh = make_mesh(conf.mesh_data, conf.mesh_model)
    dev = resolve_device(device) if device is not None else device_for_platform(conf.platform)
    root = Path(conf.prediction_root or conf.model_training_root)
    writer = process_index() == 0
    out_dir = shared_run_dir(root, conf.project, "legacy")
    if writer:
        setup_logger(out_dir)
    logger.info("saving results to %s (device %s, mesh %s)", out_dir, dev, tuple(mesh.shape))

    buffer_px = int(conf.crop_size * conf.buffer_factor)
    scene = create_scene(conf, train=True, crop_overlap=conf.crop_size // 2)
    num_classes = len(conf.classes)
    p_pixels, p_masks = legacy_prompts(conf, scene)

    groups = group_images_by_date(list((Path(conf.data) / "SatelliteImagery").glob("*/*.tif")))
    groups.pop(scene.mask_date, None)
    to_run = sorted(groups.items())
    if conf.debug:
        to_run = to_run[:1]
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
    pp_dev, pm_dev = upload(p_pixels, dev), upload(p_masks, dev)
    timers = dict.fromkeys(("mosaic", "dispatch", "fetch", "paste"), 0.0)  # kept by the spans
    n_tiles = 0

    def drain(sealed) -> None:
        """Wait for a sealed date's ids, merge them into the date's mosaic
        and write its per-class outputs; called after the next date's
        batches are queued."""
        date, merged_nodata, metas, host, event = sealed
        with span("bst.scene.fetch", into=timers):
            if event is not None:
                event.synchronize()
            preds = host.numpy()
        with span("bst.scene.paste", into=timers):
            output = np.zeros(scene.out_shape, np.uint8)
            for (crop, cn), pred in zip(metas, preds):
                pred = pred.copy()
                pred[cn.astype(bool)] = 0
                inner = pred[buffer_px:-buffer_px, buffer_px:-buffer_px]
                xmin, ymin, xmax, ymax = crop
                safe_assign_crop(
                    output, inner, ymin + buffer_px, ymax - buffer_px,
                    xmin + buffer_px, xmax - buffer_px, logic="ascending",
                )
        # per-class 1-bit GeoTIFF + shoreline shapefile (ref :199-222)
        for idx, cls in enumerate(conf.classes):
            name = CLASS_EXPORT_NAMES.get(cls)
            if name is None:
                continue
            cls_mask = (output == idx).astype(np.uint8)
            write_tiff(out_dir / f"{name}_{date}.tif", cls_mask, scene.out_transform, scene.crs, compress="lzw")
            line = extract_linestring(cls_mask.astype(bool), merged_nodata)
            if line is not None:
                save_shapefile(transform_line(line, scene.out_transform), out_dir / f"{name}_{date}.shp", scene.crs)
        logger.info("date %s done", date)

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

            with span("bst.scene.date"):
                queries, metas = [], []
                for crop in scene.crops:
                    ci, cn, _ = crop_tif(crop, merged_img, merged_nodata, None, conf.crop_size)
                    if np.all(cn):
                        continue
                    queries.append(preprocess_image_u8(ci, INPT))
                    metas.append((crop, cn))
                if not queries:
                    continue
                b = max(1, conf.batch_size)
                n_tiles += len(queries)
                results = []
                for start in range(0, len(queries), b):
                    chunk = queries[start : start + b]
                    batch_q = np.stack(chunk + [chunk[-1]] * (b - len(chunk)))  # one shape for every batch
                    with span("bst.scene.dispatch", into=timers):
                        ids = data_sharded_call(
                            lambda q: legacy_batch(model, q, pp_dev, pm_dev, conf.crop_size, num_classes),
                            (upload(batch_q, dev),), (True,), mesh,
                        )
                        results.append(ids[: len(chunk)])
                if not writer:
                    continue
                dcat = torch.cat(results) if len(results) > 1 else results[0]
                sealed = (date, merged_nodata, metas, *copy_to_host(dcat))
            # this date's work is queued — now merge and write the previous date
            if sealed_prev is not None:
                drain(sealed_prev)
            sealed_prev = sealed
        if sealed_prev is not None:
            drain(sealed_prev)
        t_stream = time.perf_counter()

    if writer:
        write_timings(out_dir, t_setup - t_start, t_stream - t_setup, timers, n_tiles)
    return out_dir
