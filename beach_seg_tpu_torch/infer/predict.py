"""Prompt-tuned sliding-window inference (counterpart of
``beach_seg_tpu/infer/predict.py``; ref src/predict.py).

Pipeline: load the train run's conf + tuned prompt pixels (or rebuild untuned
prompts from the reference date), build the predict scene (all non-reference
dates), then fan the (date × crop) tiles through ``PromptTuner.predict_step``
(or ``predict_step_probs`` for ``merge="blend"``) in batches of
``batch_size`` crops. Votes accumulate host-side into per-date mosaics
(overlay/mask/GeoTIFF outputs).

On a mesh of several ranks (``mesh_data``, ``mesh_model``) every rank walks
the same batches; each batch's rows are split over the data ranks
(``ops.sharding.data_sharded_call``, padded where the batch does not divide
them), the model axis splits the backbone, and rank 0 gathers the results
and writes every output, exactly as one device does; the other ranks write
nothing.

Host↔device traffic: the prompts go up once; per batch only the raw uint8
crops and their crop indices go up, from pinned memory without blocking.
Each date's results are concatenated on the device and copied into a pinned
host buffer without blocking, with a CUDA event recorded after the copy; the
drain loop waits on each event before it pastes, so the copies overlap the
next date's work and nothing synchronizes per batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from beach_seg_tpu_torch.config import BeachSegConfig, PredictionConfig, num_workers
from beach_seg_tpu_torch.data.dataset import BeachSegDataset, create_scene, iterate_batches, materialize_prompts
from beach_seg_tpu_torch.data.prefetch import MosaicPrefetcher
from beach_seg_tpu_torch.geo.extent import group_images_by_date
from beach_seg_tpu_torch.geo.mosaic import merge_tifs
from beach_seg_tpu_torch.infer.accumulator import VoteAccumulator
from beach_seg_tpu_torch.models.seggpt.load import load_model_params
from beach_seg_tpu_torch.ops.sharding import data_sharded_call
from beach_seg_tpu_torch.parallel.distributed import process_index, shared_run_dir
from beach_seg_tpu_torch.parallel.mesh import make_mesh, shard_model
from beach_seg_tpu_torch.train.checkpoint import load_prompt_batch
from beach_seg_tpu_torch.train.loop import config_for, model_for_config
from beach_seg_tpu_torch.train.prompt_tuner import PromptTuner
from beach_seg_tpu_torch.utils.confix import merge_yaml_into
from beach_seg_tpu_torch.utils.device import device_for_platform, resolve_device
from beach_seg_tpu_torch.utils.logging import setup_logger
from beach_seg_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


def resolve_config(pred_conf: PredictionConfig) -> BeachSegConfig:
    """Overlay the train run's conf.yaml (ref predict.py:174-187)."""
    conf = BeachSegConfig()
    if pred_conf.train_run_dir is not None:
        conf = merge_yaml_into(conf, Path(pred_conf.train_run_dir) / "conf.yaml")
    updates = {
        "data": pred_conf.data,
        "batch_size": pred_conf.batch_size,
        "debug": pred_conf.debug,
        "workers": pred_conf.workers,
        "mesh_data": pred_conf.mesh_data,
        "mesh_model": pred_conf.mesh_model,
        "compute_dtype": pred_conf.compute_dtype,
        "platform": pred_conf.platform,
    }
    # keep the train run's checkpoint unless explicitly overridden on the CLI
    if pred_conf.checkpoint != BeachSegConfig().checkpoint:
        updates["checkpoint"] = pred_conf.checkpoint
    if pred_conf.model_training_root is not None:
        updates["model_training_root"] = pred_conf.model_training_root
    return dataclasses.replace(conf, **updates)


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array → ``dev``: from pinned memory without blocking on CUDA
    (a non-blocking copy from pageable memory would be synchronous)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def copy_to_host(t: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """Start ``t``'s copy to the host: on CUDA into pinned memory without
    blocking, with an event recorded after it (wait on the event before
    reading the host tensor); elsewhere a plain copy and no event."""
    pinned = t.device.type == "cuda"
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
    host.copy_(t, non_blocking=pinned)
    event = None
    if pinned:
        event = torch.cuda.Event()
        event.record()
    return host, event


def write_timings(run_dir: Path, setup_s: float, stream_s: float, timers: dict, n_tiles: int) -> None:
    """``timings.json``: the phase seconds (``timers``: mosaic, dispatch,
    fetch, paste) and tile rate of a scene run, the JAX engines' keys."""
    (run_dir / "timings.json").write_text(json.dumps({
        "setup_s": round(setup_s, 3),
        "stream_s": round(stream_s, 3),
        "mosaic_wait_s": round(timers["mosaic"], 3),
        "dispatch_s": round(timers["dispatch"], 3),
        "fetch_s": round(timers["fetch"], 3),
        "paste_s": round(timers["paste"], 3),
        "tiles": n_tiles,
        "stream_tiles_per_sec": round(n_tiles / stream_s, 3) if stream_s > 0 else None,
    }))
    logger.info("done: %d tiles in %.2fs streaming", n_tiles, stream_s)


def run_predict(pred_conf: PredictionConfig, device=None) -> Path:
    """Predict every non-reference date of ``pred_conf.data`` → the run dir
    (``images/``, ``masks/``, ``tif/``, ``timings.json``). The device is
    ``device``, else ``pred_conf.platform`` ("" → CUDA, raising without it;
    "cpu" → the CPU)."""
    t_start = time.perf_counter()
    conf = resolve_config(pred_conf)
    mesh = make_mesh(conf.mesh_data, conf.mesh_model)
    dev = resolve_device(device) if device is not None else device_for_platform(conf.platform)
    root = Path(pred_conf.prediction_root or conf.model_training_root)
    writer = process_index() == 0
    predict_dir = shared_run_dir(root, conf.project, "predict")
    if writer:
        setup_logger(predict_dir)
    logger.info("saving results to %s (device %s, mesh %s)", predict_dir, dev, tuple(mesh.shape))

    # one scene for crops/prompts/extent; predict dates stream through the
    # mosaic prefetcher. Reading the reference imagery here builds the native
    # library once, before the merge pool starts.
    train_scene = create_scene(conf, train=True, crop_overlap=pred_conf.overlap)
    use_blend = pred_conf.merge == "blend"
    feather = None
    if use_blend:
        # Hann window, floored so zero-overlap regions still receive votes
        ramp = np.sin(np.pi * (np.arange(conf.crop_size) + 0.5) / conf.crop_size) ** 2
        feather = (np.outer(ramp, ramp) + 1e-3)[..., None].astype(np.float32)

    if pred_conf.train_run_dir is not None:
        name = "prompt_batch_ema.npz" if pred_conf.use_ema else "prompt_batch_tuned.npz"
        pb = load_prompt_batch(Path(pred_conf.train_run_dir) / name)
        logger.info("loaded %s prompts from %s", "EMA" if pred_conf.use_ema else "tuned", pred_conf.train_run_dir)
    else:
        prompts = materialize_prompts(train_scene, conf)
        pb = {"image": prompts["pixels"], "mask": prompts["masks"], "nodata": prompts["nodata"]}
        logger.info("using untuned reference-date prompts")

    # start the first mosaic merges before the model load and upload: the
    # merge is pure host work and overlaps the device setup
    data_dir = Path(conf.data)
    groups = group_images_by_date(list((data_dir / "SatelliteImagery").glob("*/*.tif")))
    groups.pop(train_scene.mask_date, None)
    merger = MosaicPrefetcher(
        sorted(groups.items()),
        functools.partial(  # picklable for the subprocess-merge path
            merge_tifs, out_shape=train_scene.out_shape,
            out_transform=train_scene.out_transform, crs=train_scene.crs,
        ),
    )

    state = load_model_params(conf.checkpoint, config_for(conf), dev)
    model, _ = model_for_config(conf, dev, state=state)
    del state
    shard_model(model, mesh)
    tuner = PromptTuner(model, conf, device=dev)
    pixels = torch.as_tensor(pb["image"], dtype=torch.float32).to(dev)
    pmasks = torch.as_tensor(pb["mask"], dtype=torch.int32).to(dev)
    pnodata = torch.as_tensor(pb["nodata"]).to(dev)
    feather_dev = torch.from_numpy(feather).to(dev) if use_blend else None

    accumulator = VoteAccumulator(
        train_scene.out_shape, predict_dir, train_scene.out_transform,
        train_scene.crs, conf.classes,
        dtype=np.float32 if use_blend else np.int32,
    ) if writer else contextlib.nullcontext()
    with accumulator as acc, torch.inference_mode():

        def paste(batch, result: np.ndarray) -> None:
            """Vote paste of one batch's host-side result (already
            back-resized on the device, so only the crop-resolution result
            crossed). The overlay PNG uses the raw crop, as in the JAX engine."""
            img_small = batch["image_u8"]
            for i in range(len(img_small)):
                if not batch["valid"][i]:
                    continue
                if batch["nodata"][i].all():  # ref predict.py:235
                    continue
                crop = train_scene.crops[int(batch["crop_idx"][i])]
                if use_blend:
                    # the feather was multiplied on the device
                    acc.update(batch["date"][i], crop, result[i], img_crop=img_small[i])
                else:
                    # class ids paste as C boolean compares, no one-hot
                    acc.update_ids(batch["date"][i], crop, result[i].astype(np.int32), img_crop=img_small[i])

        def step(image_u8, crop_idx):
            """The predict step on this data rank's rows of a batch."""
            rows = {"image_u8": image_u8, "crop_idx": crop_idx}
            if use_blend:
                return tuner.predict_step_probs(pixels, pmasks, pnodata, rows, conf.crop_size, feather_dev)
            return tuner.predict_step(pixels, pmasks, pnodata, rows, out_size=conf.crop_size)

        t_setup = time.perf_counter()
        n_tiles = 0
        timers = dict.fromkeys(("mosaic", "dispatch", "fetch", "paste"), 0.0)
        pending: list[tuple[list, torch.Tensor, torch.cuda.Event | None]] = []  # per date
        date_batches: list = []
        date_results: list = []

        def seal_date() -> None:
            """Concatenate the date's results on the device and start their
            copy into pinned host memory; the event marks its end."""
            if not date_results:
                return
            dcat = torch.cat(date_results) if len(date_results) > 1 else date_results[0]
            pending.append((list(date_batches), *copy_to_host(dcat)))
            date_batches.clear()
            date_results.clear()

        dates = iter(merger)
        while True:
            with span("bst.scene.mosaic", into=timers):
                nxt = next(dates, None)
            if nxt is None:
                break
            date, (merged_img, merged_nodata) = nxt
            with span("bst.scene.date"):
                date_scene = dataclasses.replace(
                    train_scene, date_merged_imgs={date: (merged_img, merged_nodata)}, date_masks={}
                )
                dataset = BeachSegDataset(date_scene, conf, raw=True)
                for batch in iterate_batches(dataset, conf.batch_size, workers=num_workers(conf)):
                    if not batch["valid"].any():
                        continue
                    # upload only the raw uint8 crops and their indices
                    dev_batch = {k: upload(batch[k], dev) for k in ("image_u8", "crop_idx")}
                    with span("bst.scene.dispatch", into=timers):
                        result = data_sharded_call(step, (dev_batch["image_u8"], dev_batch["crop_idx"]), (True, True), mesh)
                    n_tiles += int(batch["valid"].sum())
                    if writer:
                        date_batches.append(batch)
                        date_results.append(result)
                seal_date()
        # drain: each date's copy was started when the date was sealed; only
        # the last date's compute tail is exposed here
        for batches, host, event in pending:
            with span("bst.scene.fetch", into=timers):
                if event is not None:
                    event.synchronize()
                res = host.numpy()
            with span("bst.scene.paste", into=timers):
                ofs = 0
                for b in batches:
                    n = len(b["valid"])
                    paste(b, res[ofs : ofs + n])
                    ofs += n
        t_stream = time.perf_counter()

    if writer:
        write_timings(predict_dir, t_setup - t_start, t_stream - t_setup, timers, n_tiles)
    return predict_dir
