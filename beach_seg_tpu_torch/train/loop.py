"""The training runtime (counterpart of ``beach_seg_tpu/train/loop.py``; the
reference's ``trainer.fit``, ref src/train.py:27-132).

- :func:`config_for` / :func:`model_for_config`: which SegGPT a
  ``BeachSegConfig`` runs.
- :func:`run_training`: run-dir allocation, config/classes snapshots, scene
  setup, prompt materialization, the epoch loop over
  ``PromptTuner.train_step``, per-epoch validation (val dataset == train
  dataset, the reference's setup at data.py:245-251), TB/CSV logging, image
  grids, a state checkpoint each epoch (the port's own format,
  ``train.checkpoint``), best-prompt tracking, and prompt-batch exports
  before and after training (ref train.py:76-77,121-122), under the JAX run
  dir's file names, so either package's engines read a port run.

It runs on the CUDA device unless the caller passes ``device="cpu"`` (or the
config ``platform="cpu"``), on the (``mesh_data``, ``mesh_model``) mesh over
the process group's ranks (``parallel``): each data rank iterates its rows
of every global batch, the model axis splits the backbone, every rank holds
the same state, and rank 0 alone writes the run dir's files (the other
ranks log to ``log.rank<r>.log``).

Known intentional divergence (SURVEY.md quirk #1): the reference multiplies
``max_epochs`` by ``len(prompt_batch)``, the number of DICT KEYS (5), an
accident of ``len()`` on a dict. We train the configured ``epochs``
(``epochs_compat=true`` trains five times as many).
"""

from __future__ import annotations

import json
import logging
import math
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import torch

from beach_seg_tpu_torch.config import BeachSegConfig, num_workers
from beach_seg_tpu_torch.data.dataset import BeachSegDataset, create_scene, iterate_batches, materialize_prompts
from beach_seg_tpu_torch.data.prefetch import prefetch_iterator
from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig, eva02_config, huge_config, painter_config
from beach_seg_tpu_torch.models.seggpt.convert import load_config
from beach_seg_tpu_torch.models.seggpt.load import load_model_params
from beach_seg_tpu_torch.models.seggpt.model import SegGPT, build_model
from beach_seg_tpu_torch.ops.sharding import DATA_AXIS, axis_size
from beach_seg_tpu_torch.parallel.distributed import host_batch_slice, process_index, shared_run_dir
from beach_seg_tpu_torch.parallel.mesh import make_mesh, put_batch, shard_model
from beach_seg_tpu_torch.train.checkpoint import latest_checkpoint, restore_state, save_prompt_batch, save_state
from beach_seg_tpu_torch.train.loggers import MetricsLogger, example_grid
from beach_seg_tpu_torch.train.metrics import f1_from_confusion
from beach_seg_tpu_torch.train.prompt_tuner import PromptTuner, lr_schedule
from beach_seg_tpu_torch.utils.confix import save_yaml
from beach_seg_tpu_torch.utils.device import device_for_platform, resolve_device
from beach_seg_tpu_torch.utils.logging import setup_logger
from beach_seg_tpu_torch.utils.profiling import StepTimer, maybe_trace

logger = logging.getLogger(__name__)


def config_for(conf: BeachSegConfig) -> SegGPTConfig:
    """The topology ``conf`` selects: a ``.npz`` checkpoint that stores its
    own topology wins (it describes the weights), else the ``debug``
    miniature, else ``conf.backbone``: ``"huge"`` (ViT-H: C=1280, 32 layers,
    16 heads of 80), ``"painter"`` (Painter ViT-L: 14×14 windows outside 8
    global blocks, at every input size; a port-only backbone), ``"eva02"``
    (EVA-02-L/14's block: SwiGLU with sub-LN, 2D RoPE, q/v-only bias, patch
    14; port-only), and ViT-L
    for ``"large"`` or any other name, as in the JAX package — on a
    (2·inpt_size, inpt_size) canvas."""
    ckpt = Path(str(conf.checkpoint))
    if ckpt.suffix == ".npz" and ckpt.exists():
        stored = load_config(ckpt)
        if stored is not None:
            return stored
    image_size = (2 * conf.inpt_size, conf.inpt_size)
    if conf.debug:
        # miniature topology for smoke runs, same control flow
        return SegGPTConfig(
            hidden_size=64,
            num_hidden_layers=4,
            num_attention_heads=4,
            image_size=image_size,
            pretrain_image_size=64,
            decoder_hidden_size=16,
            merge_index=1,
            intermediate_hidden_state_indices=(1, 3),
        )
    if conf.backbone == "huge":
        return huge_config(image_size=image_size)
    if conf.backbone == "painter":
        return painter_config(image_size=image_size)
    if conf.backbone == "eva02":
        return eva02_config(image_size=image_size)
    return SegGPTConfig(image_size=image_size)


def model_for_config(conf: BeachSegConfig, device=None, state: dict | None = None, seed: int = 0) -> tuple[SegGPT, SegGPTConfig]:
    """The SegGPT of :func:`config_for` (``build_model``: on CUDA unless
    ``device`` says otherwise, ``state`` or seeded random weights, bf16 when
    ``conf.compute_dtype`` is ``"bfloat16"``, each encoder block recomputed
    in the backward when ``conf.remat``) and its config."""
    dtype = torch.bfloat16 if conf.compute_dtype == "bfloat16" else torch.float32
    cfg = config_for(conf)
    return build_model(cfg, dtype, device=device, state=state, seed=seed, remat=conf.remat), cfg


class PromptExports:
    """A run's prompt npz exports, written on background threads beside the
    steps: each is a zlib-compressed npz of all P prompts, seconds of host
    work at 448² (the JAX package writes them in line). :meth:`save` takes a
    host copy of the pixels at once; a later save of the same file waits
    for the earlier one, and ``after`` runs once the file is written. On
    leaving the ``with`` block every write has finished; the first write
    that failed raises there, unless the block itself raised."""

    def __init__(self, run_dir: Path, prompts: dict, dates: list[str], workers: int = 2):
        self.run_dir, self.prompts, self.dates = run_dir, prompts, dates
        self.pool = ThreadPoolExecutor(workers, thread_name_prefix="prompt-export")
        self.writes: dict[str, Future] = {}

    def save(self, name: str, pixels, after=None) -> None:
        host = pixels.detach().cpu().numpy() if isinstance(pixels, torch.Tensor) else pixels
        previous = self.writes.get(name)
        p = self.prompts

        def write() -> None:
            if previous is not None:
                previous.result()
            save_prompt_batch(self.run_dir / name, host, p["masks"], p["nodata"], p["crop_idx"], self.dates)
            if after is not None:
                after()

        self.writes[name] = self.pool.submit(write)

    def __enter__(self) -> "PromptExports":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.pool.shutdown(wait=True)
        if exc_type is None:
            for f in self.writes.values():
                f.result()


def run_training(conf: BeachSegConfig, scene=None, device=None) -> Path:
    """Tune the prompt pixels of ``conf``'s scene (``scene``: a prebuilt
    ``create_scene(conf, train=True)``) → the run dir. The device is
    ``device``, else ``conf.platform`` ("" → CUDA, raising without it;
    "cpu" → the CPU)."""
    mesh = make_mesh(conf.mesh_data, conf.mesh_model)
    data_size = axis_size(mesh, DATA_AXIS)
    if conf.batch_size % data_size:
        raise ValueError(f"batch_size={conf.batch_size} must divide data axis ({data_size})")
    dev = resolve_device(device) if device is not None else device_for_platform(conf.platform)
    if conf.precision != "32-true":
        logger.warning(
            "precision=%r is a Lightning-compat no-op here; set compute_dtype "
            "(currently %r) to choose the model's matmul dtype on the card", conf.precision, conf.compute_dtype,
        )
    if conf.deterministic:
        logger.warning(
            "deterministic=true is a no-op: the port does not switch PyTorch to its "
            "deterministic algorithms; the draws follow the seed either way"
        )
    rank = process_index()
    writer = rank == 0
    run_dir = shared_run_dir(Path(conf.model_training_root), conf.project, "train")
    setup_logger(run_dir, rank=rank)
    logger.info("run dir: %s (device %s, mesh %s)", run_dir, dev, tuple(mesh.shape))
    if writer:
        save_yaml(conf, run_dir / "conf.yaml")
        (run_dir / "classes.txt").write_text("\n".join(conf.classes))

    if scene is None:
        scene = create_scene(conf, train=True)
    prompts = materialize_prompts(scene, conf)
    dataset = BeachSegDataset(scene, conf)
    num_prompts = len(scene.crops)
    logger.info("%d crops / %d train items", num_prompts, len(dataset))

    model, _ = model_for_config(conf, dev, load_model_params(conf.checkpoint, config_for(conf), dev))
    shard_model(model, mesh)
    steps_per_epoch = max(1, math.ceil(len(dataset) / conf.batch_size))
    tuner = PromptTuner(model, conf, device=dev, steps_per_epoch=steps_per_epoch)
    sched = lr_schedule(conf, steps_per_epoch)

    pmasks = torch.as_tensor(prompts["masks"], dtype=torch.int32).to(dev)
    pnodata = torch.as_tensor(prompts["nodata"]).to(dev)
    state = tuner.init_state(prompts["pixels"])
    start_epoch = 0
    if conf.resume_from is not None:
        ckpt = latest_checkpoint(Path(conf.resume_from))
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint under {conf.resume_from}")
        state = restore_state(ckpt, state)
        start_epoch = state.step // steps_per_epoch
        logger.info("resumed from %s (step %d, epoch %d)", ckpt, state.step, start_epoch)

    # each data rank builds only its rows of every global batch (the shared
    # seed gives every rank the same order)
    row_slice = host_batch_slice(conf.batch_size, mesh) if data_size > 1 else None
    with PromptExports(run_dir, prompts, [scene.mask_date] * num_prompts) as exports:
        if writer:
            exports.save("prompt_batch.npz", prompts["pixels"])
        mlog = MetricsLogger(run_dir) if writer else None
        logger.info("loggers: %s", mlog.kind if writer else f"none on rank {rank}")
        # the counterpart of PRNGKey(conf.seed): restarts from the seed on resume
        gen = torch.Generator(dev).manual_seed(conf.seed)

        def put(batch: dict) -> dict:
            # "valid" rides along so the steps can zero padded rows
            return put_batch(mesh, {k: v for k, v in batch.items() if k != "date"}, dev)

        n_classes = len(conf.classes)
        timer = StepTimer()
        global_step = start_epoch * steps_per_epoch
        best_metric = None
        # epochs_compat: the reference's Trainer trains epochs × 5 (len() of
        # the prompt_batch DICT, src/train.py:98) while the cosine period
        # stays conf.epochs — lr_schedule already uses conf.epochs.
        total_epochs = conf.epochs * 5 if conf.epochs_compat else conf.epochs
        for epoch in range(start_epoch, total_epochs):
            # the confusion matrices and the val loss accumulate on the device
            # and are fetched once an epoch, not once a step
            train_cm_dev = torch.zeros((n_classes, n_classes), dtype=torch.int32, device=dev)
            with maybe_trace(conf.profile and epoch == 0 and writer, run_dir):
                batches = prefetch_iterator(
                    iterate_batches(dataset, conf.batch_size, shuffle=True, seed=conf.seed + epoch,
                                    workers=num_workers(conf), row_slice=row_slice)
                )
                for batch in batches:
                    state, metrics = tuner.train_step(state, pmasks, pnodata, put(batch), generator=gen)
                    train_cm_dev += metrics["confusion"]
                    timer.tick()
                    if writer and global_step % conf.log_every_n_steps == 0:
                        scalars = {"train/loss": float(metrics["loss"]), "lr": sched(global_step)}
                        if timer.steps_per_sec:
                            scalars["perf/steps_per_sec"] = timer.steps_per_sec
                        mlog.log_scalars(scalars, global_step)
                    global_step += 1
            if writer:
                mlog.log_scalars({"train/f1": float(f1_from_confusion(train_cm_dev.cpu()))}, global_step)

            # validation — same dataset as train (reference quirk #2)
            val_cm_dev = torch.zeros_like(train_cm_dev)
            val_loss_dev = torch.zeros((), dtype=torch.float32, device=dev)
            n_val = 0
            viz_src = None
            for batch in iterate_batches(dataset, conf.batch_size, workers=num_workers(conf), row_slice=row_slice):
                out = tuner.eval_step(state.prompt_pixels, pmasks, pnodata, put(batch), generator=gen)
                val_cm_dev += out["confusion"]
                val_loss_dev += out["loss"]
                n_val += 1
                if viz_src is None and conf.num_viz_images > 0:
                    viz_src = (batch, out["pred"])  # fetched after the loop
            val_cm = val_cm_dev.cpu()
            val_f1 = float(f1_from_confusion(val_cm))
            val_loss = float(val_loss_dev) / max(n_val, 1)
            if writer:
                mlog.log_scalars({"val/f1": val_f1, "val/loss": val_loss}, global_step)
            if writer and viz_src is not None:
                batch, pred_dev = viz_src
                n = min(conf.num_viz_images, len(batch["image"]))
                prompt_imgs = state.prompt_pixels.cpu().numpy()[batch["crop_idx"][:n] % num_prompts]
                viz = example_grid(
                    batch["image"][:n], batch["mask"][:n], pred_dev[:n].cpu().numpy(), prompt_imgs,
                    conf.classes, conf.viz_size,
                )
                mlog.log_image("val_images", viz, epoch)
            if writer:
                save_state(run_dir, state)
            # best-prompt tracking (the reference's commented-out ModelCheckpoint
            # on monitor_metric, ref train.py:82-89)
            monitored = {"val/f1": val_f1, "val/loss": val_loss}.get(conf.monitor_metric, val_f1)
            better = best_metric is None or (
                monitored > best_metric if conf.monitor_mode == "max" else monitored < best_metric
            )
            if better:
                best_metric = monitored
            if better and writer:
                best = json.dumps({"epoch": epoch, conf.monitor_metric: monitored})
                exports.save("prompt_batch_best.npz", state.prompt_pixels,
                             after=lambda text=best: (run_dir / "best.json").write_text(text))
            logger.info("epoch %d: val/f1=%.4f val/loss=%.4f", epoch, val_f1, val_loss)

        # post-fit prompt exports: the tuned pixels (ref train.py:121-122) and
        # their EMA, what the reference's legacy trainer saves
        # (src/old/train.py:168,255-258), read by predict use_ema=true
        if writer:
            exports.save("prompt_batch_tuned.npz", state.prompt_pixels)
            exports.save("prompt_batch_ema.npz", state.ema_pixels)
            mlog.close()
    return run_dir
