"""Multi-process runs of the port on the CPU for the parallel tests
(tests/test_torch_parallel*.py): ``spawn`` starts ``world`` gloo ranks with
``torch.multiprocessing`` and a ``file://`` store and returns what each
rank's task returned. The tasks live here, not in the test files, because a
spawned rank imports its task's module: this one imports torch and the port
only, never JAX. Also the small-canvas weights the engine and CLI tests run
the zero-shot and legacy engines on."""

from __future__ import annotations

import dataclasses
import os
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt import SegGPTConfig, build_model, random_state, tiny_config
from beach_seg_tpu_torch.models.seggpt.convert import save_params
from beach_seg_tpu_torch.ops.sharding import data_sharded_call
from beach_seg_tpu_torch.parallel.mesh import make_mesh, param_sharding, shard_batch, shard_model
from beach_seg_tpu_torch.train import PromptTuner

# the zero-shot and legacy engines' canvas is 896×448 whatever the crops:
# patches of 32 and a decoder of width 4 keep a CPU run to seconds
SMALL_CANVAS = SegGPTConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, image_size=(896, 448),
                            patch_size=32, pretrain_image_size=224, decoder_hidden_size=4, merge_index=0,
                            intermediate_hidden_state_indices=(0, 1))


def small_canvas_weights(path: Path, head_scale: float = 1.0) -> None:
    """The port's seeded random weights of ``SMALL_CANVAS``, the decoder head
    scaled by ``head_scale`` (a larger head paints more than one class),
    saved with the topology."""
    state = dict(random_state(SMALL_CANVAS))
    state["decoder.head_kernel"] = state["decoder.head_kernel"] * head_scale
    save_params(state, path, SMALL_CANVAS)


def _entry(rank: int, world: int, store: str, out: str, task, payload) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        result = task(payload)
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(out) / f"rank{rank}.pt")


def spawn(task, world: int, payload) -> list:
    """Run ``task(payload)`` on ``world`` gloo ranks → each rank's result."""
    with tempfile.TemporaryDirectory(prefix="torch_parallel_") as tmp:
        mp.spawn(_entry, args=(world, os.path.join(tmp, "store"), tmp, task, payload), nprocs=world, join=True)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def tuner_on(mesh, over: dict, state: dict, conf_kw: dict) -> PromptTuner:
    """A PromptTuner of the fp32 tiny SegGPT ``over`` with weights ``state``
    (numpy), on ``mesh`` (None: one process)."""
    model = build_model(tiny_config(**over), device="cpu", state={k: torch.from_numpy(v) for k, v in state.items()})
    if mesh is not None:
        shard_model(model, mesh)
    return PromptTuner(model, BeachSegConfig(**conf_kw), device="cpu", steps_per_epoch=2)


def train(tuner: PromptTuner, prompts: dict, batches: list, draws: list, mesh=None) -> dict:
    """Train steps over ``batches`` (global; each data rank passes its
    rows) with the global ``draws`` of each step → per-step losses and
    confusions, the prompt gradients (from Adam's first moment) and the
    final pixels."""
    state = tuner.init_state(prompts["pixels"])
    losses, cms, grads = [], [], []
    mu_prev = np.zeros_like(prompts["pixels"])
    for batch, d in zip(batches, draws):
        rows = shard_batch(mesh, batch) if mesh is not None else batch
        state, m = tuner.train_step(state, prompts["masks"], prompts["nodata"], rows,
                                    generator=torch.Generator().manual_seed(3), draws=d)
        losses.append(float(m["loss"]))
        cms.append(m["confusion"].numpy())
        mu = state.opt_state["mu"].numpy()
        grads.append((mu - 0.9 * mu_prev) / 0.1)
        mu_prev = mu
    return {"loss": losses, "confusion": cms, "grad": grads, "pixels": state.prompt_pixels.numpy(),
            "ema": state.ema_pixels.numpy(), "nu": state.opt_state["nu"].numpy()}


def predict(tuner: PromptTuner, prompts: dict, batch: dict, mesh=None) -> np.ndarray:
    """predict_step ids of ``batch``, its rows split over the data ranks."""
    def step(image, crop_idx):
        return tuner.predict_step(prompts["pixels"], prompts["masks"], prompts["nodata"],
                                  {"image_u8": image, "crop_idx": crop_idx})

    args = (torch.from_numpy(batch["image_u8"]), torch.from_numpy(batch["crop_idx"]))
    return data_sharded_call(step, args, (True, True), mesh).numpy()


def mesh_task(payload: dict) -> dict:
    """Every case of ``payload["cases"]`` on one (data, model) mesh each:
    ``train``, ``predict``, ``shards`` (this rank's parameter shards) and
    ``ragged`` (``data_sharded_call`` on a batch that does not divide the
    data ranks)."""
    out = {}
    for name, case in payload["cases"].items():
        mesh = make_mesh(*case["mesh"])
        kind = case["kind"]
        if kind == "ragged":
            x = torch.from_numpy(case["x"])
            out[name] = data_sharded_call(lambda a: a * 2.0 + 1.0, (x,), (True,), mesh,
                                          batch_unit=case["unit"]).numpy()
            continue
        if kind == "shards":
            state = {k: torch.from_numpy(v) for k, v in case["state"].items()}
            out[name] = {k: v.numpy() for k, v in param_sharding(mesh, state).items()}
            continue
        tuner = tuner_on(mesh, case["over"], case["state"], case["conf"])
        if kind == "train":
            out[name] = train(tuner, case["prompts"], case["batches"], case["draws"], mesh)
        else:
            out[name] = predict(tuner, case["prompts"], case["batch"], mesh)
    return out


def engine_task(payload: dict) -> dict:
    """Each scene run of ``payload["runs"]`` ({name: (run, fields)}; run
    "predict", "zero_shot", "legacy" or "training") on the CPU, in turn →
    {name: its run dir}."""
    from beach_seg_tpu_torch import config
    from beach_seg_tpu_torch.infer import run_legacy, run_predict, run_zero_shot
    from beach_seg_tpu_torch.train import run_training

    entry = {
        "predict": (config.PredictionConfig, run_predict), "zero_shot": (config.PredConfig, run_zero_shot),
        "legacy": (config.LegacyConfig, run_legacy), "training": (config.BeachSegConfig, run_training),
    }
    out = {}
    for name, (run, fields) in payload["runs"].items():
        cls, fn = entry[run]
        out[name] = fn(dataclasses.replace(cls(), **fields), device="cpu")
    return out
