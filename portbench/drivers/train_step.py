"""Prompt tuning: ``PromptTuner.train_step`` fed by the port's data path,
epoch after epoch, as ``run_training``'s inner loop drives it.

Set-up builds the port's SegGPT from the benchmark's weights, a ``Scene``
from the benchmark's seeded rasters (``traffic.scene``: the reference
date's mosaic, class map and crop windows), the port's ``BeachSegDataset``
over it, the prompts of the reference date (``materialize_prompts``) and
the tuner's state. It then drives that one state through the first
``check_steps`` steps through the window's own feed (``iterate_batches``
shuffled from the seed each epoch on the configuration's ``num_workers``
threads, under ``prefetch_iterator``) and the window's own call, which
warms every shape; the readings of those steps are kept for the check. The window goes on with the same state and feed. Every
step's random numbers are the benchmark's (``traffic.draws``).

Afterwards the reference re-derives the first steps' batches and prompts from
the rasters, checks that the port's rows are those, and follows the steps in
float32.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import harness
from portbench.reference import data as ref_data
from portbench.reference import seggpt as ref_seggpt
from portbench.reference import train as ref_train
from portbench.traffic import draws as traffic_draws
from portbench.traffic.scene import CLASSES, H, W, make_scene
from portbench.traffic.weights import make_weights

DATE = "20240101"
B1 = 0.9  # AdamW's first moment: the first gradient is mu / (1 - B1) after one step


def tune_config(cell: harness.Cell):
    from beach_seg_tpu_torch.config import BeachSegConfig

    tr, run, cfg = cell.traffic, cell.config["run"], cell.config
    aug = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg["augment"].items() if k != "erasing_ratio"}
    return BeachSegConfig(batch_size=tr["batch"], crop_size=run["crop_size"], inpt_size=run["inpt_size"],
                          compute_dtype=cfg["compute_dtype"], classes=tuple(run["classes"]), seed=cell.seed,
                          lr=cfg["train"]["lr"], min_lr=cfg["train"]["min_lr"],
                          base_lr_batch_size=cfg["train"]["base_lr_batch_size"],
                          loss_beta=cfg["train"]["loss_beta"], loss_variant=cfg["train"]["loss_variant"], **aug)


def feed(dataset, batch: int, seed: int, workers: int):
    """Batches epoch after epoch, each epoch shuffled from ``seed + epoch``
    and assembled on ``workers`` threads, as ``run_training`` builds them."""
    from beach_seg_tpu_torch.data.dataset import iterate_batches
    from beach_seg_tpu_torch.data.prefetch import prefetch_iterator

    epoch = 0
    while True:
        for b in prefetch_iterator(iterate_batches(dataset, batch, shuffle=True, seed=seed + epoch, workers=workers)):
            yield {k: v for k, v in b.items() if k != "date"}
        epoch += 1


def setup(cell: harness.Cell) -> dict:
    from beach_seg_tpu_torch.config import num_workers
    from beach_seg_tpu_torch.data.dataset import BeachSegDataset, Scene, materialize_prompts
    from beach_seg_tpu_torch.geo.affine import Affine
    from beach_seg_tpu_torch.models.seggpt.model import build_model
    from beach_seg_tpu_torch.train import PromptTuner

    tr, run = cell.traffic, cell.config["run"]
    if tuple(run["classes"]) != CLASSES:
        raise ValueError(f"the scene paints {CLASSES}, the configuration names {run['classes']}")
    harness.build_kernels(cell)
    weights = make_weights(cell.model, cell.config["weights"], cell.seed, cell.device)
    model = build_model(harness.seggpt_config(cell.model), cell.dtype, device=cell.device, state=weights)
    del weights
    conf = tune_config(cell)
    arrays = make_scene(cell.seed, tr["crops"], run["crop_size"])
    scene = Scene(date_merged_imgs={DATE: (arrays.image, arrays.nodata)}, date_masks={DATE: arrays.label},
                  crops=arrays.crops, out_shape=(H, W), out_transform=Affine.from_origin(0.0, 0.0, 3.0, 3.0),
                  crs=None, mask_date=DATE)
    dataset = BeachSegDataset(scene, conf)
    prompts = materialize_prompts(scene, conf)
    tuner = PromptTuner(model, conf, device=cell.device, steps_per_epoch=math.ceil(len(dataset) / tr["batch"]))
    state = tuner.init_state(prompts["pixels"])
    pmasks = torch.as_tensor(prompts["masks"], device=cell.device)
    pnodata = torch.as_tensor(prompts["nodata"], device=cell.device)
    gen = torch.Generator(device=cell.device).manual_seed(cell.seed)
    batches = feed(dataset, tr["batch"], cell.seed, num_workers(conf))

    def step(batch: dict, draws: dict) -> dict:
        return tuner.train_step(state, pmasks, pnodata, batch, draws=draws)[1]

    def next_draws() -> dict:
        return traffic_draws.step_draws(gen, tr["batch"], run["inpt_size"], len(prompts["pixels"]),
                                        len(run["classes"]), cell.config["augment"], cell.model)

    prog = {"pixels0": state.prompt_pixels.clone(), "losses": [], "batches": [], "draws": []}
    for k in range(tr["check_steps"]):
        batch, draws = next(batches), next_draws()
        prog["batches"].append(batch)
        prog["draws"].append(draws)
        prog["losses"].append(step(batch, draws)["loss"])
        if k == 0:
            prog["grad1"] = state.opt_state["mu"] / (1 - B1)
    prog["pixels"] = state.prompt_pixels.clone()
    harness.sync(cell)
    prog["losses"] = [float(x) for x in prog["losses"]]
    return {"tuner": tuner, "state": state, "step": step, "next_draws": next_draws, "batches": batches,
            "arrays": arrays, "prog": prog}


def window(cell: harness.Cell, st: dict, seconds: float) -> dict:
    steps = valid = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        with harness.span("batch"):
            batch = next(st["batches"])
        draws = st["next_draws"]()
        with harness.span("train_step"):
            st["step"](batch, draws)
        steps += 1
        valid += int(batch["valid"].sum())
    harness.sync(cell)
    return {"steps": steps, "valid_tiles": valid, "window_s": time.perf_counter() - t0}


def reference_inputs(cell: harness.Cell, st: dict) -> tuple[dict, list[dict], float]:
    """The prompts and the first steps' batches as the reference makes them
    from the rasters, and the count of rows where the port's batches differ
    (rows, valid flags, pixels, class maps or nodata)."""
    tr, run, arrays, prog = cell.traffic, cell.config["run"], st["arrays"], st["prog"]
    size, dev = run["inpt_size"], cell.device
    items = [ref_data.item(arrays.image, arrays.nodata, arrays.label, w, size) for w in arrays.crops]
    prompts = {k: torch.as_tensor(np.stack([it[k] for it in items]), device=dev) for k in ("image", "mask", "nodata")}
    bad = int((prompts["image"] != prog["pixels0"]).reshape(len(items), -1).any(1).sum())
    rows = [r for epoch in range(math.ceil(tr["check_steps"] * tr["batch"] / len(items)) + 1)
            for r in ref_data.epoch_batches(len(items), tr["batch"], cell.seed + epoch)][: tr["check_steps"]]
    batches = []
    for (idx, valid), got in zip(rows, prog["batches"]):
        want = {k: np.stack([items[i][k] for i in idx]) for k in ("image", "mask", "nodata")}
        same = (np.asarray(got["crop_idx"]) == idx) & (np.asarray(got["valid"]) == valid)
        for k in want:
            same &= (np.asarray(got[k]) == want[k]).reshape(len(idx), -1).all(1)
        bad += int((~same).sum())
        batch = {k: torch.as_tensor(v, device=dev) for k, v in want.items()}
        batch["valid"] = torch.as_tensor(valid, device=dev)
        batches.append(batch)
    return prompts, batches, float(bad)


def check(cell: harness.Cell, st: dict) -> list[tuple[str, float, float]]:
    limits, prog = cell.traffic["limits"], st["prog"]
    prompts, batches, bad_rows = reference_inputs(cell, st)
    weights = make_weights(cell.model, cell.config["weights"], cell.seed, cell.device)
    run = dict(cell.config["train"], batch_size=cell.traffic["batch"])
    ref = ref_train.run_steps(weights, cell.model, run, cell.config["augment"], prompts["image"], prompts["mask"],
                              prompts["nodata"], batches, prog["draws"], ref_seggpt.FP32)
    got = ref_train.readings(prog, ref, prompts["image"])
    return [("data_rows_differing", bad_rows, 0.0)] + [(k, got[k], limits[k]) for k in ("loss_rel", "grad1_leaf", "delta_leaf")]


def run(cell: harness.Cell) -> harness.Outcome:
    st = setup(cell)
    setup_s = time.perf_counter() - cell.start
    holder: dict = {}
    seconds = cell.traffic["trace_seconds"] if cell.trace else cell.seconds
    with harness.traced(cell, holder):
        res = window(cell, st, seconds)
    peak = harness.memory_peak(cell)
    for k in ("tuner", "state", "step", "next_draws", "batches"):
        st.pop(k)
    harness.release(cell)
    checks = check(cell, st)
    e2e = {"setup_s": setup_s, "train_tiles_per_s": res["valid_tiles"] / res["window_s"]}
    return harness.Outcome(attempted=res["steps"], failed=0, e2e=e2e, checks=checks, memory_peak_bytes=peak,
                           trace=holder.get("trace"), counts=res)
