"""The tuned predict step of the EVA-02 painter in a closed loop with one caller.

``drivers/painter_predict_step.py``'s set-up, window, timing, check and
traced window, with the EVA-02 weights (``traffic/eva02_weights.py``) and
the EVA-02 plain reference (``reference/eva02.py``). The configuration is
built before anything else, so a port whose config lacks the ``block``
field fails at once.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness
from portbench.drivers.painter_predict_step import traced
from portbench.drivers.predict_step import window
from portbench.reference import eva02 as ref_eva02
from portbench.reference import predict as ref_predict
from portbench.traffic import predict_inputs
from portbench.traffic.eva02_weights import make_weights


def setup(cell: harness.Cell) -> dict:
    config = harness.seggpt_config(cell.model)
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.models.seggpt.model import build_model
    from beach_seg_tpu_torch.train import PromptTuner

    tr, run = cell.traffic, cell.config["run"]
    harness.build_kernels(cell)
    weights = make_weights(cell.model, cell.config["weights"], cell.seed, cell.device)
    model = build_model(config, cell.dtype, device=cell.device, state=weights)
    del weights
    conf = BeachSegConfig(batch_size=tr["batch"], crop_size=run["crop_size"], inpt_size=run["inpt_size"],
                          compute_dtype=cell.config["compute_dtype"], classes=tuple(run["classes"]))
    tuner = PromptTuner(model, conf, device=cell.device)
    prompts = predict_inputs.prompts(cell.seed, tr["prompts"], run["inpt_size"], len(run["classes"]))
    pool = predict_inputs.batches(cell.seed, tr["pool"], tr["batch"], run["crop_size"], tr["prompts"])
    on_device = tuple(torch.as_tensor(a, device=cell.device) for a in prompts)

    def call(batch: dict) -> np.ndarray:
        return tuner.predict_step(*on_device, batch, out_size=run["crop_size"]).cpu().numpy()

    for i in range(tr["warmup_calls"]):
        call(pool[i % len(pool)])
    harness.sync(cell)
    return {"tuner": tuner, "call": call, "prompts": prompts, "pool": pool}


def check(cell: harness.Cell, st: dict, res: dict) -> list[tuple[str, float, float]]:
    tr, run = cell.traffic, cell.config["run"]
    rng = np.random.default_rng([cell.seed, 4])
    n = len(res["ids"])
    picks = sorted(rng.choice(n, size=min(tr["check_calls"], n), replace=False).tolist())
    weights = make_weights(cell.model, cell.config["weights"], cell.seed, cell.device)
    widest = 0.0
    for i in picks:
        batch = st["pool"][i % len(st["pool"])]
        scores = ref_eva02.scores(weights, cell.model, run, batch, st["prompts"], cell.device)
        widest = max(widest, ref_predict.widest_gap(scores, res["ids"][i]))
    return [("id_gap_max", widest, tr["limits"]["id_gap_max"])]


def run(cell: harness.Cell) -> harness.Outcome:
    st = setup(cell)
    setup_s = time.perf_counter() - cell.start
    holder: dict = {}
    seconds = cell.traffic["trace_seconds"] if cell.trace else cell.seconds
    with traced(cell, holder):
        res = window(cell, st, seconds)
    peak = harness.memory_peak(cell)
    st.pop("tuner"), st.pop("call")
    harness.release(cell)
    checks = check(cell, st, res)
    calls, tiles = len(res["ids"]), len(res["ids"]) * cell.traffic["batch"]
    e2e = {
        "setup_s": setup_s,
        "predict_tiles_per_s": tiles / res["window_s"],
        "predict_p95_ms": float(np.percentile(np.asarray(res["latency"]) * 1e3, 95)),
    }
    return harness.Outcome(attempted=calls, failed=0, e2e=e2e, checks=checks, memory_peak_bytes=peak,
                           trace=holder.get("trace"),
                           counts={"calls": calls, "tiles": tiles, "window_s": res["window_s"]})
