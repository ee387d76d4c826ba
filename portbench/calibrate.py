"""Readings that set a cell's correctness limits: the program's, on many
seeds, and the controls', in one process (the benchmark's own runs read only
the program's).

    python3 portbench/calibrate.py --workload <name> --seeds 11,12,... [--control-seeds 11,12,13] [--seconds 2]

Each seed builds the cell as a run does (weights, inputs, set-up), runs a
short window where the cell has one, and prints one JSON line with the
numbers the run compares. On the control seeds it adds:

- predict: the reference computed with fp8 operands (one step below the
  configuration's bf16), whose first-placed class at each sampled pixel is
  judged by the float32 reference's gap, as a served id is;
- train: the reference with TF32 products (one step below fp32 with TF32
  off) judged against the float32 reference; and the faults a train step
  can have, planted in the reference: half of each batch left out with the
  mean taken over the rest, and a step that returns its state unchanged.

Each set of readings carries ``correct``: the verdict of the run's own
comparison (``harness.Outcome``) under the cell's limits. The program's has
to read true, every control's and fault's false.

Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def verdict(checks: list[tuple[str, float, float]]) -> bool:
    """What a run reports as ``correct`` for these (name, value, limit)."""
    from portbench import harness

    return harness.Outcome(0, 0, {}, checks, 0).correct


def program(checks: list[tuple[str, float, float]]) -> dict:
    return dict({name: v for name, v, _ in checks}, correct=verdict(checks))


def judged(readings: dict, limits: dict) -> dict:
    """A control's or a fault's ``readings`` with the verdict a run would
    give them under the cell's ``limits``."""
    return dict(readings, correct=verdict([(name, readings[name], limit) for name, limit in limits.items()]))


def predict_seed(cell, control: bool) -> dict:
    import numpy as np
    import torch

    from portbench import harness
    from portbench.drivers import predict_step as drv
    from portbench.reference import predict as ref_predict
    from portbench.reference import seggpt
    from portbench.traffic.weights import make_weights

    st = drv.setup(cell)
    res = drv.window(cell, st, cell.seconds)
    st.pop("tuner"), st.pop("call")
    harness.release(cell)
    out = {"program": program(drv.check(cell, st, res)), "calls": len(res["ids"])}
    if control:
        run = cell.config["run"]
        rng = np.random.default_rng([cell.seed, 4])
        n = len(res["ids"])
        picks = sorted(rng.choice(n, size=min(cell.traffic["check_calls"], n), replace=False).tolist())
        w = make_weights(cell.model, cell.config["weights"], cell.seed, cell.device)
        widest, altered, q_prog, q_low = 0.0, 0.0, [], []
        for i in picks:
            batch = st["pool"][i % len(st["pool"])]
            ref = ref_predict.scores(w, cell.model, run, batch, st["prompts"], cell.device)
            low = ref_predict.scores(w, cell.model, run, batch, st["prompts"], cell.device, seggpt.Precision("fp8"))
            widest = max(widest, ref_predict.widest_gap(ref, low.argmax(-1).cpu().numpy()))
            q_prog.append(ref_predict.gaps(ref, res["ids"][i]))
            q_low.append(ref_predict.gaps(ref, low.argmax(-1).cpu().numpy()))
            # an answer altered where it is produced: every served id moved to the next class
            ids = (res["ids"][i].astype(np.int64) + 1) % len(run["classes"])
            altered = max(altered, ref_predict.widest_gap(ref, ids))
        out["control_fp8"] = {"id_gap_max": widest}
        for name, g in (("program", q_prog), ("control_fp8", q_low)):
            g = torch.cat([x.flatten() for x in g])
            out[name]["gap_q999"] = float(torch.quantile(g.float()[:2**24], 0.999))
            out[name]["ids_differing"] = float((g > 0).float().mean())
        out["control_fp8"] = judged(out["control_fp8"], cell.traffic["limits"])
        out["fault_ids_altered"] = judged({"id_gap_max": altered}, cell.traffic["limits"])
    return out


def train_seed(cell, control: bool) -> dict:
    import torch

    from portbench import harness
    from portbench.drivers import train_step as drv
    from portbench.reference import train as ref_train
    from portbench.traffic.weights import make_weights

    st = drv.setup(cell)
    for k in ("tuner", "state", "step", "next_draws", "batches"):
        st.pop(k)
    harness.release(cell)
    out = {"program": program(drv.check(cell, st))}
    if control:
        prompts, batches, _ = drv.reference_inputs(cell, st)
        w = make_weights(cell.model, cell.config["weights"], cell.seed, cell.device)
        run = dict(cell.config["train"], batch_size=cell.traffic["batch"])
        args = (w, cell.model, run, cell.config["augment"], prompts["image"], prompts["mask"], prompts["nodata"])
        draws = st["prog"]["draws"]
        ref = ref_train.run_steps(*args, batches, draws)

        def as_program(r):
            return {"losses": r["losses"], "grad1": r["grads"][0], "pixels": r["pixels"]}

        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = ref_train.run_steps(*args, batches, draws)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        out["control_tf32"] = ref_train.readings(as_program(tf32), ref, prompts["image"])
        half = []
        for b in batches:
            b = dict(b)
            b["valid"] = b["valid"] & (torch.arange(len(b["valid"]), device=b["valid"].device) < len(b["valid"]) // 2)
            half.append(b)
        out["fault_half_batch"] = ref_train.readings(as_program(ref_train.run_steps(*args, half, draws)), ref,
                                                     prompts["image"])
        unchanged = {"losses": ref["losses"], "grad1": ref["grads"][0], "pixels": prompts["image"]}
        out["fault_state_unchanged"] = ref_train.readings(unchanged, ref, prompts["image"])
        for k in ("control_tf32", "fault_half_batch", "fault_state_unchanged"):
            out[k] = judged(out[k], cell.traffic["limits"])
    return out


READINGS = {"predict_step": predict_seed, "train_step": train_seed}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        cell = harness.load_cell(args.workload, seed, args.seconds, False, torch.device("cuda"))
        out = READINGS[cell.traffic["driver"]](cell, seed in controls)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
