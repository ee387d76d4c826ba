"""Readings that set the Painter cell's correctness limit: the program's on
many seeds, and the controls' and planted faults', in one process
(``calibrate.py``'s readings for the ``painter_predict_step`` driver).

    python3 portbench/calibrate_painter.py --workload painter_vit_l_bf16.predict_b8 --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--seconds 2]

Each seed builds the cell as a run does, runs a short window and prints one
JSON line with ``id_gap_max``. On the control seeds it adds:

- ``control_fp8``: Painter's reference with fp8 operands (one step below the
  configuration's bf16), its first-placed class judged by the float32
  reference's gap, as a served id is;
- ``fault_ids_altered``: every served id moved to the next class;
- ``fault_all_global``: the program with every block global, SegGPT's
  topology on Painter's weights (each windowed block's tables resized to
  the grid by the model's own rel-pos interpolation);
- ``fault_windows_misplaced``: the program with the unpartition reading the
  window grid in the wrong order (a 4×2 grid of windows read as 2×4), so
  every window's output lands in another window's place.

Each set carries ``correct``, the run's own verdict under the cell's
limits: the program's has to read true, every control's and fault's false.
Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def all_global():
    """Every block of the models built inside attends over the whole grid,
    each windowed block's tables resized to the grid's 2·g − 1 rows by the
    rel-pos interpolation (HF's ``get_rel_pos``)."""
    from torch import nn

    from beach_seg_tpu_torch.models.seggpt import model
    from beach_seg_tpu_torch.ops.resize import resize_1d

    real = model.build_model

    def build(config, *args, **kwargs):
        built = real(config, *args, **kwargs)
        gh, gw = config.grid_size
        for block in built.modules():
            if isinstance(block, model.Block) and block.window:
                block.window = 0
                att = block.attention
                att.rel_pos_h = nn.Parameter(resize_1d(att.rel_pos_h, 2 * gh - 1, "linear_torch"), requires_grad=False)
                att.rel_pos_w = nn.Parameter(resize_1d(att.rel_pos_w, 2 * gw - 1, "linear_torch"), requires_grad=False)
        return built

    with mock.patch.object(model, "build_model", build):
        yield


@contextlib.contextmanager
def windows_misplaced():
    """The unpartition takes the windows column-major where the partition
    laid them out row-major."""
    from beach_seg_tpu_torch.models.seggpt import model

    real = model.window_unpartition

    def unpartition(x, window, padded, hw):
        nh, nw = padded[0] // window, padded[1] // window
        b = x.shape[0] // (nh * nw)
        swapped = x.reshape(b, nw, nh, *x.shape[1:]).transpose(1, 2).reshape(x.shape)
        return real(swapped, window, padded, hw)

    with mock.patch.object(model, "window_unpartition", unpartition):
        yield


FAULTS = {"fault_all_global": all_global, "fault_windows_misplaced": windows_misplaced}


def program_run(cell) -> tuple[dict, dict, list]:
    """Set-up, a window of ``cell.seconds`` and the check, as a run makes
    them (the program's objects released before the reference runs)."""
    from portbench import harness
    from portbench.drivers import painter_predict_step as drv

    st = drv.setup(cell)
    res = drv.window(cell, st, cell.seconds)
    st.pop("tuner"), st.pop("call")
    harness.release(cell)
    return st, res, drv.check(cell, st, res)


def painter_seed(cell, control: bool) -> dict:
    import numpy as np
    import torch

    from portbench.calibrate import judged, program
    from portbench.reference import painter as ref_painter
    from portbench.reference import predict as ref_predict
    from portbench.traffic.painter_weights import make_weights

    st, res, checks = program_run(cell)
    out = {"program": program(checks), "calls": len(res["ids"])}
    if not control:
        return out
    run, limits = cell.config["run"], cell.traffic["limits"]
    rng = np.random.default_rng([cell.seed, 4])
    n = len(res["ids"])
    picks = sorted(rng.choice(n, size=min(cell.traffic["check_calls"], n), replace=False).tolist())
    w = make_weights(cell.model, cell.config["weights"], cell.seed, cell.device)
    widest = altered = 0.0
    for i in picks:
        batch = st["pool"][i % len(st["pool"])]
        ref = ref_painter.scores(w, cell.model, run, batch, st["prompts"], cell.device)
        low = ref_painter.scores(w, cell.model, run, batch, st["prompts"], cell.device, ref_painter.Precision("fp8"))
        widest = max(widest, ref_predict.widest_gap(ref, low.argmax(-1).cpu().numpy()))
        ids = (res["ids"][i].astype(np.int64) + 1) % len(run["classes"])
        altered = max(altered, ref_predict.widest_gap(ref, ids))
    del w
    out["control_fp8"] = judged({"id_gap_max": widest}, limits)
    out["fault_ids_altered"] = judged({"id_gap_max": altered}, limits)
    for name, fault in FAULTS.items():
        with fault():
            checks = program_run(cell)[2]
        out[name] = judged({k: v for k, v, _ in checks}, limits)
        if cell.on_card:
            torch.cuda.empty_cache()
    return out


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
        print("calibrate_painter: no CUDA device", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        cell = harness.load_cell(args.workload, seed, args.seconds, False, torch.device("cuda"))
        out = painter_seed(cell, seed in controls)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
