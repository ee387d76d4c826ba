"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is ``BENCHMARK.json``'s workload ``<name>``; its traffic and driver
are in ``portbench/workloads/<name>.json``, its configuration in the file
BENCHMARK.json names, each per-layer metric's reader in
``portbench/metrics/<metric>.py``. With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled window. The numbers that decide ``correct`` are printed last on
standard error and, under ``checks``, last in the line.

Exits 2 without the CUDA devices the cell asks for, and 3 when the process
has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "beach_seg_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``beach_seg_tpu_torch`` is the port and is not one of them)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def per_layer(bench: dict, name: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def read_metric(metric: str, ctx) -> float | None:
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", ROOT / "portbench" / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def device_info(outcome, chips: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": outcome.memory_peak_bytes}
    if outcome.trace is not None:
        info["busy_s"] = outcome.trace.busy_s()
        info["window_s"] = outcome.trace.window_s
    return info


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    # the port's own nvcc output lives in beach_seg_tpu_torch/_build inside the
    # checkout; whatever else compiles is kept here, at a fixed path
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)

    import torch

    from portbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    cell.start = START
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    outcome = driver.run(cell)
    return report(bench, cell, outcome)


def report(bench: dict, cell, outcome) -> int:
    if cell.trace:
        from portbench.metrics.flops import Shape

        ctx = MetricContext(cell, outcome, Shape.from_model(cell.model))
        metrics = {}
        for m in per_layer(bench, cell.name):
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in outcome.e2e.items() if k in units}
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    line = {"correct": outcome.correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device_info(outcome, cell.entry["chips"])}
    if outcome.trace is not None:
        line["breakdown"] = {"device_ops": outcome.trace.top_ops(), "idle_gaps": outcome.trace.idle_gaps()}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.checks}
    for name, v, lim in outcome.checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


class MetricContext:
    """What a per-layer reader gets: the cell, the outcome (trace, counts)
    and the model's shape."""

    def __init__(self, cell, outcome, shape):
        self.cell, self.outcome, self.shape = cell, outcome, shape
        self.trace, self.counts = outcome.trace, outcome.counts


if __name__ == "__main__":
    sys.exit(main())
