"""What every driver shares: the cell as the files describe it, the port's
model built from the benchmark's weights, the traced window, and the
outcome a run reports."""

from __future__ import annotations

import contextlib
import gc
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench.metrics.trace import WINDOW, Trace

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"


@dataclass
class Cell:
    """One run of one cell: ``entry`` from BENCHMARK.json, ``traffic`` from
    ``workloads/<name>.json``, ``config`` from the configuration's file."""

    name: str
    entry: dict
    traffic: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    start: float = field(default_factory=time.perf_counter)

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config["compute_dtype"] == "bfloat16" else torch.float32

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"


@dataclass
class Outcome:
    """What a driver measured. ``checks``: (name, value, limit), each value
    correct while at most its limit. ``counts`` carries what the per-layer
    readers divide by (calls, tiles, steps, seconds)."""

    attempted: int
    failed: int
    e2e: dict[str, float]
    checks: list[tuple[str, float, float]]
    memory_peak_bytes: int
    trace: Trace | None = None
    counts: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v == v and v <= lim for _, v, lim in self.checks)


def load_cell(name: str, seed: int, seconds: float, trace: bool, device: torch.device) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    traffic = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    return Cell(name, entry, traffic, config, seed, seconds, trace, device)


def build_kernels(cell: Cell) -> None:
    if cell.on_card:
        from beach_seg_tpu_torch.ops import build

        build.build(*build.KERNELS)


def seggpt_config(m: dict):
    from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig

    fields = dict(m)
    fields["image_size"] = tuple(fields["image_size"])
    fields["intermediate_hidden_state_indices"] = tuple(fields["intermediate_hidden_state_indices"])
    return SegGPTConfig(**fields)


def sync(cell: Cell) -> None:
    if cell.on_card:
        torch.cuda.synchronize()


def memory_peak(cell: Cell) -> int:
    return int(torch.cuda.max_memory_allocated()) if cell.on_card else 0


def release(cell: Cell) -> None:
    """After the program's objects are dropped: give their memory back
    before the reference runs."""
    gc.collect()
    if cell.on_card:
        torch.cuda.empty_cache()


@contextlib.contextmanager
def traced(cell: Cell, holder: dict):
    """The window, under the profiler when the run traces: yields, then
    leaves the parsed trace in ``holder["trace"]``."""
    if not cell.trace:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cell.on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
            sync(cell)
    holder["trace"] = Trace.from_profiler(prof)


def span(name: str):
    """A benchmark span around a call into the port (a profiler range; free
    when nothing traces)."""
    return torch.profiler.record_function(f"portbench.{name}")
