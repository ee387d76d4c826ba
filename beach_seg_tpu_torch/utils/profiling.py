"""Tracing and step timing (counterpart of ``beach_seg_tpu/utils/profiling.py``).

``maybe_trace`` wraps a region in a ``torch.profiler`` trace of the host and
the CUDA device, written as a Chrome trace under ``<log_dir>/profile`` (where
the JAX package writes its ``jax.profiler`` trace); ``StepTimer`` tracks
steady-state step latency with warmup discard. Enable via config:
``profile=true``.

The JAX module's ``enable_compilation_cache`` has no counterpart: it points
XLA at a persistent cache of compiled programs, and the port compiles no
programs at run time (eager PyTorch; its CUDA kernels are built once by
``ops.build`` into ``_build/``, which is that cache already).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def maybe_trace(enabled: bool, log_dir: Path):
    """Profile the region when ``enabled``: CPU activity always, CUDA
    activity when a card is present; the Chrome trace goes to
    ``log_dir / "profile" / TRACE_NAME`` when the region ends."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir) / "profile"
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / TRACE_NAME))


class StepTimer:
    """Steady-state steps/sec with warmup discard."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.t0: float | None = None

    def tick(self) -> None:
        self.count += 1
        if self.count == self.warmup:
            self.t0 = time.perf_counter()

    @property
    def steps_per_sec(self) -> float | None:
        if self.t0 is None or self.count <= self.warmup:
            return None
        return (self.count - self.warmup) / (time.perf_counter() - self.t0)
