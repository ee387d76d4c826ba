"""Tracing and step timing (counterpart of ``beach_seg_tpu/utils/profiling.py``).

``maybe_trace`` wraps a region in a ``torch.profiler`` trace of the host and
the CUDA device, written as a Chrome trace under ``<log_dir>/profile`` (where
the JAX package writes its ``jax.profiler`` trace); ``StepTimer`` tracks
steady-state step latency with warmup discard. Enable via config:
``profile=true``.

``span`` names a region of the port in that trace: a ``record_function``
range while a profiler collects on the calling thread, else nothing at all
(one flag check). The names are fixed strings under ``bst.``, one per layer
boundary: ``bst.predict_step`` / ``bst.train_step`` / ``bst.eval_step`` and
their phases (``bst.predict.*``, ``bst.train.*``), the model
(``bst.seggpt`` and ``bst.seggpt.{embed,attn,mlp,decoder,loss}``; inside a
windowed block's ``attn``, ``bst.seggpt.window`` around the window layout
and its inverse and ``bst.seggpt.attn_win`` around the attention; in an
EVA-02 block, ``bst.seggpt.sub_ln`` around a sub-LN that runs outside the
kernels), each
hand-written kernel's launch wrapper (``bst.kernel.<wrapper>``), the data
feed's wait (``bst.data.wait``), the scene engines' phases and dates
(``bst.scene.*``), and ``bst.sync`` around each copy between the host and
the card that blocks the host until the card's queue has drained
(``host_sync``, ``tensor_from_host``). Spans are opened on the thread that
calls the entry (and on autograd's backward thread under it), never on a
worker thread.

The JAX module's ``enable_compilation_cache`` has no counterpart: it points
XLA at a persistent cache of compiled programs, and the port compiles no
programs at run time (eager PyTorch; its CUDA kernels are built once by
``ops.build`` into ``_build/``, which is that cache already).
"""

from __future__ import annotations

import contextlib
import functools
import time
from pathlib import Path

import torch
from torch.profiler import record_function

TRACE_NAME = "trace.json"
SYNC = "bst.sync"

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled  # thread-local: False on threads the profiler does not see


def span(name: str, into: dict | None = None):
    """A profiler range named ``name`` around the region while a profiler
    collects, else a shared do-nothing context. With ``into``, the region's
    host seconds are also added to ``into[<last part of name>]`` (``"bst.scene.paste"``
    → ``into["paste"]``), traced or not."""
    if into is not None:
        return _timed(name, into)
    return record_function(name) if _profiling() else _OFF


@contextlib.contextmanager
def _timed(name: str, into: dict):
    key = name.rsplit(".", 1)[-1]
    t0 = time.perf_counter()
    try:
        with record_function(name) if _profiling() else _OFF:
            yield
    finally:
        into[key] = into.get(key, 0.0) + time.perf_counter() - t0


def spanned(name: str):
    """Decorator: every call of the function runs in ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with record_function(name) if _profiling() else _OFF:
                return fn(*args, **kwargs)

        return call

    return wrap


def host_sync(device, data=None):
    """``span("bst.sync")`` around one call that blocks the host until the
    card has drained its queue: a copy of host data onto ``device`` (or of a
    device tensor to the host, or a read of one of its values). Open only
    while tracing, on a CUDA ``device``, and, given the ``data`` to be
    moved, only when it is not on the card already, so that the ranges count
    the waits themselves."""
    if not _profiling() or device is None or torch.device(device).type != "cuda":
        return _OFF
    if isinstance(data, torch.Tensor) and data.device.type == "cuda":
        return _OFF
    return record_function(SYNC)


def tensor_from_host(data, dtype=None, device=None) -> torch.Tensor:
    """``torch.tensor(data, dtype=dtype, device=device)``: on a CUDA device
    a blocking copy of host data, so under :func:`host_sync`."""
    with host_sync(device):
        return torch.tensor(data, dtype=dtype, device=device)


@contextlib.contextmanager
def maybe_trace(enabled: bool, log_dir: Path):
    """Profile the region when ``enabled``: CPU activity always, CUDA
    activity when a card is present; the Chrome trace goes to
    ``log_dir / "profile" / TRACE_NAME`` when the region ends."""
    if not enabled:
        yield
        return
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
