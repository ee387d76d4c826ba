"""Host↔device pipelining (SURVEY.md §7 "host/device pipeline").

The reference's geo setup is minutes of GDAL work executed serially before any
compute (tqdm loop at src/data.py:166-168) and its DataLoader
workers feed a CPU model. Here the host side runs in background threads so
TPU compute overlaps with (a) per-date mosaic construction and (b) batch
assembly:

  - ``prefetch_iterator``: wraps any iterator, keeping ``depth`` items ready
    in a background thread (covers crop/resize batch assembly).
  - ``MosaicPrefetcher``: builds per-date mosaics ``ahead`` dates in advance
    on a worker pool, so the accumulator for date N streams tiles while date
    N+1's reproject/merge runs on host CPUs.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator


def prefetch_iterator(it: Iterable, depth: int = 2) -> Iterator:
    """Background-thread prefetch of any iterator (exceptions re-raised)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            q.put(("__error__", e))
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "__error__":
            raise item[1]
        yield item


def _timed_merge(merge_fn, date: str, paths: list[Path]):
    import logging
    import time

    t0 = time.perf_counter()
    out = merge_fn(paths)
    logging.getLogger(__name__).info("mosaic %s merged in %.2fs", date, time.perf_counter() - t0)
    return out


class MosaicPrefetcher:
    """Schedules ``merge_tifs`` for upcoming dates on a thread pool.

    The default look-ahead is bounded (``max(2, workers + 1)``): each
    completed-but-unconsumed merge holds a full RGB mosaic in host memory, so
    scheduling every date upfront makes peak memory O(dates) on many-date
    scenes. ``ahead=None`` (schedule everything immediately) stays available
    as an opt-in for short scenes where the consumer drains dates much faster
    than the host merges them. Worker count is CPU-aware: merges CONTEND
    (each one already fans its file decodes out on an inner pool, and the
    einsum reprojection is CPU-hot) — on a 1-CPU host, 2 concurrent merges
    measured ~35 s where serial background merges take ~0.6 s each, so
    concurrency only scales with genuinely spare cores."""

    def __init__(
        self,
        date_paths: list[tuple[str, list[Path]]],
        merge_fn: Callable[[list[Path]], Any],
        ahead: int | None = "auto",  # type: ignore[assignment]
        workers: int | None = None,
        processes: bool | None = None,
    ):
        self.date_paths = date_paths
        self.merge_fn = merge_fn
        if workers is None:
            workers = min(len(date_paths) or 1, max(1, (os.cpu_count() or 2) // 2))
        if ahead == "auto":
            ahead = max(2, workers + 1)
        self.ahead = len(date_paths) if ahead is None else max(1, ahead)
        if processes is None:
            processes = os.environ.get("BEACH_SEG_TPU_MOSAIC_PROCS", "") not in ("", "0")
        if processes:
            # subprocess merges sidestep the GIL: the engine's model
            # load/upload holds the parent's GIL for long C stretches, and the
            # measured first-merge cost under that contention is ~8× its
            # isolated time (BENCHMARKS.md round-3 e2e section). A 'spawn'
            # context is mandatory — the TPU client's gRPC threads are already
            # live when the engines construct this, and forking a threaded
            # process wedges. merge_fn must be picklable on this path (the
            # engines pass functools.partial over geo.mosaic.merge_tifs).
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            self.pool: Any = ProcessPoolExecutor(
                max_workers=max(1, workers), mp_context=mp.get_context("spawn")
            )
        else:
            self.pool = ThreadPoolExecutor(max_workers=max(1, workers))
        self._processes = bool(processes)
        self.futures: dict[str, Future] = {}
        # schedule the first merges at CONSTRUCTION, not first iteration: the
        # engines build the prefetcher before model load/upload/compile, so
        # the first date's merge (pure host work, the single biggest exposed
        # e2e stall — 3.1 s of 6.4 s stream in round 2's timings.json) hides
        # under device setup instead of serializing after it
        for i in range(min(self.ahead, len(self.date_paths))):
            self._schedule(i)

    def _schedule(self, idx: int) -> None:
        if idx >= len(self.date_paths):
            return
        date, paths = self.date_paths[idx]
        if date not in self.futures:
            # module-level callable: on the process path the task is pickled,
            # and `self` (holding the pool) must not ride along
            self.futures[date] = self.pool.submit(_timed_merge, self.merge_fn, date, paths)

    def __iter__(self) -> Iterator[tuple[str, Any]]:
        # the first `ahead` merges were scheduled in the constructor
        for i, (date, _) in enumerate(self.date_paths):
            self._schedule(i + self.ahead)
            yield date, self.futures.pop(date).result()
        self.pool.shutdown(wait=False)
