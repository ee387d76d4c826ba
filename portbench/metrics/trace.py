"""The profiler's trace, read for the per-layer metrics.

A frozen, corrected copy of the reading in ``scripts/profile_torch_predict.py``:
device activity is taken from the exported Chrome trace (kernels, copies and
fills, with their start and length on the device), and the busy time is the
union of those intervals, so work on overlapping streams counts once. The
traced window is the benchmark's own ``portbench.window`` range. An idle gap
is named by the innermost host range that covers its middle: the
benchmark's spans (``portbench.*``) and the operators the port calls.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW = "portbench.window"


@dataclass
class Trace:
    device: list[tuple[str, float, float]]  # (name, start µs, length µs)
    host: list[tuple[str, float, float]] = field(default_factory=list)
    window: tuple[float, float] = (0.0, 0.0)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return cls.from_events(events)

    @classmethod
    def from_events(cls, events: list[dict]) -> "Trace":
        device, host, window = [], [], None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                device.append((name, ts, dur))
            elif cat in HOST_CATS:
                host.append((name, ts, dur))
                if name == WINDOW and cat == "user_annotation":
                    window = (ts, ts + dur)
        if window is None:
            raise ValueError(f"the trace holds no {WINDOW} range")
        return cls(device, host, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _intervals(self) -> list[tuple[float, float]]:
        lo, hi = self.window
        spans = sorted((max(ts, lo), min(ts + d, hi)) for _, ts, d in self.device if ts + d > lo and ts < hi)
        merged: list[list[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran."""
        return sum(b - a for a, b in self._intervals()) / 1e6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernels(self, patterns: list[str] | None = None) -> list[tuple[str, float, float]]:
        """Kernels in the window (copies and fills left out), those whose
        name matches one of ``patterns`` when given."""
        lo, hi = self.window
        regs = [re.compile(p) for p in patterns or []]
        return [
            k for k in self.device
            if lo <= k[1] < hi and not k[0].startswith(("Memcpy", "Memset"))
            and (not regs or any(r.search(k[0]) for r in regs))
        ]

    def device_seconds(self, patterns: list[str]) -> float:
        return sum(d for _, _, d in self.kernels(patterns)) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        """The device activities that took most time: [name, seconds]."""
        lo, hi = self.window
        by_name: dict[str, float] = {}
        for name, ts, d in self.device:
            if lo <= ts < hi:
                by_name[name] = by_name.get(name, 0.0) + d
        return [[k[:120], v / 1e6] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The longest device-idle gaps of the window: [what the host was
        doing, seconds]."""
        lo, hi = self.window
        edges = [lo] + [x for ab in self._intervals() for x in ab] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)), reverse=True)
        out = []
        for length, start in gaps[:n]:
            if length <= 0:
                break
            mid = start + length / 2
            covering = [(d, name) for name, ts, d in self.host if ts <= mid <= ts + d and name != WINDOW]
            what = min(covering)[1] if covering else "host idle"
            out.append([what[:120], length / 1e6])
        return out
