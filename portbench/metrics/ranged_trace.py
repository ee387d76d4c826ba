"""The profiler's trace with each device activity tied to its launch: the
launch's correlation id and the innermost port range (``bst.*``) open on
the launching thread when it was made.

``metrics/trace.py``'s ``Trace`` keeps device intervals and host ranges
apart, so a kernel cannot be put down to the region of the port that
launched it; this subclass keeps that link and reads as a ``Trace``
everywhere else. The link is the ``correlation`` id that a device event
shares with its runtime or driver call (``cudaLaunchKernel``,
``cuLaunchKernel``, ``cudaMemcpyAsync``, ...). The port's window layout
(pads and copies) is aten operations, and its kernels are launched through
ctypes inside ``bst.kernel.*``; both leave launch records in the trace.
A device event without a launch record, or launched outside every
``bst.`` range, has range ``None``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from portbench.metrics.trace import DEVICE_CATS, Trace

PREFIX = "bst."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def innermost(ranges: list[tuple[float, float, str]], times: list[float]) -> list[str | None]:
    """For each of ``times`` (sorted), the innermost of ``ranges`` ((start,
    end, name), properly nested, as one thread's ranges are) open at it."""
    out, stack, i = [], [], 0
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


@dataclass
class RangedTrace(Trace):
    correlation: list[int | None] = field(default_factory=list)  # per ``device`` entry
    launch_range: list[str | None] = field(default_factory=list)  # per ``device`` entry

    @classmethod
    def from_events(cls, events: list[dict]) -> "RangedTrace":
        trace = super().from_events(events)
        by_tid: dict = {}
        launches: dict[int, tuple] = {}
        corr: list[int | None] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name, args = e.get("cat", ""), e.get("name", ""), e.get("args") or {}
            if cat in DEVICE_CATS:
                corr.append(args.get("correlation"))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (e.get("tid"), float(e.get("ts", 0.0)))
            elif cat == "user_annotation" and name.startswith(PREFIX):
                ts = float(e.get("ts", 0.0))
                by_tid.setdefault(e.get("tid"), []).append((ts, ts + float(e.get("dur", 0.0)), name))
        named: dict[int, str | None] = {}
        per_tid: dict = {}
        for c, (tid, ts) in launches.items():
            per_tid.setdefault(tid, []).append((ts, c))
        for tid, items in per_tid.items():
            items.sort()
            for (_, c), name in zip(items, innermost(by_tid.get(tid, []), [t for t, _ in items])):
                named[c] = name
        trace.correlation = corr
        trace.launch_range = [named.get(c) for c in corr]
        return trace

    def kernels_in(self, range_name: str) -> list[tuple[str, float, float]]:
        """Kernels in the window (copies and fills left out) launched with
        ``range_name`` the innermost ``bst.`` range."""
        lo, hi = self.window
        return [
            k for k, r in zip(self.device, self.launch_range)
            if r == range_name and lo <= k[1] < hi and not k[0].startswith(("Memcpy", "Memset"))
        ]

    def device_seconds_in(self, range_name: str) -> float:
        return sum(d for _, _, d in self.kernels_in(range_name)) / 1e6

    def ranges_named(self, name: str) -> int:
        """Host ranges called ``name`` that start inside the window."""
        lo, hi = self.window
        return sum(1 for n, ts, _ in self.host if n == name and lo <= ts < hi)
