"""The port's own ranges in the traced window, read against the device's
idle time.

The port names its layer boundaries with profiler ranges under ``bst.``
(``beach_seg_tpu_torch/utils/profiling.py``): the entry calls
(``bst.predict_step``, ``bst.predict_step_probs``, ``bst.train_step``,
``bst.eval_step``), the model call inside them (``bst.seggpt``, everything
of the model and its kernels inside it), the data feed's wait for a batch
(``bst.data.wait``) and each blocking copy between host and card
(``bst.sync``). They are host ranges on the trace's own clock, so every
instant of the window in which the device ran nothing (the complement of
the union of its intervals, as ``device_idle_pct`` reads it) can be put
down to the range the host was in:

- ``model``: a ``bst.seggpt`` range is open;
- ``feed``: else a ``bst.data.wait`` range is open;
- ``entry``: else an entry range is open (the entry outside the model);
- ``outside``: none of them (the benchmark's own code, or no call at all).

The four parts add up to the window's idle time. Every reading is ``None``
when the trace holds no ``bst.`` range (a port without the spans) or no
device activity (a run without a card).
"""

from __future__ import annotations

PREFIX = "bst."
MODEL = "bst.seggpt"
FEED = "bst.data.wait"
ENTRY = ("bst.predict_step", "bst.predict_step_probs", "bst.train_step", "bst.eval_step")
SYNC = "bst.sync"
LAYERS = ("model", "feed", "entry", "outside")  # in the order an open range claims an instant


def port_ranges(trace) -> list[tuple[str, float, float]]:
    """The ``bst.`` ranges that overlap the window: (name, start µs, end µs);
    none without a trace or without device activity in the window."""
    if trace is None or not trace._intervals():
        return []
    lo, hi = trace.window
    return [(n, ts, ts + d) for n, ts, d in trace.host if n.startswith(PREFIX) and ts < hi and ts + d > lo]


def _layer(name: str) -> str | None:
    if name == MODEL:
        return "model"
    if name == FEED:
        return "feed"
    if name in ENTRY:
        return "entry"
    return None


def idle_split(trace) -> dict[str, float] | None:
    """Seconds of the window's device-idle time by the layer the host was
    in (``LAYERS``), or None without ``bst.`` ranges."""
    ranges = port_ranges(trace)
    if not ranges:
        return None
    lo, hi = trace.window
    # sweep: +1/-1 edges of each layer's ranges and of the idle intervals
    edges: list[tuple[float, int, str]] = []
    for name, a, b in ranges:
        layer = _layer(name)
        if layer is not None:
            edges += [(max(a, lo), 1, layer), (min(b, hi), -1, layer)]
    busy = trace._intervals()
    idle_edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for i in range(0, len(idle_edges) - 1, 2):
        if idle_edges[i + 1] > idle_edges[i]:
            edges += [(idle_edges[i], 1, "idle"), (idle_edges[i + 1], -1, "idle")]
    edges.sort(key=lambda e: (e[0], e[1]))
    open_ = dict.fromkeys((*LAYERS, "idle"), 0)
    out = dict.fromkeys(LAYERS, 0.0)
    prev = lo
    for t, delta, what in edges:
        if t > prev and open_["idle"] > 0:
            layer = next((k for k in LAYERS[:3] if open_[k] > 0), "outside")
            out[layer] += (t - prev) / 1e6
        prev = max(prev, t)
        open_[what] += delta
    return out


def syncs_inside(trace, entry: str) -> int | None:
    """``bst.sync`` ranges that lie inside an ``entry`` range of the window,
    or None without ``bst.`` ranges."""
    ranges = port_ranges(trace)
    if not ranges:
        return None
    outer = sorted((a, b) for n, a, b in ranges if n == entry)
    count = 0
    for name, a, b in ranges:
        if name == SYNC and any(oa <= a and b <= ob for oa, ob in outer):
            count += 1
    return count
