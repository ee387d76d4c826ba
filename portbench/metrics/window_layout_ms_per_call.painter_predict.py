"""window_layout_ms_per_call.painter_predict: device milliseconds a predict
call spends in the windowed blocks' layout, the kernels (pads, partition
and unpartition copies, crops) whose launch's innermost port range is
``bst.seggpt.window`` (``ranged_trace.RangedTrace``), over the traced
window's calls. None without that range in the trace."""

RANGE = "bst.seggpt.window"


def read(ctx):
    trace = ctx.trace
    if trace is None or not hasattr(trace, "kernels_in") or not ctx.counts.get("calls"):
        return None
    if not trace.ranges_named(RANGE):
        return None
    return 1e3 * trace.device_seconds_in(RANGE) / ctx.counts["calls"]
