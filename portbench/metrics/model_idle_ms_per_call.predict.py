"""model_idle_ms_per_call.predict: milliseconds a predict call in which the
device ran nothing while the host was inside the model call (a
``bst.seggpt`` range of the port: its Python, its launches, its syncs), over
the traced window's calls (``port_spans.idle_split``)."""

from portbench.metrics import port_spans


def read(ctx):
    split = port_spans.idle_split(ctx.trace)
    if split is None or not ctx.counts.get("calls"):
        return None
    return 1e3 * split["model"] / ctx.counts["calls"]
