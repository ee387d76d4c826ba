"""feed_idle_ms_per_step.train: milliseconds a train step in which the
device ran nothing while the host waited for the data feed's next batch (a
``bst.data.wait`` range of the port's ``prefetch_iterator``), over the
traced window's steps (``port_spans.idle_split``)."""

from portbench.metrics import port_spans


def read(ctx):
    split = port_spans.idle_split(ctx.trace)
    if split is None or not ctx.counts.get("steps"):
        return None
    return 1e3 * split["feed"] / ctx.counts["steps"]
