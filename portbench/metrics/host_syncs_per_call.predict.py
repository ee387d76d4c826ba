"""host_syncs_per_call.predict: the port's ``bst.sync`` ranges (each a copy
between host and card that waits for the card's queue to drain) inside its
``bst.predict_step`` ranges of the traced window, over the window's calls
(``port_spans.syncs_inside``)."""

from portbench.metrics import port_spans


def read(ctx):
    n = port_spans.syncs_inside(ctx.trace, "bst.predict_step")
    if n is None or not ctx.counts.get("calls"):
        return None
    return n / ctx.counts["calls"]
