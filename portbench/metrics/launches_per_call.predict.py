"""launches_per_call.predict: device kernels a predict call launches,
counted in the trace (copies and fills left out), over the traced calls."""


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("calls"):
        return None
    return len(ctx.trace.kernels()) / ctx.counts["calls"]
