"""Share of the traced window in which no kernel, copy or fill ran on the
card (the union of the device's intervals, so overlapping streams count
once)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return ctx.trace.idle_pct()
