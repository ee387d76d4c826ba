"""entry_idle_ms_per_call.predict: milliseconds a predict call in which the
device ran nothing while the host was inside ``PromptTuner.predict_step``
but outside the model call (the inputs' upload, resize and palette, the
decode and back-resize), over the traced window's calls
(``port_spans.idle_split``)."""

from portbench.metrics import port_spans


def read(ctx):
    split = port_spans.idle_split(ctx.trace)
    if split is None or not ctx.counts.get("calls"):
        return None
    return 1e3 * split["entry"] / ctx.counts["calls"]
