"""attn_fwd_roofline_pct.painter_predict: the qkv-rel attention forward's
least time over the traced window's tiles, the global rows' bound plus the
windowed rows' (``flops_window.attention_fwd_bound_s``: each kind's
operations at the bf16 peak or its interface bytes at 3.35 TB/s, whichever
is longer), over the device time of its launches, found by name as
``attn_fwd_roofline_pct.predict`` finds them."""

from portbench.metrics import flops, flops_window

PATTERNS = [r"attn_kernel", r"fill_slots"]


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("tiles"):
        return None
    device_s = ctx.trace.device_seconds(PATTERNS)
    if device_s <= 0:
        return None
    sh = flops_window.WindowShape.from_model(ctx.cell.model)
    return 100.0 * flops_window.attention_fwd_bound_s(sh, ctx.counts["tiles"], 2, flops.PEAK_BF16) / device_s
