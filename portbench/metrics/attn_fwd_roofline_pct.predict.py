"""attn_fwd_roofline_pct.predict: the qkv-rel attention forward's least
time (``flops.attention_fwd_bound_s``: scores, PV and the rel terms at the
bf16 peak, or its interface bytes at 3.35 TB/s, whichever is longer) over
its device time, both over the traced window's calls.

The port launches it through ctypes, so no operator range encloses it; its
kernels are found by name."""

from portbench.metrics import flops

PATTERNS = [r"attn_kernel", r"fill_slots"]


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("tiles"):
        return None
    device_s = ctx.trace.device_seconds(PATTERNS)
    if device_s <= 0:
        return None
    rows = ctx.counts["tiles"] * flops.layer_rows(ctx.shape)
    bound, _ = flops.attention_fwd_bound_s(ctx.shape, rows, 2, flops.PEAK_BF16)
    return 100.0 * bound / device_s
