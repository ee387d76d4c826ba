"""attn_fwd_roofline_pct.eva02_predict: the RoPE attention's least time
over the traced window (``flops_eva02.attention_fwd_bound_s``: its
operations at the bf16 peak or its launches' bytes at 3.35 TB/s, whichever
is longer, over the tiles' layer-rows), over the device time of the kernels
launched inside ``bst.kernel.attn_qkv_rope`` (the pre-pass and the key
loop), found through ``ranged_trace.RangedTrace``."""

from portbench.metrics import flops, flops_eva02

RANGE = "bst.kernel.attn_qkv_rope"


def read(ctx):
    if ctx.trace is None or not hasattr(ctx.trace, "device_seconds_in") or not ctx.counts.get("tiles"):
        return None
    device_s = ctx.trace.device_seconds_in(RANGE)
    if device_s <= 0:
        return None
    sh = flops.Shape.from_model(ctx.cell.model)
    rows = ctx.counts["tiles"] * flops.layer_rows(sh)
    launches = ctx.counts["calls"] * sh.layers
    return 100.0 * flops_eva02.attention_fwd_bound_s(sh, rows, launches, flops.PEAK_BF16)[0] / device_s
