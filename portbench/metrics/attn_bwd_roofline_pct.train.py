"""attn_bwd_roofline_pct.train: the fp32 attention backward's least time
(``flops.attention_bwd_bound_s``: 8·S²·hd a head and the rel terms at the
dense TF32 peak of 495 TF/s, or its interface bytes at 3.35 TB/s) over its
device time, over the traced window's steps. Only the rows the prompt
gradient needs count (the pixel stream, each valid tile once a layer).

The kernels are found by name: the port launches them through ctypes."""

from portbench.metrics import flops

PATTERNS = [r"bwd_q_kernel", r"bwd_k_kernel"]


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("valid_tiles"):
        return None
    device_s = ctx.trace.device_seconds(PATTERNS)
    if device_s <= 0:
        return None
    rows = ctx.counts["valid_tiles"] * ctx.shape.layers
    bound, _ = flops.attention_bwd_bound_s(ctx.shape, rows, 4, flops.PEAK_TF32)
    return 100.0 * bound / device_s
