"""mfu.eva02_predict: the model FLOPs of the tiles the traced window
completed (``flops_eva02.forward_flops_per_tile``), over the window's
seconds, as a share of one H100's dense bf16 peak (989 TF/s, 700 W data
sheet)."""

from portbench.metrics import flops, flops_eva02


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels() or not ctx.counts.get("tiles"):
        return None
    work = ctx.counts["tiles"] * flops_eva02.forward_flops_per_tile(flops.Shape.from_model(ctx.cell.model))
    return 100.0 * work / ctx.trace.window_s / flops.MFU_PEAK
