"""mfu.painter_predict: the model FLOPs of the tiles the traced window
completed (``flops_window.forward_flops_per_tile``: global and windowed
blocks each counted at their own work), over the window's seconds, as a
share of one H100's dense bf16 peak (989 TF/s, 700 W data sheet)."""

from portbench.metrics import flops, flops_window


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels() or not ctx.counts.get("tiles"):
        return None
    work = ctx.counts["tiles"] * flops_window.forward_flops_per_tile(flops_window.WindowShape.from_model(ctx.cell.model))
    return 100.0 * work / ctx.trace.window_s / flops.MFU_PEAK
