"""mfu.train: the model FLOPs of the valid tiles the traced window's train
steps took (forward and the input-gradient backward,
``flops.train_flops_per_tile``), over the window's seconds, as a share of
one H100's dense bf16 peak (989 TF/s), whatever the dtype."""

from portbench.metrics import flops


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels() or not ctx.counts.get("valid_tiles"):
        return None
    work = ctx.counts["valid_tiles"] * flops.train_flops_per_tile(ctx.shape)
    return 100.0 * work / ctx.trace.window_s / flops.MFU_PEAK
