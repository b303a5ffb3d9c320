"""The whole request's or step's share of the chip's dense peak: the model
FLOPs of every unit in the traced window (``counts``), over the window's
seconds and the data-sheet peak of the compute dtype, in percent."""

from ..counts.kernels import PEAK_FLOPS


def read(ctx):
    flops = ctx.units * ctx.counts["flops_per_unit"]
    return 100.0 * flops / ctx.window_s / PEAK_FLOPS[ctx.counts["dtype"]]
