"""Idle share of the device: the part of the traced window in which no
kernel, copy or set ran (the union of their intervals), in percent."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s() / ctx.window_s)
