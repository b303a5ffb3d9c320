"""Device kernel records per unit of traffic in the traced window: the
launches a graph replay (or an eager call) makes, which a fusion or a
capture change lowers.  Copies and sets are not counted."""


def read(ctx):
    if not ctx.units:
        return None
    return len(ctx.kernels()) / ctx.units
