"""Device time a tick of the latent attention inside the graph replay (the
nodes of every ``model.mla`` section: each block's norm, projections, RoPE
and flash attention; within the stack's), in microseconds; nothing where
the stack has no latent attention."""

from ._ticks import section_us


def read(ctx):
    return section_us(ctx, "model.mla")
