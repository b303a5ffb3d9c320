"""Device time a tick of the routed expert layers inside the graph replay
(the nodes of every ``model.moe`` section: router, sort, both grouped
products, combine, shared experts; within the stack's), in microseconds;
nothing where the stack routes no expert."""

from ._ticks import section_us


def read(ctx):
    return section_us(ctx, "model.moe")
