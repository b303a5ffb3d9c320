"""Device time a tick of the action head inside the graph replay (the
nodes of the program's ``model.head`` section: the noise draws, the
contexts, the reverse loop), in microseconds."""

from ._ticks import section_us


def read(ctx):
    return section_us(ctx, "model.head")
