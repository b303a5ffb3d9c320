"""Device time a tick of the ToMe merges inside the graph replay (the
nodes of every ``model.merge`` section, within the stack's), in
microseconds; nothing where the stack merges nothing."""

from ._ticks import section_us


def read(ctx):
    return section_us(ctx, "model.merge")
