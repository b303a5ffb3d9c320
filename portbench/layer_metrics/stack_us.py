"""Device time a tick of the transformer stack inside the graph replay
(the nodes of the program's ``model.stack`` section: readouts, assembly,
the blocks, the ToMe merges, the readout select), in microseconds."""

from ._ticks import section_us


def read(ctx):
    return section_us(ctx, "model.stack")
