"""Device time a tick of the image tokenizer inside the graph replay (the
nodes the program's ``model.image`` section added at capture), in
microseconds."""

from ._ticks import section_us


def read(ctx):
    return section_us(ctx, "model.image")
