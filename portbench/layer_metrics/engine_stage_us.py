"""Host time a tick of the engine's staging (the program's
``engine.stage_in`` and ``engine.stage_out`` spans: the frames to the
card and into the graph's buffers, the copy of the actions out of it), in
microseconds."""

from ._ticks import span_us


def read(ctx):
    return span_us(ctx, ("engine.stage_in", "engine.stage_out"))
