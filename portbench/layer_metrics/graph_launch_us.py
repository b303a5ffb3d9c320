"""Host time a tick of ``graph.replay()`` (the program's ``engine.launch``
span), in microseconds: the submission of the graph's nodes, during which
the card waits at the head of a tick."""

from ._ticks import LAUNCH, span_us


def read(ctx):
    return span_us(ctx, (LAUNCH,))
