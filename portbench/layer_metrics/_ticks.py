"""The engine's ticks in a traced window, split by the program's own spans
and by the node plans of its graphs (the port's ``utils.profiling``).

A tick is one ``engine.call`` span; its host records are those that start
between its start and the next call's (the window's end for the last).
The loop is closed and every tick ends in a copy to the host, which
waits for the device, so no tick's device work runs into the next's.

A graph replay runs none of the model's Python, so the model's sections
leave no span in it.  The engine's capture recorded instead which graph
nodes each section added (``REGISTRY.plans``: ``(section, first node,
node count)`` entries and the graph's ``total`` of device nodes).  The
profiler's device clock was seen to sit apart from the host's by 100 us
and more in some sessions, so the graph's records are found on the
device's timeline alone.  On one stream a replayed tick's device records
come in the order of its device-issuing runtime calls: the calls made
before the graph's launch (the staging copies of ``engine.stage_in``, and
the fills by which a replay hands the registered generators' seed and
offset to the graph), the graph's ``total`` records in capture order, the
calls after it (the copies out).  A graph's run is where the kinds of the
records around it (copy, set or kernel) are those of the calls around
the launch in the host's replayed ticks, and the records before and after
those are the end and the start of the runs next to it (or the
timeline's ends): a tick that lost a record shows no run, and the tick
beside it none where the lost record was one of those around the graph.
The plan read is the one whose total finds most runs.  Where the program keeps no plan, or the runs found
number fewer than ``MIN_SHARE`` of the window's ticks, a reader finds
nothing.
"""

import bisect
import collections
import re

CALL = "engine.call"
LAUNCH = "engine.launch"
GRAPH_LAUNCH = "cudaGraphLaunch"
# host runtime calls that each put one record on the device's timeline,
# the graph's launch standing for its nodes
ISSUING = re.compile(
    r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset"
    r"|GraphLaunch)")
MIN_SHARE = 0.9


def plans():
    """The program's node plans; none where the program keeps none."""
    try:
        from multi_modal_transformers_tokenmerge_torch.utils.profiling \
            import REGISTRY
    except ImportError:
        return []
    return list(REGISTRY.plans.values())


def ticks(ctx):
    """(call span, its host records in start order) of every tick of the
    window."""
    by_start = lambda r: r.start_ns
    calls = sorted((r for r in ctx.records
                    if not r.device and r.name == CALL), key=by_start)
    host = sorted((r for r in ctx.records if not r.device), key=by_start)
    starts = [r.start_ns for r in host]
    edges = [c.start_ns for c in calls] + [ctx.end_ns]
    return [(call, host[bisect.bisect_left(starts, lo):
                        bisect.bisect_left(starts, hi)])
            for call, lo, hi in zip(calls, edges, edges[1:])]


def span_us(ctx, names):
    """Mean host time a replayed tick of the spans ``names``, in
    microseconds; None where no tick replayed a graph."""
    per_tick = []
    for call, host in ticks(ctx):
        inside = [r for r in host if r.end_ns <= call.end_ns]
        if any(r.name == LAUNCH for r in inside):
            per_tick.append(sum(r.end_ns - r.start_ns for r in inside
                                if r.name in names))
    if not per_tick:
        return None
    return sum(per_tick) / len(per_tick) * 1e-3


def kind(name):
    """What a runtime call puts on the device, or what a device record
    is: 'copy', 'set' or 'kernel'."""
    for word, what in (("Memcpy", "copy"), ("Memset", "set")):
        if name.startswith((word, "cuda" + word, "cu" + word)):
            return what
    return "kernel"


def structure(window):
    """(kinds of the calls before the graph's launch, of those after it)
    of the replayed ticks, the most common; None where no tick replayed
    a graph."""
    shapes = collections.Counter()
    for _, host in window:
        issuing = [r for r in host if ISSUING.match(r.name)]
        at = [i for i, r in enumerate(issuing) if r.name == GRAPH_LAUNCH]
        if len(at) == 1:
            shapes[(tuple(kind(r.name) for r in issuing[:at[0]]),
                    tuple(kind(r.name) for r in issuing[at[0] + 1:]))] += 1
    return shapes.most_common(1)[0][0] if shapes else None


def graph_records(total, kinds, device, before, after):
    """The device records of every run of a graph of ``total`` nodes, in
    capture order; ``device`` in start order, ``kinds`` theirs."""
    b, a = len(before), len(after)
    n = b + total + a
    runs, p = [], 0
    while p + n <= len(device):
        if (tuple(kinds[p:p + b]) == before
                and tuple(kinds[p + b + total:p + n]) == after
                and (p == 0 or tuple(kinds[p - a:p]) == after)
                and (p + n == len(device)
                     or tuple(kinds[p + n:p + n + b]) == before)):
            runs.append(device[p + b:p + b + total])
            p += n
        else:
            p += 1
    return runs


def counted(ctx):
    """(plan, the graph records of each run found), or None."""
    window = ticks(ctx)
    shape = structure(window)
    if shape is None:
        return None
    device = sorted(ctx.device(), key=lambda r: r.start_ns)
    kinds = [kind(r.name) for r in device]
    found = [(graph_records(p.total, kinds, device, *shape), p)
             for p in plans()]
    if not found:
        return None
    kept, plan = max(found, key=lambda f: len(f[0]))
    if len(kept) < MIN_SHARE * len(window):
        return None
    return plan, kept


def section_us(ctx, name):
    """Mean device time a tick of the graph nodes that the sections
    ``name`` added, in microseconds; None where too few runs are found or
    no section of that name added a node."""
    found = counted(ctx)
    if found is None:
        return None
    plan, kept = found
    nodes = sorted({i for section, first, n in plan.entries
                    if section == name for i in range(first, first + n)})
    if not nodes:
        return None
    spent = sum(t[i].end_ns - t[i].start_ns for t in kept for i in nodes)
    return spent / len(kept) * 1e-3
