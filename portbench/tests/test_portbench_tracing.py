"""The readers of the program's spans and node plans, on synthetic traced
windows: each reader's value, a tick that lost a record left out, nothing
below 90% of the ticks counted or without a plan, the device's records
placed back where its clock sits apart from the host's, and the plan read
being the one the ticks match."""

import importlib

import pytest

from multi_modal_transformers_tokenmerge_torch.utils.profiling import (
    REGISTRY, NodePlan)
from portbench.harness import TraceContext
from portbench.profiling import Record

U = 100                 # ns a unit of the synthetic timeline
TICK_NS = 60_000 * U
# the graph: 2 image nodes, 4 stack nodes holding 1 merge node, 2 head
# nodes
PLAN = NodePlan((("model.image", 0, 2), ("model.stack", 2, 4),
                 ("model.merge", 3, 1), ("model.head", 6, 2)), 8)
# the full path's graph: the text tower's 3 nodes first
FULL = NodePlan((("model.text", 0, 3),) + tuple(
    (s, first + 3, n) for s, first, n in PLAN.entries), 11)


def tick(i, nodes=8, lost=None, copies=()):
    """One replayed tick's records: three staging copies, the launch (two
    fills of the generators' seed and offset, then the graph's), the
    graph's ``nodes`` records (node k takes (k + 1) * (i + 1) units), the copy
    of the output and the copy to the host; the graph's nodes ``copies``
    are copies; the device record ``lost`` (its index among them)
    dropped."""
    t = i * TICK_NS
    host = lambda name, a, b: Record(name, t + a * U, t + b * U, False)
    dev = lambda name, a, b: Record(name, t + a * U, t + b * U, True)
    records = [
        host("fleet_tick.call", 0, 60_000),
        host("engine.call", 10, 50_000),
        host("engine.stage_in", 100, 1_100),
        host("cudaMemcpyAsync", 200, 300),
        host("cudaStreamSynchronize", 300, 900),
        host("cudaMemcpyAsync", 920, 950),
        host("cudaLaunchKernel", 960, 990),
        host("engine.launch", 1_100, 1_100 + 300 * (i + 1)),
        host("cudaLaunchKernel", 1_102, 1_104),
        host("cudaLaunchKernel", 1_105, 1_107),
        host("cudaGraphLaunch", 1_110, 1_000 + 300 * (i + 1)),
        host("engine.stage_out", 40_000, 40_000 + 20 * (i + 1)),
        host("cudaMemcpyAsync", 40_005, 40_010),
        host("cudaMemcpyAsync", 55_000, 55_100),
        host("cudaStreamSynchronize", 55_100, 59_000),
        dev("Memcpy HtoD (Pinned -> Device)", 250, 850),
        dev("Memcpy DtoD (Device -> Device)", 1_000, 1_010),
        dev("elementwise_kernel", 1_020, 1_090),
        dev("fill_kernel", 1_500, 1_510),
        dev("fill_kernel", 1_600, 1_610),
    ]
    start = 2_000
    for k in range(nodes):
        name = "Memcpy DtoD (Device -> Device)" if k in copies else f"n{k}"
        records.append(dev(name, start, start + (k + 1) * (i + 1)))
        start += 1_000
    records += [dev("Memcpy DtoD (Device -> Device)", 41_000, 41_010),
                dev("Memcpy DtoH (Device -> Pageable)", 55_050, 55_090)]
    if lost is not None:
        records.remove([r for r in records if r.device][lost])
    return records


GRAPH_FIRST, COPY_IN = 5, 0     # device records a tick may lose


def window(ticks=20, lost=(), nodes=8, shift=0, copies=(), at=GRAPH_FIRST):
    """A window of ``ticks`` ticks; ticks in ``lost`` lost their device
    record ``at``; every device record ``shift`` ns later."""
    records = [Record("portbench.window", 0, ticks * TICK_NS, False)]
    for i in range(ticks):
        records += tick(i, nodes, at if i in lost else None, copies)
    records = [Record(r.name, r.start_ns + shift, r.end_ns + shift, True)
               if r.device else r for r in records]
    return TraceContext(records, 0, ticks * TICK_NS, ticks, {})


def node_us(ticks, nodes):
    """Mean device time a tick, in us, of graph nodes ``nodes`` over
    ``ticks``."""
    return sum((k + 1) * (i + 1) * U for i in ticks for k in nodes) \
        / len(ticks) * 1e-3


@pytest.fixture(autouse=True)
def plans():
    REGISTRY.clear()
    REGISTRY.plans["cached"] = PLAN
    yield REGISTRY.plans
    REGISTRY.clear()


def read(name, ctx):
    return importlib.import_module(
        f"portbench.layer_metrics.{name}").read(ctx)


ALL = range(20)
SECTIONS = {"image_tower_us": [0, 1], "stack_us": [2, 3, 4, 5],
            "merge_us": [3], "head_us": [6, 7]}


@pytest.mark.parametrize("copies", [(), (0, 1), (3, 4), (6, 7)])
@pytest.mark.parametrize("name", sorted(SECTIONS))
def test_section_readers(name, copies):
    """Copies among the graph's nodes, as the captured graphs hold, where
    they could be taken for the copies around it."""
    assert read(name, window(copies=copies)) == pytest.approx(
        node_us(ALL, SECTIONS[name]))


def test_span_readers():
    ctx = window()
    assert read("graph_launch_us", ctx) == pytest.approx(
        sum(300 * (i + 1) * U for i in ALL) / 20 * 1e-3)
    assert read("engine_stage_us", ctx) == pytest.approx(
        sum((1_000 + 20 * (i + 1)) * U for i in ALL) / 20 * 1e-3)


@pytest.mark.parametrize("at,left_out", [(GRAPH_FIRST, {7}),
                                         (COPY_IN, {6, 7})])
@pytest.mark.parametrize("name", sorted(SECTIONS))
def test_a_tick_that_lost_a_record_is_left_out(name, at, left_out):
    """A tick that lost its copy in leaves the tick before it without the
    start of the next run it needs."""
    kept = [i for i in ALL if i not in left_out]
    assert read(name, window(lost={7}, at=at)) == pytest.approx(
        node_us(kept, SECTIONS[name]))


@pytest.mark.parametrize("name", sorted(SECTIONS))
def test_nothing_below_nine_tenths_of_the_ticks(name):
    assert read(name, window(lost={1, 2})) is not None      # 18 of 20
    assert read(name, window(lost={1, 2, 3})) is None       # 17 of 20


@pytest.mark.parametrize("name", sorted(SECTIONS))
def test_nothing_without_a_plan(name, plans):
    plans.clear()
    assert read(name, window()) is None


@pytest.mark.parametrize("shift_us", [-1_500, -460, -30, 4, 120, 1_900])
def test_a_device_clock_apart_from_the_hosts(shift_us):
    """Shifted, a tick's span holds as many of its neighbour's records as
    it loses of its own (30 us earlier, its neighbour's copy in; 1.9 ms
    later, its neighbour's copies out); the runs are found on the device's
    timeline alone."""
    shift = shift_us * 1_000
    ctx = window(shift=shift, lost={4})
    for name, nodes in SECTIONS.items():
        assert read(name, ctx) == pytest.approx(
            node_us([i for i in ALL if i != 4], nodes)), name


def test_the_plan_the_ticks_match(plans):
    plans["full"] = FULL
    assert read("stack_us", window()) == pytest.approx(
        node_us(ALL, [2, 3, 4, 5]))
    # ticks of the full path's graph: its plan, its text nodes skipped
    assert read("stack_us", window(nodes=11)) == pytest.approx(
        node_us(ALL, [5, 6, 7, 8]))
    del plans["full"]
    assert read("stack_us", window(nodes=11)) is None


def test_a_plan_with_no_merge_gives_no_merge_time(plans):
    plans["cached"] = NodePlan(
        tuple(e for e in PLAN.entries if e[0] != "model.merge"), 8)
    assert read("merge_us", window()) is None
    assert read("stack_us", window()) is not None


def test_an_eager_tick_has_no_spans_to_read():
    records = [Record("engine.call", 10, 5_000, False),
               Record("engine.eager", 20, 4_000, False),
               Record("cudaLaunchKernel", 30, 40, False),
               Record("elementwise_kernel", 50, 60, True)]
    ctx = TraceContext(records, 0, TICK_NS, 1, {})
    for name in ("graph_launch_us", "engine_stage_us", "stack_us"):
        assert read(name, ctx) is None
