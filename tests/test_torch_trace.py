"""The port's tracing (``utils/profiling.py``: ``span``, ``section``, the
node plan and the registry) on the CPU, and the node plan of a captured
graph on the card.

A CPU engine serves eagerly: each call is one ``engine.call`` holding one
``engine.eager``, which holds the model's sections, with one
``model.merge`` for each ToMe compression event.  With no profiler session
``span`` is the shared null context and ``record_function`` is never
entered.  The node plan's bookkeeping runs here under a faked capture
count; the card test holds a captured graph's plan against the device
records of its replay.  The card test is marked ``cuda`` and runs with
``python -m pytest --noconftest -m cuda tests/test_torch_trace.py``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multi_modal_transformers_tokenmerge_torch.core.hw import on_cuda
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
from multi_modal_transformers_tokenmerge_torch.models.presets import (
    octo_base, octo_deep)
from multi_modal_transformers_tokenmerge_torch.serve.policy import (
    PolicyEngine)
from multi_modal_transformers_tokenmerge_torch.utils import profiling as P

BATCH = 2


def tiny(preset, **transformer):
    """``preset`` at 64 wide on two 112x112 frames of 28-px patches (16
    image tokens a frame), a 2-layer T5 and an 8-step diffusion head;
    ``transformer`` overrides its transformer's fields."""
    cfg = preset()
    return cfg.replace(
        input_sequence="[TaskDescriptionPrefix{16}] [Image{16};Readout{4}]*2",
        compression_sequence=(cfg.compression_sequence and
                              "[TaskDescriptionPrefix{0}] "
                              "[Image{4};Readout{0}]*2"),
        token_embedding_dim=64,
        text=cfg.text.replace(vocab_size=100, embedding_dim=64,
                              t5_num_layers=2, t5_num_heads=2, t5_d_kv=32,
                              t5_d_ff=128),
        images=cfg.images.replace(
            image_size=(112, 112, 3), patch_size=28, embedding_dim=64,
            resnet=cfg.images.resnet.replace(features=8, group_norm_groups=4,
                                             output_features=64)),
        transformer=cfg.transformer.replace(
            attention=cfg.transformer.attention.replace(num_heads=2,
                                                        qkv_features=64),
            mlp_dim=128, **transformer),
        heads=cfg.heads.replace(diffusion=cfg.heads.diffusion.replace(
            diffusion_steps=8, time_dim=64, mlp_dim=64)))


# (configuration, ToMe compression events of one forward)
CONFIGS = {
    "octo_base": (lambda: tiny(octo_base), 0),
    "tome_staged": (lambda: tiny(octo_deep, num_blocks=6,
                                 tome_merge_every=2), 2),
    "tome_layers": (lambda: tiny(octo_deep, num_blocks=2,
                                 tome_merge_every=1), 2),
}


def engine(name, device="cpu"):
    cfg = CONFIGS[name][0]()
    eng = PolicyEngine(Octo(cfg, device=device, seed=0), batch_size=BATCH,
                       seed=1)
    eng.compile((cfg.text.max_length,),
                (cfg.num_observation_blocks, *cfg.images.image_size))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.text.vocab_size, (cfg.text.max_length,))
    frames = torch.from_numpy(rng.integers(
        0, 256, (BATCH, cfg.num_observation_blocks, *cfg.images.image_size),
        dtype=np.uint8))
    eng.set_instruction(ids)
    return eng, ids, frames


def annotations(prof):
    """(name, start, end) of every span of a finished session, in start
    order."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()), key=lambda a: a[1])


def within(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


@pytest.fixture(autouse=True)
def registry():
    P.REGISTRY.clear()
    yield P.REGISTRY
    P.REGISTRY.clear()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_each_call_is_one_engine_call_over_the_model_sections(name):
    eng, ids, frames = engine(name)
    events = CONFIGS[name][1]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng(frames)
        eng(frames, text_tokens=ids)
    spans = annotations(prof)
    calls = [s for s in spans if s[0] == "engine.call"]
    assert len(calls) == 2
    for call, full in zip(calls, (False, True)):
        inside = [s for s in spans if within(s, call) and s is not call]
        eager = [s for s in inside if s[0] == "engine.eager"]
        assert len(eager) == 1
        names = [s[0] for s in inside if within(s, eager[0])]
        assert names.count("model.image") == 1
        assert names.count("model.stack") == 1
        assert names.count("model.head") == 1
        assert names.count("model.text") == (1 if full else 0)
        assert names.count("model.merge") == events
        stack = [s for s in inside if s[0] == "model.stack"][0]
        assert all(within(s, stack) for s in inside if s[0] == "model.merge")
        assert not {"engine.stage_in", "engine.launch",
                    "engine.stage_out"} & set(names)


def test_without_a_session_span_enters_nothing(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    eng, ids, frames = engine("tome_staged")
    assert P.span("engine.call", 1) is P._OFF
    assert P.section("model.stack") is P._OFF
    eng(frames)
    eng(frames, text_tokens=ids)


class Counter:
    """A faked capture: ``count()`` is the device nodes captured so far."""

    def __init__(self):
        self.n = 0

    def add(self, k):
        self.n += k

    def __call__(self):
        return self.n


def test_node_plan_ranges_nesting_and_remainder(registry):
    nodes = Counter()
    nodes.add(5)                        # before the plan: not counted
    with P.node_plan("cached", nodes):
        nodes.add(1)                    # outside every section
        with P.section("model.image"):
            nodes.add(3)
        with P.section("model.stack"):
            nodes.add(2)
            with P.section("model.merge"):
                nodes.add(4)
            nodes.add(1)
            with P.section("model.merge"):
                pass
        with P.section("model.head"):
            nodes.add(2)
        nodes.add(1)
    plan = registry.plans["cached"]
    assert plan.total == 14
    assert plan.entries == (("model.image", 1, 3), ("model.stack", 4, 7),
                            ("model.merge", 6, 4), ("model.merge", 11, 0),
                            ("model.head", 11, 2))
    assert plan.nodes("model.merge") == {6, 7, 8, 9}
    assert plan.outside() == 2
    # after the capture a section is a span again
    assert P.section("model.head") is P._OFF


def test_node_plan_through_an_exception(registry):
    nodes = Counter()
    with P.node_plan("full", nodes):
        with pytest.raises(ValueError):
            with P.section("model.text"):
                nodes.add(2)
                raise ValueError
        nodes.add(1)
    assert registry.plans["full"] == P.NodePlan((("model.text", 0, 2),), 3)
    with pytest.raises(ValueError):
        with P.node_plan("cached", nodes):
            with P.section("model.image"):
                raise ValueError
    assert "cached" not in registry.plans
    assert P.section("model.image") is P._OFF
    # no counter (no runtime to read): nothing is recorded
    with P.node_plan("cached", None):
        assert P.section("model.image") is P._OFF
    assert "cached" not in registry.plans


class FakeGraph:
    """Stands for a captured graph on the CPU: a replay doubles the
    input."""

    def __init__(self, source, out):
        self.source, self.out = source, out

    def replay(self):
        self.out.copy_(self.source[:, :1].float().mean(dim=(1, 2, 3, 4))
                       [:, None].expand_as(self.out) * 2)


def test_route_counters_and_replay_spans(registry):
    eng, ids, frames = engine("octo_base")
    eng(frames)
    eng(frames, text_tokens=ids)
    # every run of the image tower, compile()'s two on the CPU included,
    # counts its two residual blocks' norms, here on the plain chain
    assert registry.counters == {"engine.eager_calls": 2,
                                 "image.norm_plain": 8}
    s_text = eng._text_embeddings.clone()
    s_images = torch.zeros(frames.shape)
    out = torch.zeros(BATCH, 8)
    eng._graphs["cached"] = (FakeGraph(s_images, out), (s_text, s_images),
                             out)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = eng(frames)
    assert torch.equal(got, frames[:, :1].float().mean(dim=(1, 2, 3, 4))
                       [:, None].expand(BATCH, 8) * 2)
    assert got is not out
    eng(frames, text_tokens=ids)         # no full graph: eager
    eng(frames, noisy=torch.zeros(BATCH, 8))    # own draws: eager
    assert registry.counters == {"engine.eager_calls": 4,
                                 "engine.replays": 1,
                                 "image.norm_plain": 12}
    spans = annotations(prof)
    assert [s[0] for s in spans] == ["engine.call", "engine.stage_in",
                                     "engine.launch", "engine.stage_out"]
    assert all(within(s, spans[0]) for s in spans)
    assert spans[1][2] <= spans[2][1] and spans[2][2] <= spans[3][1]


@pytest.fixture
def card():
    if not torch.cuda.is_available() or not on_cuda(
            torch.empty(0, device="cuda")):
        pytest.skip("needs an sm_90 CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["octo_base", "tome_staged"])
def test_plan_matches_the_replays_device_records(card, name, registry):
    """The plan counts the graph's device nodes: one replay's device
    records number its total, no node was added for it, and the cached
    path's sections cover every node."""
    eng, ids, frames = engine(name, card)
    cached, full = registry.plans["cached"], registry.plans["full"]
    assert {s for s, _, _ in cached.entries} == (
        {"model.image", "model.stack", "model.head"}
        | ({"model.merge"} if CONFIGS[name][1] else set()))
    assert cached.outside() == 0
    assert full.total == cached.total + len(full.nodes("model.text"))
    graph = eng._graphs["cached"][0]
    warm = torch.zeros(8, device=card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(256):             # the guard: takes any lost records
            warm.erfinv_()
        torch.cuda.synchronize()
        with torch.profiler.record_function("replay"):
            graph.replay()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    launch = [e for e in events if e.name() == "cudaGraphLaunch"]
    assert len(launch) == 1
    device = [e for e in events
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation()
              and e.correlation_id() == launch[0].correlation_id()]
    assert len(device) == cached.total
