"""The grouped expert kernels and the ``octo_moonlight`` stack on the card.
Marked ``cuda``; they skip where there is no sm_90 card and run on one
with ``python -m pytest -m cuda tests/test_torch_moonlight_card.py``.

Tolerance of the kernels against their plain version: both round at the
same points (the SwiGLU rows, each weighted row, the sum) from float32
products of the same bf16 operands; they differ where a float32 sum in
another order lands on the other side of a bf16 rounding, one bf16 ulp
(2^-8 relative) of an intermediate, which the next product averages out:
well under 2^-8 of the output's norm."""

import numpy as np
import pytest
import torch

from multi_modal_transformers_tokenmerge_torch import (Octo, PolicyEngine,
                                                       load_config)
from multi_modal_transformers_tokenmerge_torch.core.hw import on_cuda
from multi_modal_transformers_tokenmerge_torch.ops.grouped_experts import (
    grouped_experts, grouped_experts_reference)
from multi_modal_transformers_tokenmerge_torch.serve.policy import (
    serving_copy)
from multi_modal_transformers_tokenmerge_torch.utils.profiling import REGISTRY

TOL = 2.0 ** -10


@pytest.fixture
def card():
    if not torch.cuda.is_available() or not on_cuda(
            torch.empty(0, device="cuda")):
        pytest.skip("needs an sm_90 CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(card, routing, t=1792, d=2048, f=1408, e=64, k=6, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn(t, d, generator=g, device=card).to(bf)
    wgu = (torch.randn(e, 2 * f, d, generator=g, device=card)
           / d ** 0.5).to(bf)
    wd = (torch.randn(e, d, f, generator=g, device=card) / f ** 0.5).to(bf)
    shared = torch.randn(t, d, generator=g, device=card).to(bf)
    scores = torch.rand(t, e, generator=g, device=card)
    if routing == "skewed":
        # a few experts take most tokens, most see few or none
        scores = scores * torch.logspace(0, -3, e, device=card)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    experts = order[:, :k]
    if routing == "single":
        experts = torch.arange(k, device=card).expand(t, k).contiguous()
    weights = torch.rand(t, k, generator=g, device=card)
    return x, wgu, wd, weights, experts, shared


@pytest.mark.cuda
@pytest.mark.parametrize("routing", ["uniform", "skewed", "single"])
@pytest.mark.parametrize("tokens", [1792, 768])
def test_grouped_kernel_matches_plain_at_moonlight_widths(card, routing,
                                                          tokens):
    args = _case(card, routing, t=tokens)
    got = grouped_experts(*args)
    torch.cuda.synchronize()
    want = grouped_experts_reference(*args)
    err = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert err < TOL, err
    assert torch.equal(got, grouped_experts(*args))


@pytest.mark.cuda
def test_captured_replay_equals_eager_twin(card):
    """octo_moonlight at its widths and 4 blocks (1 dense, 3 routed, a merge
    after 2): the compiled engine's replays equal the eager engine's calls
    on the same seed bit for bit, and every capture took the kernels."""
    cfg = load_config("octo_moonlight", ["transformer.num_blocks=4",
                                         "transformer.tome_merge_every=2"])
    model = Octo(cfg, device=card, seed=0)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 32128, 16))
    shape = (8, 2, 280, 280, 3)
    REGISTRY.counters.clear()
    compiled = PolicyEngine(model, batch_size=8, seed=5)
    compiled.set_instruction(ids)
    compiled.compile((16,), shape[1:])
    # two paths, each an eager run and a capture, 3 routed layers each
    assert REGISTRY.counters["moe.grouped_kernel"] == 2 * 2 * 3
    assert REGISTRY.counters["moe.plain"] == 0
    eager = PolicyEngine(model, batch_size=8, seed=5)
    eager.set_instruction(ids)
    for i in range(3):
        images = torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8))
        got, want = compiled(images), eager(images)
        assert torch.isfinite(want).all()
        assert torch.equal(got, want), i
    assert REGISTRY.counters["engine.replays"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("preset,overrides,one_copy", [
    ("octo_deep", ["dtype=bfloat16"], False),
    ("octo_moonlight", ["transformer.num_blocks=2"], True)])
def test_serving_copy_peak(card, preset, overrides, one_copy):
    """float32 parameters served in bfloat16: the copy's peak is one float32
    copy of the model (its deep copy) and one cast at a time, as before; a
    bfloat16 model's copy allocates no weight (its buffers alone)."""
    model = Octo(load_config(preset, overrides), device=card, seed=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    copy = serving_copy(model)
    peak = torch.cuda.max_memory_allocated() - base
    tensors = list(model.parameters()) + list(model.buffers())
    whole = sum(t.numel() * t.element_size() for t in tensors)
    largest = max(p.numel() * 2 for p in model.parameters())
    # the allocator rounds each block up to 512 bytes
    slack = 512 * 2 * len(tensors) + 2**20
    buffers = sum(b.numel() * b.element_size() for b in copy.buffers())
    if one_copy:
        assert peak <= buffers + slack, (peak, buffers)
    else:
        assert peak <= whole + largest + slack, (peak, whole, largest)
