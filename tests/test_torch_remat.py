"""``cfg.remat`` in the port's two stacks, and the generator replay it
rests on (``core/replay.py``), on the CPU.

* Remat against remat off, in the port: one train step of a micro Octo
  with every dropout at 0.1 (the flash cases draw their attention dropout
  inside the kernels' plain versions), from the same weights and
  generator seeds: the loss, every gradient and the generators' final
  states are equal bit for bit, and each block ran twice (its forward and
  its recompute).  The plain stack, the ToMe stack in both cadences, merge
  and prune, and the MoE MLP, whose balance loss is an output of the
  recomputed call and counts once.
* Remat against the JAX stacks' ``nn.remat``: the same keep mask per
  shape in both packages (as ``test_torch_train``'s dropout tests), the
  loss within ``LOSS_RTOL`` relative and every gradient within
  ``GRAD_TOL`` of its leaf's largest value (``test_torch_train``'s
  tolerances).
"""

import numpy as np
import pytest
import torch

from test_torch_moe import _moe
from test_torch_train import (GRAD_TOL, LOSS_RTOL, RecordingOptimizer,
                              _assert_grads_close, _draws,
                              _jax_loss_and_grads, _port_draws, _shape_mask)
from torch_parity import (inputs, micro_pair, octo_micro_t5,
                          octo_micro_tome_layers, octo_micro_tome_staged,
                          to_torch_config)
from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.core import replay
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_torch.modules import layers
from multi_modal_transformers_tokenmerge_torch.train import state as tstate
from multi_modal_transformers_tokenmerge_torch.train import steps as tsteps

assert (LOSS_RTOL, GRAD_TOL) == (1e-5, 1e-4)

FLASH = dict(attention_impl="flash", flash_backward="pallas")
CASES = {
    "plain": (octo_micro_t5, {}),
    "plain_flash": (octo_micro_t5, FLASH),
    "plain_moe": (lambda: _moe(octo_micro_t5), {}),
    "layers_merge": (octo_micro_tome_layers, {}),
    "layers_prune_prestack": (lambda: octo_micro_tome_layers(
        compression_mode="prune", prestack_merge=True), {}),
    "layers_moe": (lambda: _moe(octo_micro_tome_layers), {}),
    "staged": (octo_micro_tome_staged, {}),
    "staged_flash": (octo_micro_tome_staged, FLASH),
    "staged_moe": (lambda: _moe(octo_micro_tome_staged), {}),
}


def _model(jcfg, remat, **transformer):
    tc = to_torch_config(jcfg)
    tc = tc.replace(transformer=tc.transformer.replace(remat=remat,
                                                       **transformer))
    return TOcto(tc, device="cpu", seed=0)


def _blocks(model):
    t = model.transformer
    if hasattr(t, "blocks"):
        return list(t.blocks)
    if t.num_stages == 0:
        return [getattr(t, f"block_{i}") for i in range(t.cfg.num_blocks)]
    return [b for i in range(t.num_stages) for b in getattr(t, f"stage_{i}")]


def _step(jcfg, remat, transformer, batch, d):
    """One diffusion train step; (loss, gradients, generator states after,
    forward calls of each block, the MoE balance loss)."""
    model = _model(jcfg, remat, **transformer)
    calls = [0] * len(_blocks(model))
    for i, blk in enumerate(_blocks(model)):
        # a pre-hook: the recompute stops once it has remade what the
        # backward needs, before the block returns
        blk.register_forward_pre_hook(
            lambda m, a, i=i: calls.__setitem__(i, calls[i] + 1))
    rec = RecordingOptimizer()
    state = tstate.create_train_state(model, rec, rngs=3)
    state, loss = tsteps.make_train_step("diffusion")(
        state, *batch, draws=_port_draws(d))
    aux = model.moe_aux_loss()
    return (loss, rec.grads[0], {n: g.get_state() for n, g in
                                 state.rngs.items()}, calls, aux)


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_equals_remat_off(case):
    make, transformer = CASES[case]
    jcfg = make()
    assert jcfg.transformer.attention.dropout_rate == 0.1
    assert jcfg.transformer.dropout_rate == 0.1
    b = 2
    ids, images = inputs(jcfg, batch=b, frames=2, seed=60)
    actions = np.random.default_rng(61).uniform(-1, 1, (b, 4)).astype(
        np.float32)
    batch = (torch.tensor(ids).long(), torch.tensor(images),
             torch.tensor(actions))
    d = _draws(jcfg, b, 62)
    off = _step(jcfg, False, transformer, batch, d)
    on = _step(jcfg, True, transformer, batch, d)
    assert torch.equal(on[0], off[0])
    assert set(on[1]) == set(off[1])
    for name, g in off[1].items():
        if g is None:
            assert on[1][name] is None, name
        else:
            assert torch.equal(on[1][name], g), name
    for name, st in off[2].items():
        assert torch.equal(on[2][name], st), name
    assert off[3] == [1] * len(off[3])
    assert on[3] == [2] * len(on[3])
    if "moe" in case:
        assert off[4] is not None and torch.equal(on[4], off[4])
    else:
        assert off[4] is None and on[4] is None


def test_remat_is_a_plain_call_without_gradients():
    """Serving (no gradients) runs each block once, remat or not."""
    jcfg = octo_micro_tome_layers()
    model = _model(jcfg, True).eval()
    calls = []
    for blk in _blocks(model):
        blk.register_forward_pre_hook(lambda *a: calls.append(1))
    ids, images = inputs(jcfg, batch=2, frames=2, seed=63)
    with torch.no_grad():
        model.predict_continuous_action(torch.tensor(ids).long(),
                                        torch.tensor(images))
    assert len(calls) == len(_blocks(model))


@pytest.mark.parametrize("make", [octo_micro_t5, octo_micro_tome_layers,
                                  octo_micro_tome_staged],
                         ids=["plain", "layers", "staged"])
def test_remat_matches_jax_remat(monkeypatch, make):
    """``remat=True`` in both packages, every dropout at 0.1 with the same
    keep mask per shape: the continuous loss and its gradients agree (the
    recomputes of both draw the forward's masks again)."""
    base = make()
    jcfg = base.replace(transformer=base.transformer.replace(remat=True))
    jm, v, tm = micro_pair(jcfg)
    assert tm.config.transformer.remat
    b = 2
    ids, images = inputs(jcfg, batch=b, frames=2, seed=64)
    actions = np.random.default_rng(65).uniform(-1, 1, (b, 4)).astype(
        np.float32)
    d = _draws(jcfg, b, 66)
    j_loss, j_grads = _jax_loss_and_grads(
        monkeypatch, jm, v["params"], ids, images, actions, d, _shape_mask,
        method="compute_l2_loss")
    rec = RecordingOptimizer()
    state = tstate.create_train_state(tm, rec, rngs=0)
    sites = []
    monkeypatch.setattr(layers, "keep_mask",
                        lambda shape, p, g, device: sites.append(shape) or
                        torch.from_numpy(_shape_mask(shape)))
    state, loss = tsteps.make_train_step("continuous")(
        state, torch.tensor(ids).long(), torch.tensor(images),
        torch.tensor(actions),
        draws={"positions": _port_draws(d)["positions"]})
    # four dropout sites a block, drawn in the forward and the recompute
    assert len(sites) == 2 * 4 * jcfg.transformer.num_blocks
    assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    want = convert.from_flax(j_grads, tm.config)
    got = {n: g for n, g in rec.grads[0].items() if g is not None}
    _assert_grads_close(got, {n: want[n] for n in got})


def test_checkpointed_replays_explicit_generators():
    """``checkpointed`` on a function that draws from two explicit
    generators: the gradient is that of the plain call on the same draws,
    the recompute drew the same masks, and the generators end where the
    plain call leaves them."""
    def fn(x, g1, g2, masks):
        m1 = torch.rand(x.shape, generator=g1) < 0.5
        m2 = torch.rand(x.shape, generator=g2) < 0.7
        masks.append((m1, m2))
        return (x * m1).sin() * (x * m2).cos()

    x0 = torch.randn(5, 7, dtype=torch.float64)
    results = []
    for remat in (False, True):
        g1 = torch.Generator().manual_seed(1)
        g2 = torch.Generator().manual_seed(2)
        masks = []
        x = x0.clone().requires_grad_(True)
        if remat:
            y = replay.checkpointed(lambda t: fn(t, g1, g2, masks), [g1, g2],
                                    x)
        else:
            y = fn(x, g1, g2, masks)
        (grad,) = torch.autograd.grad(y.square().sum(), x)
        results.append((grad, masks, g1.get_state(), g2.get_state()))
    (g_off, m_off, s1, s2), (g_on, m_on, t1, t2) = results
    assert torch.equal(g_on, g_off)
    assert len(m_off) == 1 and len(m_on) == 2
    for a, b in zip(m_on[1], m_off[0]):
        assert torch.equal(a, b)
    assert torch.equal(t1, s1) and torch.equal(t2, s2)


def test_replayed_restores_the_generators():
    g = torch.Generator().manual_seed(5)
    saved = g.get_state()
    first = torch.rand(3, generator=g)
    later = g.get_state()
    with replay.replayed([g], [saved]):
        assert torch.equal(torch.rand(3, generator=g), first)
    assert torch.equal(g.get_state(), later)
