"""The port's mixture-of-experts MLP (``modules/moe.py``) against the JAX
package's, on the CPU in float32 with converted weights: the block alone,
the plain stack and both ToMe paths (per-layer and staged), forward and
backward, the pre-weighted balance loss the stacks hand back, the train
step that adds it, the weight conversion and the decay mask.

Tolerances: the block alone is held to the JAX MoE tests' (``tests/
test_moe.py:69,154``): 2e-5 on the forward, 1e-4 relative / 1e-5 absolute
on gradients.  A stack's forward and its balance loss are held to 2e-5
too, and its gradients, as the train step tests hold theirs,
each leaf within 1e-4 of its largest |gradient| (an element-wise 1e-5 is
below what two or four blocks of float32 reach: 1.3e-5 to 3.3e-5 was seen
on one element in a thousand).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (LOSS_RTOL, RecordingOptimizer,
                              _assert_grads_close, _draws, _inject_jax,
                              _inject_port, _jax_loss_and_grads, _no_dropout,
                              _port_draws)
from torch_parity import (MODULE_TOL, inputs, micro_pair,
                          octo_micro_t5, octo_micro_tome_layers,
                          octo_micro_tome_staged, to_torch_config)
from micro_configs import octo_micro
from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.core import config as tcfg
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_torch.modules import moe as tmoe
from multi_modal_transformers_tokenmerge_torch.train import optim as toptim
from multi_modal_transformers_tokenmerge_torch.train import state as tstate
from multi_modal_transformers_tokenmerge_torch.train import steps as tsteps
from multi_modal_transformers_tokenmerge_tpu.core.config import MoEConfig
from multi_modal_transformers_tokenmerge_tpu.modules import moe as jmoe
from multi_modal_transformers_tokenmerge_tpu.train import optim as joptim

FWD_TOL = MODULE_TOL            # 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


# -- the block ---------------------------------------------------------------

def _block_pair(cfg, d=8, mlp_dim=16, activation="relu", zero_router=False,
                seed=0):
    jm = jmoe.MoEMLPBlock(cfg, mlp_dim=mlp_dim, out_dim=d,
                          activation=activation)
    x = np.random.default_rng(seed).normal(size=(2, 12, d)).astype(
        np.float32)
    v = jax.tree.map(np.asarray,
                     jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    if zero_router:
        v["params"]["router"]["kernel"] = np.zeros_like(
            v["params"]["router"]["kernel"])
    tm = tmoe.MoEMLPBlock(tcfg.MoEConfig(**vars(cfg)), d, mlp_dim, d,
                          activation)
    p = v["params"]
    tm.load_state_dict({
        "router.weight": torch.tensor(p["router"]["kernel"].T),
        **{k: torch.tensor(p[k]) for k in ("expert_wi", "expert_bi",
                                           "expert_wo", "expert_bo")}})
    return jm, v, tm, x


BLOCK_CASES = {
    "top1": (MoEConfig(num_experts=4, top_k=1, capacity_factor=2.0), {}),
    "top2": (MoEConfig(num_experts=4, top_k=2, capacity_factor=1.0), {}),
    "top1_overflow": (MoEConfig(num_experts=4, top_k=1,
                                capacity_factor=0.4), {}),
    "top2_overflow_gelu": (MoEConfig(num_experts=3, top_k=2,
                                     capacity_factor=0.5),
                           {"activation": "gelu"}),
    # every expert ties: the lower index wins, as jax.lax.top_k
    "zero_router_top1": (MoEConfig(num_experts=4, top_k=1,
                                   capacity_factor=2.0),
                         {"zero_router": True}),
    "zero_router_top2": (MoEConfig(num_experts=4, top_k=2,
                                   capacity_factor=0.6),
                         {"zero_router": True}),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_matches_jax(case):
    cfg, kw = BLOCK_CASES[case]
    jm, v, tm, x = _block_pair(cfg, **kw)
    y_j, aux_j = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        y, aux = tm(torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=FWD_TOL)
    # the choices themselves, ties included
    probs = jax.nn.softmax(jnp.asarray(x) @ v["params"]["router"]["kernel"])
    _, idx_j = jax.lax.top_k(probs, cfg.top_k)
    _, _, _, sel = tm.route(torch.tensor(x))
    np.testing.assert_array_equal(sel.argmax(-1).numpy(), np.asarray(idx_j))
    if kw.get("zero_router"):
        assert float(aux) == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("case", ["top1", "top2_overflow_gelu",
                                  "zero_router_top2"])
def test_block_gradients_match_jax(case):
    cfg, kw = BLOCK_CASES[case]
    jm, v, tm, x = _block_pair(cfg, **kw)
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def loss_j(params, xx):
        y, aux = jm.apply({"params": params}, xx)
        return jnp.sum(y * g) + 0.01 * aux

    gp, gx = jax.grad(loss_j, argnums=(0, 1))(v["params"], jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y, aux = tm(xt)
    loss = (y * torch.tensor(g)).sum() + 0.01 * aux
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [xt] + [p for _, p in
                                              tm.named_parameters()])
    want = {"router.weight": np.asarray(gp["router"]["kernel"]).T,
            **{k: np.asarray(gp[k]) for k in ("expert_wi", "expert_bi",
                                              "expert_wo", "expert_bo")}}
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for name, got in zip(names, grads[1:]):
        np.testing.assert_allclose(got.numpy(), want[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    assert np.abs(want["router.weight"]).max() > 0


@pytest.mark.parametrize("seq", [1, 7, 74, 224])
@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 1.25), (2, 0.3)])
def test_capacity_matches_jax(seq, top_k, cf):
    kw = dict(num_experts=4, top_k=top_k, capacity_factor=cf)
    assert tmoe.moe_capacity(tcfg.MoEConfig(**kw), seq) == \
        jmoe.moe_capacity(MoEConfig(**kw), seq)


def test_router_noise_draws_from_the_generator():
    """Train mode with router_noise jitters the float32 logits by a factor
    in [1 - r, 1 + r] drawn from the generator: same seed, same output;
    eval mode and r = 0 leave them alone."""
    cfg = MoEConfig(num_experts=4, top_k=1, capacity_factor=2.0,
                    router_noise=0.5)
    _, _, tm, x = _block_pair(cfg)
    xt = torch.tensor(x)
    with torch.no_grad():
        a = tm(xt, True, torch.Generator().manual_seed(3))[0]
        b = tm(xt, True, torch.Generator().manual_seed(3))[0]
        c = tm(xt, True, torch.Generator().manual_seed(4))[0]
        plain = tm(xt)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) or not torch.equal(a, plain)
    with pytest.raises(ValueError, match="generator"):
        tm(xt, True)


# -- the stacks --------------------------------------------------------------

def _moe(make, top_k=1, **transformer):
    """``make()`` with MoE MLPs: 4 experts, capacity 1.25, a balance-loss
    weight of 0.5 (large enough that its gradient shows)."""
    cfg = make()
    return cfg.replace(transformer=cfg.transformer.replace(
        mlp_type="moe", moe=MoEConfig(num_experts=4, top_k=top_k,
                                      capacity_factor=1.25,
                                      aux_loss_weight=0.5),
        **transformer))


STACK_CASES = {
    "plain_top1": lambda: _moe(octo_micro_t5),
    "plain_top2": lambda: _moe(octo_micro_t5, top_k=2),
    "layers_merge": lambda: _moe(octo_micro_tome_layers),
    "layers_prune_top2": lambda: _moe(octo_micro_tome_layers, top_k=2,
                                      compression_mode="prune"),
    "staged_merge": lambda: _moe(octo_micro_tome_staged),
    "staged_top2_prestack": lambda: _moe(octo_micro_tome_staged, top_k=2,
                                         prestack_merge=True),
}


def _stack_call(tm):
    """(JAX method, port call) running the transformer stack alone on a
    token sequence."""
    if tm.use_compression:
        method = lambda m, t: m.transformer(t, deterministic=True)
        run = lambda t: tm.transformer(t)
    else:
        mask = jnp.asarray(tm.attention_mask.numpy())
        method = lambda m, t: m.transformer(t, mask=mask, deterministic=True)
        run = lambda t: tm.transformer(t, tm.attention_mask)
    return method, run


def _tokens(tm, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, tm.layout.total_tokens,
                            tm.config.token_embedding_dim)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_stack_matches_jax(case):
    cfg = STACK_CASES[case]()
    jm, v, tm = micro_pair(cfg)
    x = _tokens(tm, 2)
    method, run = _stack_call(tm)
    # the params alone: init's sown 'losses' would be summed in again
    ref, mut = jm.apply({"params": v["params"]}, jnp.asarray(x),
                        method=method, mutable=["losses"])
    with torch.no_grad():
        out = run(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_TOL,
                               atol=FWD_TOL)
    want = float(jmoe.moe_aux_loss(mut))
    assert want > 0
    assert abs(float(tm.moe_aux_loss()) - want) <= FWD_TOL * want


@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_stack_gradients_match_jax(case):
    """d/dparams of sum(out * g) + the pre-weighted balance loss."""
    jm, v, tm = micro_pair(STACK_CASES[case]())
    x = _tokens(tm, 3)
    method, run = _stack_call(tm)
    out = run(torch.tensor(x))
    g = np.random.default_rng(4).normal(size=tuple(out.shape)).astype(
        np.float32)

    def loss_j(params):
        out, mut = jm.apply({"params": params}, jnp.asarray(x),
                            method=method, mutable=["losses"])
        return jnp.sum(out * g) + jmoe.moe_aux_loss(mut)

    grads_j = jax.tree.map(np.asarray, jax.grad(loss_j)(v["params"]))
    want = convert.from_flax(grads_j, tm.config)
    named = [(n, p) for n, p in tm.named_parameters()
             if n.startswith("transformer.")]
    loss = (out * torch.tensor(g)).sum() + tm.moe_aux_loss()
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    got = {n: g for (n, _), g in zip(named, grads) if g is not None}
    assert set(got) == {n for n, _ in named}
    _assert_grads_close(got, {n: want[n] for n in got})
    routers = [n for n in got if n.endswith("router.weight")]
    assert len(routers) == tm.config.transformer.num_blocks
    assert all(float(got[n].abs().max()) > 0 for n in routers)


# -- the train step ----------------------------------------------------------

def _jax_total_loss_and_grads(monkeypatch, jm, params, ids, images, actions,
                              d, method):
    """jax.value_and_grad of the JAX train step's objective: the mean loss
    plus the sown 'losses' (train/steps.py:_total_loss)."""
    queues = _inject_jax(monkeypatch, d, diffusion="diffusion" in method)
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        loss, mut = jm.apply(
            {"params": p}, ids, images, actions, train=True,
            rngs={"dropout": key, "patch_encoding": key, "diffusion": key},
            method=method, mutable=["losses"])
        return jnp.mean(loss) + jmoe.moe_aux_loss(mut)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    monkeypatch.undo()
    assert not any(queues.values()), "a JAX draw was not consumed"
    return float(loss), jax.tree.map(np.asarray, grads)


TRAIN_CASES = {
    "plain_diffusion": (lambda: _no_dropout(_moe(octo_micro_t5)),
                        "diffusion"),
    "layers_continuous": (lambda: _no_dropout(_moe(octo_micro_tome_layers)),
                          "continuous"),
    "staged_top2_diffusion": (lambda: _no_dropout(_moe(
        octo_micro_tome_staged, top_k=2)), "diffusion"),
}


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_adds_the_weighted_aux(monkeypatch, case, jit):
    """make_train_step (eager, and jit=True, which runs eagerly for a
    state on the CPU) against jax.value_and_grad of the JAX step's
    objective: the loss with the weighted balance loss in it, every
    gradient leaf (the routers' among them) within 1e-4 of its largest."""
    make, head = TRAIN_CASES[case]
    jcfg = make()
    jm, v, model = micro_pair(jcfg)
    b = 2
    ids, images = inputs(jcfg, batch=b, frames=2, seed=50)
    dims = {"continuous": 4, "diffusion": 4}
    actions = np.random.default_rng(51).uniform(
        -1, 1, (b, dims[head])).astype(np.float32)
    d = _draws(jcfg, b, 52)
    method = tsteps.LOSS_METHODS[head]
    j_loss, j_grads = _jax_total_loss_and_grads(
        monkeypatch, jm, v["params"], ids, images, actions, d, method)
    # the JAX objective without the balance loss, to see it enter
    j_plain, _ = _jax_loss_and_grads(monkeypatch, jm, v["params"], ids,
                                     images, actions, d, method=method)
    rec = RecordingOptimizer()
    state = tstate.create_train_state(model, rec, rngs=0)
    draws = _port_draws(d)
    if head == "diffusion":
        _inject_port(monkeypatch, d["keep"])
    else:
        draws = {"positions": draws["positions"]}
    step = tsteps.make_train_step(head, jit=jit)
    state, loss = step(state, torch.tensor(ids).long(), torch.tensor(images),
                       torch.tensor(actions), draws=draws)
    aux = float(model.moe_aux_loss())
    assert aux > 0
    assert abs(float(loss) - (j_plain + aux)) <= LOSS_RTOL * abs(j_loss)
    assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    want = convert.from_flax(j_grads, model.config)
    got = {n: g for n, g in rec.grads[0].items() if g is not None}
    routers = [n for n in got if n.endswith("router.weight")]
    assert len(routers) == jcfg.transformer.num_blocks
    assert all(float(got[n].abs().max()) > 0 for n in routers)
    _assert_grads_close(got, {n: want[n] for n in got})


def test_dense_model_hands_back_no_aux():
    tm = TOcto(to_torch_config(octo_micro()), device="cpu", seed=0)
    with torch.no_grad():
        tm.transformer(torch.zeros(1, tm.layout.total_tokens, 32),
                       tm.attention_mask)
    assert tm.moe_aux_loss() is None


# -- weights and decay -------------------------------------------------------

@pytest.mark.parametrize("make", [octo_micro_t5, octo_micro_tome_layers,
                                  octo_micro_tome_staged])
def test_convert_and_decay_mask_follow_the_moe_tree(make):
    """convert.from_flax carries router/kernel and expert_wi/bi/wo/bo in the
    scanned and the per-layer layouts; decay_mask decays them all (the
    expert biases are (E, F) leaves in flax, 2-D), against the JAX mask."""
    jcfg = _moe(make)
    _, v, tm = micro_pair(jcfg)
    params = jax.tree.map(np.asarray, v["params"])
    sd = tm.state_dict()
    moe_keys = [k for k in sd if ".moe." in k]
    assert len(moe_keys) == 5 * jcfg.transformer.num_blocks
    assert all(sd[k].dtype == torch.float32 for k in moe_keys)
    # the router kernel is transposed like any dense; the experts copied
    first = "transformer.blocks.0" if make is octo_micro_t5 else (
        "transformer.block_0" if make is octo_micro_tome_layers
        else "transformer.stage_0.0")
    t = params["transformer"]
    flax_block = (t["blocks"] if make is octo_micro_t5 else
                  t["block_0"] if make is octo_micro_tome_layers
                  else t["stage_0"])["moe"]
    scanned = make is not octo_micro_tome_layers
    pick = (lambda a: a[0]) if scanned else (lambda a: a)
    np.testing.assert_array_equal(sd[first + ".moe.router.weight"].numpy(),
                                  pick(flax_block["router"]["kernel"]).T)
    for k in ("expert_wi", "expert_bi", "expert_wo", "expert_bo"):
        np.testing.assert_array_equal(sd[f"{first}.moe.{k}"].numpy(),
                                      pick(flax_block[k]))
    flags = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32),
                         joptim.decay_mask(params), params)
    want = convert.from_flax(flags, tm.config)
    got = toptim.decay_mask(tm)
    for name, flag in got.items():
        assert bool(want[name].all()) == flag == bool(want[name].any()), name
    assert all(got[k] for k in moe_keys)


def test_serving_copy_stores_the_experts_in_the_compute_dtype():
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        serving_copy)
    cfg = to_torch_config(_moe(octo_micro)).replace(
        dtype="bfloat16")
    tm = TOcto(cfg, device="cpu", seed=0)
    copy = serving_copy(tm)
    block = copy.transformer.blocks[0].moe
    assert block.expert_wi.dtype == torch.bfloat16
    assert block.router.weight.dtype == torch.float32
    x = torch.randn(2, tm.layout.total_tokens, 32).to(torch.bfloat16)
    with torch.no_grad():
        torch.testing.assert_close(
            copy.transformer(x, copy.attention_mask),
            tm.eval().transformer(x, tm.attention_mask), rtol=0, atol=0)
