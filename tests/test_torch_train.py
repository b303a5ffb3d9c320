"""The port's diffusion training step against the JAX package's, on the CPU.

The micro T5 Octo of ``torch_parity`` with every configurable dropout rate
at 0 and ``pool_vjp='pallas'`` in both packages; the port runs
``attention_impl='flash'`` (the flash kernels' plain versions), the JAX
package its XLA attention, which is the same function without dropout.
Train-mode randomness is made with numpy and handed to both: the JAX
package's ``jax.random`` draws are replaced for the call, the port takes
the draws as arguments, and the time encoder's fixed-rate dropout gets the
same keep masks in both.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import inputs, micro_pair, octo_micro_t5, \
    octo_micro_tome_layers, octo_micro_tome_staged, to_torch_config
from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_torch.modules import layers
from multi_modal_transformers_tokenmerge_torch.ops import flash_attention as tfa
from multi_modal_transformers_tokenmerge_torch.ops import pool as tpool
from multi_modal_transformers_tokenmerge_torch.ops.image_ops import (
    position_interval_bounds,
)
from multi_modal_transformers_tokenmerge_torch.train import loop as tloop
from multi_modal_transformers_tokenmerge_torch.train import optim as toptim
from multi_modal_transformers_tokenmerge_torch.train import state as tstate
from multi_modal_transformers_tokenmerge_torch.train import steps as tsteps
from multi_modal_transformers_tokenmerge_torch.utils import data as tdata
from multi_modal_transformers_tokenmerge_tpu.train import optim as joptim

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4      # of the leaf's largest |gradient|
PARAM_TOL = 1e-5


def _jax_cfg():
    base = octo_micro_t5()
    tr = base.transformer
    return base.replace(
        transformer=tr.replace(
            dropout_rate=0.0, attention=tr.attention.replace(dropout_rate=0.0)),
        images=base.images.replace(
            resnet=base.images.resnet.replace(pool_vjp="pallas")),
        heads=base.heads.replace(
            diffusion=base.heads.diffusion.replace(dropout_rate=0.0)))


def _port(jcfg):
    """(JAX module, JAX params, port model with 'flash' attention)."""
    jm, v, tm = micro_pair(jcfg)
    tc = to_torch_config(jcfg)
    tc = tc.replace(transformer=tc.transformer.replace(attention_impl="flash"))
    model = TOcto(tc, device="cpu", seed=None)
    model.load_state_dict(tm.state_dict())
    return jm, v["params"], model


def _draws(cfg, batch, seed):
    """Every train-mode draw of one step, from numpy."""
    rng = np.random.default_rng(seed)
    img = cfg.images
    rs, rp, cs, cp = position_interval_bounds(img.image_size[0],
                                              img.patch_size,
                                              img.position_interval)
    shape = (batch, cfg.num_observation_blocks, rs.shape[0])
    d = cfg.heads.diffusion
    return {
        "rows": rng.integers(rs, np.maximum(rp, rs + 1), shape).astype(
            np.int32),
        "cols": rng.integers(cs, np.maximum(cp, cs + 1), shape).astype(
            np.int32),
        "time": rng.integers(0, d.diffusion_steps, (batch, 1)).astype(
            np.int32),
        "noise": rng.normal(size=(batch, d.action_space_dim)).astype(
            np.float32),
        # FourierFeatures' MLP drops at 0.1 whatever the config says
        "keep": [rng.random((batch, n)) < 0.9 for n in (d.mlp_dim,
                                                        d.time_dim)],
    }


def _port_draws(d):
    return {"positions": (torch.tensor(d["rows"]), torch.tensor(d["cols"])),
            "time": torch.tensor(d["time"]), "noise": torch.tensor(d["noise"])}


def _inject_jax(monkeypatch, d, mask_of_shape=None, diffusion=True):
    """Serve the JAX call's randint / normal / bernoulli from ``d``; with
    ``mask_of_shape``, every keep mask is that function of its shape.
    Only the diffusion loss draws a time, noise and the time encoder's
    keep masks."""
    queues = {"randint": collections.deque(
                  [d["rows"], d["cols"]] + ([d["time"]] if diffusion else [])),
              "normal": collections.deque([d["noise"]] if diffusion else []),
              "bernoulli": collections.deque(d["keep"] if diffusion else [])}

    def serve(name, shape):
        if name == "bernoulli" and mask_of_shape is not None:
            return jnp.asarray(mask_of_shape(shape))
        value = queues[name].popleft()
        assert tuple(shape) == value.shape, (name, shape, value.shape)
        return jnp.asarray(value)

    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, *a, **k: serve("randint", shape))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), *a, **k: serve("normal", shape))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: serve("bernoulli",
                                                             shape))
    return queues


def _inject_port(monkeypatch, masks):
    """Serve the port's dropout keep masks from ``masks`` in order."""
    queue = collections.deque(masks)

    def keep_mask(shape, keep_prob, generator, device):
        m = torch.as_tensor(queue.popleft())
        assert tuple(m.shape) == tuple(shape)
        return m.to(device)

    monkeypatch.setattr(layers, "keep_mask", keep_mask)
    return queue


class RecordingOptimizer:
    """Stands in for the optimizer: records the gradients of each update."""

    def __init__(self):
        self.grads = []

    def init(self, named_params):
        pass

    def step(self, params, grads):
        self.grads.append({n: None if g is None else g.clone()
                           for n, g in grads.items()})


def _jax_loss_and_grads(monkeypatch, jm, params, ids, images, actions, d,
                        mask_of_shape=None,
                        method="compute_diffusion_denoise_loss"):
    queues = _inject_jax(monkeypatch, d, mask_of_shape,
                         diffusion="diffusion" in method)
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        return jnp.mean(jm.apply(
            {"params": p}, ids, images, actions, train=True,
            rngs={"dropout": key, "patch_encoding": key, "diffusion": key},
            method=method))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    monkeypatch.undo()
    if mask_of_shape is not None:
        queues.pop("bernoulli")
    assert not any(queues.values()), "a JAX draw was not consumed"
    return float(loss), jax.tree.map(np.asarray, grads)


def _actions(cfg, batch, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (batch, cfg.heads.diffusion.action_space_dim)).astype(
            np.float32)


def _assert_grads_close(port_grads, want):
    """``port_grads`` (name -> gradient or None) against ``want`` (name ->
    tensor): each leaf within GRAD_TOL of its largest |gradient|."""
    assert set(port_grads) <= set(want)
    largest = max(float(g.abs().max()) for g in want.values())
    for name, ref in want.items():
        got = port_grads.get(name)
        scale = float(ref.abs().max())
        if got is None:
            # the frozen text tower: no gradient in the port, zeros in JAX
            assert scale == 0.0, name
            continue
        if name.endswith(".key.bias"):
            # exactly zero (softmax ignores a shift shared by a row's
            # logits, in the plain blocks and in the ToMe blocks, whose
            # merge plan passes no gradient): both packages hold rounding
            # noise only
            assert max(scale, float(got.abs().max())) <= GRAD_TOL * largest
            continue
        err = float((got - ref).abs().max())
        assert err <= GRAD_TOL * max(scale, 1e-30), (name, err, scale)


def test_train_step_matches_jax(monkeypatch):
    """make_train_step('diffusion') with the port's flash path against
    jax.value_and_grad of the JAX loss with XLA attention: loss within
    1e-5 relative, every gradient leaf within 1e-4 of its largest value,
    grad_norm the global norm before clipping."""
    jcfg = _jax_cfg()
    jm, jparams, model = _port(jcfg)
    b = 2
    ids, images = inputs(jcfg, batch=b, frames=2, seed=3)
    actions = _actions(jcfg, b, 4)
    d = _draws(jcfg, b, 5)
    j_loss, j_grads = _jax_loss_and_grads(monkeypatch, jm, jparams, ids,
                                          images, actions, d)

    rec = RecordingOptimizer()
    state = tstate.create_train_state(model, rec, rngs=0)
    _inject_port(monkeypatch, d["keep"])
    fwd, dq = tfa.flash_fwd_lse.launches, tfa.flash_dq.launches
    step = tsteps.make_train_step("diffusion")
    state, loss = step(state, torch.tensor(ids), torch.tensor(images),
                       torch.tensor(actions), draws=_port_draws(d))
    # CPU tensors take the plain versions, never the kernels
    assert (tfa.flash_fwd_lse.launches, tfa.flash_dq.launches) == (fwd, dq)
    assert state.step == 1
    assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    _assert_grads_close(rec.grads[0],
                        convert.from_flax(j_grads, model.config))
    j_norm = float(optax.global_norm(j_grads))
    got_norm = float(state.metrics.compute()["grad_norm"])
    assert abs(got_norm - j_norm) <= 1e-5 * j_norm


def _shape_mask(shape):
    """A keep mask that depends on its shape only: the JAX package scans
    its blocks, tracing the body once, so every block sees the masks drawn
    for the first; the port is handed the same mask per shape."""
    shape = tuple(int(n) for n in shape)
    seed = sum(n * 1009 ** i for i, n in enumerate(shape))
    return np.random.default_rng(seed).random(shape) < 0.9


def test_every_dropout_site_matches_jax(monkeypatch):
    """Every dropout at 0.1 (attention weights on the plain path, after
    attention, in the MLPs, in the denoiser and its time encoder): the
    same keep masks give the JAX loss and gradients."""
    base = octo_micro_t5()
    jcfg = base.replace(images=base.images.replace(
        resnet=base.images.resnet.replace(pool_vjp="pallas")))
    assert jcfg.transformer.attention.dropout_rate == 0.1
    jm, v, tm = micro_pair(jcfg)
    b = 2
    ids, images = inputs(jcfg, batch=b, frames=2, seed=20)
    actions = _actions(jcfg, b, 21)
    d = _draws(jcfg, b, 22)
    j_loss, j_grads = _jax_loss_and_grads(monkeypatch, jm, v["params"], ids,
                                          images, actions, d, _shape_mask)
    rec = RecordingOptimizer()
    state = tstate.create_train_state(tm, rec, rngs=0)
    sites = []
    monkeypatch.setattr(layers, "keep_mask",
                        lambda shape, p, g, device: sites.append(shape) or
                        torch.from_numpy(_shape_mask(shape)))
    step = tsteps.make_train_step("diffusion")
    state, loss = step(state, torch.tensor(ids), torch.tensor(images),
                       torch.tensor(actions), draws=_port_draws(d))
    # 2 blocks x (weights, after attention, 2 in the MLP) + 4 in the head
    assert len(sites) == 12
    assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    _assert_grads_close(rec.grads[0], convert.from_flax(j_grads, tm.config))


def test_flash_and_plain_attention_agree_in_the_model(monkeypatch):
    """The port's 'flash' and 'xla' attention paths, same draws: the same
    loss and gradients (dead rows do not occur under the Octo mask)."""
    jcfg = _jax_cfg()
    _, _, flash_model = _port(jcfg)
    tc = flash_model.config
    plain = TOcto(tc.replace(transformer=tc.transformer.replace(
        attention_impl="xla")), device="cpu", seed=None)
    plain.load_state_dict(flash_model.state_dict())
    assert plain.transformer.blocks[0].attention.attention_fn is None
    assert flash_model.transformer.blocks[0].attention.attention_fn
    b = 2
    ids, images = (torch.tensor(x) for x in inputs(jcfg, batch=b, seed=6))
    actions = torch.tensor(_actions(jcfg, b, 7))
    d = _draws(jcfg, b, 8)
    out = []
    for m in (flash_model, plain):
        _inject_port(monkeypatch, d["keep"])
        loss = m.compute_diffusion_denoise_loss(
            ids, images, actions, True, rngs={"dropout": torch.Generator()},
            **_port_draws(d))
        named = [(n, p) for n, p in m.named_parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        out.append((loss, {n: g if g is not None else torch.zeros_like(p)
                           for (n, p), g in zip(named, grads)}))
    (l1, g1), (l2, g2) = out
    torch.testing.assert_close(l1, l2, rtol=1e-6, atol=0)
    _assert_grads_close(g1, g2)


def _synthetic_grads(jparams, seed, scale):
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        if path[0].key == "text_encoder":
            return np.zeros_like(p)     # behind stop_gradient in JAX
        return (rng.normal(size=p.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jparams)


@pytest.mark.parametrize("warmup,clip,frozen,masked_decay", [
    (2, 1.0, True, True),      # warmup from lr 0; clipping active
    (0, None, True, True),     # no warmup, no clipping
    (1, 1e3, False, True),     # clipping inactive; unmasked frozen tower
    (2, 1.0, False, False),    # no decay mask: every leaf decays
])
def test_optimizer_matches_optax(warmup, clip, frozen, masked_decay):
    """Three make_optimizer updates on the same gradients as the optax
    chain of the JAX package: parameters within 1e-5.  Weight decay 0.5
    makes a wrong decay mask visible."""
    jcfg = _jax_cfg()
    _, jparams, model = _port(jcfg)
    jparams = jax.tree.map(np.asarray, jparams)
    kw = dict(peak_lr=1e-2, warmup_steps=warmup, total_steps=6,
              weight_decay=0.5, clip_norm=clip,
              frozen_prefixes=("text_encoder",) if frozen else ())
    jtx = joptim.make_optimizer(params=jparams if masked_decay or frozen
                                else None, **kw)
    if masked_decay or frozen:
        ttx = toptim.make_optimizer(params=model, **kw)
    else:
        ttx = toptim.make_optimizer(params=None, **kw)
    params = {n: p for n, p in model.named_parameters()}
    ttx.init(model.named_parameters())
    jstate = jtx.init(jparams)
    text_names = [n for n in params if n.startswith("text_encoder.")]
    before = {n: params[n].detach().clone() for n in text_names}
    for i in range(3):
        jg = _synthetic_grads(jparams, 10 + i, scale=0.1)
        updates, jstate = jtx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = convert.from_flax(jg, model.config)
        tg = {n: (None if n in text_names else g) for n, g in tg.items()}
        ttx.step(params, tg)
        if i == 0 and warmup:
            # optax's warmup starts at lr 0: the first update moves nothing
            want = convert.from_flax(jax.tree.map(np.asarray, jparams),
                                     model.config)
            for n, p in params.items():
                torch.testing.assert_close(p.detach(), want[n], rtol=0,
                                           atol=PARAM_TOL)
    want = convert.from_flax(jax.tree.map(np.asarray, jparams), model.config)
    for n, p in params.items():
        err = float((p.detach() - want[n]).abs().max())
        assert err <= PARAM_TOL, (n, err)
    moved = max(float((params[n].detach() - before[n]).abs().max())
                for n in text_names)
    if frozen:
        assert moved == 0.0          # masked: no state, no update
    else:
        assert moved > 0.0           # unmasked optax still decays it


def test_schedule_matches_optax():
    for warmup, total in ((0, 10), (3, 10), (5, 5)):
        ours = toptim.warmup_cosine_schedule(3e-4, warmup, total)
        ref = joptim.warmup_cosine_schedule(3e-4, warmup, total)
        for count in range(0, 14):
            assert ours(count) == pytest.approx(float(ref(count)), rel=1e-6,
                                                abs=1e-12)


def _step_grads(monkeypatch, model, batch, draws, masks, **step_kw):
    rec = RecordingOptimizer()
    state = tstate.create_train_state(model, rec, rngs=0)
    _inject_port(monkeypatch, masks)
    step = tsteps.make_train_step("diffusion", **step_kw)
    state, loss = step(state, *batch, draws=draws)
    return float(loss), rec.grads[0]


def test_accumulation_equals_one_step(monkeypatch):
    """accum_steps=2 over the halves of a batch, on the same draws, gives
    the loss and gradients of one step over the whole batch."""
    jcfg = _jax_cfg()
    _, _, model = _port(jcfg)
    b = 4
    ids, images = inputs(jcfg, batch=b, seed=11)
    batch = (torch.tensor(ids), torch.tensor(images),
             torch.tensor(_actions(jcfg, b, 12)))
    d = _draws(jcfg, b, 13)
    l1, g1 = _step_grads(monkeypatch, model, batch, _port_draws(d),
                         d["keep"])
    halves = [m[i * 2:(i + 1) * 2] for i in range(2) for m in d["keep"]]
    l2, g2 = _step_grads(monkeypatch, model, batch, _port_draws(d), halves,
                         accum_steps=2)
    assert l2 == pytest.approx(l1, rel=1e-6)
    for n, a in g1.items():
        if a is None:
            assert g2[n] is None
            continue
        assert g2[n].dtype == a.dtype
        torch.testing.assert_close(g2[n], a, rtol=1e-4,
                                   atol=1e-6 * float(a.abs().max()) + 1e-12)


def test_text_embeddings_input_equals_ids(monkeypatch):
    """text_input='embeddings' on cache_text_embeddings' output trains the
    same objective as 'ids'."""
    jcfg = _jax_cfg()
    _, _, model = _port(jcfg)
    b = 2
    ids, images = inputs(jcfg, batch=b, seed=14)
    actions = _actions(jcfg, b, 15)
    d = _draws(jcfg, b, 16)
    emb, _, _ = next(tdata.cache_text_embeddings(
        iter([(ids, images, actions)]), model))
    assert emb.shape == (b, jcfg.text.max_length, jcfg.token_embedding_dim)
    l1, g1 = _step_grads(monkeypatch, model,
                         (torch.tensor(ids), torch.tensor(images),
                          torch.tensor(actions)), _port_draws(d), d["keep"])
    l2, g2 = _step_grads(monkeypatch, model,
                         (emb, torch.tensor(images), torch.tensor(actions)),
                         _port_draws(d), d["keep"], text_input="embeddings")
    assert l2 == l1
    for n, a in g1.items():
        if a is None:
            assert g2[n] is None
        else:
            assert torch.equal(a, g2[n]), n


def test_fit_runs_the_generators_and_logs(monkeypatch):
    """fit on synthetic batches with every dropout on: the step draws from
    the state's generators (no explicit draws), the pool backward goes
    through ops.pool and the flash path through its plain versions, and
    the logger receives windowed metrics."""
    cfg = _port(_jax_cfg())[2].config
    tc = cfg.replace(transformer=cfg.transformer.replace(
        dropout_rate=0.1,
        attention=cfg.transformer.attention.replace(dropout_rate=0.1)),
        heads=cfg.heads.replace(diffusion=cfg.heads.diffusion.replace(
            dropout_rate=0.1)))
    model = TOcto(tc, device="cpu", seed=0)
    tx = toptim.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=4,
                               params=model,
                               frozen_prefixes=("text_encoder",))
    state = tstate.create_train_state(model, tx, rngs=1)
    logged = []

    class Logger:
        def log(self, metrics, step):
            logged.append((step, metrics))

    calls = []
    original = tpool.pool_bwd_reference
    monkeypatch.setattr(tpool, "pool_bwd_reference",
                        lambda *a: calls.append(1) or original(*a))
    batches = tdata.synthetic_octo_batches(
        2, image_shape=(2, *tc.images.image_size), text_length=tc.text.max_length,
        action_dim=tc.heads.diffusion.action_space_dim,
        vocab_size=tc.text.vocab_size)
    state = tloop.fit(state, batches, "diffusion", 3, logger=Logger(),
                      log_every=2)
    assert state.step == 3 and len(calls) == 3
    (step, metrics), = logged
    assert step == 2
    assert set(metrics) == {"loss", "grad_norm", "last_loss",
                            "steps_per_sec"}
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("num_steps,log_every,window", [(4, 2, 2),
                                                         (5, 2, 1)])
def test_fit_returns_the_last_windows_metrics(monkeypatch, num_steps,
                                              log_every, window):
    """The metrics restart at every log but the one at the last step (the
    JAX package's fit, train/loop.py:131): the state returned holds the
    steps since the last restart, the last logged window when a log falls
    on the last step."""
    model = _port(_jax_cfg())[2]
    state = tstate.create_train_state(
        model, toptim.make_optimizer(peak_lr=1e-3, warmup_steps=1,
                                     total_steps=8, params=model), rngs=0)

    def step_fn(st, text, images, actions):
        st.step += 1
        loss = torch.tensor(float(st.step))
        st.metrics.update(loss=loss, grad_norm=2 * loss)
        return st, loss

    monkeypatch.setattr(tloop, "make_train_step", lambda *a, **k: step_fn)
    logged = []

    class Logger:
        def log(self, metrics, step):
            logged.append((step, metrics))

    batches = iter([(np.zeros(1), np.zeros(1), np.zeros(1))] * num_steps)
    state = tloop.fit(state, batches, "diffusion", num_steps,
                      logger=Logger(), log_every=log_every)
    last = range(num_steps - window + 1, num_steps + 1)
    assert state.metrics.counts == {"grad_norm": window, "loss": window}
    got = {k: float(v) for k, v in state.metrics.compute().items()}
    assert got == {"loss": float(np.mean(last)),
                   "grad_norm": 2 * float(np.mean(last))}
    if num_steps % log_every == 0:
        assert {k: logged[-1][1][k] for k in got} == got


def test_unported_options_raise():
    model = _port(_jax_cfg())[2]
    # every head has its step now; an unknown one is refused
    for head in ("continuous", "categorical", "diffusion"):
        assert callable(tsteps.make_train_step(head))
    with pytest.raises(ValueError, match="unknown head"):
        tsteps.make_train_step("gaussian")
    with pytest.raises(ValueError):
        tsteps.make_train_step("diffusion", text_input="tokens")
    state = tstate.create_train_state(model, RecordingOptimizer())
    # meshes are ported (tests/test_torch_parallel.py); what is not a
    # (data, model) DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        tloop.fit(state, iter([]), "diffusion", 1, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tloop.evaluate(state, iter([]), "diffusion", 1, mesh=object())
    # checkpointing (fit(checkpointer=...)) and skip_nonfinite_steps are
    # ported: tests/test_torch_checkpoint.py, tests/test_torch_optim.py
    assert toptim.make_optimizer(skip_nonfinite_steps=3).skip_nonfinite == 3


def test_metrics_kinds():
    m = tstate.Metrics.empty(loss="avg", tokens="sum")
    m.update(loss=2.0, tokens=3.0).update(loss=4.0)
    out = {k: float(v) for k, v in m.compute().items()}
    assert out == {"loss": 3.0, "tokens": 3.0}
    fresh = m.zeros_like().update(tokens=1.0)
    assert {k: float(v) for k, v in fresh.compute().items()} == {
        "loss": 0.0, "tokens": 1.0}
    with pytest.raises(KeyError):
        m.update(other=1.0)
    with pytest.raises(ValueError):
        tstate.Metrics.empty(loss="max")


def test_ema_follows_the_update():
    """ema <- d * ema + (1 - d) * params after each update, as the JAX
    state's apply_gradients (train/state.py)."""
    model = _port(_jax_cfg())[2]
    tx = toptim.make_optimizer(peak_lr=1e-2, warmup_steps=0, total_steps=4,
                               params=model,
                               frozen_prefixes=("text_encoder",))
    state = tstate.create_train_state(model, tx, rngs=0, ema_decay=0.9)
    start = {n: p.detach().clone() for n, p in state.params.items()}
    grads = {n: torch.ones_like(p) for n, p in state.params.items()}
    state.apply_gradients(grads)
    assert state.step == 1
    for n, p in state.params.items():
        want = 0.9 * start[n] + 0.1 * p.detach()
        # one float32 rounding apart: the update multiplies, then adds
        torch.testing.assert_close(state.ema_params[n], want, rtol=1e-6,
                                   atol=1e-6)


# -- the ToMe models and the other heads -------------------------------------

def _no_dropout(cfg):
    tr = cfg.transformer
    return cfg.replace(
        transformer=tr.replace(dropout_rate=0.0,
                               attention=tr.attention.replace(
                                   dropout_rate=0.0)),
        heads=cfg.heads.replace(diffusion=cfg.heads.diffusion.replace(
            dropout_rate=0.0)))


TOME_TRAIN = {
    # the staged stack on the flash forward without LSE, gradients
    # recomputed through the plain attention
    "staged_flash_xla": (lambda: _no_dropout(octo_micro_tome_staged()),
                         dict(attention_impl="flash", flash_backward="xla")),
    # the staged stack on the forward with LSE, gradients from the plain
    # versions of the dq and dk/dv kernels
    "staged_flash_pallas": (lambda: _no_dropout(octo_micro_tome_staged()),
                            dict(attention_impl="flash",
                                 flash_backward="pallas")),
    "layers": (lambda: _no_dropout(octo_micro_tome_layers()), {}),
    "layers_prune_prestack": (lambda: _no_dropout(octo_micro_tome_layers(
        compression_mode="prune", prestack_merge=True)), {}),
}
HEAD_ACTIONS = {"continuous": 4, "categorical": 2, "diffusion": 4}


def _tome_port(jcfg, **transformer):
    jm, v, tm = micro_pair(jcfg)
    tc = to_torch_config(jcfg)
    tc = tc.replace(transformer=tc.transformer.replace(**transformer))
    model = TOcto(tc, device="cpu", seed=None)
    model.load_state_dict(tm.state_dict())
    return jm, v["params"], model


@pytest.mark.parametrize("head", sorted(HEAD_ACTIONS))
@pytest.mark.parametrize("case", sorted(TOME_TRAIN))
def test_tome_train_step_matches_jax(monkeypatch, case, head):
    """One train step of a micro ToMe Octo for each head's loss, the same
    draws handed to both packages: loss within 1e-5 relative, every
    gradient leaf within 1e-4 of its largest value."""
    make, transformer = TOME_TRAIN[case]
    jcfg = make()
    jm, jparams, model = _tome_port(jcfg, **transformer)
    b = 2
    ids, images = inputs(jcfg, batch=b, frames=2, seed=40)
    actions = np.random.default_rng(41).uniform(
        -1, 1, (b, HEAD_ACTIONS[head])).astype(np.float32)
    d = _draws(jcfg, b, 42)
    j_loss, j_grads = _jax_loss_and_grads(
        monkeypatch, jm, jparams, ids, images, actions, d,
        method=tsteps.LOSS_METHODS[head])
    rec = RecordingOptimizer()
    state = tstate.create_train_state(model, rec, rngs=0)
    draws = _port_draws(d)
    if head == "diffusion":
        _inject_port(monkeypatch, d["keep"])
    else:
        draws = {"positions": draws["positions"]}
    step = tsteps.make_train_step(head)
    state, loss = step(state, torch.tensor(ids).long(), torch.tensor(images),
                       torch.tensor(actions), draws=draws)
    assert loss.ndim == 0
    assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    want = convert.from_flax(j_grads, model.config)
    # only the trained head's parameters (and the backbone's) see a gradient
    others = [h for h in HEAD_ACTIONS if h != head]
    for name, g in rec.grads[0].items():
        if name.split("_")[0] in others and "action_head" in name:
            assert g is None and not want[name].any(), name
    _assert_grads_close({n: g for n, g in rec.grads[0].items()
                         if g is not None},
                        {n: g for n, g in want.items()
                         if rec.grads[0].get(n) is not None})


@pytest.mark.parametrize("make", [octo_micro_tome_layers,
                                  octo_micro_tome_staged])
def test_tome_every_dropout_site_matches_jax(monkeypatch, make):
    """Every dropout at 0.1 in a ToMe stack (the per-layer blocks'
    explicit attention weights among them), the same keep mask per shape
    in both packages: the continuous loss and its gradients agree."""
    jcfg = make()
    assert jcfg.transformer.attention.dropout_rate == 0.1
    jm, v, tm = micro_pair(jcfg)
    b = 2
    ids, images = inputs(jcfg, batch=b, frames=2, seed=43)
    actions = np.random.default_rng(44).uniform(-1, 1, (b, 4)).astype(
        np.float32)
    d = _draws(jcfg, b, 45)
    j_loss, j_grads = _jax_loss_and_grads(
        monkeypatch, jm, v["params"], ids, images, actions, d, _shape_mask,
        method="compute_l2_loss")
    rec = RecordingOptimizer()
    state = tstate.create_train_state(tm, rec, rngs=0)
    sites = []
    monkeypatch.setattr(layers, "keep_mask",
                        lambda shape, p, g, device: sites.append(shape) or
                        torch.from_numpy(_shape_mask(shape)))
    step = tsteps.make_train_step("continuous")
    state, loss = step(state, torch.tensor(ids).long(), torch.tensor(images),
                       torch.tensor(actions),
                       draws={"positions": _port_draws(d)["positions"]})
    assert len(sites) == 4 * jcfg.transformer.num_blocks
    assert abs(float(loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
    want = convert.from_flax(j_grads, tm.config)
    got = {n: g for n, g in rec.grads[0].items() if g is not None}
    _assert_grads_close(got, {n: want[n] for n in got})


@pytest.mark.parametrize("make", [octo_micro_tome_layers,
                                  octo_micro_tome_staged, octo_micro_t5])
def test_decay_mask_matches_optax_mask(make):
    """decay_mask on a per-layer tree (block_{l}: norms and plain biases
    1-D, no decay), a staged tree (stage_{i}: scanned, everything decays)
    and the plain scanned stack, against the JAX package's mask of the flax
    tree, leaf for leaf."""
    jcfg = make()
    _, v, tm = micro_pair(jcfg)
    params = jax.tree.map(np.asarray, v["params"])
    flags = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32),
                         joptim.decay_mask(params), params)
    want = convert.from_flax(flags, tm.config)
    got = toptim.decay_mask(tm)
    assert set(got) == set(want)
    for name, flag in got.items():
        assert bool(want[name].all()) == flag == bool(want[name].any()), name
    t = "transformer."
    if make is octo_micro_tome_layers:
        assert not got[t + "block_0.ln_attention.weight"]
        assert not got[t + "block_1.out.bias"]
        assert got[t + "block_0.query.bias"] and got[t + "block_0.out.weight"]
    elif make is octo_micro_tome_staged:
        assert got[t + "stage_0.1.ln_mlp.weight"]
        assert got[t + "stage_1.0.attention.out.bias"]
        assert not got[t + "posembed_input.pos_embedding"]


def test_tome_fit_runs_each_head():
    """fit on synthetic batches through the staged ToMe model for the
    continuous and categorical heads: finite windowed losses."""
    cfg = _tome_port(_no_dropout(octo_micro_tome_staged()),
                     attention_impl="flash", flash_backward="xla")[2].config
    for head, dim in (("continuous", 4), ("categorical", 2)):
        model = TOcto(cfg, device="cpu", seed=0)
        tx = toptim.make_optimizer(peak_lr=1e-3, warmup_steps=1,
                                   total_steps=4, params=model)
        state = tstate.create_train_state(model, tx, rngs=1)
        logged = []

        class Logger:
            def log(self, metrics, step):
                logged.append(metrics)

        batches = tdata.synthetic_octo_batches(
            2, image_shape=(2, *cfg.images.image_size),
            text_length=cfg.text.max_length, action_dim=dim,
            vocab_size=cfg.text.vocab_size)
        state = tloop.fit(state, batches, head, 2, logger=Logger(),
                          log_every=2)
        assert state.step == 2 and np.isfinite(logged[0]["loss"])
