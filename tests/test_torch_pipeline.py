"""The port's GPipe pipeline against the JAX package's ``pipelined_apply``
and the sequential stack, on the CPU: forward and gradients, PP x DP, and
the shapes it refuses.

In process the stages form a ``LocalRing``; across processes they run on
four gloo ranks (one launch for the module, ``torch_dist.launch``): four
stages, and on a (data 2, pipe 2) mesh two 2-stage pipelines and PP x DP.
Against the port's own sequential stack (the same blocks run one after
another) the tolerances are the JAX pipeline tests' (``tests/
test_pipeline.py``, pipeline against sequential): 2e-5 forward, 5e-4 /
1e-5 gradients of mean(out^2).  Against the JAX package, where the
blocks' float32 arithmetic differs between the frameworks and the stack's
outputs reach 70, each tensor is held within 2e-5 (forward) and 1e-4
(gradients, as ``test_torch_train``) of its largest magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_dist import launch, results
from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.core import config as tcfg
from multi_modal_transformers_tokenmerge_torch.modules.attention import (
    EncoderBlock as TBlock)
from multi_modal_transformers_tokenmerge_torch.parallel.pipeline import (
    pipelined_apply, split_stages)
from multi_modal_transformers_tokenmerge_tpu.core.config import (
    AttentionConfig, TransformerConfig)
from multi_modal_transformers_tokenmerge_tpu.modules.attention import (
    EncoderBlock as JBlock)
from multi_modal_transformers_tokenmerge_tpu.parallel.pipeline import (
    pipelined_apply as jpipe, split_stages as jsplit)

FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5
JAX_GRAD_TOL = 1e-4     # of the leaf's largest |gradient|
B, S, E, LAYERS = 8, 6, 16, 8


def _port_cfg(cfg):
    """The JAX TransformerConfig as the port's."""
    kw = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    kw["attention"] = tcfg.AttentionConfig(
        **{f: getattr(cfg.attention, f)
           for f in cfg.attention.__dataclass_fields__})
    kw["moe"] = tcfg.MoEConfig(**{f: getattr(cfg.moe, f)
                                  for f in cfg.moe.__dataclass_fields__})
    return tcfg.TransformerConfig(**kw)


@pytest.fixture(scope="module")
def setup():
    cfg = TransformerConfig(
        num_blocks=LAYERS,
        attention=AttentionConfig(num_heads=2, qkv_features=E,
                                  dropout_rate=0.0),
        mlp_dim=32, dropout_rate=0.0)
    block = JBlock(cfg)
    mask_np = np.tril(np.ones((S, S), dtype=bool))
    mask = jnp.asarray(mask_np)
    x = np.random.default_rng(0).standard_normal((B, S, E)).astype(
        np.float32)
    one = block.init(jax.random.PRNGKey(1), jnp.asarray(x), mask,
                     True)["params"]
    stacked = jax.tree.map(
        lambda leaf: jnp.stack([leaf * (1.0 + 0.05 * i)
                                for i in range(LAYERS)]), one)

    def layer_fn(p, h):
        return block.apply({"params": p}, h, mask, True)[0]

    def sequential(params, h):
        return jax.lax.scan(lambda c, p: (layer_fn(p, c), None), h,
                            params)[0]

    layer_trees = [jax.tree.map(lambda a: np.asarray(a[i]), stacked)
                   for i in range(LAYERS)]
    port_cfg = _port_cfg(cfg)
    layers = [convert.tree_to_state(t) for t in layer_trees]
    ref = np.asarray(sequential(stacked, jnp.asarray(x)))
    g_seq = jax.grad(lambda p, h: jnp.mean(jnp.square(sequential(p, h))))(
        stacked, jnp.asarray(x))

    def per_layer(g):
        return [convert.tree_to_state(jax.tree.map(lambda a: np.asarray(a[i]),
                                                   g))
                for i in range(LAYERS)]

    cache = {}

    def jax_pipe(stages, m, data=None, grads=False):
        """JAX pipelined_apply's output and (with ``grads``) per-layer
        gradients, each made once for the module."""
        key = (stages, m, data, grads)
        if key not in cache:
            cache[key] = _jax_pipe(stages, m, data, grads)
        return cache[key]

    def _jax_pipe(stages, m, data, grads):
        n = stages * (data or 1)
        devs = np.asarray(jax.devices()[:n])
        mesh = (Mesh(devs.reshape(data, stages), ("data", "pipe")) if data
                else Mesh(devs, ("pipe",)))
        run = lambda p, h: jpipe(layer_fn, jsplit(p, stages), h, mesh, m,
                                 data_axis="data" if data else None)
        out = np.asarray(run(stacked, jnp.asarray(x)))
        if not grads:
            return out, None
        g = jax.grad(lambda p, h: jnp.mean(jnp.square(run(p, h))))(
            stacked, jnp.asarray(x))
        return out, per_layer(g)

    return dict(cfg=port_cfg, mask=mask_np, x=x, layers=layers, ref=ref,
                g_seq=per_layer(g_seq), jax_pipe=jax_pipe)


def _blocks(setup):
    out = []
    for sd in setup["layers"]:
        b = TBlock(setup["cfg"], E)
        b.load_state_dict(sd)
        out.append(b)
    return out


def _layer_fn(setup):
    mask = torch.as_tensor(setup["mask"])
    return lambda block, h: block(h, mask)


def _port_sequential(setup):
    """The port's blocks one after another: output and gradients."""
    blocks = _blocks(setup)
    fn = _layer_fn(setup)
    h = torch.tensor(setup["x"])
    for b in blocks:
        h = fn(b, h)
    named = [(f"{li}.{n}", p) for li, b in enumerate(blocks)
             for n, p in b.named_parameters()]
    grads = torch.autograd.grad(h.square().mean(), [p for _, p in named])
    return h.detach(), {n: g for (n, _), g in zip(named, grads)}


def _assert_out(got, port_ref, jax_ref):
    got = got.detach().numpy()
    np.testing.assert_allclose(got, port_ref.numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert np.abs(got - jax_ref).max() <= FWD_TOL * np.abs(jax_ref).max()


def _assert_grads(got, port_ref, jax_ref, layers=range(LAYERS)):
    largest = max(float(g.abs().max()) for t in jax_ref for g in t.values())
    for li in layers:
        for n, ref in jax_ref[li].items():
            g = got[f"{li}.{n}"].numpy()
            np.testing.assert_allclose(
                g, port_ref[f"{li}.{n}"].numpy(), rtol=GRAD_RTOL,
                atol=GRAD_ATOL, err_msg=f"layer {li} {n}")
            ref = ref.numpy()
            if n.endswith("key.bias"):
                # exactly zero (softmax ignores a shift shared by a row's
                # logits): both packages hold rounding noise only
                assert max(np.abs(ref).max(), np.abs(g).max()) <= (
                    JAX_GRAD_TOL * largest), (li, n)
                continue
            assert np.abs(g - ref).max() <= JAX_GRAD_TOL * np.abs(ref).max(), (
                li, n)


@pytest.mark.parametrize("stages,microbatches", [(4, 4), (8, 8), (2, 4)])
def test_local_pipeline_matches_jax_forward(setup, stages, microbatches):
    """A LocalRing of stages against the JAX pipeline and the sequential
    stack."""
    out = pipelined_apply(_layer_fn(setup),
                          split_stages(_blocks(setup), stages),
                          torch.tensor(setup["x"]), stages, microbatches)
    jout, _ = setup["jax_pipe"](stages, microbatches)
    seq, _ = _port_sequential(setup)
    _assert_out(out, seq, jout)
    assert np.abs(out.detach().numpy() - setup["ref"]).max() <= (
        FWD_TOL * np.abs(setup["ref"]).max())


def test_local_pipeline_matches_jax_gradients(setup):
    blocks = _blocks(setup)
    x = torch.tensor(setup["x"])
    out = pipelined_apply(_layer_fn(setup), split_stages(blocks, 4), x, 4, 4)
    named = [(f"{li}.{n}", p) for li, b in enumerate(blocks)
             for n, p in b.named_parameters()]
    grads = torch.autograd.grad(out.square().mean(), [p for _, p in named])
    got = {n: g for (n, _), g in zip(named, grads)}
    _, jgrads = setup["jax_pipe"](4, 4, grads=True)
    _, seq = _port_sequential(setup)
    _assert_grads(got, seq, jgrads)
    _assert_grads(got, seq, setup["g_seq"])


def _scheduled_stack(blocks, stages, m, x, layer_fn):
    """The pipeline's forward under autograd: at tick t stage i runs its
    blocks on microbatch t - i, stages in order, so a generator the blocks
    draw from draws what it draws in the pipeline."""
    per = len(blocks) // stages
    hs = list(x.chunk(m))
    for t in range(m + stages - 1):
        for i in range(stages):
            if 0 <= t - i < m:
                for b in blocks[i * per:(i + 1) * per]:
                    hs[t - i] = layer_fn(b, hs[t - i])
    return torch.cat(hs)


def test_pipeline_recompute_replays_dropout(setup):
    """Dropout on in every block, drawn from one generator: the backward's
    recompute replays each (stage, tick)'s masks, so the gradients are
    those of the forward that ran (the same schedule under autograd), and
    the generator ends where the forward left it."""
    cfg = setup["cfg"]
    cfg = dataclasses.replace(cfg, dropout_rate=0.2,
                              attention=dataclasses.replace(
                                  cfg.attention, dropout_rate=0.2))
    blocks = []
    for sd in setup["layers"]:
        b = TBlock(cfg, E)
        b.load_state_dict(sd)
        blocks.append(b)
    mask = torch.as_tensor(setup["mask"])
    gen = torch.Generator().manual_seed(11)
    layer_fn = lambda block, h: block(h, mask, True, gen)
    x = torch.tensor(setup["x"])
    params = [p for b in blocks for p in b.parameters()]

    out = pipelined_apply(layer_fn, split_stages(blocks, 4), x, 4, 4,
                          generators=[gen])
    after_forward = gen.get_state()
    grads = torch.autograd.grad(out.square().mean(), params)
    assert torch.equal(gen.get_state(), after_forward)

    gen.manual_seed(11)
    ref = _scheduled_stack(blocks, 4, 4, x, layer_fn)
    assert torch.equal(gen.get_state(), after_forward)
    ref_grads = torch.autograd.grad(ref.square().mean(), params)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    seq, _ = _port_sequential(setup)
    assert np.abs(out.detach().numpy() - seq.numpy()).max() > 1e-2
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_pipeline_rejects_bad_shapes(setup):
    with pytest.raises(ValueError, match="not divisible"):
        split_stages(_blocks(setup), 3)
    with pytest.raises(ValueError, match="not divisible"):
        pipelined_apply(_layer_fn(setup), split_stages(_blocks(setup), 4),
                        torch.tensor(setup["x"]), 4, 3)


@pytest.fixture(scope="module")
def four_ranks(setup, tmp_path_factory):
    work = tmp_path_factory.mktemp("pipeline")
    torch.save({"cfg": setup["cfg"], "features": E, "mask": setup["mask"],
                "x": setup["x"], "layers": setup["layers"], "m4": 4, "m2": 4,
                "m_dp": 2}, work / "inputs.pt")
    return launch("pipeline_checks", 4, work)


def test_four_rank_pipeline_matches_jax(setup, four_ranks):
    """Four stages on four ranks: every rank returns the whole output, and
    the rank of stage r holds the gradients of its two layers."""
    jout, jgrads = setup["jax_pipe"](4, 4, grads=True)
    seq_out, seq = _port_sequential(setup)
    for rank, res in enumerate(results(four_ranks, "four_stages")):
        _assert_out(res["out"], seq_out, jout)
        mine = range(2 * rank, 2 * rank + 2)
        _assert_grads(res["grads"], seq, jgrads, mine)
        assert all(g is None for n, g in res["grads"].items()
                   if int(n.split(".")[0]) not in mine)


def test_two_stage_pipelines_on_a_mesh(setup, four_ranks):
    """The mesh's two 'pipe' groups each run a 2-stage pipeline (gradients
    against the JAX sequential stack's)."""
    jout, _ = setup["jax_pipe"](2, 4)
    jgrads = setup["g_seq"]
    seq_out, seq = _port_sequential(setup)
    for res in results(four_ranks, "two_stages_and_pp_dp"):
        _assert_out(res["out2"], seq_out, jout)
        mine = range(4 * res["pipe_rank"], 4 * res["pipe_rank"] + 4)
        _assert_grads(res["grads2"], seq, jgrads, mine)


def test_pipeline_composes_with_data_parallelism(setup, four_ranks):
    """PP x DP on (data 2, pipe 2): each data rank runs its rows of every
    microbatch and returns the global output, gathered over the data axis
    as the JAX function returns it; the output and the data-summed
    gradients of the loss every rank takes on it equal the JAX PP x DP
    pipeline's and the sequential stack's."""
    jout, jgrads = setup["jax_pipe"](2, 2, data=2, grads=True)
    seq_out, seq = _port_sequential(setup)
    for res in results(four_ranks, "two_stages_and_pp_dp"):
        assert res["out_dp"].shape == seq_out.shape
        _assert_out(res["out_dp"], seq_out, jout)
        mine = range(4 * res["pipe_rank"], 4 * res["pipe_rank"] + 4)
        _assert_grads(res["grads_dp"], seq, jgrads, mine)
        _assert_grads(res["grads_dp"], seq, setup["g_seq"], mine)
        assert res["dp_error"] is not None and "data axis" in res["dp_error"]
