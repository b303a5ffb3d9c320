"""The port's CompressedTransformerStack against the JAX package's, on the
CPU in float32 with converted weights: both cadences, merge and prune,
``prestack_merge``, proportional attention, ``final_norm``,
``sequence_compat``, mixture-of-experts MLPs, the flash hook of the staged
path, and every rejection.  The micro ToMe fixtures of ``torch_parity`` supply the models;
the stacks are called directly on random token sequences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (MODULE_TOL, assert_close, flat_intermediates,
                          micro_pair, octo_micro_tome_layers,
                          octo_micro_tome_staged,
                          to_torch_config)
from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_torch.modules import tome_stack as tts
from multi_modal_transformers_tokenmerge_torch.ops import flash_attention as tfa
from multi_modal_transformers_tokenmerge_torch.sequence.layout import (
    SequenceLayout,
)
from multi_modal_transformers_tokenmerge_tpu.core.config import MoEConfig

# 12 layer norms and 2-4 merges deep: a few float32 roundings more than one
# module's 2e-5
STACK_TOL = 5 * MODULE_TOL

CASES = {
    "layers_merge": octo_micro_tome_layers(),
    "layers_prune": octo_micro_tome_layers(compression_mode="prune"),
    "layers_merge_prestack": octo_micro_tome_layers(prestack_merge=True),
    "layers_prune_prestack": octo_micro_tome_layers(compression_mode="prune",
                                                    prestack_merge=True),
    "layers_proportional": octo_micro_tome_layers(
        proportional_attention=True),
    "layers_proportional_prestack_norm": octo_micro_tome_layers(
        proportional_attention=True, prestack_merge=True, final_norm=True),
    "layers_sequence_compat": octo_micro_tome_layers(
        layer_norm_reduction="sequence_compat"),
    "layers_three_blocks": octo_micro_tome_layers(num_blocks=3),
    "staged_merge": octo_micro_tome_staged(),
    "staged_prune": octo_micro_tome_staged(compression_mode="prune"),
    "staged_merge_prestack": octo_micro_tome_staged(prestack_merge=True),
    "staged_prune_prestack": octo_micro_tome_staged(compression_mode="prune",
                                                    prestack_merge=True),
    "staged_final_norm": octo_micro_tome_staged(final_norm=True),
    "staged_sequence_compat": octo_micro_tome_staged(
        layer_norm_reduction="sequence_compat"),
    "staged_uneven": octo_micro_tome_staged(num_blocks=5),
    "staged_three_stages": octo_micro_tome_staged(num_blocks=6),
    # mixture-of-experts MLPs in both paths (tests/test_torch_moe.py holds
    # their gradients and balance loss)
    "layers_moe": octo_micro_tome_layers(mlp_type="moe"),
    "staged_moe_top2": octo_micro_tome_staged(
        mlp_type="moe", moe=MoEConfig(top_k=2)),
}


def _tokens(cfg, seed, batch=2):
    layout = SequenceLayout.from_strings(cfg.input_sequence,
                                         cfg.compression_sequence)
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, layout.total_tokens,
                            cfg.token_embedding_dim)).astype(np.float32)


def _jax_stack(jm, v, x):
    return jm.apply(v, jnp.asarray(x),
                    method=lambda m, t: m.transformer(t, deterministic=True))


@pytest.mark.parametrize("case", sorted(CASES))
def test_compressed_stack_matches_jax(case):
    cfg = CASES[case]
    jm, v, tm = micro_pair(cfg)
    x = _tokens(cfg, seed=1)
    ref = _jax_stack(jm, v, x)
    with torch.no_grad():
        out = tm.transformer(torch.tensor(x))
    layout = tm.layout
    final = tm.transformer.final_layer()
    assert tuple(out.shape) == ref.shape == (
        2, layout.tokens_at_layer(final), cfg.token_embedding_dim)
    assert_close(out, ref, STACK_TOL)
    # the readouts are taken at the final layout
    np.testing.assert_array_equal(
        tm.readout_index.numpy(),
        layout.modality_index("readouts", layer=final))


def test_final_layer_follows_cadence_and_prestack():
    want = {"layers_merge": 2, "layers_merge_prestack": 3,
            "layers_three_blocks": 3, "staged_merge": 1,
            "staged_merge_prestack": 2, "staged_uneven": 2,
            "staged_three_stages": 2}
    for case, layer in want.items():
        tc = to_torch_config(CASES[case])
        tm = TOcto(tc, device="meta", seed=None)
        assert tm.transformer.final_layer() == layer, case


@pytest.mark.parametrize("case", ["staged_merge", "staged_prune_prestack",
                                  "staged_three_stages"])
def test_staged_flash_path_matches_jax_xla(case):
    """The port with attention_impl='flash', flash_backward='xla' (the
    forward kernel's plain version on the CPU, one hook and one set of
    device tables per stage) against the JAX stack with
    attention_impl='xla': the same function."""
    cfg = CASES[case]
    tr = cfg.transformer
    jcfg = cfg.replace(transformer=tr.replace(
        attention=tr.attention.replace(dropout_rate=0.0)))
    jm, v, plain = micro_pair(jcfg)
    tc = to_torch_config(jcfg)
    tc = tc.replace(transformer=tc.transformer.replace(
        attention_impl="flash", flash_backward="xla"))
    tm = TOcto(tc, device="cpu", seed=None).eval()
    tm.load_state_dict(plain.state_dict())
    stack = tm.transformer
    hooks = [getattr(stack, f"stage_{i}")[0].attention.attention_fn
             for i in range(stack.num_stages)]
    assert all(hooks) and len(set(map(id, hooks))) == stack.num_stages
    calls = []
    original = tfa.flash_fwd_reference

    def counting(*a, **k):
        calls.append(a[0].shape[1])
        return original(*a, **k)

    x = _tokens(cfg, seed=2)
    tfa.flash_fwd_reference = counting
    try:
        with torch.no_grad():
            out = stack(torch.tensor(x))
    finally:
        tfa.flash_fwd_reference = original
    off = 1 if tr.prestack_merge else 0
    k = tr.tome_merge_every
    want = [tm.layout.tokens_at_layer(b // k + off)
            for b in range(tr.num_blocks)]
    assert calls == want      # every block of every stage, at its length
    assert_close(out, _jax_stack(jm, v, x), STACK_TOL)
    # and differentiable through the recompute backward
    xt = torch.tensor(x, requires_grad=True)
    stack(xt).square().sum().backward()
    xp = torch.tensor(x, requires_grad=True)
    plain.transformer(xp).square().sum().backward()
    # within 1e-4 of the largest gradient, as tests/test_torch_train.py
    assert (xt.grad - xp.grad).abs().max() <= 1e-4 * xp.grad.abs().max()


def test_train_mode_dropout_sites(monkeypatch):
    """Per-layer blocks in train mode: attention-weight dropout (explicit
    weights), after attention and twice in the MLP; the pruning importance
    reads the weights BEFORE dropout, so the first block keeps the same
    tokens whatever the mask."""
    from multi_modal_transformers_tokenmerge_torch.modules import layers
    cfg = CASES["layers_prune"]
    _, _, tm = micro_pair(cfg)
    x = torch.tensor(_tokens(cfg, seed=3))
    sites = []
    monkeypatch.setattr(
        layers, "keep_mask",
        lambda shape, p, g, device: sites.append(tuple(shape)) or torch.ones(
            shape, dtype=torch.bool))
    with torch.no_grad():
        out = tm.transformer(x, True, torch.Generator())
        want = tm.transformer(x)
    assert len(sites) == 2 * 4 and len(sites[0]) == 4
    # every element kept and rescaled by 1/0.9 at each of four sites
    assert not torch.allclose(out, want)
    kept = []
    original = tts.prune_gather
    monkeypatch.setattr(tts, "prune_gather",
                        lambda t, idx: kept.append(idx) or original(t, idx))
    rng = np.random.default_rng(0)
    monkeypatch.setattr(
        layers, "keep_mask",
        lambda shape, p, g, device: torch.tensor(rng.random(shape) < p))
    with torch.no_grad():
        tm.transformer(x, True, torch.Generator())
        first = kept[0]
        kept.clear()
        tm.transformer(x)
    assert torch.equal(first, kept[0])


def _stack_cfg(blocks, every, **kw):
    from multi_modal_transformers_tokenmerge_torch.core.config import (
        AttentionConfig, TransformerConfig)
    return TransformerConfig(
        num_blocks=blocks,
        attention=AttentionConfig(num_heads=2, qkv_features=16,
                                  dropout_rate=0.0),
        mlp_dim=32, dropout_rate=0.0, compression_mode="merge",
        tome_merge_every=every, **kw)


TEXT_LAYOUT = ("[Text{4}] [Image{16};Readout{2}]",
               "[Text{0}] [Image{4};Readout{0}]")


def _build(cfg, strings=TEXT_LAYOUT):
    layout = SequenceLayout.from_strings(*strings)
    return tts.CompressedTransformerStack(cfg, layout, 16, device="cpu")


def test_grouped_bad_mode_rejected():
    with pytest.raises(ValueError, match="unknown compression mode"):
        _build(_stack_cfg(4, 2).replace(compression_mode="banana"))
    with pytest.raises(ValueError, match="unknown compression mode"):
        _build(_stack_cfg(2, 1).replace(compression_mode="banana"))


def test_merge_of_causal_text_set_rejected():
    strings = ("[Text{8}] [Image{16};Readout{2}]",
               "[Text{2}] [Image{4};Readout{0}]")
    with pytest.raises(ValueError, match="causal"):
        _build(_stack_cfg(4, 2), strings)
    # prune mode keeps the order and accepts the same layout
    stack = _build(_stack_cfg(4, 2).replace(compression_mode="prune"),
                   strings)
    for m in stack.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = stack(torch.zeros(1, 26, 16))
    assert tuple(out.shape) == (1, 20, 16)


def test_proportional_attention_rejected_in_staged_path():
    with pytest.raises(ValueError, match="proportional_attention"):
        _build(_stack_cfg(4, 2, proportional_attention=True))


def test_flash_rejected_in_per_layer_path():
    strings = (TEXT_LAYOUT[0], "[Text{0}] [Image{1};Readout{0}]")
    with pytest.raises(ValueError, match="flash"):
        _build(_stack_cfg(2, 1, attention_impl="flash"), strings)


def test_prestack_requires_active_compression():
    base = to_torch_config(octo_micro_tome_layers())
    cfg = base.replace(
        compression_sequence=None,
        transformer=base.transformer.replace(compression_mode="none",
                                             prestack_merge=True))
    with pytest.raises(ValueError, match="prestack_merge"):
        TOcto(cfg, device="meta", seed=None)
    # a compression string alone is not active compression either
    with pytest.raises(ValueError, match="prestack_merge"):
        TOcto(base.replace(transformer=base.transformer.replace(
            compression_mode="none", prestack_merge=True)), device="meta",
            seed=None)


def test_prestack_exhaustion_raises_loudly():
    strings = ("[TaskDescriptionPrefix{4}] [Image{16};Readout{2}]*2",
               "[TaskDescriptionPrefix{0}] [Image{2};Readout{0}]*2")
    with pytest.raises(ValueError, match="exhausted|cannot merge"):
        stack = _build(_stack_cfg(8, 1, prestack_merge=True), strings)
        stack(torch.zeros(1, 40, 16))


def test_plain_stack_ignores_compression_mode():
    """A compression_mode without a compressible layout runs the plain
    stack, as the JAX Octo does (models/octo.py:75-92): the port used to
    raise 'token merging / pruning is not ported yet' here."""
    from torch_parity import inputs, octo_micro_t5
    base = octo_micro_t5()
    jcfg = base.replace(transformer=base.transformer.replace(
        compression_mode="merge"))
    assert jcfg.compression_sequence is None
    jm, v, tm = micro_pair(jcfg)
    assert type(tm.transformer).__name__ == "TransformerStack"
    assert not tm.use_compression
    ids, images = inputs(jcfg, seed=4)
    ref = jm.apply(v, jnp.asarray(ids), jnp.asarray(images),
                   method="generate_readouts")
    with torch.no_grad():
        out = tm.generate_readouts(torch.tensor(ids).long(),
                                   torch.tensor(images))
    assert_close(out, ref, STACK_TOL)
    # a compression string of zero rates is not compressible either
    zero = jcfg.replace(compression_sequence=(
        "[TaskDescriptionPrefix{0}] [Image{0};Readout{0}]*2"))
    tz = TOcto(to_torch_config(zero), device="meta", seed=None)
    assert not tz.use_compression


def test_convert_layouts_of_both_cadences():
    """stage_{i} subtrees carry a leading layer axis and split; block_{l}
    subtrees do not, and hold query/key/value/out under the block."""
    for cfg, key, flax_path in (
            (CASES["staged_merge"], "transformer.stage_1.1.attention.query."
             "weight", ("stage_1", "attention", "query", "kernel")),
            (CASES["layers_merge"], "transformer.block_1.query.weight",
             ("block_1", "query", "kernel"))):
        _, v, tm = micro_pair(cfg)
        params = jax.tree.map(np.asarray, v["params"])
        leaf = params["transformer"]
        for p in flax_path:
            leaf = leaf[p]
        if "stage_1" in flax_path:
            assert leaf.shape == (2, 32, 2, 16)
            leaf = leaf[1]
        state = convert.from_flax(params, tm.config)
        np.testing.assert_array_equal(state[key].numpy(),
                                      leaf.reshape(32, 32).T)
        assert "transformer.final_norm.weight" not in state


# -- activations and attention probes -----------------------------------------

@pytest.mark.parametrize("case,activation", [
    ("layers", "gelu"), ("layers", "glu"), ("staged", "silu"),
    ("staged", "glu")])
def test_compressed_stack_activation_matches(case, activation):
    """Both cadences with another flax activation than relu, weights by
    convert.from_flax (glu: dense_out takes mlp_dim // 2 inputs)."""
    make = octo_micro_tome_layers if case == "layers" else \
        octo_micro_tome_staged
    cfg = make(mlp_activation=activation)
    jm, v, tm = micro_pair(cfg)
    x = _tokens(cfg, seed=3)
    ref = _jax_stack(jm, v, x)
    with torch.no_grad():
        out = tm.transformer(torch.tensor(x))
    assert_close(out, ref, STACK_TOL)


@pytest.mark.parametrize("case", ["layers_merge", "staged_merge",
                                  "staged_prune", "staged_three_stages",
                                  "staged_merge_prestack"])
def test_compressed_stack_probes_match(case):
    """capture_intermediates against apply(..., mutable=['intermediates']):
    one entry per stage at that stage's token count, its blocks stacked on
    axis 0; the per-layer blocks sow nothing in JAX and record nothing
    here.  f32, the stack's tolerance."""
    from multi_modal_transformers_tokenmerge_torch.modules.attention import (
        capture_intermediates)
    cfg = CASES[case]
    jm, v, tm = micro_pair(cfg)
    x = _tokens(cfg, seed=6)
    _, state = jm.apply(v, jnp.asarray(x), method=lambda m, t: m.transformer(
        t, deterministic=True), mutable=["intermediates"])
    ref = flat_intermediates(state.get("intermediates", {}))
    with torch.no_grad(), capture_intermediates(tm) as probes:
        tm.transformer(torch.tensor(x))
    assert sorted(probes) == sorted(ref)
    stages = tm.transformer.num_stages
    assert len(ref) == stages
    off = tm.transformer.off
    for i in range(stages):
        key = f"transformer/stage_{i}/attention/attention_weights"
        s = tm.layout.tokens_at_layer(i + off)
        blocks = len(getattr(tm.transformer, f"stage_{i}"))
        assert tuple(probes[key][0].shape) == ref[key][0].shape == (
            blocks, 2, 2, s, s)
        assert_close(probes[key][0], ref[key][0], STACK_TOL)


def test_full_model_probes_match():
    """The whole model's forward (embed text tower, image tower, staged
    ToMe stack): the same probe paths and weights as the JAX model's."""
    from multi_modal_transformers_tokenmerge_torch.modules.attention import (
        capture_intermediates)
    from torch_parity import inputs
    cfg = octo_micro_tome_staged(num_blocks=6)
    jm, v, tm = micro_pair(cfg)
    ids, images = inputs(cfg, seed=8)
    _, state = jm.apply(v, jnp.asarray(ids), jnp.asarray(images),
                        method="generate_readouts", mutable=["intermediates"])
    ref = flat_intermediates(state["intermediates"])
    with torch.no_grad(), capture_intermediates(tm) as probes:
        tm.generate_readouts(torch.from_numpy(ids).long(),
                             torch.from_numpy(images))
    assert sorted(probes) == sorted(ref) == [
        f"transformer/stage_{i}/attention/attention_weights"
        for i in range(3)]
    for key in ref:
        assert_close(probes[key][0], ref[key][0], STACK_TOL)
