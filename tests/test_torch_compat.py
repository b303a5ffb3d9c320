"""The port's ``compat.py`` and ``modules/value_tokenizer.py`` against the
JAX package's, on synthetic trees and inputs made from numpy seeds.

The converters are fed trees in the layouts the JAX converters read: an HF
``FlaxT5EncoderModel`` tree, a native tree from before the fused q|k|v
projection, and reference Octo trees in both of the reference's naming
schemes, each built from a seed (never from a checkpoint on disk).  The
port's result, a state_dict, must equal the JAX converter's result carried
over by ``convert``, bit for bit (the converters only move arrays).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_configs import octo_micro
from torch_parity import micro_pair, octo_micro_t5, to_torch_config
from multi_modal_transformers_tokenmerge_torch import compat as tc
from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_torch.modules import (
    value_tokenizer as tv)
from multi_modal_transformers_tokenmerge_torch.modules.t5 import (
    T5EncoderStack as TT5)
from multi_modal_transformers_tokenmerge_tpu import compat as jc
from multi_modal_transformers_tokenmerge_tpu.models.octo import Octo as JOcto
from multi_modal_transformers_tokenmerge_tpu.modules import (
    value_tokenizer as jv)
from multi_modal_transformers_tokenmerge_tpu.modules.t5 import (
    T5EncoderStack as JT5)

TOL = 1e-6


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _assert_states_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


# -- value tokenizer -----------------------------------------------------------

@pytest.mark.parametrize("mu", [255.0, 15.0])
def test_mu_law_matches_jax(mu):
    x = np.random.default_rng(0).uniform(-1, 1, (64,)).astype(np.float32)
    x[:3] = (0.0, -1.0, 1.0)
    enc = tv.mu_law_encode(torch.tensor(x), mu)
    np.testing.assert_allclose(_np(enc), np.asarray(
        jv.mu_law_encode(jnp.asarray(x), mu)), rtol=TOL, atol=TOL)
    dec = tv.mu_law_decode(enc, mu)
    np.testing.assert_allclose(_np(dec), np.asarray(
        jv.mu_law_decode(jnp.asarray(_np(enc)), mu)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(dec), x, atol=1e-5)
    np.testing.assert_array_equal(_np(tc.mu_law_encoder(torch.tensor(x))),
                                  _np(tv.mu_law_encode(torch.tensor(x))))


def test_action_tokenizer_matches_jax():
    jm = jv.ActionTokenizer(num_actions=10, embedding_dim=6)
    ids = np.random.default_rng(1).integers(0, 10, (3, 5)).astype(np.int32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    tm = tv.ActionTokenizer(10, 6)
    tm.load_state_dict(convert.tree_to_state(
        jax.tree.map(np.asarray, v["params"])))
    np.testing.assert_array_equal(
        _np(tm(torch.tensor(ids, dtype=torch.long))),
        np.asarray(jm.apply(v, jnp.asarray(ids))))
    assert list(tm.state_dict()) == ["action_embedding.weight"]


# -- reference-compatible names ------------------------------------------------

def test_image_to_patches_matches_jax():
    img = np.random.default_rng(2).integers(0, 256, (8, 12, 3)).astype(
        np.float32)
    for normalize in (True, False):
        np.testing.assert_allclose(
            _np(tc.image_to_patches(torch.tensor(img), 4, normalize)),
            np.asarray(jc.image_to_patches(jnp.asarray(img), 4, normalize)),
            rtol=TOL, atol=TOL)


@pytest.mark.parametrize("class_token,distill_token", [
    (False, False), (True, False), (True, True)])
def test_merge_closure_matches_jax(class_token, distill_token):
    rng = np.random.default_rng(3)
    metric = rng.normal(size=(2, 11, 6)).astype(np.float32)
    x = rng.normal(size=(2, 11, 5)).astype(np.float32)
    merge_t = tc.bipartite_soft_matching(torch.tensor(metric), 3,
                                         class_token, distill_token)
    merge_j = jc.bipartite_soft_matching(jnp.asarray(metric), 3,
                                         class_token, distill_token)
    np.testing.assert_allclose(_np(merge_t(torch.tensor(x))),
                               np.asarray(merge_j(jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    xt, st = tc.merge_wavg(merge_t, torch.tensor(x))
    xj, sj = jc.merge_wavg(merge_j, jnp.asarray(x))
    np.testing.assert_allclose(_np(xt), np.asarray(xj), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(_np(st), np.asarray(sj))
    identity = tc.bipartite_soft_matching(torch.tensor(metric), 0)
    assert torch.equal(identity(torch.tensor(x)), torch.tensor(x))


def test_compute_top_k_tokens_matches_jax():
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(10, 3)).astype(np.float32)
    scores = rng.normal(size=(10,)).astype(np.float32)
    idx, k = ((0, 4), (4, 6)), (2, 3)
    np.testing.assert_array_equal(
        _np(tc.compute_top_k_tokens(torch.tensor(emb), torch.tensor(scores),
                                    idx, k)),
        np.asarray(jc.compute_top_k_tokens(jnp.asarray(emb),
                                           jnp.asarray(scores), idx, k)))


@pytest.mark.parametrize("spec", [
    ("[TaskDescriptionPrefix{4}] [Image{4};Readout{2}]*2", None),
    ("[TaskDescriptionPrefix{4}] [Image{16};Readout{2}]*2",
     "[TaskDescriptionPrefix{0}] [Image{2};Readout{0}]*2")])
def test_token_sequence_matches_jax(spec):
    t, j = tc.TokenSequence(*spec), jc.TokenSequence(*spec)
    assert t.slice_idx == j.slice_idx
    assert t.tokenset_slices == j.tokenset_slices
    for layer in (None, 1):
        np.testing.assert_array_equal(
            _np(t.generate_attention_mask(3, layer)),
            np.asarray(j.generate_attention_mask(3, layer)))
    for modality in ("text", "images", "readouts"):
        np.testing.assert_array_equal(_np(t.get_modality_idx(modality)),
                                      np.asarray(j.get_modality_idx(modality)))
    assert [(s.kind, s.num_tokens, s.timestep, s.compressed_per_layer)
            for s in t.generate_layer_token_sequence(1)] == \
        [(s.kind, s.num_tokens, s.timestep, s.compressed_per_layer)
         for s in j.generate_layer_token_sequence(1)]
    layout = t.layout
    rng = np.random.default_rng(5)
    parts = [rng.normal(size=(2, layout.modality_tokens(m), 3)).astype(
        np.float32) for m in ("text", "images", "readouts")]
    np.testing.assert_array_equal(
        _np(t.assemble_embeddings(tc.TokenEmbeddings(
            *map(torch.tensor, parts)))),
        np.asarray(j.assemble_embeddings(jc.TokenEmbeddings(
            *map(jnp.asarray, parts)))))


def test_heads_names_match_jax():
    x = np.linspace(-1.2, 1.2, 25).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tc.assign_bins(torch.tensor(x), (-1.0, 1.0), 8)),
        np.asarray(jc.assign_bins(jnp.asarray(x), (-1.0, 1.0), 8)))
    np.testing.assert_allclose(tc.cosine_beta_schedule(32),
                               np.asarray(jc.cosine_beta_schedule(32)),
                               rtol=1e-6, atol=1e-7)


# -- converters ----------------------------------------------------------------

def _hf_t5(rng, layers=2, d=16, heads=2, d_kv=8, d_ff=24, vocab=40,
           buckets=8):
    """A synthetic HF FlaxT5EncoderModel parameter tree (the relative
    bias in the first block only, as HF keeps it)."""
    f = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)
    block = lambda i: {"layer": {
        "0": {"SelfAttention": {
            "q": {"kernel": f(d, heads * d_kv)},
            "k": {"kernel": f(d, heads * d_kv)},
            "v": {"kernel": f(d, heads * d_kv)},
            "o": {"kernel": f(heads * d_kv, d)},
            **({"relative_attention_bias": {"embedding": f(buckets, heads)}}
               if i == 0 else {})},
              "layer_norm": {"weight": 1.0 + f(d)}},
        "1": {"DenseReluDense": {"wi": {"kernel": f(d, d_ff)},
                                 "wo": {"kernel": f(d_ff, d)}},
              "layer_norm": {"weight": 1.0 + f(d)}}}}
    return {"shared": {"embedding": f(vocab, d)},
            "encoder": {"block": {str(i): block(i) for i in range(layers)},
                        "final_layer_norm": {"weight": 1.0 + f(d)}}}


def test_hf_t5_converter_matches_jax_and_runs():
    hf = _hf_t5(np.random.default_rng(6))
    got = tc.convert_hf_t5_encoder_params(hf)
    ref_tree = jax.tree.map(np.asarray, jc.convert_hf_t5_encoder_params(hf))
    _assert_states_equal(got, convert.tree_to_state(ref_tree,
                                                    (("blocks",),)))
    tower = TT5(vocab_size=40, d_model=16, num_layers=2, num_heads=2,
                d_kv=8, d_ff=24, rel_pos_buckets=8, rel_pos_max_distance=16)
    tower.load_state_dict(got)
    ids = np.random.default_rng(7).integers(0, 40, (2, 6)).astype(np.int32)
    jt = JT5(vocab_size=40, d_model=16, num_layers=2, num_heads=2, d_kv=8,
             d_ff=24, rel_pos_buckets=8, rel_pos_max_distance=16)
    want = jt.apply({"params": ref_tree}, jnp.asarray(ids))
    with torch.no_grad():
        out = tower(torch.tensor(ids, dtype=torch.long))
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _split_qkv(tree):
    """The native layout from before the fused projection: every
    ``{qkv, o}`` node back to ``{q, k, v, o}``."""
    if not isinstance(tree, dict):
        return tree
    if "qkv" in tree and "o" in tree:
        fused = np.asarray(tree["qkv"]["kernel"])
        rest = {k: _split_qkv(v) for k, v in tree.items() if k != "qkv"}
        return {**{n: {"kernel": np.take(fused, i, axis=-3)}
                   for i, n in enumerate("qkv")}, **rest}
    return {k: _split_qkv(v) for k, v in tree.items()}


def test_upgrade_fused_qkv_matches_jax():
    cfg = octo_micro_t5()
    _, v, tm = micro_pair(cfg)
    native = jax.tree.map(np.asarray, v["params"])
    old = _split_qkv(native)
    assert "q" in old["text_encoder"]["t5_encoder"]["blocks"]["attn"]
    got = tc.upgrade_fused_qkv_params(old, tm.config)
    upgraded = jax.tree.map(np.asarray, jc.upgrade_fused_qkv_params(old))
    _assert_states_equal(got, convert.from_flax(upgraded, tm.config))
    _assert_states_equal(got, tm.state_dict())
    # an already fused tree passes as it is
    _assert_states_equal(tc.upgrade_fused_qkv_params(native, tm.config),
                         tm.state_dict())


def _reference_tree(native, numbered: bool):
    """The reference's layout of a native micro Octo tree: hydra
    auto-numbered names, or the attribute names of pre-instantiated
    sub-configs (the MLP denses flat in the block scope there)."""
    n = native
    rn = n["image_encoder"]["resnet"]
    blocks = n["transformer"]["blocks"]
    den = n["diffusion_action_head"]["denoiser"]
    first = {"kernel": np.concatenate([den["noisy_proj"]["kernel"],
                                       den["time_proj"]["kernel"],
                                       den["readout_proj"]["kernel"]]),
             "bias": den["noisy_proj"]["bias"]}
    attn = {k: blocks["attention"][k]
            for k in ("query", "key", "value", "out")}
    fourier = den["time_encoder"]
    if numbered:
        return {
            "text_encoder": {"Embed_0": n["text_encoder"]["token_embedding"],
                             "Embed_1": n["text_encoder"][
                                 "position_embedding"]},
            "image_encoder": {
                "ResNetV2Block_0": {
                    "Conv_0": rn["input_conv"], "Conv_1": rn["block0_conv"],
                    "GroupNorm_0": rn["block0_norm"],
                    "Dense_0": rn["output_dense"]},
                "Embed_0": n["image_encoder"]["row_position_embedding"],
                "Embed_1": n["image_encoder"]["col_position_embedding"]},
            "readout_encoder": n["readout_encoder"],
            "attention_blocks": {
                "posembed_input": n["transformer"]["posembed_input"],
                "ScanEncoder1DBlock_0": {
                    "LayerNorm_0": blocks["ln_attention"],
                    "LayerNorm_1": blocks["ln_mlp"],
                    "MultiHeadDotProductAttention_0": attn,
                    "MLPBlock_0": {"Dense_0": blocks["mlp"]["dense_in"],
                                   "Dense_1": blocks["mlp"]["dense_out"]}}},
            "continuous_action_head": {
                "Dense_0": n["continuous_action_head"]["mean"]},
            "categorical_action_head": {
                "Dense_0": n["categorical_action_head"]["logits"]},
            "diffusion_action_head": {"OctoDenoise_0": {
                "FourierFeatures_0": {
                    "fourier_kernel": fourier["fourier_kernel"],
                    "MLPBlock_0": {"Dense_0": fourier["mlp"]["dense_in"],
                                   "Dense_1": fourier["mlp"]["dense_out"]}},
                "MLPBlock_0": {"Dense_0": first,
                               "Dense_1": den["first_out"]}}},
        }
    return {
        "text_encoder": {"embedding": n["text_encoder"]["token_embedding"],
                         "position_embedding": n["text_encoder"][
                             "position_embedding"]},
        "image_encoder": {
            "resnet": {"input_conv": rn["input_conv"],
                       "resnet_norm": rn["block0_norm"],
                       "resnet_conv": rn["block0_conv"],
                       "output_dense": rn["output_dense"]},
            "row_embeddings": n["image_encoder"]["row_position_embedding"],
            "col_embeddings": n["image_encoder"]["col_position_embedding"]},
        "readout_encoder": n["readout_encoder"],
        "attention_blocks": {
            "posembed_input": n["transformer"]["posembed_input"],
            "ScanEncoder1DBlock": {
                "LayerNorm_0": blocks["ln_attention"],
                "LayerNorm_1": blocks["ln_mlp"], "SelfAttention": attn,
                "Dense_0": blocks["mlp"]["dense_in"],
                "Dense_1": blocks["mlp"]["dense_out"]}},
        "continuous_action_head": {
            "dense": n["continuous_action_head"]["mean"]},
        "categorical_action_head": {
            "dense": n["categorical_action_head"]["logits"]},
        "diffusion_action_head": {"denoiser": {
            "time_encoder": {"fourier_kernel": fourier["fourier_kernel"],
                             "mlp_block": {
                                 "dense": fourier["mlp"]["dense_in"],
                                 "dense_out": fourier["mlp"]["dense_out"]}},
            "mlp_block": {"dense": first, "dense_out": den["first_out"]}}},
    }


@pytest.mark.parametrize("numbered", [True, False])
def test_reference_octo_converter_matches_jax(numbered):
    cfg = octo_micro()
    jm = JOcto(cfg)
    rng = np.random.default_rng(8)
    images = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    v = jm.init({"params": jax.random.PRNGKey(2),
                 "diffusion": jax.random.PRNGKey(3)},
                jnp.zeros((2, 4), jnp.int32), jnp.asarray(images))
    native = jax.tree.map(np.asarray, v["params"])
    ref = _reference_tree(native, numbered)
    tcfg = to_torch_config(cfg)
    got = tc.convert_reference_octo_params(ref, tcfg)
    from_jax = jax.tree.map(np.asarray, jc.convert_reference_octo_params(ref))
    _assert_states_equal(got, convert.from_flax(from_jax, tcfg))
    _assert_states_equal(got, convert.from_flax(native, tcfg))
    model = TOcto(tcfg, device="cpu", seed=None)
    model.load_state_dict(got)
    with pytest.raises(ValueError, match="inconsistent"):
        bad = _reference_tree(native, numbered)
        head = bad["diffusion_action_head"]
        den = head["OctoDenoise_0" if numbered else "denoiser"]
        block = den["MLPBlock_0" if numbered else "mlp_block"]
        block["Dense_0" if numbered else "dense"]["kernel"] = \
            block["Dense_0" if numbered else "dense"]["kernel"][:8]
        tc.convert_reference_octo_params(bad, tcfg)
