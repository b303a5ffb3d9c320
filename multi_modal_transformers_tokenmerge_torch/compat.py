"""Reference-compatible names, mapped onto the port.

Counterpart of the JAX package's ``compat.py``: users migrating from the
reference (``maggieHao/multi_modal_transformers_TokenMerge``) import the
names they know here.

Covered (reference -> here):
  tokenizers.token_sequencer.TokenSequence      -> TokenSequence
  tokenizers.token_sequencer.TokenEmbeddings    -> TokenEmbeddings
  tokenizers.token_compression.bipartite_soft_matching -> the same, in the
      merge-closure form
  tokenizers.token_compression.merge_wavg       -> merge_wavg
  tokenizers.token_compression.compute_top_k_tokens -> compute_top_k_tokens
  tokenizers.images.image_tokenizer.image_to_patches -> image_to_patches
  tokenizers.numeric_values.value_tokenizer.mu_law_encoder -> mu_law_encoder
  action_heads.categorical.assign_bins          -> assign_bins
  action_heads.diffusion.cosine_beta_schedule   -> cosine_beta_schedule
  models.octo.Octo                              -> models.octo.Octo

Weight migration, each into the port's ``state_dict``:
  convert_reference_octo_params(ref_params, cfg) -- a reference Octo
      parameter tree -> ``Octo(cfg)``'s state_dict;
  convert_hf_t5_encoder_params(hf_params) -- HF ``FlaxT5EncoderModel``
      parameters -> ``modules.t5.T5EncoderStack``'s state_dict;
  upgrade_fused_qkv_params(params, cfg) -- a native (JAX package) tree
      saved before the fused q|k|v projection -> ``Octo(cfg)``'s
      state_dict.
Each walks the source tree as the JAX converter does (numpy arrays in
nested dicts), into the JAX package's layout, which ``convert`` then
carries over.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .convert import from_flax, tree_to_state
from .heads.categorical import assign_bins  # noqa: F401
from .heads.diffusion import cosine_beta_schedule  # noqa: F401
from .models.octo import Octo, TokenEmbeddings  # noqa: F401
from .modules.value_tokenizer import mu_law_encode as mu_law_encoder  # noqa: F401
from .ops import tome as _tome
from .ops.image_ops import patchify
from .ops.pruning import prune_gather, topk_tokens_per_set
from .sequence.dsl import TokenSetSpec
from .sequence.layout import SequenceLayout

__all__ = [
    "TokenSequence", "TokenEmbeddings", "bipartite_soft_matching",
    "merge_wavg", "compute_top_k_tokens", "image_to_patches",
    "mu_law_encoder", "assign_bins", "cosine_beta_schedule", "Octo",
    "convert_reference_octo_params", "convert_hf_t5_encoder_params",
    "upgrade_fused_qkv_params",
]


def image_to_patches(image, patch_size, normalize):
    """(H, W, C) image -> (P, p, p, C) patches."""
    return patchify(image, patch_size, normalize)


def bipartite_soft_matching(metric, r, class_token=False,
                            distill_token=False):
    """Reference-style merge closure: ``merge(x, mode='sum')`` built from a
    static match plan."""
    plan = _tome.bipartite_soft_matching(metric, r, class_token=class_token,
                                         distill_token=distill_token)

    def merge(x, mode="sum"):
        if plan is None:
            return x
        return _tome.apply_merge(plan, x, mode=mode)

    return merge


def merge_wavg(merge, x, size=None):
    """Size-weighted merge through a reference-style closure."""
    if size is None:
        size = torch.ones_like(x[..., :1])
    x = merge(x * size, mode="sum")
    size = merge(size, mode="sum")
    return x / size, size


def compute_top_k_tokens(embeddings, importance_scores, tokenset_idx,
                         tokenset_k):
    """Per-set top-k pruning, the unbatched reference signature:
    embeddings (T, C), scores (T,)."""
    keep = topk_tokens_per_set(importance_scores[None], tuple(tokenset_idx),
                               tuple(tokenset_k), sort_kept=False)
    return prune_gather(embeddings[None], keep)[0]


class TokenSequence:
    """Reference-compatible facade over the static SequenceLayout: slice
    tables are reusable tuples, masks come from numpy constants, and
    assembly is one gather."""

    def __init__(self, token_sequence: str,
                 token_compression_sequence: Optional[str] = None):
        self.token_sequence_str = token_sequence
        self.token_compression_sequence_str = token_compression_sequence
        self.layout = SequenceLayout.from_strings(
            token_sequence, token_compression_sequence)
        self.token_sequence = self.layout.sets
        self.slice_idx = self.layout.modality_slices()
        self.tokenset_slices = self.layout.set_slices()

    def generate_attention_mask(self, repeats: int = 1,
                                layer: Optional[int] = None):
        mask = torch.as_tensor(self.layout.attention_mask(layer or 0))
        return mask[None].repeat(repeats, 1, 1)

    def assemble_embeddings(self, embeddings: TokenEmbeddings,
                            slice_idx=None):
        combined = torch.cat(
            [embeddings.text, embeddings.images, embeddings.readouts], dim=1)
        perm = torch.as_tensor(self.layout.assembly_permutation,
                               dtype=torch.long, device=combined.device)
        return combined.index_select(1, perm)

    def get_modality_idx(self, modality: str):
        return torch.as_tensor(self.layout.modality_index(modality))

    def generate_layer_token_sequence(self, layer: int):
        return tuple(
            TokenSetSpec(s.kind, s.tokens_at_layer(layer), s.timestep,
                         s.compressed_per_layer)
            for s in self.layout.sets)


# -- parameter-tree converters ----------------------------------------------

def _pick(tree, *candidates):
    """Tolerant child lookup: exact names first (flax attribute names and
    hydra auto-numbered names), then a unique-prefix match."""
    for name in candidates:
        if name in tree:
            return tree[name]
    for name in candidates:
        hits = sorted(k for k in tree if k.startswith(name))
        if len(hits) == 1:
            return tree[hits[0]]
    raise KeyError(f"none of {candidates} in {sorted(tree)}")


def _numbered(tree, prefix):
    """All children named ``prefix_<i>``, in index order."""
    hits = [k for k in tree if k.startswith(prefix + "_")]
    return [tree[k] for k in sorted(hits,
                                    key=lambda k: int(k.rsplit("_", 1)[-1]))]


def _hf_t5_tree(hf_params) -> dict:
    """HF ``FlaxT5EncoderModel`` tree -> the JAX package's T5EncoderStack
    tree: q|k|v stacked into one fused (layers, d_model, 3, heads, d_kv)
    kernel, every block leaf stacked on a leading layer axis."""
    enc = hf_params["encoder"]
    block_keys = sorted(enc["block"], key=int)
    first_attn = enc["block"][block_keys[0]]["layer"]["0"]["SelfAttention"]
    d_model = np.shape(first_attn["q"]["kernel"])[0]
    rel_bias = np.asarray(first_attn["relative_attention_bias"]["embedding"])
    num_heads = rel_bias.shape[1]
    d_kv = np.shape(first_attn["q"]["kernel"])[1] // num_heads

    def stack(fn):
        return np.stack([np.asarray(fn(enc["block"][k]["layer"]))
                         for k in block_keys])

    qkv = np.stack(
        [stack(lambda l, name=name: np.asarray(
            l["0"]["SelfAttention"][name]["kernel"]).reshape(
                d_model, num_heads, d_kv))
         for name in ("q", "k", "v")], axis=2)
    return {
        "token_embedding": {"embedding": hf_params["shared"]["embedding"]},
        "relative_attention_bias": {"embedding": rel_bias},
        "blocks": {
            "attn_norm": {"scale": stack(
                lambda l: l["0"]["layer_norm"]["weight"])},
            "attn": {
                "qkv": {"kernel": qkv},
                "o": {"kernel": stack(
                    lambda l: np.asarray(l["0"]["SelfAttention"]["o"][
                        "kernel"]).reshape(num_heads, d_kv, d_model))},
            },
            "mlp_norm": {"scale": stack(
                lambda l: l["1"]["layer_norm"]["weight"])},
            "wi": {"kernel": stack(
                lambda l: l["1"]["DenseReluDense"]["wi"]["kernel"])},
            "wo": {"kernel": stack(
                lambda l: l["1"]["DenseReluDense"]["wo"]["kernel"])},
        },
        "final_norm": {"scale": enc["final_layer_norm"]["weight"]},
    }


def convert_hf_t5_encoder_params(hf_params) -> dict:
    """HF ``FlaxT5EncoderModel`` parameters -> the state_dict of the port's
    :class:`modules.t5.T5EncoderStack` (to load under
    ``text_encoder.t5_encoder.`` of an Octo model with a T5 tower)."""
    return tree_to_state(_hf_t5_tree(hf_params), (("blocks",),))


def _fuse_qkv(params):
    """The JAX package's fused-qkv upgrade of a native tree: each
    ``{q, k, v, o}`` attention node becomes ``{qkv, o}`` with the three
    kernels stacked on a new axis -3; fused trees pass unchanged."""
    if not isinstance(params, dict):
        return params
    if {"q", "k", "v", "o"} <= set(params) and "qkv" not in params:
        fused = np.stack([np.asarray(params[n]["kernel"])
                          for n in ("q", "k", "v")], axis=-3)
        rest = {k: _fuse_qkv(v) for k, v in params.items()
                if k not in ("q", "k", "v")}
        return {"qkv": {"kernel": fused}, **rest}
    return {k: _fuse_qkv(v) for k, v in params.items()}


def upgrade_fused_qkv_params(params, cfg) -> dict:
    """A native parameter tree of the JAX package saved before the fused
    q|k|v projection (``attn/{q,k,v}/kernel`` of shape ([layers,] d_model,
    heads, d_kv)) -> ``Octo(cfg)``'s state_dict; an already fused tree
    converts as it is."""
    return from_flax(_fuse_qkv(dict(params)), cfg)


def _convert_resnet(resnet):
    """Reference ResNetV2Block params -> the ResNetV2Embedder tree.  Two
    source shapes: hydra auto-numbered (Conv_0 the input conv, Conv_1.. the
    block convs, GroupNorm_0..) or attribute-named (input_conv /
    resnet_norm / resnet_conv, one conv and norm shared across the loop:
    num_blocks == 1 only)."""
    numbered_convs = _numbered(resnet, "Conv")
    if numbered_convs:
        input_conv, block_convs = numbered_convs[0], numbered_convs[1:]
        norms = _numbered(resnet, "GroupNorm")
    else:
        input_conv = resnet["input_conv"]
        block_convs = ([resnet["resnet_conv"]]
                       if "resnet_conv" in resnet else [])
        norms = [resnet["resnet_norm"]] if "resnet_norm" in resnet else []
    out = {"input_conv": input_conv,
           "output_dense": _pick(resnet, "output_dense", "Dense")}
    for i, (n, c) in enumerate(zip(norms, block_convs)):
        out[f"block{i}_norm"] = n
        out[f"block{i}_conv"] = c
    return out


def _convert_denoiser(ref, time_dim: int, embed_dim: int):
    """Reference OctoDenoise -> the split-projection denoiser: the first
    dense acts on concat([noisy (A), time_emb, readout]); its kernel rows
    split by source."""
    fourier = _pick(ref, "time_encoder", "FourierFeatures")
    fourier_mlp = _pick(fourier, "mlp_block", "MLPBlock")
    f_in = _pick(fourier_mlp, "dense", "Dense_0")
    f_out = _pick(fourier_mlp, "dense_out", "Dense_1")
    try:
        block = _pick(ref, "mlp_block")
    except KeyError:
        block = _numbered(ref, "MLPBlock")[-1]
    b_in = _pick(block, "dense", "Dense_0")
    b_out = _pick(block, "dense_out", "Dense_1")
    k0 = np.asarray(b_in["kernel"])
    action_dim = k0.shape[0] - time_dim - embed_dim
    if action_dim <= 0:
        raise ValueError(
            f"denoiser input dim {k0.shape[0]} inconsistent with "
            f"time_dim={time_dim} embed_dim={embed_dim}")
    return {
        "time_encoder": {
            "fourier_kernel": fourier["fourier_kernel"],
            "mlp": {"dense_in": f_in, "dense_out": f_out},
        },
        "noisy_proj": {"kernel": k0[:action_dim], "bias": b_in["bias"]},
        "time_proj": {"kernel": k0[action_dim:action_dim + time_dim]},
        "readout_proj": {"kernel": k0[action_dim + time_dim:]},
        "first_out": b_out,
    }


def _reference_octo_tree(ref) -> dict:
    """A reference Octo tree -> the JAX package's native Octo tree (an
    ``embed`` text encoder; only the heads present in the source)."""
    out = {}
    text = _pick(ref, "text_encoder")
    out["text_encoder"] = {
        "token_embedding": _pick(text, "embedding", "Embed_0"),
        "position_embedding": _pick(text, "position_embedding", "Embed_1"),
    }
    image = _pick(ref, "image_encoder")
    out["image_encoder"] = {
        "resnet": _convert_resnet(
            _pick(image, "resnet", "embedding_function", "ResNetV2Block")),
        "row_position_embedding": _pick(image, "row_position_embedding",
                                        "row_embeddings", "Embed_0"),
        "col_position_embedding": _pick(image, "col_position_embedding",
                                        "col_embeddings", "Embed_1"),
    }
    out["readout_encoder"] = {
        "pos_embedding": _pick(ref, "readout_encoder")["pos_embedding"]}
    attn_blocks = _pick(ref, "attention_blocks")
    stack = _pick(attn_blocks, "ScanEncoder1DBlock")
    attn = _pick(stack, "MultiHeadDotProductAttention", "SelfAttention")
    try:
        mlp = _pick(stack, "MLPBlock")
        mlp_in, mlp_out = _pick(mlp, "dense", "Dense_0"), _pick(
            mlp, "dense_out", "Dense_1")
    except KeyError:  # the MLP denses flat in the block scope
        mlp_in, mlp_out = stack["Dense_0"], stack["Dense_1"]
    out["transformer"] = {
        "posembed_input": attn_blocks["posembed_input"],
        "blocks": {
            "ln_attention": stack["LayerNorm_0"],
            "ln_mlp": stack["LayerNorm_1"],
            "attention": {"query": attn["query"], "key": attn["key"],
                          "value": attn["value"], "out": attn["out"]},
            "mlp": {"dense_in": mlp_in, "dense_out": mlp_out},
        },
    }
    embed_dim = np.shape(out["readout_encoder"]["pos_embedding"])[-1]
    if "continuous_action_head" in ref:
        out["continuous_action_head"] = {
            "mean": _pick(ref["continuous_action_head"], "dense", "Dense")}
    if "categorical_action_head" in ref:
        out["categorical_action_head"] = {
            "logits": _pick(ref["categorical_action_head"], "dense",
                            "Dense")}
    if "diffusion_action_head" in ref:
        den = _pick(ref["diffusion_action_head"], "denoising_model",
                    "denoiser", "OctoDenoise")
        fourier = _pick(den, "time_encoder", "FourierFeatures")
        f_out = _pick(_pick(fourier, "mlp_block", "MLPBlock"),
                      "dense_out", "Dense_1")
        time_dim = np.shape(f_out["kernel"])[-1]
        out["diffusion_action_head"] = {
            "denoiser": _convert_denoiser(den, time_dim, embed_dim)}
    return out


def convert_reference_octo_params(ref_params, cfg) -> dict:
    """A reference ``Octo`` parameter tree -> ``Octo(cfg)``'s state_dict.
    Both flax naming schemes of the reference are read (attribute names
    where sub-configs were pre-instantiated, ``Type_N`` auto-numbering
    under plain hydra); ``cfg`` must name the heads the tree holds.  An
    ``embed`` text encoder is assumed; for the HF T5 tower use
    :func:`convert_hf_t5_encoder_params`."""
    return from_flax(_reference_octo_tree(ref_params), cfg)
