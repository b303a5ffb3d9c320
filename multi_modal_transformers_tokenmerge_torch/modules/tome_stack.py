"""Compressed transformer stack: ToMe merging or attention-score pruning
between layers, over statically shrinking per-layer sequence layouts.

Counterpart of the JAX package's ``modules/tome_stack.py``.

* Layer ``l`` consumes ``S_l`` tokens and produces ``S_{l+1}``; the counts
  come from the compression DSL, so every layer has fixed shapes.
* Compression happens between attention and MLP, on the residual stream,
  and per token set: only sets with a nonzero rate are touched.
* The merge metric of a per-layer block is the attention-key mean over
  heads; the pruning importance is the mean pre-dropout attention weight
  over heads and queries.  A standalone event between stages uses the
  hidden state itself (cosine metric, or L2-norm importance).
* ``merge_wavg`` size tracking carries through the whole stack, in the
  compute dtype; proportional attention adds ``log(size)`` to the logits.
* Under a model axis (``parallel.mesh.shard_params``) a per-layer block
  splits its heads as ``attention.MultiHeadAttention`` does; its merge
  metric and pruning importance, means over every head, are its heads'
  sums summed over the model axis, so every rank takes the same plan.
* With ``mlp_type='moe'`` every block's MLP is the routed ``moe`` block;
  its capacity follows each layer's or stage's token count, and the stack
  hands the pre-weighted balance loss on in ``moe_aux``.

Every stage mask is a buffer on the model's device, and with
``attention_impl='flash'`` (or ``'auto'`` past its gate) each stage runs
the flash kernels on its own mask, whose device tables are built here,
when the stack is built.

Every rejection of the JAX stack raises here when the stack is built, not
at its first call.  ``cfg.remat`` recomputes every block in the backward,
in both cadences (``attention.call_block``), as the JAX stack's
``nn.remat``: a per-layer block's merge plan and token sizes are outputs
of the recomputed call, which must make the forward's plan again; the
events between stages are not recomputed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.config import TransformerConfig
from ..ops.pruning import prune_gather, topk_tokens_per_set
from ..ops.tome import bipartite_soft_matching, merge_wavg
from ..sequence.dsl import KIND_TEXT
from ..sequence.layout import SequenceLayout
from ..core.tensor_parallel import from_model, to_model
from ..utils.profiling import section
from .attention import (AddPositionEmbedding, EncoderBlock,
                        MultiHeadAttention, call_block, layer_norm_dim,
                        make_mlp, masked_attention, mlp_branch,
                        select_attention_fn)
from .layers import Dense, LayerNorm, dropout
from .moe import sum_aux

__all__ = ["CompressedEncoderBlock", "CompressedTransformerStack"]


def _merge_sets(x, size, metric, layout: SequenceLayout, layer: int):
    """Per-set ToMe merge of the residual stream with the 'stable' match
    ordering.  x (B, S_l, E), size (B, S_l, 1), metric (B, S_l, D) ->
    (B, S_{l+1}, E), (B, S_{l+1}, 1)."""
    with section("model.merge"):
        xs, sizes = [], []
        for (start, n), n_next in zip(layout.set_slices(layer),
                                      layout.set_counts_at_layer(layer + 1)):
            x_i = x[:, start:start + n]
            s_i = size[:, start:start + n]
            r = n - n_next
            if r > 0:
                plan = bipartite_soft_matching(metric[:, start:start + n], r,
                                               ordering="stable")
                x_i, s_i = merge_wavg(plan, x_i, s_i)
            xs.append(x_i)
            sizes.append(s_i)
        return torch.cat(xs, dim=1), torch.cat(sizes, dim=1)


def _prune_sets(x, size, importance, layout: SequenceLayout, layer: int):
    """Per-set top-k pruning of the residual stream."""
    keep_idx = topk_tokens_per_set(importance, layout.set_slices(layer),
                                   layout.set_counts_at_layer(layer + 1))
    return prune_gather(x, keep_idx), prune_gather(size, keep_idx)


def _mask_buffer(layout: SequenceLayout, layer: int, device) -> torch.Tensor:
    return torch.as_tensor(layout.attention_mask(layer), device=device)


class CompressedEncoderBlock(nn.Module):
    """Pre-LN encoder block that shrinks the sequence between attention and
    MLP.  The attention weights are explicit when pruning, proportional
    attention or weight dropout need them, and the fused plain attention
    otherwise."""

    def __init__(self, cfg: TransformerConfig, layout: SequenceLayout,
                 layer: int, features: int, *, device=None, **kw):
        super().__init__()
        if cfg.compression_mode not in ("merge", "prune"):
            raise ValueError(
                f"unknown compression mode {cfg.compression_mode!r}")
        kw = dict(kw, device=device)
        a = cfg.attention
        if a.qkv_features % a.num_heads:
            raise ValueError("qkv_features must divide into num_heads")
        self.cfg = cfg
        self.layout = layout
        self.layer = layer
        self.num_heads = a.num_heads
        self.head_dim = a.qkv_features // a.num_heads
        ln = lambda: LayerNorm(features, cfg.layer_norm_epsilon,
                               layer_norm_dim(cfg), **kw)
        proj = lambda: Dense(features, a.qkv_features, bias=a.use_bias, **kw)
        self.ln_attention = ln()
        self.query, self.key, self.value = proj(), proj(), proj()
        self.out = Dense(a.qkv_features, features, bias=a.use_bias, **kw)
        self.ln_mlp = ln()
        self.mlp_name = "moe" if cfg.mlp_type == "moe" else "mlp"
        self.add_module(self.mlp_name, make_mlp(cfg, features, **kw))
        self.register_buffer("mask", _mask_buffer(layout, layer, device),
                             persistent=False)

    def split(self):
        """The model-axis split of the heads, as
        ``MultiHeadAttention.split``; None when the block is whole."""
        return MultiHeadAttention.split(self)

    def forward(self, x, size, train: bool = False,
                rng: Optional[torch.Generator] = None,
                aux: Optional[list] = None):
        c = self.cfg
        rate = c.attention.dropout_rate
        b, t, _ = x.shape
        split = self.split()
        heads = self.num_heads // (1 if split is None else split.size)
        h0 = 0 if split is None else split.rank * heads
        y = to_model(self.ln_attention(x), split)
        q, k, v = (proj.column(y).reshape(b, t, heads, self.head_dim)
                   for proj in (self.query, self.key, self.value))

        need_weights = (c.compression_mode == "prune"
                        or c.proportional_attention
                        or (rate > 0.0 and train))
        if need_weights:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            logits = logits / math.sqrt(self.head_dim)
            if c.proportional_attention:
                logits = logits + torch.log(size)[:, None, None, :, 0]
            logits = logits.masked_fill(~self.mask,
                                        torch.finfo(torch.float32).min)
            # the pruning importance reads the pre-dropout weights
            clean_weights = torch.softmax(logits, dim=-1)
            # a split block draws every head's mask and keeps its heads'
            weights = dropout(clean_weights, rate, train, rng,
                              cut=(1, h0, self.num_heads))
            attn_out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
        else:
            clean_weights = None
            attn_out = masked_attention(q, k, v, self.mask)

        y = self.out.row(attn_out.reshape(b, t, -1))
        x = x + dropout(y, c.dropout_rate, train, rng)

        # the metric and the importance are means over every head: a split
        # block sums its heads', sums those over the model axis and divides,
        # so that every rank takes the same plan
        if c.compression_mode == "merge":
            if split is None:
                metric = k.mean(dim=-2)      # key mean over heads (B, S, D)
            else:
                metric = from_model(k.sum(dim=-2), split) / self.num_heads
            x, size = _merge_sets(x, size, metric, self.layout, self.layer)
        else:
            if split is None:
                importance = clean_weights.mean(dim=(1, 2))      # (B, K)
            else:
                importance = from_model(clean_weights.sum(dim=(1, 2)),
                                        split) / (self.num_heads * t)
            x, size = _prune_sets(x, size, importance, self.layout,
                                  self.layer)
        return x + mlp_branch(getattr(self, self.mlp_name), self.ln_mlp(x),
                              c.dropout_rate, train, rng, aux), size


class CompressedTransformerStack(nn.Module):
    """Compressed stack with a configurable merge cadence.

    ``tome_merge_every == 1``: compression inside every block
    (``block_{l}``, a :class:`CompressedEncoderBlock`).

    ``tome_merge_every == k > 1``: blocks between events share shapes; each
    group of k plain encoder blocks is ``stage_{i}``, with a standalone
    per-set event (hidden-state metric) between stages.  The compression
    string's per-layer rate applies per event boundary.

    ``prestack_merge``: one more event before block / stage 0, over the
    position-embedded inputs; every later block or stage then reads the
    layout one event further on."""

    def __init__(self, cfg: TransformerConfig, layout: SequenceLayout,
                 features: int, *, device=None, **kw):
        super().__init__()
        if cfg.compression_mode == "merge":
            causal = [f"{s.kind}{{{s.num_tokens}}}" for s in layout.sets
                      if s.compressed_per_layer > 0 and s.kind == KIND_TEXT]
            if causal:
                raise ValueError(
                    f"ToMe merge reorders tokens within a set, which breaks "
                    f"causal intra-attention: {causal} are causal sets with "
                    f"a nonzero compression rate.  Use compression_mode="
                    f"'prune' (order-preserving per-set top-k) for causal "
                    f"sets, or zero their rate in the compression string.")
        if cfg.compression_mode not in ("merge", "prune"):
            raise ValueError(
                f"unknown compression mode {cfg.compression_mode!r}")
        kw = dict(kw, device=device)
        self.cfg = cfg
        self.layout = layout
        self.moe_aux = None
        self.off = 1 if cfg.prestack_merge else 0
        self.posembed_input = AddPositionEmbedding(layout.total_tokens,
                                                   features, **kw)
        k = cfg.tome_merge_every
        if k <= 1:
            if cfg.attention_impl == "flash":
                raise ValueError(
                    "attention_impl='flash' is incompatible with per-layer "
                    "compressed blocks (they materialize attention weights "
                    "for the importance/metric signals); use the staged "
                    "path (tome_merge_every > 1) for flash attention, or "
                    "attention_impl='auto'")
            self.num_stages = 0
            for layer in range(cfg.num_blocks):
                self.add_module(f"block_{layer}", CompressedEncoderBlock(
                    cfg, layout, layer + self.off, features, **kw))
        else:
            if cfg.proportional_attention:
                raise ValueError(
                    "proportional_attention requires per-layer compressed "
                    "blocks (tome_merge_every=1): the staged path's "
                    "EncoderBlocks do not thread token sizes into the "
                    "attention logits, so the option would be silently inert")
            self.num_stages = -(-cfg.num_blocks // k)
            for stage in range(self.num_stages):
                blocks_here = min(k, cfg.num_blocks - stage * k)
                layer = stage + self.off
                attention_fn = select_attention_fn(
                    cfg, layout.attention_mask(layer),
                    layout.tokens_at_layer(layer), device)
                self.add_module(f"stage_{stage}", nn.ModuleList(
                    EncoderBlock(cfg, features, attention_fn, **kw)
                    for _ in range(blocks_here)))
                self.register_buffer(f"mask_{stage}",
                                     _mask_buffer(layout, layer, device),
                                     persistent=False)
        self.final_norm = (LayerNorm(features, cfg.layer_norm_epsilon, -1,
                                     **kw) if cfg.final_norm else None)

    def _event(self, x, size, layer: int):
        """A standalone compression event on the hidden state."""
        if self.cfg.compression_mode == "merge":
            return _merge_sets(x, size, x, self.layout, layer)
        importance = torch.linalg.vector_norm(x.float(), dim=-1)
        return _prune_sets(x, size, importance, self.layout, layer)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        """Also sets ``moe_aux`` as ``TransformerStack`` does: the
        pre-weighted sum of every block's balance loss, or None."""
        x = self.posembed_input(x)
        size = torch.ones_like(x[..., :1])
        aux = []
        if self.off:
            x, size = self._event(x, size, 0)
        remat = self.cfg.remat
        if self.num_stages == 0:
            for layer in range(self.cfg.num_blocks):
                x, size = call_block(getattr(self, f"block_{layer}"), remat,
                                     x, size, train, rng, aux)
        for stage in range(self.num_stages):
            mask = getattr(self, f"mask_{stage}")
            for block in getattr(self, f"stage_{stage}"):
                x = call_block(block, remat, x, mask, train, rng, aux)
            if stage < self.num_stages - 1:
                x, size = self._event(x, size, stage + self.off)
        self.moe_aux = sum_aux(aux, self.cfg.moe.aux_loss_weight)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x

    def final_layer(self) -> int:
        """Stage / layer index of the output layout (for readout slicing)."""
        if self.num_stages == 0:
            return self.cfg.num_blocks + self.off
        return self.num_stages - 1 + self.off
