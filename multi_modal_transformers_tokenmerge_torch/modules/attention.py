"""Pre-LN transformer encoder blocks under a static boolean mask.

Counterpart of the JAX package's ``modules/attention.py``.  The attention
core is chosen once, when the stack is built, by
:func:`select_attention_fn` with the JAX package's semantics: the plain
masked softmax attention below (float32 logits and softmax, scaled by
1/sqrt(head_dim)), or the flash attention of ``ops.flash_attention``, whose
kernels run on an sm_90 card and whose plain versions run on the CPU.

Attention-weight probes (the JAX module's ``attention_weights`` sown into
the ``intermediates`` collection): inside :func:`capture_intermediates`
every :class:`MultiHeadAttention` also records ``softmax(q k^T / sqrt(d))``
in float32 under its mask, masked with ``finfo(float32).min`` as JAX does
(a fully masked row is uniform there), beside the attention path it runs.

Train mode (``train=True`` with a ``dropout`` generator) applies every
dropout site of the JAX blocks: after the MLP activation and after its
output projection, after the attention block, and on the attention weights
(in the flash kernel through its hook, or on the explicit weights of the
plain path).

Under ``parallel.mesh.shard_params`` with a model axis, the attention and
the MLP split their products as the JAX package's XLA does
(``core.tensor_parallel``): ``query``, ``key``, ``value`` and ``dense_in``
are column-parallel (a rank computes its ``num_heads / P`` heads, its
``mlp_dim / P`` hidden columns), ``out`` and ``dense_out`` row-parallel
(the partial products summed over ``model``, the bias added once).  The
attention core runs on the rank's heads inside ``head_slice``, so its
dropout draws are those of those heads; the hidden columns' dropout mask
is drawn whole and cut.  An MLP whose activation works over the last axis
(``glu``, the softmaxes, ``standardize``) cannot split its hidden layer:
its layers gather their outputs instead (``Dense.forward``).  Probes
report every head.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.config import AttentionConfig, TransformerConfig
from ..core.hw import kernel_device
from ..core.replay import checkpointed
from ..core.tensor_parallel import (gather_model, head_offset, head_slice,
                                    to_model)
from .layers import (ROW_ACTIVATIONS, Dense, LayerNorm, activation_fn,
                     dropout, init_normal, init_truncated)
from .moe import MoEMLPBlock, sum_aux

__all__ = ["MLPBlock", "MultiHeadAttention", "EncoderBlock", "make_mlp",
           "mlp_branch", "call_block",
           "TransformerStack", "AddPositionEmbedding",
           "MultiHeadAttentionPooling", "masked_attention",
           "select_attention_fn", "layer_norm_dim", "capture_intermediates"]

_IMPLS = ("auto", "xla", "flash")


def select_attention_fn(cfg: TransformerConfig, mask_np: np.ndarray,
                        seq_len: int, device=None) -> Optional[Callable]:
    """The flash-attention hook for this stack, or None for the plain path.

    ``'xla'``: plain.  ``'flash'``: always the flash path (its plain
    versions on the CPU).  ``'auto'``: flash when the stack lives on an
    sm_90 card and ``seq_len >= flash_min_seq`` (the JAX gate), at every
    head dim (the kernels of ``csrc/flash_attention.cu`` up to 256, those of
    ``csrc/flash_attention_wide.cu`` above).  ``flash_block_q/k`` are the
    TPU kernels' tiles: the hook runs at the card's tiles
    (``kernel_tiles``), on the CPU too, so the stack computes the same
    whatever tiles its config names.  Attention-weight dropout needs
    ``flash_backward='pallas'``: forcing ``'flash'`` with another backward
    raises, ``'auto'`` falls back to the plain path.
    ``flash_backward='xla'`` runs the forward kernel that saves no LSE and
    recomputes the gradients through the plain attention.  With a real
    ``device`` the mask's device tables are built here, once."""
    if cfg.attention_impl not in _IMPLS:
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}; "
                         f"one of {_IMPLS}")
    if cfg.flash_backward not in ("pallas", "xla"):
        raise ValueError(f"unknown flash_backward {cfg.flash_backward!r}")
    if cfg.attention_impl == "xla":
        return None
    dropout_rate = cfg.attention.dropout_rate
    if dropout_rate > 0.0 and cfg.flash_backward != "pallas":
        if cfg.attention_impl == "flash":
            raise ValueError(
                "attention_impl='flash' with flash_backward='xla' cannot "
                f"honor attention.dropout_rate={dropout_rate}: the recompute "
                "backward cannot regenerate the kernel's dropout masks. Use "
                "flash_backward='pallas', set attention.dropout_rate=0.0, "
                "or use attention_impl='auto'/'xla'.")
        return None
    if cfg.attention_impl == "auto" and (seq_len < cfg.flash_min_seq
                                         or not kernel_device(device)):
        return None
    from ..ops.flash_attention import make_attention_fn
    fn = make_attention_fn(mask_np, backward=cfg.flash_backward,
                           dropout_rate=dropout_rate)
    if device is not None and torch.device(device).type != "meta":
        fn.tables_for(cfg.attention.qkv_features // cfg.attention.num_heads,
                      device)
    return fn


def masked_attention(q, k, v, mask: Optional[torch.Tensor],
                     dropout_rate: float = 0.0,
                     generator: Optional[torch.Generator] = None):
    """q, k, v (B, T, H, D) -> (B, T, H, D).  ``mask`` (T, T) bool, True =
    attend.  Float32 logits and softmax; the weights, dropped at
    ``dropout_rate`` with a mask from ``generator``, return to v's dtype
    (``jax.nn.dot_product_attention``'s XLA path, and the explicit weights
    of the JAX module's dropout path)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        neg = -0.7 * torch.finfo(torch.float32).max
        logits = logits.masked_fill(~mask, neg)
    # heads [h0, h0 + H) of a split attention draw those heads' mask
    h0, total = head_offset(q.shape[2])
    probs = dropout(torch.softmax(logits, dim=-1), dropout_rate,
                    dropout_rate > 0.0, generator, cut=(1, h0, total))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


class MLPBlock(nn.Module):
    """Dense -> activation -> Dropout -> Dense -> Dropout.  ``activation``
    is any flax activation name the JAX block can apply
    (``layers.ACTIVATIONS``); others raise here.  ``glu`` halves the
    hidden width, so ``dense_out`` takes ``mlp_dim // 2`` inputs."""

    def __init__(self, in_dim: int, mlp_dim: int, out_dim: int,
                 activation: str = "relu", dropout_rate: float = 0.1, **kw):
        super().__init__()
        self.act = activation_fn(activation)
        hidden = mlp_dim
        if activation == "glu":
            if mlp_dim % 2:
                raise ValueError(f"glu halves the last axis; mlp_dim "
                                 f"{mlp_dim} is odd")
            hidden = mlp_dim // 2
        self.dropout_rate = dropout_rate
        self.elementwise = activation not in ROW_ACTIVATIONS
        self.dense_in = Dense(in_dim, mlp_dim, **kw)
        self.dense_out = Dense(hidden, out_dim, **kw)

    def split(self):
        """The model-axis split of the hidden layer: ``dense_in``
        column-parallel and ``dense_out`` row-parallel under an
        elementwise activation; else None (whole layers, or layers that
        gather)."""
        s_in, s_out = self.dense_in.split(), self.dense_out.split()
        if (self.elementwise and s_in is not None and s_out is not None
                and (s_in.dim, s_out.dim) == (0, 1)):
            return s_in
        return None

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        split = self.split()
        if split is None:
            x = dropout(self.act(self.dense_in(x)), self.dropout_rate,
                        train, rng)
            return dropout(self.dense_out(x), self.dropout_rate, train, rng)
        h = self.act(self.dense_in.column(to_model(x, split)))
        n = h.shape[-1]
        h = dropout(h, self.dropout_rate, train, rng,
                    cut=(h.dim() - 1, split.rank * n, n * split.size))
        return dropout(self.dense_out.row(h), self.dropout_rate, train, rng)


class MultiHeadAttention(nn.Module):
    """Self-attention with a static boolean mask.  ``attention_fn``, when
    set, replaces the core: ``fn(q, k, v, mask, dropout_generator=None)``
    on (B, T, H, D), applying attention-weight dropout itself when handed
    a generator."""

    def __init__(self, cfg: AttentionConfig, features: int,
                 attention_fn: Optional[Callable] = None, **kw):
        super().__init__()
        if cfg.qkv_features % cfg.num_heads:
            raise ValueError("qkv_features must divide into num_heads")
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.qkv_features // cfg.num_heads
        self.dropout_rate = cfg.dropout_rate
        self.attention_fn = attention_fn
        proj = lambda: Dense(features, cfg.qkv_features, bias=cfg.use_bias,
                             **kw)
        self.query, self.key, self.value = proj(), proj(), proj()
        self.out = Dense(cfg.qkv_features, features, bias=cfg.use_bias, **kw)
        # a list while capture_intermediates records this module's weights
        self.probe = None

    def record_weights(self, q, k, mask, split=None):
        """The JAX module's sown ``attention_weights``: float32 logits
        over sqrt(head_dim), masked with finfo(float32).min, softmax; a
        rank of a split attention records every rank's heads."""
        if _capturing():
            raise RuntimeError("attention probes are eager only: they cannot "
                               "be recorded inside a CUDA-graph capture")
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits / math.sqrt(self.head_dim)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1).detach()
        self.probe.append(gather_model(weights, split, dim=1))

    def split(self):
        """The model-axis split of the heads: ``query``, ``key`` and
        ``value`` column-parallel and ``out`` row-parallel; else None."""
        splits = [self.query.split(), self.key.split(), self.value.split()]
        s_out = self.out.split()
        if (s_out is not None and s_out.dim == 1
                and all(s is not None and s.dim == 0 for s in splits)):
            return s_out
        return None

    def forward(self, x, mask=None, train: bool = False,
                rng: Optional[torch.Generator] = None):
        b, t, _ = x.shape
        split = self.split()
        heads = self.num_heads // (1 if split is None else split.size)
        x = to_model(x, split)
        proj = lambda d: d.column(x).reshape(b, t, heads, self.head_dim)
        q, k, v = proj(self.query), proj(self.key), proj(self.value)
        if self.probe is not None:
            self.record_weights(q, k, mask, split)
        stochastic = train and self.dropout_rate > 0.0
        if stochastic and rng is None:
            raise ValueError(f"attention dropout rate {self.dropout_rate} in "
                             f"train mode needs a 'dropout' generator")
        with (contextlib.nullcontext() if split is None
              else head_slice(split.rank * heads, self.num_heads)):
            if self.attention_fn is not None:
                out = self.attention_fn(q, k, v, mask,
                                        dropout_generator=rng if stochastic
                                        else None)
            else:
                out = masked_attention(
                    q, k, v, mask, self.dropout_rate if stochastic else 0.0,
                    rng)
        return self.out.row(out.reshape(b, t, -1))


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def capture_intermediates(model: nn.Module):
    """Record the attention weights of every :class:`MultiHeadAttention`
    in ``model`` while the block runs (the JAX package's
    ``apply(..., mutable=['intermediates'])``).

    Yields a dict, filled when the block exits, keyed by the flax path of
    each JAX ``attention_weights`` entry relative to ``model`` (e.g.
    ``'transformer/blocks/attention/attention_weights'``, or
    ``'transformer/stage_{i}/attention/attention_weights'`` in the staged
    ToMe stack).  Each value is a tuple with one entry per forward in the
    block, as flax's ``sow`` keeps them; an entry stacks the layers of a
    stack (or stage) on axis 0, as ``nn.scan`` does: (L, B, H, S, S)
    float32 at that stack's token count.  The per-layer compressed blocks
    and the T5 tower sow nothing in JAX and record nothing here.  Probes
    are eager only: asking for them inside a CUDA-graph capture raises,
    and a graph replay records nothing."""
    if _capturing():
        raise RuntimeError("attention probes are eager only: they cannot be "
                           "recorded inside a CUDA-graph capture")
    groups: Dict[str, list] = {}
    for name, m in model.named_modules():
        if isinstance(m, MultiHeadAttention):
            path = [p for p in name.split(".") if p and not p.isdigit()]
            key = "/".join(path + ["attention_weights"])
            groups.setdefault(key, []).append(m)
            m.probe = []
    out: Dict[str, Tuple[torch.Tensor, ...]] = {}
    try:
        yield out
    finally:
        for key, mods in groups.items():
            calls = [m.probe for m in mods]
            for m in mods:
                m.probe = None
            n = min(len(c) for c in calls)
            if n:
                out[key] = tuple(torch.stack([c[i] for c in calls])
                                 for i in range(n))


def layer_norm_dim(cfg: TransformerConfig) -> int:
    """The axis a block's LayerNorms pool over: the features, or axis 1
    for the reference's 'sequence_compat' LayerNorm."""
    if cfg.layer_norm_reduction == "sequence_compat":
        return 1
    if cfg.layer_norm_reduction == "features":
        return -1
    raise ValueError(
        f"unknown layer_norm_reduction {cfg.layer_norm_reduction!r}")


def make_mlp(cfg: TransformerConfig, features: int, **kw) -> nn.Module:
    """The block's MLP: the dense :class:`MLPBlock`, or with
    ``mlp_type='moe'`` the routed ``moe.MoEMLPBlock``."""
    if cfg.mlp_type == "dense":
        return MLPBlock(features, cfg.mlp_dim, features, cfg.mlp_activation,
                        cfg.dropout_rate, **kw)
    if cfg.mlp_type == "moe":
        return MoEMLPBlock(cfg.moe, features, cfg.mlp_dim, features,
                           cfg.mlp_activation, **kw)
    raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}; 'dense' or 'moe'")


def mlp_branch(mlp: nn.Module, y, dropout_rate: float, train: bool,
               rng: Optional[torch.Generator], aux: Optional[list]):
    """The MLP branch of a pre-LN block on LN(x).  The dense block drops
    inside; the MoE block's output takes one dropout after it, and its
    balance loss is appended to ``aux``."""
    if isinstance(mlp, MLPBlock):
        return mlp(y, train, rng)
    y, loss = mlp(y, train, rng)
    if aux is not None:
        aux.append(loss)
    return dropout(y, dropout_rate, train, rng)


def call_block(block: nn.Module, remat: bool, x, other, train: bool,
               rng: Optional[torch.Generator], aux: Optional[list]):
    """``block(x, other, train, rng, aux)`` for an :class:`EncoderBlock`
    (``other``: the mask) or a compressed block (``other``: the token
    sizes).  With ``remat`` (the JAX stacks' ``nn.remat``) the block's
    activations are recomputed in the backward (``core.replay.
    checkpointed``), its dropout draws replayed from ``rng``; its MoE
    balance loss is an output of the checkpointed call, appended to
    ``aux`` once, not again by the recompute."""
    if not remat:
        return block(x, other, train, rng, aux)

    def run(x, other):
        local = []
        out = block(x, other, train, rng, local)
        return out, (local[0] if local else None)

    out, loss = checkpointed(run, [rng] if train else [], x, other)
    if loss is not None and aux is not None:
        aux.append(loss)
    return out


class EncoderBlock(nn.Module):
    """Pre-LN block: x + Dropout(attn(LN(x))), then x + mlp(LN(x)).  With
    ``mlp_type='moe'`` the MLP is ``moe`` (the flax name) and its balance
    loss goes to the ``aux`` list a caller hands in."""

    def __init__(self, cfg: TransformerConfig, features: int,
                 attention_fn: Optional[Callable] = None, **kw):
        super().__init__()
        dim = layer_norm_dim(cfg)
        self.dropout_rate = cfg.dropout_rate
        ln = lambda: LayerNorm(features, cfg.layer_norm_epsilon, dim, **kw)
        self.ln_attention = ln()
        self.attention = MultiHeadAttention(cfg.attention, features,
                                            attention_fn, **kw)
        self.ln_mlp = ln()
        self.mlp_name = "moe" if cfg.mlp_type == "moe" else "mlp"
        self.add_module(self.mlp_name, make_mlp(cfg, features, **kw))

    def forward(self, x, mask=None, train: bool = False,
                rng: Optional[torch.Generator] = None,
                aux: Optional[list] = None):
        y = self.attention(self.ln_attention(x), mask, train, rng)
        x = x + dropout(y, self.dropout_rate, train, rng)
        return x + mlp_branch(getattr(self, self.mlp_name), self.ln_mlp(x),
                              self.dropout_rate, train, rng, aux)


class AddPositionEmbedding(nn.Module):
    """Learned (1, S, E) position embedding added to the sequence (in the
    compute dtype, which the sequence is in)."""

    CAST_PARAMS = ("pos_embedding",)

    def __init__(self, seq_len: int, features: int, *,
                 dtype=torch.float32, param_dtype=torch.float32, device=None,
                 **_):
        super().__init__()
        self.dtype = dtype
        self.pos_embedding = nn.Parameter(torch.empty(
            1, seq_len, features, dtype=param_dtype, device=device))

    def reset_parameters(self, generator) -> None:
        init_normal(self.pos_embedding, 0.02, generator)

    def forward(self, x):
        return x + self.pos_embedding.to(x.dtype)


class TransformerStack(nn.Module):
    """Position embedding + encoder blocks (+ optional final LayerNorm).
    ``cfg.compression_mode`` is not read here: the compressed stack is
    ``modules.tome_stack.CompressedTransformerStack``.  ``cfg.remat``
    recomputes each block in the backward (:func:`call_block`)."""

    def __init__(self, cfg: TransformerConfig, seq_len: int, features: int,
                 attention_fn: Optional[Callable] = None, **kw):
        super().__init__()
        self.remat = cfg.remat
        self.aux_loss_weight = cfg.moe.aux_loss_weight
        self.moe_aux = None
        self.posembed_input = AddPositionEmbedding(seq_len, features, **kw)
        self.blocks = nn.ModuleList(
            EncoderBlock(cfg, features, attention_fn, **kw)
            for _ in range(cfg.num_blocks))
        self.final_norm = (LayerNorm(features, cfg.layer_norm_epsilon, -1,
                                     **kw) if cfg.final_norm else None)

    def forward(self, x, mask=None, train: bool = False,
                rng: Optional[torch.Generator] = None):
        """Also sets ``moe_aux``: with ``mlp_type='moe'`` the pre-weighted
        ``aux_loss_weight * sum`` of the blocks' balance losses (a float32
        device tensor, the JAX stack's sown ``moe_aux``), else None."""
        x = self.posembed_input(x)
        aux = []
        for block in self.blocks:
            x = call_block(block, self.remat, x, mask, train, rng, aux)
        self.moe_aux = sum_aux(aux, self.aux_loss_weight)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x


class MultiHeadAttentionPooling(nn.Module):
    """MAP head: a learned one-token query cross-attends over the sequence
    (flax ``MultiHeadDotProductAttention``: the query scaled by
    1/sqrt(head_dim) before the product, no mask), then x + mlp(LN(x)).
    (B, S, E) -> (B, 1, E)."""

    CAST_PARAMS = ("learnt_q_input",)

    def __init__(self, features: int, num_heads: int = 3, mlp_dim: int = 768,
                 dropout_rate: float = 0.1, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        if features % num_heads:
            raise ValueError("features must divide into num_heads")
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.dtype = dtype
        self.num_heads = num_heads
        self.learnt_q_input = nn.Parameter(torch.empty(
            1, 1, features, dtype=param_dtype, device=device))
        self.cross_attention = nn.ModuleDict({
            name: Dense(features, features, bias_init="zeros", **kw)
            for name in ("query", "key", "value", "out")})
        self.ln = LayerNorm(features, 1e-6, -1, **kw)
        self.mlp = MLPBlock(features, mlp_dim, features,
                            dropout_rate=dropout_rate, **kw)

    def reset_parameters(self, generator) -> None:
        # flax he_normal on (1, 1, E): fan_in is 1 * 1 (the receptive field
        # times the second-to-last dim)
        init_truncated(self.learnt_q_input, math.sqrt(2.0), generator)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        b, s, e = x.shape
        h, d = self.num_heads, e // self.num_heads
        attn = self.cross_attention
        query = self.learnt_q_input.to(self.dtype).expand(b, 1, e)
        q = attn["query"](query).reshape(b, 1, h, d) / math.sqrt(d)
        k = attn["key"](x).reshape(b, s, h, d)
        v = attn["value"](x).reshape(b, s, h, d)
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        x = attn["out"](torch.einsum("bhqk,bkhd->bqhd", weights, v)
                        .reshape(b, 1, e))
        return x + self.mlp(self.ln(x), train, rng)
