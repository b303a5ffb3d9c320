"""A DeepSeek-V3-style decoder stack inside Octo: latent attention (MLA)
with decoupled RoPE, dense and dropless routed SwiGLU layers, and the
staged ToMe merges of ``modules.tome_stack`` carrying each token's RoPE
position.

Written from DeepSeek-V3's modelling code (Moonlight-16B-A3B's
``model_type``), for ``core.config.LatentMoETransformerConfig``:

* pre-RMSNorm blocks (float32 statistics, the scale applied in float32,
  one rounding to the compute dtype); a final RMSNorm;
* latent attention with no query compression: ``q = W_q x`` (H heads of
  ``nope + rope``), ``[c_kv; k_pe] = W_kva x`` (``k_pe`` shared by the
  heads), ``c_kv`` through an RMSNorm, ``[k_nope; v] = W_kvb c_kv``; RoPE
  on ``q_pe`` and ``k_pe`` in interleaved pairs (pair ``i`` turned by
  ``position * theta^(-2i / rope)``), computed in float32; the scale is
  ``(nope + rope)^-1/2``; ``o = W_o`` of the heads' values; no biases;
* the block-causal stage masks of Octo's layout, on the flash kernels at
  the qk head dim (``v`` zero-padded to it and cut back: a zero column
  adds nothing), or the plain masked attention;
* blocks ``< first_k_dense_replace``: a SwiGLU MLP, ``W_down (silu(W_g x)
  * W_u x)``; the rest: the router in float32 (``sigmoid(W_r x)``, top-k
  by score + a selection bias, the chosen scores normalised and scaled,
  ``ops.grouped_experts.route``), every choice computed (no capacity) by
  ``ops.grouped_experts.grouped_experts`` (the CUDA kernels on the card,
  the plain version for CPU tensors), plus the shared experts, one SwiGLU
  of ``n_shared_experts * moe_intermediate_size``, unweighted.

The stack (:class:`LatentMoEStack`) runs its blocks in stages of
``tome_merge_every`` blocks with a ToMe event on the hidden state between
stages, as ``CompressedTransformerStack``'s staged cadence does.  Each
token's RoPE position starts at its index in the assembled sequence and
goes through every merge by the same size-weighted average as the hidden
state, in float32: a merged token sits at the mean position of the tokens
it stands for.

Tracing (``utils.profiling``): each block's attention is the section
``model.mla``, each routed layer (router, sort, products, combine, shared
experts) ``model.moe``, both inside ``model.stack``; the counters
``moe.grouped_kernel`` and ``moe.plain`` count the routed layers' calls by
route, one a layer a forward (a replay runs no Python).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import LatentMoETransformerConfig, MoEConfig
from ..ops.grouped_experts import grouped_experts, route
from ..sequence.layout import SequenceLayout
from ..utils.profiling import REGISTRY, section
from .attention import masked_attention, select_attention_fn
from .layers import Dense, init_normal
from .tome_stack import _mask_buffer, _merge_sets

__all__ = ["RMSNorm", "SwiGLU", "LatentAttention", "Router", "RoutedExperts",
           "LatentMoEBlock", "LatentMoEStack", "rope_angles", "apply_rope"]


class RMSNorm(nn.Module):
    """``x / sqrt(mean(x^2) + eps) * weight`` over the last axis, in
    float32, rounded once to the compute dtype."""

    def __init__(self, features: int, eps: float, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                               device=device))

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(self.dtype)


def rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """(cos, sin) of (B, S, 1, dim / 2), float32, for (B, S, 1) float32
    positions."""
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=positions.device) / dim)
    angle = positions[..., None] * inv
    return torch.cos(angle), torch.sin(angle)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dim) float32 turned in interleaved pairs (2i, 2i + 1)."""
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack((even * cos - odd * sin, even * sin + odd * cos),
                       dim=-1).flatten(-2)


class SwiGLU(nn.Module):
    """``down(silu(gate x) * up x)``; ``gate_up`` holds the gate's rows,
    then the up rows."""

    def __init__(self, features: int, width: int, **kw):
        super().__init__()
        self.width = width
        self.gate_up = Dense(features, 2 * width, bias=False, **kw)
        self.down = Dense(width, features, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, u = self.gate_up(x).split(self.width, dim=-1)
        return self.down(F.silu(g) * u)


class LatentAttention(nn.Module):
    """Multi-head latent attention without query compression (module
    docstring).  ``attention_fn``: the flash hook of the stage, taking
    (B, S, H, D) q, k, v at the qk head dim; None for the plain path."""

    def __init__(self, cfg: LatentMoETransformerConfig, features: int,
                 **kw):
        super().__init__()
        self.heads = cfg.attention.num_heads
        self.nope, self.rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        self.v_dim, self.rank = cfg.v_head_dim, cfg.kv_lora_rank
        h = self.heads
        self.dtype = kw.get("dtype", torch.float32)
        self.q_proj = Dense(features, h * (self.nope + self.rope),
                            bias=False, **kw)
        self.kv_a_proj = Dense(features, self.rank + self.rope, bias=False,
                               **kw)
        self.kv_a_norm = RMSNorm(self.rank, cfg.rms_norm_eps, **kw)
        self.kv_b_proj = Dense(self.rank, h * (self.nope + self.v_dim),
                               bias=False, **kw)
        self.out = Dense(h * self.v_dim, features, bias=False, **kw)

    def forward(self, x, cos, sin, mask, attention_fn=None):
        b, s, _ = x.shape
        h, nope, rope = self.heads, self.nope, self.rope
        q = self.q_proj(x).view(b, s, h, nope + rope)
        c_kv, k_pe = self.kv_a_proj(x).split([self.rank, rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_norm(c_kv)).view(b, s, h,
                                                       nope + self.v_dim)
        k_nope, v = kv.split([nope, self.v_dim], dim=-1)
        q_pe = apply_rope(q[..., nope:].float(), cos, sin).to(self.dtype)
        k_pe = apply_rope(k_pe[:, :, None].float(), cos, sin).to(self.dtype)
        q = torch.cat([q[..., :nope], q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, s, h, rope)], dim=-1)
        if attention_fn is None:
            o = masked_attention(q, k, v, mask)
        else:
            v = F.pad(v, (0, nope + rope - self.v_dim))
            o = attention_fn(q, k, v)[..., :self.v_dim]
        return self.out(o.reshape(b, s, h * self.v_dim))


class Router(nn.Module):
    """The float32 sigmoid router: ``weight`` (E, D) and ``bias`` (E,), the
    selection bias (DeepSeek-V3's ``e_score_correction_bias``), which
    chooses experts and weighs nothing."""

    def __init__(self, experts: int, features: int, *,
                 param_dtype=torch.float32, device=None, **_):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, features,
                                               dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(experts, dtype=param_dtype,
                                             device=device))

    def reset_parameters(self, generator) -> None:
        init_normal(self.weight, 1.0 / math.sqrt(self.weight.shape[1]),
                    generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(T, D) -> (T, E) float32 sigmoid scores."""
        return torch.sigmoid(F.linear(x.float(), self.weight.float()))


class RoutedExperts(nn.Module):
    """The dropless routed layer: the :class:`Router`, the stacked experts
    (``w_gate_up`` (E, 2F, D): gate rows first; ``w_down`` (E, D, F)) and
    the shared experts."""

    CAST_PARAMS = ("w_gate_up", "w_down")

    def __init__(self, cfg: LatentMoETransformerConfig, features: int, *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        e, f = cfg.n_routed_experts, cfg.moe_intermediate_size
        self.dtype = dtype
        self.top_k = cfg.num_experts_per_tok
        self.scale = cfg.routed_scaling_factor
        empty = lambda *shape: nn.Parameter(torch.empty(
            *shape, dtype=param_dtype, device=device))
        self.router = Router(e, features, **kw)
        self.w_gate_up = empty(e, 2 * f, features)
        self.w_down = empty(e, features, f)
        self.shared = SwiGLU(features, cfg.n_shared_experts * f, **kw)

    def reset_parameters(self, generator) -> None:
        d, f = self.w_gate_up.shape[-1], self.w_down.shape[-1]
        init_normal(self.w_gate_up, 1.0 / math.sqrt(d), generator)
        init_normal(self.w_down, 1.0 / math.sqrt(f), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        weights, experts = route(self.router(x), self.router.bias,
                                 self.top_k, self.scale)
        REGISTRY.counters["moe.plain" if x.device.type == "cpu"
                          else "moe.grouped_kernel"] += 1
        out = grouped_experts(x, self.w_gate_up.to(self.dtype),
                              self.w_down.to(self.dtype), weights, experts,
                              self.shared(x))
        return out.reshape(shape)


class LatentMoEBlock(nn.Module):
    """``x + attn(norm(x))``, then ``x + mlp(norm(x))`` with the dense
    SwiGLU (``mlp``) or the routed layer (``moe``)."""

    def __init__(self, cfg: LatentMoETransformerConfig, features: int,
                 layer: int, **kw):
        super().__init__()
        self.ln_attention = RMSNorm(features, cfg.rms_norm_eps, **kw)
        self.attention = LatentAttention(cfg, features, **kw)
        self.ln_mlp = RMSNorm(features, cfg.rms_norm_eps, **kw)
        self.routed = layer >= cfg.first_k_dense_replace
        if self.routed:
            self.moe = RoutedExperts(cfg, features, **kw)
        else:
            self.mlp = SwiGLU(features, cfg.mlp_dim, **kw)

    def forward(self, x, cos, sin, mask, attention_fn=None):
        with section("model.mla"):
            x = x + self.attention(self.ln_attention(x), cos, sin, mask,
                                   attention_fn)
        if not self.routed:
            return x + self.mlp(self.ln_mlp(x))
        with section("model.moe"):
            return x + self.moe(self.ln_mlp(x))


# Fields of TransformerConfig that this stack does not read, at the one
# value each that it computes (its activation is SiLU, it has no dropout, no
# biases, RMSNorm with ``rms_norm_eps``, no GShard block, no remat): any
# other value would be a setting with no effect, so it is refused.
_UNREAD = {"mlp_activation": "silu", "mlp_type": "dense", "moe": MoEConfig(),
           "dropout_rate": 0.0, "layer_norm_epsilon": 1e-6,
           "layer_norm_reduction": "features", "prestack_merge": False,
           "proportional_attention": False, "remat": False}
_UNREAD_ATTENTION = {"dropout_rate": 0.0, "use_bias": False}


def _check_unread(cfg: LatentMoETransformerConfig) -> None:
    wrong = [f"{k}={getattr(cfg, k)!r} (takes {v!r})"
             for k, v in _UNREAD.items() if getattr(cfg, k) != v]
    wrong += [f"attention.{k}={getattr(cfg.attention, k)!r} (takes {v!r})"
              for k, v in _UNREAD_ATTENTION.items()
              if getattr(cfg.attention, k) != v]
    if wrong:
        raise ValueError("the latent-attention stack does not read "
                         + ", ".join(wrong))


class LatentMoEStack(nn.Module):
    """The blocks in stages of ``tome_merge_every`` with a ToMe event on the
    hidden state between stages, token positions carried through each
    (module docstring); ``stage_{i}`` holds stage i's blocks."""

    def __init__(self, cfg: LatentMoETransformerConfig,
                 layout: SequenceLayout, features: int, *, device=None,
                 **kw):
        super().__init__()
        _check_unread(cfg)
        if cfg.compression_mode != "merge" or cfg.tome_merge_every < 1:
            raise ValueError(
                "the latent-attention stack merges between stages: "
                "compression_mode='merge' and tome_merge_every >= 1, got "
                f"{cfg.compression_mode!r}, {cfg.tome_merge_every}")
        kw = dict(kw, device=device)
        self.cfg = cfg
        self.layout = layout
        self.moe_aux = None
        k = cfg.tome_merge_every
        self.num_stages = -(-cfg.num_blocks // k)
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        # the flash hook's tables are built at the qk head dim it runs at
        flash_cfg = cfg.replace(attention=cfg.attention.replace(
            qkv_features=cfg.attention.num_heads * qk))
        self.attention_fns = []
        for stage in range(self.num_stages):
            self.attention_fns.append(select_attention_fn(
                flash_cfg, layout.attention_mask(stage),
                layout.tokens_at_layer(stage), device))
            self.add_module(f"stage_{stage}", nn.ModuleList(
                LatentMoEBlock(cfg, features, layer, **kw)
                for layer in range(stage * k,
                                   min(cfg.num_blocks, (stage + 1) * k))))
            self.register_buffer(f"mask_{stage}",
                                 _mask_buffer(layout, stage, device),
                                 persistent=False)
        self.register_buffer("positions", torch.as_tensor(
            np.arange(layout.total_tokens, dtype=np.float32),
            device=device)[:, None], persistent=False)
        self.final_norm = (RMSNorm(features, cfg.rms_norm_eps, **kw)
                           if cfg.final_norm else None)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if train:
            raise NotImplementedError("the latent-attention stack serves "
                                      "only: it has no training path")
        c = self.cfg
        size = torch.ones_like(x[..., :1])
        positions = self.positions.expand(x.shape[0], -1, -1)
        for stage in range(self.num_stages):
            cos, sin = rope_angles(positions, c.qk_rope_head_dim,
                                   c.rope_theta)
            mask = getattr(self, f"mask_{stage}")
            fn = self.attention_fns[stage]
            for block in getattr(self, f"stage_{stage}"):
                x = block(x, cos, sin, mask, fn)
            if stage < self.num_stages - 1:
                x, size, positions = _merge_sets(x, size, x, self.layout,
                                                 stage, positions)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x

    def final_layer(self) -> int:
        """Stage index of the output layout (for readout slicing)."""
        return self.num_stages - 1
