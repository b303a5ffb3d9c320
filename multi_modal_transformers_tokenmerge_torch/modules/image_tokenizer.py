"""Image tokenizer: patchify -> per-patch ResNetV2 conv embed -> learned
row/col position embeddings.

Counterpart of the JAX package's ``modules/image_tokenizer.py``.  Patches
run as one NCHW conv batch of B*F*P images.  Its two ``conv_layout``s
compute the same function, and this module matches both.

* GroupNorm with ``norm_stats_scope='image'`` pools its statistics over
  every patch and frame of a batch element, which ``torch.nn.GroupNorm``
  cannot do, so :class:`PatchGroupNorm` computes them itself, in float32,
  with the clamped E[x^2] - mu^2 variance.
* flax's ``nn.gelu`` is the tanh approximation.  Each residual block's
  norm and GELU go through :meth:`PatchGroupNorm.forward_gelu`: on the
  card one pair of kernels (``ops.group_norm``; where autograd records,
  with a plain PyTorch backward), on the CPU the plain chain;
  ``REGISTRY.counters`` counts each route (``image.norm_kernel``,
  ``image.norm_plain``).
* ``output_dense`` flattens each patch's feature map in (c, h, w) order;
  ``convert.from_flax`` permutes the flax kernel's (h, w, c) rows to match.
* ``pool_vjp`` picks the max-pool backward as in the JAX package: 'xla'
  (and 'auto', which is 'xla') is torch's own, 'pallas' the CUDA kernel of
  ``ops.pool`` (its plain version on the CPU).
* Position tokens are interval midpoints in eval mode; in train mode they
  are drawn within each patch's interval from the ``patch_encoding``
  generator, or passed in.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ImageTokenizerConfig, ResNetEmbedderConfig
from ..ops.image_ops import (eval_position_tokens, patchify,
                             sample_position_tokens)
from ..ops.group_norm import GroupNormGelu, group_norm_gelu_op
from ..ops.pool import max_pool_nchw
from ..utils.profiling import REGISTRY
from .layers import Conv2d, Dense, Embed

__all__ = ["group_norm_stats", "PatchGroupNorm", "ResNetV2Embedder",
           "ImageTokenizer"]


def group_norm_stats(f: torch.Tensor, num_groups: int, eps: float,
                     stats_scope: str, patches_per_element: int):
    """GroupNorm statistics and normalization of a float32 (B*G, C, h, w)
    patch map, no affine: the JAX package's ``group_norm_stats_hwcn``,
    shared by :class:`PatchGroupNorm` and the quantized serving towers
    (``serve.quantize``) so that a numerical fix applies to both.  The
    variance is E[x^2] - mu^2 clamped at zero, as flax's."""
    n, c, h, w = f.shape
    g = num_groups
    if stats_scope == "image":
        f = f.reshape(n // patches_per_element, patches_per_element, g,
                      c // g, h, w)
        dims = (1, 3, 4, 5)
    elif stats_scope == "patch":
        f = f.reshape(n, g, c // g, h, w)
        dims = (2, 3, 4)
    else:
        raise ValueError(f"unknown norm_stats_scope {stats_scope!r}")
    mu = f.mean(dims, keepdim=True)
    var = ((f * f).mean(dims, keepdim=True) - mu * mu).clamp_min(0.0)
    return ((f - mu) * torch.rsqrt(var + eps)).reshape(n, c, h, w)


class PatchGroupNorm(nn.Module):
    """GroupNorm on (B*G, C, h, w) patch maps, G = frames * patches.

    ``stats_scope='image'``: statistics per (batch element, group) over all
    G patches; ``'patch'``: per (patch, group)."""

    def __init__(self, channels: int, num_groups: int, eps: float,
                 stats_scope: str, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        if stats_scope not in ("image", "patch"):
            raise ValueError(f"unknown norm_stats_scope {stats_scope!r}")
        if channels % num_groups:
            raise ValueError(f"{channels} channels not divisible into "
                             f"{num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.stats_scope = stats_scope
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(channels, dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(channels, dtype=param_dtype,
                                             device=device))

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, patches_per_element: int):
        f = group_norm_stats(x.float(), self.num_groups, self.eps,
                             self.stats_scope, patches_per_element)
        f = (f * self.weight.float()[:, None, None]
             + self.bias.float()[:, None, None])
        return f.to(self.dtype)

    def forward_gelu(self, x: torch.Tensor, patches_per_element: int):
        """:meth:`forward` then the tanh GELU.  CPU tensors take the plain
        chain; any other device the two kernels of ``ops.group_norm`` (the
        statistics scope set by the patches an element: 1 for 'patch'):
        through the custom op outside autograd, through ``GroupNormGelu``,
        whose backward is plain PyTorch, where autograd records."""
        if x.device.type == "cpu":
            REGISTRY.counters["image.norm_plain"] += 1
            return F.gelu(self(x, patches_per_element), approximate="tanh")
        REGISTRY.counters["image.norm_kernel"] += 1
        args = (x, self.weight, self.bias, self.num_groups, self.eps,
                patches_per_element if self.stats_scope == "image" else 1,
                self.dtype)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, self.weight, self.bias)):
            return GroupNormGelu.apply(*args)
        return group_norm_gelu_op(*args)


class ResNetV2Embedder(nn.Module):
    """input conv (VALID, strided) -> max-pool -> num_blocks x (GroupNorm ->
    GELU -> conv SAME) -> + residual -> flatten -> Dense."""

    def __init__(self, cfg: ResNetEmbedderConfig, patch_size: int,
                 in_channels: int, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        if cfg.pool_vjp not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown pool_vjp {cfg.pool_vjp!r}")
        self.cfg = cfg
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.input_conv = Conv2d(in_channels, cfg.features, cfg.input_kernel,
                                 cfg.input_stride, "VALID", **kw)
        for i in range(cfg.num_blocks):
            self.add_module(f"block{i}_norm", PatchGroupNorm(
                cfg.features, cfg.group_norm_groups, cfg.group_norm_epsilon,
                cfg.norm_stats_scope, **kw))
            self.add_module(f"block{i}_conv", Conv2d(
                cfg.features, cfg.features, cfg.block_kernel, (1, 1), "SAME",
                **kw))
        side = self.feature_map_side(cfg, patch_size)
        self.output_dense = Dense(side * side * cfg.features,
                                  cfg.output_features, **kw)

    @staticmethod
    def feature_map_side(cfg: ResNetEmbedderConfig, patch_size: int) -> int:
        """Side of the square map that reaches ``output_dense``."""
        conv = (patch_size - cfg.input_kernel[0]) // cfg.input_stride[0] + 1
        return (conv - cfg.pool_window[0]) // cfg.pool_stride[0] + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, G, p, p, C) patches -> (B, G, output_features)."""
        c = self.cfg
        b, g, p, _, ch = x.shape
        y = x.reshape(b * g, p, p, ch).permute(0, 3, 1, 2)  # NCHW
        y = self.input_conv(y)
        y = max_pool_nchw(y, c.pool_window, c.pool_stride,
                          vjp="pallas" if c.pool_vjp == "pallas" else "xla")
        residual = y
        for i in range(c.num_blocks):
            y = getattr(self, f"block{i}_norm").forward_gelu(y, g)
            y = getattr(self, f"block{i}_conv")(y)
        y = y + residual
        out = self.output_dense(y.reshape(b * g, -1))
        return out.reshape(b, g, c.output_features)


class ImageTokenizer(nn.Module):
    """(B, [F,] H, W, C) images -> (B, F*P, E) embeddings."""

    def __init__(self, cfg: ImageTokenizerConfig, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        h, w, ch = cfg.image_size
        if h != w:
            raise ValueError(f"image must be square, got {h}x{w}")
        if cfg.resnet.output_features != cfg.embedding_dim:
            raise ValueError(
                f"resnet.output_features ({cfg.resnet.output_features}) != "
                f"embedding_dim ({cfg.embedding_dim})")
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.resnet = ResNetV2Embedder(cfg.resnet, cfg.patch_size, ch, **kw)
        self.row_position_embedding = Embed(cfg.position_interval,
                                            cfg.embedding_dim, **kw)
        self.col_position_embedding = Embed(cfg.position_interval,
                                            cfg.embedding_dim, **kw)
        rows, cols = eval_position_tokens(h, cfg.patch_size,
                                          cfg.position_interval)
        self.register_buffer("eval_rows", torch.as_tensor(
            rows, dtype=torch.long, device=device), persistent=False)
        self.register_buffer("eval_cols", torch.as_tensor(
            cols, dtype=torch.long, device=device), persistent=False)

    def forward(self, images: torch.Tensor, train: bool = False,
                positions=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``positions``: optional train-mode (rows, cols) tokens, each
        (B, F, P) or (B, F*P); absent in train mode they are drawn from
        ``generator``."""
        cfg = self.cfg
        if images.ndim == 4:
            images = images[:, None]
        b, f, h, w, c = images.shape
        if (h, w, c) != tuple(cfg.image_size):
            raise ValueError(f"input image shape {(h, w, c)} != configured "
                             f"{cfg.image_size}")
        patches = patchify(images, cfg.patch_size, cfg.normalize,
                           dtype=self.dtype)
        num_patches = patches.shape[2]
        emb = self.resnet(patches.reshape(b, f * num_patches,
                                          *patches.shape[3:]))
        if not train:
            rows = self.eval_rows.repeat(f)
            cols = self.eval_cols.repeat(f)
        else:
            if positions is None:
                if generator is None:
                    raise ValueError("train-mode patch positions need a "
                                     "'patch_encoding' generator or "
                                     "explicit positions")
                positions = sample_position_tokens(
                    (b, f), h, cfg.patch_size, cfg.position_interval,
                    generator, images.device)
            rows, cols = (torch.as_tensor(t, device=images.device).reshape(
                b, f * num_patches) for t in positions)
        return (emb + self.row_position_embedding(rows)
                + self.col_position_embedding(cols))
