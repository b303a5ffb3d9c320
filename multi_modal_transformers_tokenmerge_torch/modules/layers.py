"""Small layers shared by the port's modules.

Each layer keeps its parameters in the parameter dtype and computes in the
compute dtype, casting at the call as the flax layers of the JAX package
do: a Linear's inputs and weights go to the compute dtype, norms take their
statistics in float32 and cast the result.  Parameter names follow PyTorch
(``weight``, ``bias``); ``convert.from_flax`` maps the flax names onto them.

``reset_parameters(generator)`` draws the flax initializers' distributions
from an explicit ``torch.Generator``; :func:`dropout` draws its keep mask
from one too.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from ..core.global_batch import draw_global
from ..core.tensor_parallel import (draw_cut, from_model, gather_model,
                                    local, model_split, to_model)

__all__ = ["Dense", "Conv2d", "LayerNorm", "Embed", "BatchNorm", "dropout",
           "init_normal", "init_truncated", "ACTIVATIONS", "ROW_ACTIVATIONS",
           "activation_fn"]

# std correction of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def init_normal(t: torch.Tensor, std: float, generator) -> None:
    with torch.no_grad():
        nn.init.normal_(t, 0.0, std, generator=generator)


def init_truncated(t: torch.Tensor, std: float, generator) -> None:
    """flax ``variance_scaling(..., 'truncated_normal')`` for a target std."""
    s = std / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s,
                              generator=generator)


def _standardize(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.standardize`` over the last axis: E[x^2] - mu^2 variance
    clipped at 0, epsilon 1e-5, in the input's dtype."""
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
    return (x - mu) * torch.rsqrt(var + 1e-5)


# flax.linen activation name -> the torch function with flax's defaults:
# every name the JAX package's MLPBlock resolves with getattr(flax.linen,
# name) and can apply to an array of the block's shape.  gelu is flax's
# tanh approximation; glu halves the last axis; standardize (normalize is
# its flax alias) and the softmaxes work over the last axis.
ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "celu": F.celu,
    "selu": F.selu,
    "softplus": F.softplus,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "relu6": F.relu6,
    "hard_sigmoid": F.hardsigmoid,
    "hard_silu": F.hardswish,
    "hard_swish": F.hardswish,
    "hard_tanh": F.hardtanh,
    "log_sigmoid": F.logsigmoid,
    "soft_sign": F.softsign,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "standardize": _standardize,
    "normalize": _standardize,
    "glu": lambda x: F.glu(x, dim=-1),
}


# the activations that work over the last axis: a hidden layer split over
# its columns cannot apply them
ROW_ACTIVATIONS = frozenset({"softmax", "log_softmax", "standardize",
                             "normalize", "glu"})


def activation_fn(name: str):
    """The torch function of a flax activation name; any other name (one
    the JAX block cannot apply either: ``one_hot``, ``logsumexp``,
    ``PReLU``, ...) raises ValueError."""
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unsupported mlp activation {name!r}; one of "
                         f"{sorted(ACTIVATIONS)}") from None


def keep_mask(shape, keep_prob: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """Bernoulli(keep_prob) bool mask drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator],
            cut: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: in train mode with ``rate`` > 0, kept elements
    are scaled by 1/(1 - rate) and the rest zeroed; otherwise ``x``.  The
    mask comes from ``generator``, which train mode then requires.
    ``cut`` = (dim, offset, total): ``x`` holds ``[offset, offset + n)`` of
    ``total`` along ``dim`` (a rank's heads or columns of a split
    product), and the mask is drawn whole and cut to them."""
    if not train or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError(f"dropout rate {rate} in train mode needs a "
                         f"'dropout' generator")
    keep_prob = 1.0 - rate
    # a data-parallel step draws the global batch's mask
    draw = lambda s: keep_mask(s, keep_prob, generator, x.device)
    if cut is not None:
        whole = draw
        draw = lambda s: draw_cut(whole, s, *cut)
    keep = draw_global(draw, x.shape)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class Dense(nn.Module):
    """``y = x @ W.T + b`` in the compute dtype.

    ``kernel_init``: 'he' (he_normal, the JAX package's choice for its own
    layers), 'lecun' (flax's Dense default) or 'xavier' (xavier_uniform).
    ``bias_init``: 'normal' (std 1e-2) or 'zeros'."""

    # parameters every forward casts to ``self.dtype`` before use: a serving
    # copy may store them in it (serve.policy.serving_copy)
    CAST_PARAMS = ("weight", "bias")

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, dtype=torch.float32,
                 param_dtype=torch.float32, device=None,
                 kernel_init: str = "he", bias_init: str = "normal"):
        super().__init__()
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=param_dtype, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=param_dtype,
                                              device=device))
                     if bias else None)

    def reset_parameters(self, generator) -> None:
        fan_in = self.weight.shape[1]
        if self.kernel_init == "xavier":
            bound = math.sqrt(6.0 / (fan_in + self.weight.shape[0]))
            with torch.no_grad():
                self.weight.copy_(torch.rand(
                    self.weight.shape, generator=generator,
                    device=self.weight.device) * (2 * bound) - bound)
        else:
            scale = 2.0 if self.kernel_init == "he" else 1.0
            init_truncated(self.weight, math.sqrt(scale / fan_in), generator)
        if self.bias is not None:
            if self.bias_init == "normal":
                init_normal(self.bias, 1e-2, generator)
            else:
                with torch.no_grad():
                    self.bias.zero_()

    def split(self):
        """The model-axis split of the weight (``core.tensor_parallel``),
        or None: a weight left whole or gathered where it is used."""
        if parametrize.is_parametrized(self, "weight"):
            return None
        return model_split(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Whole input to whole output, whatever the weight's split: a
        column-parallel weight's columns are gathered, a row-parallel one
        takes its columns of the input."""
        split = self.split()
        if split is None:
            b = None if self.bias is None else self.bias.to(self.dtype)
            return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)
        x = to_model(x, split)
        if split.dim == 0:
            return gather_model(self._column(x, split), split)
        n = local(self.weight).shape[1]
        return self._row(x.narrow(-1, split.rank * n, n), split)

    def column(self, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel layer's output columns on this rank, from the
        replicated ``x`` that went through ``to_model`` (the whole output
        of a weight left whole)."""
        split = self.split()
        return self.forward(x) if split is None else self._column(x, split)

    def row(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel layer's whole output from this rank's columns of
        its input: the partial products summed over the model axis, the
        bias added once (``forward`` for a weight left whole)."""
        split = self.split()
        return self.forward(x) if split is None else self._row(x, split)

    def _column(self, x, split):
        w = local(self.weight).to(self.dtype)
        b = self.bias
        if b is not None:
            # a replicated bias: its gradient is summed over the ranks
            n = w.shape[0]
            b = to_model(b.to(self.dtype), split).narrow(0, split.rank * n, n)
        return F.linear(x.to(self.dtype), w, b)

    def _row(self, x, split):
        y = from_model(F.linear(x.to(self.dtype),
                                local(self.weight).to(self.dtype)), split)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Conv2d(nn.Module):
    """NCHW convolution in the compute dtype, 'VALID' or 'SAME' padding,
    OIHW weights."""

    CAST_PARAMS = ("weight", "bias")

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=(1, 1), padding: str = "VALID", *,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        if padding not in ("VALID", "SAME"):
            raise ValueError(f"unknown padding {padding!r}")
        if padding == "SAME" and tuple(stride) != (1, 1):
            raise ValueError("SAME padding is supported at stride 1 only")
        self.dtype = dtype
        self.stride = tuple(stride)
        self.padding = "same" if padding == "SAME" else 0
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, *kernel_size, dtype=param_dtype,
            device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, dtype=param_dtype,
                                             device=device))

    def reset_parameters(self, generator) -> None:
        fan_in = self.weight[0].numel()
        init_truncated(self.weight, math.sqrt(2.0 / fan_in), generator)
        init_normal(self.bias, 1e-2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype), stride=self.stride,
                        padding=self.padding)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: float32 statistics with the clamped
    E[x^2] - mu^2 variance, per-feature scale and bias, result cast to the
    compute dtype.  ``reduction_dim`` is the axis the statistics pool over:
    -1 (features) or 1 (the reference's 'sequence_compat' LayerNorm)."""

    def __init__(self, features: int, eps: float = 1e-6,
                 reduction_dim: int = -1, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.reduction_dim = reduction_dim
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                             device=device))

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        dim = self.reduction_dim
        mu = x32.mean(dim, keepdim=True)
        var = ((x32 * x32).mean(dim, keepdim=True) - mu * mu).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x32 - mu) * mul + self.bias.float()
        return y.to(self.dtype)


class Embed(nn.Module):
    """Lookup table; rows come out in the compute dtype.

    ``std=None`` gives flax's Embed default (normal, std 1/sqrt(dim))."""

    CAST_PARAMS = ("weight",)

    def __init__(self, num_embeddings: int, features: int, *,
                 std: Optional[float] = None, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.std = std if std is not None else 1.0 / math.sqrt(features)
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, features, dtype=param_dtype, device=device))

    def reset_parameters(self, generator) -> None:
        init_normal(self.weight, self.std, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (epsilon 1e-5).

    Kept in flax's terms rather than torch's ``BatchNorm1d``, whose
    momentum is the weight of the new statistic (flax's ``momentum=0.99``
    is torch's 0.01) and whose running variance is the unbiased one: the
    buffers ``mean`` and ``var`` are flax's ``batch_stats``, the running
    mean and the running *biased* variance.  Train mode normalizes by the
    float32 batch statistics (mean and the clamped E[x^2] - mu^2 over every
    axis but the last) and updates the buffers in place as
    ``momentum * old + (1 - momentum) * new``; eval mode normalizes by the
    buffers.  ``per_example``: statistics over every axis but the first and
    the last (what the JAX package gets by calling the layer under
    ``jax.vmap``); the buffers then take the mean of the examples'
    statistics, where the JAX update leaks a vmap tracer."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype,
                                             device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False,
                per_example: bool = False) -> torch.Tensor:
        x32 = x.float()
        if not train:
            mean, var = self.mean, self.var
        else:
            dims = tuple(range(1 if per_example else 0, x.dim() - 1))
            mean = x32.mean(dims, keepdim=per_example)
            var = ((x32 * x32).mean(dims, keepdim=per_example)
                   - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                new_mean, new_var = mean.detach(), var.detach()
                if per_example:
                    new_mean = new_mean.reshape(-1, x.shape[-1]).mean(0)
                    new_var = new_var.reshape(-1, x.shape[-1]).mean(0)
                self.mean.mul_(m).add_(new_mean, alpha=1.0 - m)
                self.var.mul_(m).add_(new_var, alpha=1.0 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((x32 - mean) * mul + self.bias.float()).to(self.dtype)

