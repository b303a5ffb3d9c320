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
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Dense", "Conv2d", "LayerNorm", "Embed", "dropout", "init_normal",
           "init_truncated", "ACTIVATIONS", "activation_fn"]

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
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: in train mode with ``rate`` > 0, kept elements
    are scaled by 1/(1 - rate) and the rest zeroed; otherwise ``x``.  The
    mask comes from ``generator``, which train mode then requires."""
    if not train or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError(f"dropout rate {rate} in train mode needs a "
                         f"'dropout' generator")
    keep_prob = 1.0 - rate
    keep = keep_mask(x.shape, keep_prob, generator, x.device)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class Dense(nn.Module):
    """``y = x @ W.T + b`` in the compute dtype.

    ``kernel_init``: 'he' (he_normal, the JAX package's choice for its own
    layers) or 'lecun' (flax's Dense default).  ``bias_init``: 'normal'
    (std 1e-2) or 'zeros'."""

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
        scale = 2.0 if self.kernel_init == "he" else 1.0
        init_truncated(self.weight, math.sqrt(scale / fan_in), generator)
        if self.bias is not None:
            if self.bias_init == "normal":
                init_normal(self.bias, 1e-2, generator)
            else:
                with torch.no_grad():
                    self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


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
