"""Random weights drawn from the run's seed, for the program and the
reference alike.

One generator on the device draws every parameter in one call into one
flat float32 buffer; each parameter is a view into it, scaled by a rule
of its name and shape alone:

- a bias: normal, std 0.02;
- a vector that is not a bias (a norm's scale): 1 + normal, std 0.1;
- a lookup table or learned token block (``*embedding*``, ``*_bias.weight``
  of T5): normal, std 0.5 for the T5 token table, else 0.1;
- a Fourier kernel (n, 1): normal, std sqrt(2 / n);
- the diffusion head's readout projection: normal, std 3 / sqrt(fan_in);
- any other matrix or convolution: normal, std 1 / sqrt(fan_in), fan_in
  being the product of every dimension but the first.

The readout projection carries the observation into the denoiser.  Drawn
at the plain fan-in std, its term in the denoiser's first layer is about
a fifth of the noisy sample's in the noise prediction, so the actions
hardly depend on the towers and the stack, as a trained policy's do; at
three times that std the readouts decide most of each step's prediction
while no action reaches the clip (octo_deep and octo_base_chunk28).

T5 attends without the 1/sqrt(d_kv) scale; its published initialisation
(Raffel et al., arXiv:1910.10683, in Mesh TensorFlow) folds that scale into
the query weights, std (d_model d_kv)^-1/2.  The query third of the fused
projection is drawn so; at std d_model^-1/2 the logits' std would be
sqrt(d_kv) = 8 and every softmax nearly one-hot.

One rule ties two layers.  A one-block diffusion denoiser's output layer
(A, H) is set to ``2 A / |Wn|^2 * Wn^T`` of its input layer Wn (H, A):
since E[w relu(w.x)] = E[w w^T] x / 2 over Gaussian rows w, the untrained
denoiser then predicts roughly its own input, as a trained one predicts
the noise, and the DDPM reverse loop contracts.  With both layers drawn
independently the loop amplifies any difference by up to 1/sqrt(alpha)
per step and most actions end at the clip.

The same seed gives the same tensors on the same device, so the reference
draws its copy anew after the window instead of sharing the program's.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

__all__ = ["draw", "std_of"]

ALIGN = 64      # elements: each view starts on a 256-byte boundary
# (output layer, input layer) of a one-block diffusion denoiser: the output
# layer is tied to the input layer's transpose (see the module docstring)
TIED = ("denoiser.first_out.weight", "denoiser.noisy_proj.weight")
# T5's fused query|key|value projections: the query third takes T5's own
# initialisation (see the module docstring)
T5_QKV = ("t5_encoder.", ".attn.qkv.weight")
# the diffusion head's projection of the readouts, and its std's gain
READOUT_PROJ = "denoiser.readout_proj.weight"
READOUT_GAIN = 3.0


def std_of(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of the parameter ``name`` of ``shape``."""
    if name.endswith(".bias"):
        return 0.0, 0.02
    if len(shape) == 1:
        return 1.0, 0.1
    if "token_embedding" in name and "t5" in name:
        return 0.0, 0.5
    if "embedding" in name or name.endswith("relative_attention_bias.weight"):
        return 0.0, 0.1
    if name.endswith("fourier_kernel"):
        return 0.0, math.sqrt(2.0 / shape[0])
    fan_in = math.prod(shape[1:])
    if name.endswith(READOUT_PROJ):
        return 0.0, READOUT_GAIN / math.sqrt(fan_in)
    return 0.0, 1.0 / math.sqrt(fan_in)


def draw(shapes: Mapping[str, Tuple[int, ...]], seed: int, device,
         model: Mapping) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every (name, shape) of the
    configuration ``model`` (its numbers, as a nested dict)."""
    offsets, total = {}, 0
    for name, shape in shapes.items():
        offsets[name] = total
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out = {}
    for name, shape in shapes.items():
        n = math.prod(shape)
        mean, std = std_of(name, tuple(shape))
        view = flat[offsets[name]:offsets[name] + n].view(shape)
        view.mul_(std).add_(mean)
        out[name] = view
    d_kv = model["text"].get("t5_d_kv")
    for name in out:
        if T5_QKV[0] in name and name.endswith(T5_QKV[1]):
            q = out[name][:out[name].shape[0] // 3]
            q.mul_(1.0 / math.sqrt(d_kv))
        if name.endswith(TIED[0]):
            src = out[name[:-len(TIED[0])] + TIED[1]]
            if tuple(out[name].shape) == tuple(src.shape[::-1]):
                out[name].copy_(src.T * (2.0 * src.shape[1] / src.square().sum()))
    return out
