"""DDPM diffusion action head.

Counterpart of the JAX package's ``heads/diffusion.py``.  The denoiser's
first layer is split by source (``noisy_proj``, ``time_proj``,
``readout_proj``), so everything that does not depend on the current sample
is computed once before the reverse loop: the (T, B, H) per-step contexts
``time_proj(FourierFeatures(t)) + readout_proj(mean(readouts))``.  With
the one-block denoiser of the shipped configurations the loop itself is
``ops.ddpm_sampler``, its plain version on the CPU and one of two CUDA
kernels on the card, chosen by shape (``ops.ddpm_sampler.sampler_variant``):
the register kernel (``csrc/ddpm_sampler.cu``) where it takes the shape (A
<= 16, H up to 1536 or 768, T·H contexts in one block's shared memory:
octo_base), else the wide kernel (``csrc/ddpm_sampler_wide.cu``), which
takes any action dim, width and step count (octo_base with a 28-wide
action chunk, a 3072-wide denoiser and 100 steps).  With ``num_blocks > 1`` the first layer widens to ``mlp_dim`` and
``num_blocks - 1`` tail ``MLPBlock``s (``mlp_1``, ``mlp_2``, ...; ReLU and
dropout 0.1, the block's defaults, whatever the configuration says) follow
it, the last out to the action dim; the JAX package runs that denoiser in a
``lax.scan`` outside its fused sampler, and the port runs it in a plain
reverse loop here, on any device.

Randomness comes from a ``torch.Generator`` or is passed in: ``noisy``
(B, A) and ``noise`` (T, B, A).  ``sampler_rng_mode='reference'`` keeps
the reference sampler's semantics: the initial sample's noise is reused at
every step and noise is still added at t=0.

Training: :meth:`DiffusionActionHead.denoise_loss` draws a timestep and
noise per example (from the ``diffusion`` generator, or passed in) and
scores the denoiser's noise prediction.  In train mode the denoiser drops
out after its first layer and after its output (``dropout_rate``), and the
time encoder's MLP drops out at the fixed rate 0.1 of the JAX package's
``FourierFeatures``, whatever the configuration says.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..core.config import DiffusionHeadConfig
from ..modules.attention import MLPBlock
from ..modules.layers import Dense, dropout, init_truncated
from ..ops.ddpm_sampler import ddpm_sampler_op
from ..core.global_batch import draw_global

__all__ = ["DiffusionActionHead", "OctoDenoise", "FourierFeatures",
           "cosine_beta_schedule", "ddim_schedule"]


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine noise schedule, in numpy (float64)."""
    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps) / timesteps
    alphas_cumprod = np.cos((t + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def ddim_schedule(diffusion_steps: int, ddim_steps: int,
                  alphas_cumprod: np.ndarray):
    """Evenly subsampled DDIM (eta=0) schedule over a trained DDPM.

    Returns ``(taus, d1, d2, e1, e2)``: descending timesteps and, per step,
    ``x0 = clip(d1*x - d2*eps)``, ``x_prev = e1*x0 + e2*eps``."""
    if not 1 <= ddim_steps <= diffusion_steps:
        raise ValueError(
            f"ddim_steps={ddim_steps} must be in [1, {diffusion_steps}]")
    taus = np.round(
        np.linspace(diffusion_steps - 1, 0, ddim_steps)).astype(np.int32)
    alpha = alphas_cumprod[taus]
    alpha_prev = np.append(alphas_cumprod[taus[1:]], 1.0)
    d1 = 1.0 / np.sqrt(alpha)
    d2 = np.sqrt(1.0 - alpha) / np.sqrt(alpha)
    e1 = np.sqrt(alpha_prev)
    e2 = np.sqrt(1.0 - alpha_prev)
    return (taus, d1.astype(np.float32), d2.astype(np.float32),
            e1.astype(np.float32), e2.astype(np.float32))


class FourierFeatures(nn.Module):
    """Learned Fourier time embedding + MLP (with the MLP's dropout)."""

    CAST_PARAMS = ("fourier_kernel",)

    def __init__(self, output_dim: int, mlp_dim: int, *,
                 dropout_rate: float = 0.1, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.fourier_kernel = nn.Parameter(torch.empty(
            output_dim // 2, 1, dtype=param_dtype, device=device))
        self.mlp = MLPBlock(output_dim, mlp_dim, output_dim,
                            dropout_rate=dropout_rate, dtype=dtype,
                            param_dtype=param_dtype, device=device)

    def reset_parameters(self, generator) -> None:
        # flax he_normal on an (output_dim/2, 1) shape: fan_in = output_dim/2
        init_truncated(self.fourier_kernel,
                       math.sqrt(2.0 / self.fourier_kernel.shape[0]),
                       generator)

    def forward(self, t: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """(..., 1) float times -> (..., output_dim)."""
        x = (2 * math.pi * t.to(self.dtype)) @ self.fourier_kernel.T.to(
            self.dtype)
        return self.mlp(torch.cat([torch.cos(x), torch.sin(x)], dim=-1),
                        train, rng)


class OctoDenoise(nn.Module):
    """Denoiser MLP over (noisy action, time embedding, readout embedding)
    with its first layer split by source, then ``num_blocks - 1`` tail
    blocks ``mlp_{i}`` (the JAX ``OctoDenoise``)."""

    def __init__(self, cfg: DiffusionHeadConfig, readout_dim: int, **kw):
        super().__init__()
        if cfg.num_blocks < 1:
            raise ValueError(f"diffusion num_blocks={cfg.num_blocks} < 1")
        h, a = cfg.mlp_dim, cfg.action_space_dim
        self.dropout_rate = cfg.dropout_rate
        self.num_blocks = cfg.num_blocks
        self.time_encoder = FourierFeatures(cfg.time_dim, cfg.mlp_dim, **kw)
        self.noisy_proj = Dense(a, h, **kw)
        self.time_proj = Dense(cfg.time_dim, h, bias=False, **kw)
        self.readout_proj = Dense(readout_dim, h, bias=False, **kw)
        self.first_out = Dense(h, a if cfg.num_blocks == 1 else h, **kw)
        # MLPBlock's defaults (relu, dropout 0.1), as the JAX tail blocks
        for i in range(1, cfg.num_blocks):
            self.add_module(f"mlp_{i}", MLPBlock(
                h, h, a if i == cfg.num_blocks - 1 else h, **kw))

    def tail(self, x, train: bool = False,
             rng: Optional[torch.Generator] = None):
        for i in range(1, self.num_blocks):
            x = getattr(self, f"mlp_{i}")(x, train, rng)
        return x

    def denoise_from_context(self, noisy_action: torch.Tensor,
                             context: torch.Tensor) -> torch.Tensor:
        """(B, A) noisy actions, (B, H) first-layer context of one step ->
        (B, A) noise prediction in the compute dtype (eval mode)."""
        x = torch.relu(self.noisy_proj(noisy_action) + context)
        return self.tail(self.first_out(x))

    def contexts(self, times: torch.Tensor, readout_emb: torch.Tensor):
        """(T,) times, (B, E) readout embedding -> (T, B, H) per-step
        first-layer contexts in the compute dtype."""
        time_emb = self.time_encoder(times[:, None].float())
        return (self.time_proj(time_emb)[:, None, :]
                + self.readout_proj(readout_emb)[None])

    def forward(self, noisy_action: torch.Tensor, time: torch.Tensor,
                readout_emb: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, A) noisy actions, (B, 1) float times, (B, E) readout
        embedding -> (B, A) noise prediction in the compute dtype."""
        ctx = (self.time_proj(self.time_encoder(time, train, rng))
               + self.readout_proj(readout_emb))
        x = torch.relu(self.noisy_proj(noisy_action) + ctx)
        x = dropout(x, self.dropout_rate, train, rng)
        x = dropout(self.first_out(x), self.dropout_rate, train, rng)
        return self.tail(x, train, rng)


class DiffusionActionHead(nn.Module):
    def __init__(self, cfg: DiffusionHeadConfig, readout_dim: int, **kw):
        super().__init__()
        if cfg.sampler_rng_mode not in ("folded", "reference"):
            raise ValueError(
                f"unknown sampler_rng_mode {cfg.sampler_rng_mode!r}")
        if cfg.ddim_eps_mode not in ("raw", "recompute"):
            raise ValueError(f"unknown ddim_eps_mode {cfg.ddim_eps_mode!r}; "
                             f"'raw' or 'recompute'")
        self.cfg = cfg
        self.denoiser = OctoDenoise(cfg, readout_dim, **kw)
        betas = cosine_beta_schedule(cfg.diffusion_steps)
        alphas = 1.0 - betas
        self._np_alpha_hats = np.cumprod(alphas)
        self._schedules = {}    # (ddim_steps, device) -> (times, coeffs)
        device = kw.get("device")
        self.register_buffer("betas", torch.as_tensor(
            betas, dtype=torch.float32, device=device), persistent=False)
        self.register_buffer("alphas", torch.as_tensor(
            alphas, dtype=torch.float32, device=device), persistent=False)
        self.register_buffer("alpha_hats", torch.as_tensor(
            self._np_alpha_hats, dtype=torch.float32, device=device),
            persistent=False)

    def schedule(self, ddim_steps: Optional[int] = None):
        """(times (T,), coeffs (T, 3|4) f32) for DDPM or ``ddim_steps``-step
        DDIM, on the head's device; made once for each (steps, device), so
        that sampling copies nothing from the host (a CUDA graph could not
        capture that)."""
        device = self.alphas.device
        key = (ddim_steps, str(device))
        if key not in self._schedules:
            with torch.inference_mode(False), torch.no_grad():
                self._schedules[key] = self._make_schedule(ddim_steps, device)
        return self._schedules[key]

    def _make_schedule(self, ddim_steps, device):
        cfg = self.cfg
        if ddim_steps is not None:
            taus, d1, d2, e1, e2 = ddim_schedule(
                cfg.diffusion_steps, ddim_steps, self._np_alpha_hats)
            coeffs = torch.as_tensor(np.stack([d1, d2, e1, e2], axis=-1),
                                     device=device)
            return torch.as_tensor(taus, device=device), coeffs
        times = torch.arange(cfg.diffusion_steps - 1, -1, -1, device=device)
        c3 = torch.sqrt(self.betas[times])
        if cfg.sampler_rng_mode != "reference":
            c3 = torch.where(times > 0, c3, torch.zeros_like(c3))
        coeffs = torch.stack([
            1.0 / torch.sqrt(self.alphas[times]),
            (1.0 - self.alphas[times])
            / torch.sqrt(1.0 - self.alpha_hats[times]),
            c3,
        ], dim=-1)
        return times, coeffs

    def predict_denoise_term(self, readouts: torch.Tensor, time: torch.Tensor,
                             noisy_actions: torch.Tensor, train: bool = True,
                             rng: Optional[torch.Generator] = None):
        """(B, R, E) readouts, (B, 1) time, (B, A) noisy actions -> (B, A);
        ``rng`` is the ``dropout`` generator of train mode."""
        return self.denoiser(noisy_actions, time, readouts.mean(dim=-2),
                             train, rng)

    def denoise_loss(self, readouts: torch.Tensor, actions: torch.Tensor,
                     train: bool = True, time: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None, *,
                     rngs: Optional[Mapping[str, torch.Generator]] = None
                     ) -> torch.Tensor:
        """Mean over the batch of 0.5 * ||pred - noise||^2 at a random
        timestep.  ``time`` (B, 1) int and ``noise`` (B, A) float are drawn
        from ``rngs[cfg.rng_collection]`` unless given; ``rngs['dropout']``
        drives train-mode dropout."""
        cfg = self.cfg
        rngs = rngs or {}
        b = actions.shape[0]
        device = actions.device
        if time is None or noise is None:
            g = rngs.get(cfg.rng_collection)
            if g is None:
                raise ValueError(f"denoise_loss needs a '{cfg.rng_collection}'"
                                 f" generator or explicit time and noise")
            # a data-parallel step draws the global batch's
            if time is None:
                time = draw_global(lambda s: torch.randint(
                    0, cfg.diffusion_steps, s, generator=g, device=device),
                    (b, 1))
            if noise is None:
                noise = draw_global(lambda s: torch.randn(
                    s, generator=g, device=device), actions.shape)
        time = time.to(device=device, dtype=torch.long)
        noise = noise.to(device=device, dtype=torch.float32)
        alpha_hat = self.alpha_hats[time]
        noisy = (torch.sqrt(alpha_hat) * actions
                 + torch.sqrt(1 - alpha_hat) * noise)
        pred = self.predict_denoise_term(readouts, time.float(), noisy,
                                         train, rngs.get("dropout"))
        loss = 0.5 * torch.square(pred.float() - noise)
        return loss.sum(dim=-1).mean()

    def predict_action(self, readouts: torch.Tensor, *,
                       noisy: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       ddim_steps: Optional[int] = None) -> torch.Tensor:
        """(B, R, E) readouts -> (B, A) float32 actions by the full reverse
        process (DDPM, or DDIM when ``ddim_steps`` or ``cfg.ddim_steps`` is
        set).

        ``noisy`` (B, A) is the initial sample and ``noise`` (T, B, A) the
        per-step DDPM noise; whichever is absent is drawn from
        ``generator`` on the readouts' device."""
        cfg = self.cfg
        b = readouts.shape[0]
        a = cfg.action_space_dim
        device = readouts.device
        ddim_steps = ddim_steps if ddim_steps is not None else cfg.ddim_steps
        times, coeffs = self.schedule(ddim_steps)
        steps = times.shape[0]
        # a data-parallel engine draws the global batch's
        if noisy is None:
            noisy = draw_global(lambda s: torch.randn(
                s, generator=generator, device=device), (b, a))
        noisy = noisy.to(device=device, dtype=torch.float32)
        if ddim_steps is None and noise is None:
            if cfg.sampler_rng_mode == "reference":
                noise = noisy.expand(steps, b, a)
            else:
                noise = draw_global(lambda s: torch.randn(
                    s, generator=generator, device=device), (steps, b, a),
                    dim=1)
        if noise is not None:
            noise = noise.to(device=device, dtype=torch.float32)

        contexts = self.denoiser.contexts(times, readouts.mean(dim=-2))
        d = self.denoiser
        if d.num_blocks > 1:
            return self._reverse_loop(noisy, contexts, noise, coeffs,
                                      ddim_steps is not None)
        return ddpm_sampler_op(
            noisy, contexts, None if ddim_steps is not None else noise,
            coeffs, d.noisy_proj.weight, d.noisy_proj.bias,
            d.first_out.weight, d.first_out.bias, cfg.clip_value,
            ddim_steps is not None,
            ddim_steps is not None and cfg.ddim_eps_mode == "recompute")

    def _reverse_loop(self, noisy, contexts, noise, coeffs, ddim: bool):
        """The reverse process of a multi-block denoiser, step by step (the
        JAX package's ``lax.scan`` paths): DDPM
        ``x = clip(c1 * (x - c2 * eps) + c3 * noise_t)``, or DDIM with the
        clamped x0 and ``ddim_eps_mode``."""
        cfg = self.cfg
        clip = cfg.clip_value
        recompute = cfg.ddim_eps_mode == "recompute"
        x = noisy
        for i in range(contexts.shape[0]):
            eps = self.denoiser.denoise_from_context(x, contexts[i]).float()
            if ddim:
                d1, d2, e1, e2 = coeffs[i].unbind()
                x0 = torch.clamp(d1 * x - d2 * eps, -clip, clip)
                if recompute:
                    eps = (d1 * x - x0) / d2
                x = e1 * x0 + e2 * eps
            else:
                c1, c2, c3 = coeffs[i].unbind()
                x = c1 * (x - c2 * eps) + c3 * noise[i]
            x = torch.clamp(x, -clip, clip)
        return x
