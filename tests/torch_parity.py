"""Shared fixtures of the torch-port parity tests.

``micro_pair(cfg)`` initializes the JAX package's Octo for a micro
configuration, converts its parameters with the port's
``convert.from_flax`` and loads them into the port's Octo on the CPU.
``capture_sampler_inputs`` records the initial sample and per-step noise
that the JAX diffusion head hands to its fused sampler, so the port can be
given the very same randomness.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from micro_configs import octo_micro, octo_micro_tome
from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.core import config as tcfg
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_tpu.heads import diffusion as jdiff
from multi_modal_transformers_tokenmerge_tpu.models.octo import Octo as JOcto

# f32 tolerance per module (tests/test_ddpm_fused.py:47) and for the whole
# slice through 32-step sampling
MODULE_TOL = 2e-5
SLICE_TOL = 1e-4


def octo_micro_t5(**overrides):
    """Micro Octo with a 2-layer T5 tower, 2 frames (so the 'image'
    GroupNorm scope spans frames) and a 32-step diffusion head."""
    base = octo_micro()
    cfg = base.replace(
        input_sequence="[TaskDescriptionPrefix{4}] [Image{4};Readout{2}]*2",
        num_observation_blocks=2,
        text=base.text.replace(kind="t5", t5_num_layers=2, t5_num_heads=2,
                               t5_d_ff=48, t5_d_kv=8),
        heads=base.heads.replace(
            diffusion=base.heads.diffusion.replace(diffusion_steps=32,
                                                   sampler_impl="fused")),
    )
    return cfg.replace(**overrides)


def octo_micro_tome_layers(**transformer):
    """Micro ToMe Octo, per-layer cadence: 2 frames of 16 image tokens, 2
    compressed blocks that each shed 2 image tokens a set (44 -> 36), every
    head (the JAX diffusion head on its fused sampler, so that
    ``capture_sampler_inputs`` sees its noise).  ``transformer`` overrides
    fields of its TransformerConfig."""
    cfg = octo_micro_tome()
    return cfg.replace(
        transformer=cfg.transformer.replace(**transformer),
        heads=cfg.heads.replace(diffusion=cfg.heads.diffusion.replace(
            sampler_impl="fused")))


def octo_micro_tome_staged(**transformer):
    """Micro ToMe Octo, staged cadence: 4 blocks in 2 stages of 2 with one
    merge event between them (44 -> 40 tokens)."""
    return octo_micro_tome_layers(**{"num_blocks": 4, "tome_merge_every": 2,
                                     **transformer})


def to_torch_config(cfg):
    """The JAX config, field for field, as the port's config."""
    def conv(obj, cls):
        kw = {}
        for f in obj.__dataclass_fields__:
            v = getattr(obj, f)
            if hasattr(v, "__dataclass_fields__"):
                v = conv(v, getattr(tcfg, type(v).__name__))
            kw[f] = v
        return cls(**kw)
    return conv(cfg, tcfg.OctoConfig)


@functools.lru_cache(maxsize=None)
def micro_pair(cfg):
    """(JAX module, JAX variables, port module) for one JAX config."""
    jm = JOcto(cfg)
    b, f = 2, 2
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "diffusion": jax.random.PRNGKey(1)},
                jnp.zeros((b, cfg.text.max_length), jnp.int32),
                jnp.zeros((b, f, *cfg.images.image_size)))
    params = jax.tree.map(np.asarray, v["params"])
    tc = to_torch_config(cfg)
    tm = TOcto(tc, device="cpu", seed=None)
    tm.load_state_dict(convert.from_flax(params, tc))
    return jm, v, tm.eval()


def inputs(cfg, batch=2, frames=2, seed=0):
    """Token ids and uint8-valued float images, from numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.text.vocab_size,
                       (batch, cfg.text.max_length)).astype(np.int32)
    images = rng.integers(0, 256, (batch, frames, *cfg.images.image_size)
                          ).astype(np.float32)
    return ids, images


class capture_sampler_inputs:
    """Patches the JAX head (undone by ``monkeypatch``) to record the
    (noisy, noise) of every JAX
    ``fused_ddpm_sample`` call, jitted or not."""

    def __init__(self, monkeypatch):
        self.calls = []
        original = jdiff.fused_ddpm_sample

        def wrapper(noisy, contexts, noise, *args, **kw):
            jax.debug.callback(
                lambda a, b: self.calls.append((np.asarray(a),
                                                np.asarray(b))),
                noisy, noise)
            return original(noisy, contexts, noise, *args, **kw)

        monkeypatch.setattr(jdiff, "fused_ddpm_sample", wrapper)

    def last(self):
        jax.effects_barrier()
        noisy, noise = self.calls[-1]
        return torch.tensor(noisy), torch.tensor(noise)


def assert_close(port, ref, tol):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref, dtype=np.float32),
                               rtol=tol, atol=tol)


def flat_intermediates(tree, prefix=()):
    """A flax ``intermediates`` tree as {'a/b/attention_weights': value}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_intermediates(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out
