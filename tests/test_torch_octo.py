"""The whole serving slice of the port against the JAX package: images and
a cached instruction through ``Octo.predict_diffusion_action_with_text``
and ``PolicyEngine.__call__``, 32-step DDPM, the JAX side with
``sampler_impl='fused'`` (interpret mode on the CPU).  f32, tolerance 1e-4
for the whole slice through 32-step sampling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.serve.policy import (
    PolicyEngine as TEngine,
)
from multi_modal_transformers_tokenmerge_tpu.serve.policy import (
    PolicyEngine as JEngine,
)
from torch_parity import SLICE_TOL, assert_close, capture_sampler_inputs, \
    inputs, micro_pair, octo_micro_t5, to_torch_config


@pytest.mark.parametrize("cached_text", [True, False])
def test_predict_diffusion_action_matches(monkeypatch, cached_text):
    """``predict_diffusion_action_with_text`` on cached embeddings, and
    ``predict_diffusion_action`` from token ids."""
    cfg = octo_micro_t5()
    jm, v, tm = micro_pair(cfg)
    ids, images = inputs(cfg, seed=7)
    cap = capture_sampler_inputs(monkeypatch)
    rngs = {"diffusion": jax.random.PRNGKey(11)}
    if cached_text:
        text = jm.apply(v, jnp.asarray(ids), method="encode_text")
        ref = jm.apply(v, text, jnp.asarray(images), rngs=rngs,
                       method="predict_diffusion_action_with_text")
    else:
        ref = jm.apply(v, jnp.asarray(ids), jnp.asarray(images), rngs=rngs,
                       method="predict_diffusion_action")
    noisy, noise = cap.last()
    t_ids, t_images = torch.from_numpy(ids).long(), torch.from_numpy(images)
    with torch.no_grad():
        if cached_text:
            out = tm.predict_diffusion_action_with_text(
                tm.encode_text(t_ids), t_images, noisy=noisy, noise=noise)
        else:
            out = tm.predict_diffusion_action(t_ids, t_images, noisy=noisy,
                                              noise=noise)
    assert tuple(out.shape) == ref.shape == (2, 4)
    assert_close(out, ref, SLICE_TOL)


@pytest.mark.parametrize("ddim_steps", [None, 8])
def test_policy_engine_matches(monkeypatch, ddim_steps):
    cfg = octo_micro_t5()
    jm, v, tm = micro_pair(cfg)
    ids, _ = inputs(cfg, batch=1, seed=8)
    jeng = JEngine(jm, v, head="diffusion", batch_size=2,
                   rng=jax.random.PRNGKey(3), ddim_steps=ddim_steps)
    teng = TEngine(tm, head="diffusion", batch_size=2, seed=3,
                   ddim_steps=ddim_steps)
    jeng.set_instruction(ids[0])
    teng.set_instruction(ids[0])
    cap = capture_sampler_inputs(monkeypatch)
    for step in range(2):  # two requests: the engine's stream advances
        _, images = inputs(cfg, seed=20 + step)
        ref = jeng(images)
        noisy, noise = cap.last()
        out = teng(images, noisy=noisy,
                   noise=None if ddim_steps else noise)
        assert tuple(out.shape) == ref.shape == (2, 4)
        assert_close(out, ref, SLICE_TOL)


def test_policy_engine_draws_fresh_noise_per_request():
    cfg = octo_micro_t5()
    _, _, tm = micro_pair(cfg)
    eng = TEngine(tm, batch_size=2, seed=0)
    ids, images = inputs(cfg, batch=1)
    eng.set_instruction(ids)
    a, b = eng(images.repeat(2, 0)), eng(images.repeat(2, 0))
    assert torch.isfinite(a).all() and (a.abs() <= 5.0).all()
    assert (a - b).abs().max() > 1e-4
    again = TEngine(tm, batch_size=2, seed=0).set_instruction(ids)
    torch.testing.assert_close(again(images.repeat(2, 0)), a, rtol=0, atol=0)


def test_encode_instruction_lru():
    cfg = octo_micro_t5()
    _, _, tm = micro_pair(cfg)
    eng = TEngine(tm, batch_size=1)
    eng._instruction_cache_max = 2
    ids = [inputs(cfg, batch=1, seed=s)[0][0] for s in range(3)]
    first = eng.encode_instruction(ids[0])
    assert eng.encode_instruction(ids[0]) is first
    eng.encode_instruction(ids[1])
    eng.encode_instruction(ids[2])
    assert len(eng._instruction_cache) == 2
    assert eng.encode_instruction(ids[0]) is not first


def test_convert_rejects_unknown_and_missing_keys():
    cfg = octo_micro_t5()
    _, v, _ = micro_pair(cfg)
    params = jax.tree.map(np.asarray, v["params"])
    tc = to_torch_config(cfg)
    extra = dict(params, mystery={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="mystery"):
        convert.from_flax(extra, tc)
    short = {k: val for k, val in params.items() if k != "readout_encoder"}
    with pytest.raises(KeyError, match="readout_encoder"):
        convert.from_flax(short, tc)


def test_entry_points_default_to_cuda():
    """The port never drops quietly to the CPU: with no device given it
    builds on 'cuda', which fails on a CPU-only build."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only build")
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    with pytest.raises((RuntimeError, AssertionError)):
        Octo(to_torch_config(octo_micro_t5()))
