"""The whole serving slice of the port against the JAX package: images and
a cached instruction through ``Octo.predict_diffusion_action_with_text``
and ``PolicyEngine.__call__``, 32-step DDPM, the JAX side with
``sampler_impl='fused'`` (interpret mode on the CPU).  f32, tolerance 1e-4
for the whole slice through 32-step sampling.  Then the ToMe models (the
micro fixtures of ``torch_parity``, staged and per-layer) end to end for
each head's predict method and through ``PolicyEngine``, and every preset:
built on the ``meta`` device at full size, converted at micro size."""

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
    inputs, micro_pair, octo_micro_t5, octo_micro_tome_layers, \
    octo_micro_tome_staged, to_torch_config


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


TOME = {"staged": octo_micro_tome_staged, "layers": octo_micro_tome_layers,
        "staged_prune_prestack": lambda: octo_micro_tome_staged(
            compression_mode="prune", prestack_merge=True),
        "layers_proportional": lambda: octo_micro_tome_layers(
            proportional_attention=True)}
PREDICT = {"continuous": ("predict_continuous_action", (2, 1, 4)),
           "categorical": ("predict_action_logits", (2, 2, 16)),
           "diffusion": ("predict_diffusion_action", (2, 4))}


@pytest.mark.parametrize("head", sorted(PREDICT))
@pytest.mark.parametrize("cadence", sorted(TOME))
def test_tome_octo_predict_matches(monkeypatch, cadence, head):
    """A micro ToMe Octo end to end, from token ids and images to each
    head's prediction, and the cached-text variant beside it."""
    cfg = TOME[cadence]()
    jm, v, tm = micro_pair(cfg)
    ids, images = inputs(cfg, seed=30)
    method, shape = PREDICT[head]
    t_ids, t_images = torch.from_numpy(ids).long(), torch.from_numpy(images)
    kw = {}
    if head == "diffusion":
        cap = capture_sampler_inputs(monkeypatch)
        ref = jm.apply(v, jnp.asarray(ids), jnp.asarray(images),
                       rngs={"diffusion": jax.random.PRNGKey(5)},
                       method=method)
        kw["noisy"], kw["noise"] = cap.last()
    else:
        ref = jm.apply(v, jnp.asarray(ids), jnp.asarray(images),
                       method=method)
    with torch.no_grad():
        out = getattr(tm, method)(t_ids, t_images, **kw)
        cached = getattr(tm, method + "_with_text")(
            tm.encode_text(t_ids), t_images, **kw)
    assert tuple(out.shape) == ref.shape == shape
    assert_close(out, ref, SLICE_TOL)
    assert torch.equal(out, cached)


@pytest.mark.parametrize("head", ["continuous", "categorical"])
def test_policy_engine_other_heads_match(head):
    cfg = octo_micro_tome_staged()
    jm, v, tm = micro_pair(cfg)
    ids, _ = inputs(cfg, batch=1, seed=31)
    jeng = JEngine(jm, v, head=head, batch_size=2)
    teng = TEngine(tm, head=head, batch_size=2)
    jeng.set_instruction(ids[0])
    teng.set_instruction(ids[0])
    _, images = inputs(cfg, seed=32)
    ref = jeng(images)
    out = teng(images)
    assert tuple(out.shape) == ref.shape == PREDICT[head][1]
    assert_close(out, ref, SLICE_TOL)


def test_policy_engine_head_checks():
    cfg = octo_micro_tome_staged()
    _, _, tm = micro_pair(cfg)
    with pytest.raises(ValueError, match="unknown head"):
        TEngine(tm, head="gaussian")
    with pytest.raises(ValueError, match="ddim_steps only applies"):
        TEngine(tm, head="continuous", ddim_steps=2)
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    tc = tm.config
    bare = Octo(tc.replace(heads=tc.heads.replace(diffusion=None,
                                                  categorical=None)),
                device="meta", seed=None)
    assert not hasattr(bare, "diffusion_action_head")
    with pytest.raises(ValueError, match="no 'diffusion' head"):
        TEngine(bare, head="diffusion")


def _micro_of(cfg):
    """A preset cut to micro widths, its sequence layout, compression,
    cadence, text tower kind and heads kept."""
    from multi_modal_transformers_tokenmerge_tpu.core.config import (
        ResNetEmbedderConfig)
    side = cfg.images.patches_per_dim
    h = cfg.heads
    return cfg.replace(
        token_embedding_dim=32,
        text=cfg.text.replace(vocab_size=64, embedding_dim=32,
                              t5_num_layers=2, t5_num_heads=2, t5_d_ff=48,
                              t5_d_kv=8),
        images=cfg.images.replace(
            image_size=(side * 16, side * 16, 3), patch_size=16,
            position_interval=16, embedding_dim=32,
            resnet=ResNetEmbedderConfig(
                num_blocks=1, features=8, input_kernel=(4, 4),
                input_stride=(2, 2), group_norm_groups=4,
                output_features=32)),
        transformer=cfg.transformer.replace(
            attention=cfg.transformer.attention.replace(num_heads=2,
                                                        qkv_features=32),
            mlp_dim=64),
        heads=h.replace(
            categorical=h.categorical and h.categorical.replace(num_bins=16),
            diffusion=h.diffusion and h.diffusion.replace(
                diffusion_steps=4, time_dim=16, mlp_dim=32)))


@pytest.mark.parametrize("name", ["octo_tiny", "octo_small", "octo_base",
                                  "octo_multicam", "octo_base_deep",
                                  "octo_deep"])
def test_every_preset_builds_and_converts(name):
    """The port's preset equals the JAX package's field for field and
    builds at full size on the meta device (no memory); at micro widths
    ``from_flax`` accepts the JAX package's parameter tree of the preset
    (shapes from ``jax.eval_shape`` of its init) and the result loads."""
    from multi_modal_transformers_tokenmerge_torch.models import presets as tp
    from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
    from multi_modal_transformers_tokenmerge_tpu.models import presets as jp
    from multi_modal_transformers_tokenmerge_tpu.models.octo import (
        Octo as JOcto)
    jcfg = jp.PRESETS[name]()
    assert to_torch_config(jcfg) == tp.PRESETS[name]()
    full = Octo(tp.PRESETS[name](), device="meta", seed=None)
    compressed = name in ("octo_small", "octo_base_deep", "octo_deep")
    assert full.use_compression == compressed
    assert type(full.transformer).__name__ == (
        "CompressedTransformerStack" if compressed else "TransformerStack")
    if compressed:
        assert full.transformer.num_stages == 3
        want = {"octo_deep": [224, 160, 96]}.get(name, [74, 66, 58])
        assert [full.transformer.get_buffer(f"mask_{i}").shape[0]
                for i in range(3)] == want
        assert full.transformer.final_layer() == 2

    micro = _micro_of(jcfg)
    jm = JOcto(micro)
    frames = jm.bind({}).layout.modality_tokens("images") // \
        micro.images.tokens_per_image
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0),
                         "diffusion": jax.random.PRNGKey(1)},
                        jnp.zeros((1, micro.text.max_length), jnp.int32),
                        jnp.zeros((1, frames, *micro.images.image_size))))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32),
        shapes["params"])
    tc = to_torch_config(micro)
    state = convert.from_flax(params, tc)
    tm = Octo(tc, device="cpu", seed=None)
    tm.load_state_dict(state)
    heads = [h for h in ("continuous", "categorical", "diffusion")
             if getattr(tc.heads, h) is not None]
    assert all(hasattr(tm, f"{h}_action_head") for h in heads)
    layer = tm.transformer.final_layer() if compressed else 0
    assert tm.readout_index.tolist() == tm.layout.modality_index(
        "readouts", layer=layer).tolist()
    n_flax = sum(a.size for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in tm.parameters()) == n_flax
