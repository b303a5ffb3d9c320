"""Image path of the port against the JAX package: patchify, eval position
tokens, the ResNetV2 embedder under both JAX conv layouts and both GroupNorm
statistics scopes, and the whole image tokenizer.  f32, tolerance 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_transformers_tokenmerge_torch.ops import image_ops as tops
from multi_modal_transformers_tokenmerge_tpu.modules.image_tokenizer import (
    ResNetV2Embedder as JEmbedder,
)
from multi_modal_transformers_tokenmerge_tpu.ops import image_ops as jops
from torch_parity import MODULE_TOL, assert_close, inputs, micro_pair, \
    octo_micro_t5


@pytest.mark.parametrize("normalize", [True, False])
def test_patchify_matches(normalize):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 3, 64, 64, 3)).astype(np.float32)
    j = jops.patchify(jnp.asarray(imgs), 16, normalize)
    t = tops.patchify(torch.from_numpy(imgs), 16, normalize)
    assert tuple(t.shape) == j.shape == (2, 3, 16, 16, 16, 3)
    assert_close(t, j, 0.0)


@pytest.mark.parametrize("dim,patch,interval", [(280, 56, 128), (64, 32, 16),
                                                (224, 28, 128)])
def test_eval_position_tokens_match(dim, patch, interval):
    for a, b in zip(tops.eval_position_tokens(dim, patch, interval),
                    jops.eval_position_tokens(dim, patch, interval)):
        np.testing.assert_array_equal(a, b)


def _cfg(layout, scope):
    base = octo_micro_t5()
    return base.replace(images=base.images.replace(
        resnet=base.images.resnet.replace(conv_layout=layout,
                                          norm_stats_scope=scope)))


@pytest.mark.parametrize("scope", ["image", "patch"])
@pytest.mark.parametrize("layout", ["hwcn", "nhwc"])
def test_resnet_embedder_matches(layout, scope):
    cfg = _cfg(layout, scope)
    _, v, tm = micro_pair(cfg)
    rng = np.random.default_rng(1)
    # (B, G, p, p, C) with G = 2 frames x 4 patches
    patches = rng.uniform(-1, 1, (2, 8, 32, 32, 3)).astype(np.float32)
    ref = JEmbedder(cfg.images.resnet).apply(
        {"params": v["params"]["image_encoder"]["resnet"]},
        jnp.asarray(patches))
    with torch.no_grad():
        out = tm.image_encoder.resnet(torch.from_numpy(patches))
    assert tuple(out.shape) == ref.shape
    assert_close(out, ref, MODULE_TOL)


@pytest.mark.parametrize("layout", ["hwcn", "nhwc"])
def test_image_tokenizer_matches(layout):
    cfg = _cfg(layout, "image")
    jm, v, tm = micro_pair(cfg)
    _, images = inputs(cfg)
    ref = jm.apply(v, jnp.asarray(images),
                   method=lambda m, x: m.image_encoder(x, train=False))
    with torch.no_grad():
        out = tm.image_encoder(torch.from_numpy(images))
    assert tuple(out.shape) == ref.shape == (2, 8, 32)
    assert_close(out, ref, MODULE_TOL)


@pytest.mark.parametrize("dim,patch,interval", [(280, 56, 128), (64, 32, 16),
                                                (64, 8, 4)])
def test_sample_position_tokens_support(dim, patch, interval):
    """Train-mode tokens fall in each patch's [start, stop) interval, a
    degenerate interval (64/8/4) widened to its start bucket, exactly the
    support of the JAX sampler."""
    import jax
    rs, rp, cs, cp = jops.position_interval_bounds(dim, patch, interval)
    g = torch.Generator().manual_seed(0)
    ours = tops.sample_position_tokens((64, 2), dim, patch, interval, g)
    theirs = jops.sample_position_tokens(jax.random.PRNGKey(0), (64, 2),
                                         dim, patch, interval)
    for t, j, lo, hi in zip(ours, theirs, (rs, cs), (rp, cp)):
        hi = np.maximum(hi, lo + 1)
        assert tuple(t.shape) == (64, 2, lo.shape[0])
        for a in (t.numpy(), np.asarray(j)):
            flat = a.reshape(-1, lo.shape[0])
            assert (flat >= lo).all() and (flat < hi).all()
            np.testing.assert_array_equal(flat.min(0), lo)
    if interval == 4:
        assert (rp <= rs).any()


def test_image_tokenizer_train_mode_matches(monkeypatch):
    """Train mode with the same position draws handed to both packages."""
    import jax
    cfg = _cfg("hwcn", "image")
    jm, v, tm = micro_pair(cfg)
    _, images = inputs(cfg)
    rs, _, cs, _ = jops.position_interval_bounds(
        cfg.images.image_size[0], cfg.images.patch_size,
        cfg.images.position_interval)
    rng = np.random.default_rng(2)
    draws = [rng.integers(0, cfg.images.position_interval,
                          (2, 2, rs.shape[0])).astype(np.int32)
             for _ in range(2)]
    queue = list(draws)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, *a, **k: jnp.asarray(queue.pop(0)))
    ref = jm.apply(v, jnp.asarray(images),
                   method=lambda m, x: m.image_encoder(x, train=True),
                   rngs={"patch_encoding": jax.random.PRNGKey(0)})
    assert not queue
    with torch.no_grad():
        out = tm.image_encoder(torch.from_numpy(images), True,
                               tuple(torch.from_numpy(d) for d in draws))
    assert_close(out, ref, MODULE_TOL)
    with pytest.raises(ValueError):
        tm.image_encoder(torch.from_numpy(images), True)
