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
