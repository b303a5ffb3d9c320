"""The port's legacy model families, point-cloud tokenizer and offset
attention against the JAX package (``models/legacy.py``,
``modules/pointcloud.py``, ``modules/offset_attention.py``) on the CPU,
with the weights carried by ``convert.from_flax_variables`` (flax
``batch_stats`` included) and inputs made from numpy seeds.  Float32
throughout, at the per-module tolerance of ``torch_parity`` (2e-5)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import MODULE_TOL, assert_close
from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.core import config as tcfg
from multi_modal_transformers_tokenmerge_torch.models import legacy as T
from multi_modal_transformers_tokenmerge_torch.modules import layers as tlayers
from multi_modal_transformers_tokenmerge_torch.modules import pointcloud as tpc
from multi_modal_transformers_tokenmerge_torch.modules.attention import (
    TransformerStack)
from multi_modal_transformers_tokenmerge_torch.modules.offset_attention import (
    OffsetAttention as TOffset)
from multi_modal_transformers_tokenmerge_tpu.models import legacy as J
from multi_modal_transformers_tokenmerge_tpu.modules import pointcloud as jpc
from multi_modal_transformers_tokenmerge_tpu.modules.offset_attention import (
    OffsetAttention as JOffset)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables):
    module.load_state_dict(convert.from_flax_variables(_np(variables),
                                                       module))
    return module.eval()


def _rngs():
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    return {"params": keys[0], "patch_encoding": keys[1], "dropout": keys[2]}


def _points(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- the point-cloud tokenizer --------------------------------------------------------

def test_pairwise_sq_dist_matches_jax():
    a, b = _points(0, (3, 10, 3)), _points(1, (3, 7, 3))
    want = np.stack([np.asarray(jpc.pairwise_sq_dist(jnp.asarray(x),
                                                     jnp.asarray(y)))
                     for x, y in zip(a, b)])
    assert_close(tpc.pairwise_sq_dist(torch.tensor(a), torch.tensor(b)),
                 want, MODULE_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_farthest_point_sampling_matches_jax(seed):
    """The same start index gives the same samples, one cloud or a
    batch."""
    pts = _points(seed, (2, 200, 3))
    key = jax.random.PRNGKey(seed)
    start = int(jax.random.randint(key, (), 0, 200))
    want = np.stack([np.asarray(jpc.farthest_point_sampling(
        jnp.asarray(p), 24, key)) for p in pts])
    got = tpc.farthest_point_sampling(torch.tensor(pts), 24, start)
    np.testing.assert_array_equal(got.numpy(), want)
    one = tpc.farthest_point_sampling(torch.tensor(pts[0]), 24, start)
    np.testing.assert_array_equal(one.numpy(), want[0])


def test_farthest_point_sampling_draws_its_start_from_a_generator():
    pts = torch.tensor(_points(3, (4, 50, 3)))
    g = torch.Generator().manual_seed(7)
    a = tpc.farthest_point_sampling(pts, 10, generator=g)
    g.manual_seed(7)
    b = tpc.farthest_point_sampling(pts, 10, generator=g)
    assert torch.equal(a, b)
    assert all(len(set(row.tolist())) == 10 for row in a)


@pytest.mark.parametrize("exact", [True, False])
def test_knn_matches_jax(exact):
    """``exact=False`` is JAX's approx_max_k, exact on the CPU."""
    pts, cents = _points(4, (120, 3)), _points(5, (9, 3))
    want = np.asarray(jpc.knn(jnp.asarray(pts), jnp.asarray(cents), 6,
                              exact=exact))
    got = tpc.knn(torch.tensor(pts), torch.tensor(cents), 6, exact=exact)
    np.testing.assert_array_equal(got.numpy(), want)


def test_knn_breaks_ties_toward_the_lower_index():
    pts = jnp.asarray(np.arange(20, dtype=np.float32)[:, None] * [1, 0, 0])
    want = np.asarray(jpc.knn(pts, pts[:2], 3, exact=True))
    got = tpc.knn(torch.tensor(np.asarray(pts)),
                  torch.tensor(np.asarray(pts[:2])), 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ball_query_matches_jax():
    pts, cents = _points(6, (80, 3)), _points(7, (5, 3))
    want = np.asarray(jpc.ball_query(jnp.asarray(pts), jnp.asarray(cents),
                                     8, 0.9))
    got = tpc.ball_query(torch.tensor(pts), torch.tensor(cents), 8, 0.9)
    np.testing.assert_array_equal(got.numpy(), want)


def _sample_and_group(train):
    pts = _points(8, (2, 100, 6))
    key = jax.random.PRNGKey(2)
    jm = jpc.SampleAndGroup(num_samples=16, num_neighbours=8, embed_dim=32)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(pts[0]), key)
    start = int(jax.random.randint(key, (), 0, 100))
    tm = _load(tpc.SampleAndGroup(6, 16, 8, 32), v)
    want = np.stack([np.asarray(
        jm.apply(v, jnp.asarray(p), key, train,
                 mutable=["batch_stats"] if train else False)
        [0 if train else slice(None)]) for p in pts])
    return tm(torch.tensor(pts), train, start), want


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_sample_and_group_matches_jax(train):
    """Eval mode on the converted statistics; train mode on each cloud's
    own batch statistics (what the JAX module computes under vmap)."""
    got, want = _sample_and_group(train)
    assert got.shape == (2, 16, 3 + 32)
    assert_close(got, want, MODULE_TOL)


# -- BatchNorm, offset attention ------------------------------------------------------

def test_batchnorm_train_step_updates_like_flax():
    """A train-mode call normalizes by the batch statistics and moves the
    buffers as flax moves ``batch_stats`` (momentum 0.99 on the running
    mean and the biased variance); eval mode reads the buffers."""
    x = _points(9, (4, 7, 5)) * 3 + 1
    jm = fnn.BatchNorm(use_running_average=False)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"scale": jnp.linspace(0.5, 1.5, 5),
                    "bias": jnp.linspace(-1, 1, 5)},
         "batch_stats": {"mean": jnp.linspace(0, 1, 5),
                         "var": jnp.linspace(1, 2, 5)}}
    y, upd = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tm = _load(tlayers.BatchNorm(5), v)
    got = tm(torch.tensor(x), train=True)
    assert_close(got, y, MODULE_TOL)
    assert_close(tm.mean, upd["batch_stats"]["mean"], 1e-6)
    assert_close(tm.var, upd["batch_stats"]["var"], 1e-6)
    y_eval = fnn.BatchNorm(use_running_average=True).apply(
        {"params": v["params"], "batch_stats": upd["batch_stats"]},
        jnp.asarray(x))
    assert_close(tm(torch.tensor(x)), y_eval, MODULE_TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_offset_attention_matches_jax(train):
    x = _points(10, (2, 10, 16))
    jm = JOffset(num_heads=2, qkv_features=16)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = _load(TOffset(16, 2, 16), v)
    if train:
        y, upd = jm.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        got = tm(torch.tensor(x), train=True)
        bs = upd["batch_stats"]["lbr_bn"]
        assert_close(tm.lbr_bn.mean, bs["mean"], 1e-6)
        assert_close(tm.lbr_bn.var, bs["var"], 1e-6)
    else:
        y = jm.apply(v, jnp.asarray(x))
        got = tm(torch.tensor(x))
    assert_close(got, y, MODULE_TOL)


def _pct_cfgs():
    kw = dict(lbr_features=(16, 16), sample1=(32, 8, 32),
              sample2=(16, 8, 32), attention_heads=2, attention_layers=4)
    return J.PointCloudTransformerConfig(**kw), T.PointCloudTransformerConfig(
        **kw)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_point_cloud_transformer_matches_jax(train):
    """Both stages' FPS starts are the JAX key's draws; train mode
    normalizes by batch statistics."""
    jc, tc = _pct_cfgs()
    jm = J.PointCloudTransformer(jc)
    pts = _points(11, (2, 128, 3))
    key = jax.random.PRNGKey(2)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(pts), key)
    if train:
        want, _ = jm.apply(v, jnp.asarray(pts), key, train=True,
                           mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(pts), key)
    k1, k2 = jax.random.split(key)
    starts = (int(jax.random.randint(k1, (), 0, 128)),
              int(jax.random.randint(k2, (), 0, 32)))
    tm = _load(T.PointCloudTransformer(tc, 3, device="cpu", seed=None), v)
    got = tm(torch.tensor(pts), train, starts)
    assert got.shape == (2, 16, 32 * 4)
    assert_close(got, want, MODULE_TOL)


# -- the concept learners and the planner ----------------------------------------------

@pytest.fixture(scope="module")
def cl_inputs():
    rng = np.random.default_rng(12)
    return dict(text=rng.integers(1, 256, (2, 8)).astype(np.int32),
                images=rng.uniform(0, 255, (2, 4, 64, 64, 3)).astype(
                    np.float32),
                actions=np.array([[3, 2, 0, 0], [1, 0, 0, 0]], np.int32))


def _pair(jcls, tcls, *init_args, **tkw):
    jm = jcls(J.ConceptLearnerConfig())
    v = jm.init(_rngs(), *init_args)
    tm = _load(tcls(T.ConceptLearnerConfig(), device="cpu", seed=None, **tkw),
               v)
    return jm, v, tm


def test_gato_concept_learner_matches_jax(cl_inputs):
    c = cl_inputs
    args = (c["text"], c["images"], c["actions"])
    jm, v, tm = _pair(J.GatoConceptLearner, T.GatoConceptLearner, *args)
    with torch.no_grad():
        got = tm(*(torch.tensor(a) for a in args))
    assert got.shape == (2, 32)
    assert_close(got, jm.apply(v, *args), MODULE_TOL)


def test_single_image_concept_learner_matches_jax(cl_inputs):
    args = (cl_inputs["text"], cl_inputs["images"][:, 0])
    jm, v, tm = _pair(J.SingleImageConceptLearner,
                      T.SingleImageConceptLearner, *args)
    with torch.no_grad():
        assert_close(tm(*(torch.tensor(a) for a in args)),
                     jm.apply(v, *args), MODULE_TOL)


@pytest.mark.parametrize("layer", [0, 1])
def test_attention_importance_matches_jax(cl_inputs, layer):
    args = (cl_inputs["text"], cl_inputs["images"][:, 0])
    jm, v, tm = _pair(J.SingleImageConceptLearner,
                      T.SingleImageConceptLearner, *args)
    want = J.attention_importance(jm, v, *args, layer=layer)
    got = T.attention_importance(tm, *(torch.tensor(a) for a in args),
                                 layer=layer)
    assert got.shape == (2, 8 + 4)
    assert_close(got, want, MODULE_TOL)
    with pytest.raises(ValueError, match="no attention weights"):
        T.attention_importance(tm, *(torch.tensor(a) for a in args),
                               layer=5)


class _TinyScanned(fnn.Module):
    """The JAX test's scanned-stack probe model."""

    @fnn.compact
    def __call__(self, text, images):
        from multi_modal_transformers_tokenmerge_tpu.core.config import (
            AttentionConfig, TransformerConfig)
        from multi_modal_transformers_tokenmerge_tpu.modules.attention import (
            TransformerStack as JStack)
        t = fnn.Embed(16, 16, name="embed")(text)
        im = fnn.Dense(16, name="dense")(images.reshape(images.shape[0], 4,
                                                        -1))
        x = jnp.concatenate([t, im], axis=1)
        cfg = TransformerConfig(
            num_blocks=2, attention=AttentionConfig(
                num_heads=2, qkv_features=16, dropout_rate=0.0),
            mlp_dim=32, dropout_rate=0.0)
        return JStack(cfg, name="transformer")(x)


class _TorchTinyScanned(torch.nn.Module):
    def __init__(self):
        super().__init__()
        cfg = tcfg.TransformerConfig(
            num_blocks=2, attention=tcfg.AttentionConfig(
                num_heads=2, qkv_features=16, dropout_rate=0.0),
            mlp_dim=32, dropout_rate=0.0)
        self.embed = tlayers.Embed(16, 16)
        self.dense = tlayers.Dense(64 * 64 * 3 // 4, 16)
        self.transformer = TransformerStack(cfg, 12, 16)

    def forward(self, text, images):
        im = self.dense(images.reshape(images.shape[0], 4, -1))
        return self.transformer(torch.cat([self.embed(text), im], dim=1))


def test_attention_importance_reads_a_stacked_transformer():
    """A TransformerStack records one (L, B, H, Q, K) entry; the layer
    index picks its layer, as in JAX."""
    text = np.ones((2, 8), np.int32)
    images = np.random.default_rng(13).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jm = _TinyScanned()
    v = jm.init(jax.random.PRNGKey(0), text, images)
    tm = _TorchTinyScanned()
    tm.load_state_dict(convert.tree_to_state(
        _np(v["params"]), (("transformer", "blocks"),)))
    for layer in (0, 1):
        want = J.attention_importance(jm, v, text, images, layer=layer)
        got = T.attention_importance(tm, torch.tensor(text),
                                     torch.tensor(images), layer=layer)
        assert_close(got, want, MODULE_TOL)
    with pytest.raises(ValueError, match="out of range"):
        T.attention_importance(tm, torch.tensor(text), torch.tensor(images),
                               layer=5)


def test_concept_learner_meta_loss_matches_jax(cl_inputs):
    args = (cl_inputs["text"], cl_inputs["images"][:, 0],
            np.array([1, 2], np.int32))
    jm, v, tm = _pair(J.ConceptLearnerMetaLoss, T.ConceptLearnerMetaLoss,
                      *args)
    with torch.no_grad():
        got = tm(*(torch.tensor(a) for a in args))
    assert got.shape == (2, 1) and bool((got >= 0).all())
    assert_close(got, jm.apply(v, *args), MODULE_TOL)


def test_concept_planner_matches_jax(cl_inputs):
    images = cl_inputs["images"][:, 0]
    text = np.zeros((2, 4), np.int32)
    text[0, :2] = [7, 9]
    jm, v, tm = _pair(J.ConceptPlanner, T.ConceptPlanner, images, text,
                      text_length=4)
    with torch.no_grad():
        tok, lp, val = tm(torch.tensor(images), torch.tensor(text))
        logits = tm.predict_next_token_logits(torch.tensor(images),
                                              torch.tensor(text))
    jtok, jlp, jval = jm.apply(v, images, text)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert_close(lp, jlp, MODULE_TOL)
    assert_close(val, jval, MODULE_TOL)
    assert_close(logits, jm.apply(v, images, text,
                                  method="predict_next_token_logits"),
                 MODULE_TOL)


@pytest.mark.parametrize("terminate", [5, 158])
def test_concept_planner_generation_matches_jax(cl_inputs, terminate):
    """Greedy generation token for token, the log-probabilities and the
    empty text's value; a terminated row emits 0 after its stop token."""
    images = cl_inputs["images"][:, 0]
    text = np.zeros((2, 4), np.int32)
    jm, v, tm = _pair(J.ConceptPlanner, T.ConceptPlanner, images, text)
    jgen = jm.apply(v, images, terminate_token=terminate,
                    method="predict_concept_and_value")
    with torch.no_grad():
        gen = tm.predict_concept_and_value(torch.tensor(images),
                                           terminate_token=terminate)
    assert gen[0].dtype == torch.int32 and gen[0].shape == (2, 4)
    np.testing.assert_array_equal(gen[0].numpy(), np.asarray(jgen[0]))
    assert_close(gen[1], jgen[1], MODULE_TOL)
    assert_close(gen[2], jgen[2], MODULE_TOL)
    assert bool((gen[1] <= 0).all())


def test_make_concept_learner_and_visual_planner():
    cfg = T.ConceptLearnerConfig()
    assert isinstance(T.make_concept_learner("v1", cfg, device="meta",
                                             seed=None), T.GatoConceptLearner)
    assert isinstance(T.make_concept_learner("v2", cfg, device="meta",
                                             seed=None),
                      T.SingleImageConceptLearner)
    with pytest.raises(NotImplementedError):
        T.make_concept_learner("v3", cfg)
    vcp = T.VisualConceptPlanner(planner_state=1, learner_state=2)
    assert (vcp.planner_state, vcp.learner_state) == (1, 2)


def test_from_flax_variables_refuses_a_foreign_tree(cl_inputs):
    args = (cl_inputs["text"], cl_inputs["images"][:, 0])
    jm = J.SingleImageConceptLearner(J.ConceptLearnerConfig())
    v = _np(jm.init(_rngs(), *args))
    v["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    tm = T.SingleImageConceptLearner(T.ConceptLearnerConfig(), device="cpu",
                                     seed=None)
    with pytest.raises(KeyError, match="extra"):
        convert.from_flax_variables(v, tm)
