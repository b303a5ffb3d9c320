"""The port's ToMe merging and top-k pruning ops against the JAX package's,
on the CPU in float32: the same numpy inputs through both, indices exact
(tie cases included), values to 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_transformers_tokenmerge_torch.ops import pruning as tprune
from multi_modal_transformers_tokenmerge_torch.ops import tome as ttome
from multi_modal_transformers_tokenmerge_tpu.ops import pruning as jprune
from multi_modal_transformers_tokenmerge_tpu.ops import tome as jtome

TOL = 2e-5


def _metric(kind, b, t, c, seed):
    """Random tokens.  'ties': every token is one of four signed, scaled
    axis vectors, so the normalized scores are exactly -1, 0 or 1 in any
    summation order and most of them tie; 'coarse' rounds to halves so
    that some do; 'equal' ties them all."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    if kind == "ties":
        axis = rng.integers(0, 2, (b, t))
        sign = rng.choice([-2.0, 2.0, 4.0], (b, t)).astype(np.float32)
        x = np.zeros((b, t, c), np.float32)
        np.put_along_axis(x, axis[..., None], sign[..., None], axis=-1)
    elif kind == "coarse":
        x = np.round(x * 2) / 2 + 0.25
    elif kind == "equal":
        x = np.ones_like(x)
    return x


def _same_plan(pt, pj):
    assert pt.r == pj.r and pt.distill == pj.distill
    for name in ("unm_idx", "src_idx", "dst_idx"):
        got = getattr(pt, name).numpy()
        want = np.asarray(getattr(pj, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("ordering", ["score", "stable"])
@pytest.mark.parametrize("kind,b,t,c,r", [
    ("random", 3, 9, 4, 2), ("random", 2, 10, 8, 3), ("random", 4, 50, 64, 12),
    ("random", 2, 100, 16, 32), ("random", 1, 7, 4, 3),
    ("ties", 2, 24, 8, 5), ("ties", 3, 50, 16, 12), ("ties", 2, 100, 8, 32),
    ("coarse", 2, 50, 2, 12), ("coarse", 3, 25, 3, 4),
    ("equal", 2, 16, 4, 5),
])
def test_matching_index_for_index(ordering, kind, b, t, c, r):
    x = _metric(kind, b, t, c, seed=t + r)
    pj = jtome.bipartite_soft_matching(jnp.asarray(x), r, ordering=ordering)
    pt = ttome.bipartite_soft_matching(torch.tensor(x), r, ordering=ordering)
    _same_plan(pt, pj)
    # every source index appears once between kept and merged
    both = torch.cat([pt.unm_idx, pt.src_idx], dim=1)[..., 0].sort(-1).values
    assert torch.equal(both, torch.arange((t + 1) // 2).expand(b, -1))


@pytest.mark.parametrize("ordering", ["score", "stable"])
@pytest.mark.parametrize("class_token,distill_token",
                         [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_matching_protected_tokens(ordering, class_token, distill_token,
                                   kind):
    x = _metric(kind, 2, 20, 8, seed=3)
    kw = dict(class_token=class_token, distill_token=distill_token,
              ordering=ordering)
    pj = jtome.bipartite_soft_matching(jnp.asarray(x), 4, **kw)
    pt = ttome.bipartite_soft_matching(torch.tensor(x), 4, **kw)
    _same_plan(pt, pj)
    if class_token:
        assert not (pt.src_idx == 0).any()
    if distill_token:
        assert not (pt.dst_idx == 0).any()
    out_j = jtome.apply_merge(pj, jnp.asarray(x))
    out_t = ttome.apply_merge(pt, torch.tensor(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=TOL,
                               atol=TOL)
    if class_token:
        # kept sources come in match order ('score': the class token, whose
        # score is -inf, last) or in their original order ('stable': first)
        at = 0 if ordering == "stable" else pt.unm_idx.shape[1] - 1 + int(
            distill_token)
        np.testing.assert_array_equal(out_t[:, at].numpy(), x[:, 0])
    if distill_token:
        np.testing.assert_array_equal(out_t[:, 1].numpy(), x[:, 1])


@pytest.mark.parametrize("mode", ["sum", "keep"])
@pytest.mark.parametrize("ordering", ["score", "stable"])
def test_apply_merge(mode, ordering):
    x = _metric("ties", 3, 30, 8, seed=5)
    feats = np.random.default_rng(6).normal(size=(3, 30, 5)).astype(
        np.float32)
    pj = jtome.bipartite_soft_matching(jnp.asarray(x), 7, ordering=ordering)
    pt = ttome.bipartite_soft_matching(torch.tensor(x), 7, ordering=ordering)
    out_j = jtome.apply_merge(pj, jnp.asarray(feats), mode=mode)
    out_t = ttome.apply_merge(pt, torch.tensor(feats), mode=mode)
    assert tuple(out_t.shape) == (3, 23, 5)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=TOL,
                               atol=TOL)
    if mode == "sum":   # a merge moves mass, it loses none
        np.testing.assert_allclose(out_t.sum(1).numpy(), feats.sum(1),
                                   rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="unknown merge mode"):
        ttome.apply_merge(pt, torch.tensor(feats), mode="mean")
    assert ttome.apply_merge(None, torch.tensor(feats)).shape == (3, 30, 5)


def test_merge_wavg_conserves_size():
    """Two successive merges: values and sizes agree with JAX, the sizes
    sum to the original token count, and a merge of equal tokens leaves
    them unchanged."""
    x = _metric("random", 2, 40, 16, seed=7)
    xj, sj = jnp.asarray(x), None
    xt, st = torch.tensor(x), None
    for r in (9, 6):
        pj = jtome.bipartite_soft_matching(xj, r, ordering="stable")
        pt = ttome.bipartite_soft_matching(xt, r, ordering="stable")
        _same_plan(pt, pj)
        xj, sj = jtome.merge_wavg(pj, xj, sj)
        xt, st = ttome.merge_wavg(pt, xt, st)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert tuple(xt.shape) == (2, 25, 16) and tuple(st.shape) == (2, 25, 1)
    assert torch.equal(st.sum(1), torch.full((2, 1), 40.0))
    same = torch.ones(1, 12, 4) * 3.0
    plan = ttome.bipartite_soft_matching(same, 4)
    merged, size = ttome.merge_wavg(plan, same)
    assert torch.equal(merged, torch.full((1, 8, 4), 3.0))
    assert size.sum() == 12
    # r == 0: no plan, nothing changes, sizes start at one
    assert ttome.bipartite_soft_matching(same, 0) is None
    out, size = ttome.merge_wavg(None, same)
    assert out is same and torch.equal(size, torch.ones(1, 12, 1))


def test_merge_is_differentiable_and_rounded_once():
    """The gradient flows through the merged values (not the plan), and in
    bfloat16 the merged sum is one float32 sum rounded once."""
    x = torch.tensor(_metric("random", 2, 12, 8, seed=8), requires_grad=True)
    plan = ttome.bipartite_soft_matching(x.detach(), 3)
    out, _ = ttome.merge_wavg(plan, x)
    out.sum().backward()
    assert torch.isfinite(x.grad).all() and (x.grad != 0).any()
    xb = x.detach().to(torch.bfloat16)
    got = ttome.apply_merge(plan, xb)
    n_dst = xb.shape[1] // 2
    src = torch.gather(xb[:, ::2], 1, plan.src_idx.expand(-1, -1, 8)).float()
    want = xb[:, 1::2].clone()
    for b in range(2):
        total = torch.zeros(n_dst, 8)
        total.index_add_(0, plan.dst_idx[b, :, 0], src[b])
        want[b] = want[b] + total.to(torch.bfloat16)
    assert torch.equal(got[:, -n_dst:], want)


@pytest.mark.parametrize("t,protected,r", [(10, 0, 6), (11, 1, 6), (8, 2, 4)])
def test_matching_raises_on_too_many(t, protected, r):
    x = _metric("random", 1, t, 4, seed=9)
    kw = dict(class_token=protected >= 1, distill_token=protected >= 2)
    with pytest.raises(ValueError, match="cannot merge"):
        jtome.bipartite_soft_matching(jnp.asarray(x), r, **kw)
    with pytest.raises(ValueError, match="cannot merge"):
        ttome.bipartite_soft_matching(torch.tensor(x), r, **kw)
    with pytest.raises(ValueError, match="unknown ordering"):
        ttome.bipartite_soft_matching(torch.tensor(x), 1, ordering="random")


SETS = ((0, 4), (4, 10), (14, 3), (17, 10), (27, 3))


@pytest.mark.parametrize("sort_kept", [True, False])
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("keep", [(4, 10, 3, 10, 3), (4, 6, 3, 6, 3),
                                  (2, 1, 3, 9, 0)])
def test_topk_tokens_per_set(sort_kept, kind, keep):
    rng = np.random.default_rng(10)
    imp = rng.normal(size=(3, 30)).astype(np.float32)
    if kind == "ties":
        imp = np.round(imp) + 0.0  # a handful of distinct values, no -0.0
    want = jprune.topk_tokens_per_set(jnp.asarray(imp), SETS, keep,
                                      sort_kept=sort_kept)
    got = tprune.topk_tokens_per_set(torch.tensor(imp), SETS, keep,
                                     sort_kept=sort_kept)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.normal(size=(3, 30, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tprune.prune_gather(torch.tensor(x), got).numpy(),
        np.asarray(jprune.prune_gather(jnp.asarray(x), want)))
    np.testing.assert_array_equal(
        tprune.prune_gather(torch.tensor(imp), got).numpy(),
        np.asarray(jprune.prune_gather(jnp.asarray(imp), want)))


def test_topk_raises_on_too_many():
    imp = torch.zeros(1, 30)
    with pytest.raises(ValueError, match="cannot keep"):
        tprune.topk_tokens_per_set(imp, SETS, (5, 10, 3, 10, 3))


# -- signed zeros: jax.lax.top_k ranks +0.0 above -0.0 ---------------------------

def test_top_k_order_ranks_signed_zeros_as_lax_top_k():
    import jax
    x = np.array([[0.0, -0.0, 0.0, -0.0, -1.0],
                  [-0.0, 2.0, 0.0, -0.0, -0.0]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 5)[1])
    np.testing.assert_array_equal(want[0], [0, 2, 1, 3, 4])
    np.testing.assert_array_equal(tprune.top_k_order(torch.tensor(x)).numpy(),
                                  want)


def _signed_zero_metric():
    """(1, 8, 2) tokens with signed zero components: sources (even
    positions) (1, 0), (-1, 0), (0, -1), (0, 1) against destinations (odd
    positions) all (-0, -1): products -0.0 and -0.0, +0.0 and -0.0, then
    1 and -1."""
    src = [[1.0, 0.0], [-1.0, 0.0], [0.0, -1.0], [0.0, 1.0]]
    x = np.zeros((1, 8, 2), np.float32)
    x[0, 0::2] = src
    x[0, 1::2] = [-0.0, -1.0]
    return x


@pytest.mark.parametrize("r", [1, 2, 3])
def test_stable_matching_ranks_signed_zeros_as_jax(r):
    """'stable' ordering takes top_k (``top_k_order``) on the sources' best
    scores.  Tokens with signed zero components: both frameworks sum a
    dot product from +0.0, so these scores are +0.0 and tie, and the lower
    index merges first in both."""
    x = _signed_zero_metric()
    pj = jtome.bipartite_soft_matching(jnp.asarray(x), r, ordering="stable")
    pt = ttome.bipartite_soft_matching(torch.tensor(x), r, ordering="stable")
    _same_plan(pt, pj)
    xt = torch.tensor(np.random.default_rng(3).normal(size=(1, 8, 3)),
                      dtype=torch.float32)
    np.testing.assert_allclose(
        ttome.merge_wavg(pt, xt)[0].numpy(),
        np.asarray(jtome.merge_wavg(pj, jnp.asarray(xt.numpy()))[0]),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sort_kept", [True, False])
def test_topk_tokens_per_set_ranks_signed_zeros_as_jax(sort_kept):
    imp = np.array([[-0.0, 0.0, -0.0, 0.0, -1.0, 2.0,
                     0.0, -0.0, -0.0, 0.0, 3.0, -0.0]], np.float32)
    sets, keep = ((0, 6), (6, 6)), (3, 2)
    want = jprune.topk_tokens_per_set(jnp.asarray(imp), sets, keep,
                                      sort_kept=sort_kept)
    got = tprune.topk_tokens_per_set(torch.tensor(imp), sets, keep,
                                     sort_kept=sort_kept)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if sort_kept:
        np.testing.assert_array_equal(got.numpy(), [[1, 3, 5, 6, 10]])


def test_compute_top_k_tokens_ranks_signed_zeros_as_jax():
    from multi_modal_transformers_tokenmerge_torch import compat as tcompat
    from multi_modal_transformers_tokenmerge_tpu import compat as jcompat
    scores = np.array([-0.0, 0.0, 1.0, -0.0, 0.0, -0.0, 0.0, -2.0],
                      np.float32)
    emb = np.random.default_rng(4).normal(size=(8, 3)).astype(np.float32)
    idx, k = ((0, 4), (4, 4)), (2, 3)
    want = jcompat.compute_top_k_tokens(jnp.asarray(emb), jnp.asarray(scores),
                                        idx, k)
    got = tcompat.compute_top_k_tokens(torch.tensor(emb),
                                       torch.tensor(scores), idx, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
