"""The port's ring attention against the JAX package's ``ring_attention``,
on the CPU: the plain inner block and the flash one (the kernels' plain
versions here, the JAX Pallas kernels in interpret mode), forward and
gradients, with dead rows, CP x DP, and the shapes it refuses.

In process the ring is a ``LocalRing`` of P shards (the counterpart of the
JAX tests' virtual devices); across processes it runs on 2 and 4 gloo
ranks, one launch each for the module (``torch_dist.launch``), each rank
holding its shard.  Tolerances are the JAX ring tests'
(``tests/test_ring_attention.py``): 2e-5 forward, 5e-4 / 1e-6 gradients
of mean(out^2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_dist import launch, results
from multi_modal_transformers_tokenmerge_torch.parallel import (
    ring_attention as tring)
from multi_modal_transformers_tokenmerge_torch.parallel.distributed import (
    LocalRing)
from multi_modal_transformers_tokenmerge_torch.sequence.layout import (
    SequenceLayout)
from multi_modal_transformers_tokenmerge_tpu.ops.flash_attention import (
    _xla_reference_attention as jfull)
from multi_modal_transformers_tokenmerge_tpu.parallel.ring_attention import (
    ring_attention as jring)

FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-6
B, S, H, D = 2, 64, 2, 8
SF = 512    # flash: shards of 256 (ring 2) and 128 (ring 4)


def _qkv(seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, H, D)).astype(np.float32)
                 for _ in range(3))


def _masks():
    octo = SequenceLayout.from_strings(
        "[TaskDescriptionPrefix{8}] [Image{10};Readout{4}]*4")
    dead = np.tril(np.ones((S, S), dtype=bool))
    dead[5] = False
    dead[S - 3] = False
    return {"dense": np.ones((S, S), dtype=bool),
            "causal": np.tril(np.ones((S, S), dtype=bool)),
            "octo": octo.attention_mask(), "dead": dead}


def _flash_masks():
    octo = SequenceLayout.from_strings(
        "[TaskDescriptionPrefix{32}] [Image{100};Readout{20}]*4")
    rng = np.random.default_rng(3)
    blocky = np.zeros((SF, SF), dtype=bool)
    edges = np.sort(rng.choice(np.arange(32, SF - 32), 5, replace=False))
    parts = np.split(np.arange(SF), edges)
    for i, rows in enumerate(parts):
        for j, cols in enumerate(parts):
            if j <= i and rng.random() < 0.7:
                blocky[np.ix_(rows, cols)] = True
    blocky[rng.choice(SF, 4, replace=False)] = False
    return {"causal": np.tril(np.ones((SF, SF), dtype=bool)),
            "octo": octo.attention_mask(), "dead": blocky}


def _jax(q, k, v, mask, ring, impl, grads=True, data=None):
    """JAX ring_attention's output and, with ``grads``, its gradients of
    mean(out^2); else the gradients of the JAX package's whole-sequence
    attention (the function the ring computes, dead rows zero), which
    compile in a fraction of the time."""
    n = ring * (data or 1)
    devs = np.asarray(jax.devices()[:n])
    mesh = (Mesh(devs.reshape(data, ring), ("data", "seq")) if data
            else Mesh(devs, ("seq",)))
    kw = dict(impl=impl, interpret=impl == "flash",
              batch_axis="data" if data else None)

    def run(q, k, v):
        return jring(q, k, v, mask, mesh, **kw)

    out = np.asarray(run(q, k, v))
    if not grads:
        m = jnp.asarray(mask)
        run = lambda q, k, v: jfull(q, k, v, m)
    g = jax.grad(lambda *a: jnp.mean(jnp.square(run(*a))),
                 argnums=(0, 1, 2))(q, k, v)
    return out, [np.asarray(x) for x in g]


# case -> (impl, ring, mask name, seed, gradients of the JAX ring (else of
# the whole-sequence attention), CP x DP data size)
CASES = {
    "xla_dense_2": ("xla", 2, "dense", 12, False, None),
    "xla_causal_4": ("xla", 4, "causal", 14, False, None),
    "xla_octo_2": ("xla", 2, "octo", 16, False, None),
    "xla_octo_4": ("xla", 4, "octo", 17, True, None),
    "xla_octo_8": ("xla", 8, "octo", 18, False, None),
    "xla_dead_4": ("xla", 4, "dead", 19, False, None),
    "flash_causal_2": ("flash", 2, "causal", 20, True, None),
    "flash_octo_4": ("flash", 4, "octo", 21, False, None),
    "flash_dead_4": ("flash", 4, "dead", 22, False, None),
    "cpdp_xla_4": ("xla", 2, "octo", 23, True, 2),
    "cpdp_flash_4": ("flash", 2, "causal", 24, False, 2),
}


@pytest.fixture(scope="module")
def refs():
    out = {}
    for name, (impl, p, m, seed, grads, data) in CASES.items():
        flash = impl == "flash"
        mask = (_flash_masks() if flash else _masks())[m]
        b = 4 if data else (1 if flash else B)
        q, k, v = _qkv(seed, b=b, s=SF if flash else S)
        o, g = _jax(q, k, v, mask, p, impl, grads, data)
        out[name] = dict(q=q, k=k, v=v, mask=mask, out=o, grads=g, ring=p,
                         impl=impl, data=data)
    return out


def _port_local(r):
    q, k, v = (torch.tensor(r[x], requires_grad=True) for x in "qkv")
    out = tring.ring_attention(q, k, v, r["mask"], r["ring"], impl=r["impl"])
    loss = out.square().mean()
    return out.detach(), torch.autograd.grad(loss, (q, k, v))


def _check(out, grads, r, rows=slice(None), cols=slice(None)):
    np.testing.assert_allclose(out.numpy(), r["out"][rows, cols],
                               rtol=FWD_TOL, atol=FWD_TOL)
    for g, want in zip(grads, r["grads"]):
        np.testing.assert_allclose(g.numpy(), want[rows, cols],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if not n.startswith("cpdp")))
def test_local_ring_matches_jax(refs, name):
    """The ring of P shards in one process."""
    r = refs[name]
    out, grads = _port_local(r)
    _check(out, grads, r)
    if "dead" in name:
        live = r["mask"].any(axis=1)
        assert np.all(out.numpy()[:, ~live] == 0.0)
        for g in grads:
            assert np.all(np.isfinite(g.numpy()))


@pytest.fixture(scope="module")
def group_runs(refs, tmp_path_factory):
    runs = {}
    for world in (2, 4):
        work = tmp_path_factory.mktemp(f"ring{world}")
        cases = {}
        for name, r in refs.items():
            w = r["ring"] * (r["data"] or 1)
            if w == world:
                cases[name] = dict(q=r["q"], k=r["k"], v=r["v"],
                                   mask=r["mask"], impl=r["impl"],
                                   world=world, cp_dp=bool(r["data"]))
        torch.save({"cases": cases}, work / "inputs.pt")
        runs[world] = launch("ring_checks", world, work)
    return runs


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if CASES[n][1] * (CASES[n][5] or 1)
                                        in (2, 4)))
def test_group_ring_matches_jax(refs, group_runs, name):
    """Each gloo rank's shard of the output and of dq, dk, dv."""
    r = refs[name]
    world = r["ring"] * (r["data"] or 1)
    s = r["q"].shape[1] // r["ring"]
    for rank, res in enumerate(results(group_runs[world], name)):
        if r["data"]:
            rows = slice(*res["rows"])
            cols = slice(res["seq_rank"] * s, (res["seq_rank"] + 1) * s)
        else:
            rows, cols = slice(None), slice(rank * s, (rank + 1) * s)
        _check(res["out"], res["grads"], r, rows, cols)


def test_group_ring_refuses_unaligned_shards(group_runs):
    for msg in results(group_runs[2], "unaligned"):
        assert msg is not None and "divisible" in msg


def test_ring_refuses_an_indivisible_sequence():
    q = torch.zeros(B, 63, H, D)
    with pytest.raises(ValueError, match="not divisible"):
        tring.ring_attention(q, q, q, np.ones((63, 63), dtype=bool), 4)


def test_flash_ring_refuses_unaligned_shards():
    q = torch.zeros(B, S, H, D)   # shards of 32 under 64 x 64 tiles
    with pytest.raises(ValueError, match="divisible"):
        tring.ring_attention(q, q, q, np.ones((S, S), dtype=bool), 2,
                             impl="flash")
    # 'auto' falls back to the plain block
    out = tring.ring_attention(q, q, q, np.ones((S, S), dtype=bool), 2,
                               impl="auto")
    assert out.shape == q.shape


def test_flash_ring_runs_float32_partials_per_step(refs, monkeypatch):
    """Every step of the flash ring asks the kernels for float32 outputs:
    P^2 forward steps, P^2 dq and P^2 dk/dv, whatever the input dtype."""
    calls = []
    for name in ("flash_fwd_lse", "flash_bwd"):
        real = getattr(tring, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("out_dtype")))
            return _real(*a, **kw)
        monkeypatch.setattr(tring, name, spy)
    r = refs["flash_octo_4"]
    q, k, v = (torch.tensor(r[x]).to(torch.bfloat16).requires_grad_(True)
               for x in "qkv")
    out = tring.ring_attention(q, k, v, r["mask"], 4, impl="flash")
    assert out.dtype == torch.bfloat16
    out.float().square().mean().backward()
    assert calls.count(("flash_fwd_lse", torch.float32)) == 16
    assert calls.count(("flash_bwd", torch.float32)) == 16
    assert q.grad.dtype == torch.bfloat16


def test_ring_tables_are_cached_per_mask_and_device(refs):
    r = refs["flash_octo_4"]
    a = tring.ring_tables(r["mask"], 4, 64, 64, "cpu")
    b = tring.ring_tables(r["mask"].copy(), 4, 64, 64, "cpu")
    assert a is b
    tiles, khi, qlo = a
    assert tiles.shape == (4, 4, 128, 128) and tiles.dtype == torch.int8
    assert khi.shape == (4, 4, 2) and qlo.shape == (4, 4, 2)
    # the octo layout is block-causal: a query shard sees no later shard
    assert int(khi[0, 3].max()) == 0


def test_local_ring_is_a_rotation():
    ring = LocalRing(3)
    assert ring.shift([("a",), ("b",), ("c",)]) == [("c",), ("a",), ("b",)]
    assert ring.shift([("a",), ("b",), ("c",)], direction=-1) == [
        ("b",), ("c",), ("a",)]
