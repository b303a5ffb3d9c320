"""The sampler at every shape the Pallas sampler takes.

The plain version ``ddpm_sample_reference`` against the JAX package's
``fused_ddpm_sample`` in interpret mode, at shapes past each limit of the
register kernel (action dims above 16, widths it does not hold, 100
steps), in all three modes; and the rule that picks the register or the
wide kernel for a shape, checked on a faked card.  float32, tolerance
``MODULE_TOL`` (2e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_transformers_tokenmerge_torch.ops import ddpm_sampler as tds
from multi_modal_transformers_tokenmerge_tpu.ops import ddpm_sampler as jds
from torch_parity import MODULE_TOL, assert_close

MODES = ("ddpm", "ddim_raw", "ddim_recompute")


def _inputs(t, b, h, a, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(noisy=f(b, a), contexts=f(t, b, h), noise=f(t, b, a),
                coeffs=(np.abs(f(t, 4)) * 0.1 + 0.5).astype(np.float32),
                wn=f(a, h) * (1.0 / a) ** 0.5, bn=f(h) * 0.1,
                wo=f(h, a) * (1.0 / h) ** 0.5, bo=f(a) * 0.1)


def _jax(x, mode):
    ddim = mode != "ddpm"
    coeffs = x["coeffs"] if ddim else x["coeffs"][:, :3]
    return np.asarray(jds.fused_ddpm_sample(
        *(jnp.asarray(x[k]) for k in ("noisy", "contexts", "noise")),
        jnp.asarray(coeffs),
        *(jnp.asarray(x[k]) for k in ("wn", "bn", "wo", "bo")),
        clip_value=5.0, compute_dtype=jnp.float32, ddim_x0clip=ddim,
        ddim_eps_recompute=mode == "ddim_recompute", interpret=True))


def _port(x, mode):
    ddim = mode != "ddpm"
    T = torch.from_numpy
    coeffs = x["coeffs"] if ddim else x["coeffs"][:, :3]
    return tds.ddpm_sampler(
        T(x["noisy"]), T(x["contexts"]), None if ddim else T(x["noise"]),
        T(coeffs), T(x["wn"].T.copy()), T(x["bn"]), T(x["wo"].T.copy()),
        T(x["bo"]), clip_value=5.0, ddim_x0clip=ddim,
        ddim_eps_recompute=mode == "ddim_recompute")


# (T, H, A): action dims past the register kernel's 16 (and its 8-lane
# padding), widths it does not tile, 100 steps
SHAPES = [(16, 64, 1), (16, 64, 17), (16, 64, 28), (16, 64, 112),
          (16, 40, 8), (16, 200, 8), (100, 32, 8)]


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("t,h,a", SHAPES)
def test_reference_matches_pallas_interpret(t, h, a, mode, batch):
    x = _inputs(t, batch, h, a, seed=t * 1000 + h + a + batch)
    before = tds.ddpm_sampler.launches
    out = _port(x, mode)
    assert tds.ddpm_sampler.launches == before   # CPU: the plain version
    assert tuple(out.shape) == (batch, a)
    assert_close(out, _jax(x, mode), MODULE_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_reference_matches_the_batch_blocked_pallas_call(monkeypatch, mode):
    """The Pallas call blocks the batch (2 rows a grid step, 5 rows padded
    to 6) and gives the unblocked call's result; the plain version matches
    both."""
    x = _inputs(6, 5, 32, 28, seed=3)
    whole = _jax(x, mode)
    monkeypatch.setattr(jds, "_CTX_BLOCK_BYTES", 6 * 32 * 4 * 2)
    blocked = _jax(x, mode)
    np.testing.assert_array_equal(blocked, whole)
    assert_close(_port(x, mode), whole, MODULE_TOL)


# -- which kernel a shape reaches ---------------------------------------------

# (T, B, H, A, dtype) -> the kernel
ROUTES = [
    ((32, 1, 768, 8, torch.bfloat16), "register"),      # octo_base
    ((32, 37, 768, 8, torch.float32), "register"),
    ((32, 8, 768, 16, torch.bfloat16), "register"),     # the widest A
    ((32, 8, 1536, 8, torch.bfloat16), "register"),     # the widest H
    ((32, 8, 768, 17, torch.bfloat16), "wide"),
    ((16, 8, 768, 1400, torch.bfloat16), "wide"),       # ACT's chunk
    ((32, 8, 1537, 8, torch.bfloat16), "wide"),
    ((32, 8, 1536, 9, torch.bfloat16), "wide"),
    ((100, 8, 768, 8, torch.float32), "wide"),          # 307 KB of contexts
    ((74, 8, 768, 8, torch.float32), "register"),       # 227 KB: still fits
    ((75, 8, 768, 8, torch.float32), "wide"),
    ((100, 64, 3072, 28, torch.bfloat16), "wide"),      # octo_base_chunk28
    ((10, 1, 3072, 28, torch.bfloat16), "wide"),
]


@pytest.mark.parametrize("shape,variant", ROUTES)
def test_variant_rule(shape, variant):
    assert tds.sampler_variant(*shape) == variant


class _Stub:
    """A kernel library that records its launches and launches nothing."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def ddpm_sampler_launch(self, *args):
        self.calls.append(("register", args))
        return 0

    def ddpm_sampler_wide_launch(self, *args):
        self.calls.append(("wide", args))
        return 0

    def ddpm_sampler_wide_plan(self, *args):
        return 0      # every field 0: no scratch


@pytest.fixture
def faked_card(monkeypatch):
    """The device gate passing (as on the card), each library a stub that
    records the launch, meta tensors for the operands."""
    calls, names = [], []

    def library(name):
        names.append(name)
        return _Stub(name, calls)

    monkeypatch.setattr(tds, "on_cuda", lambda *t: True)
    monkeypatch.setattr(tds, "_library", library)
    monkeypatch.setattr(tds, "_device_facts", lambda device: (None, 132))
    return calls, names


def _meta(t, b, h, a, dtype, ddim=False):
    m = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")
    return ((m(b, a), m(t, b, h, dt=dtype), None if ddim else m(t, b, a),
             m(t, 4 if ddim else 3), m(h, a), m(h), m(a, h), m(a)),
            dict(clip_value=5.0, ddim_x0clip=ddim))


@pytest.mark.parametrize("ddim", [False, True])
@pytest.mark.parametrize("shape,variant", ROUTES)
def test_each_shape_reaches_its_kernel(faked_card, shape, variant, ddim):
    calls, names = faked_card
    total = tds.ddpm_sampler.launches
    counts = {v: c.launches for v, c in tds.ddpm_sampler.by_variant.items()}
    args, kw = _meta(*shape, ddim=ddim)
    out = tds.ddpm_sampler(*args, **kw)
    assert tuple(out.shape) == (shape[1], shape[3])
    assert [c[0] for c in calls] == [variant]
    assert names == ["ddpm_sampler" if variant == "register" else
                     "ddpm_sampler_wide"]
    launch = calls[0][1]
    # steps, batch, hidden, adim follow the 9 (register) or 10 (wide)
    # pointers
    first = 9 if variant == "register" else 10
    assert launch[first:first + 4] == (shape[0], shape[1], shape[2],
                                       shape[3])
    assert tds.ddpm_sampler.launches == total + 1
    for v, c in tds.ddpm_sampler.by_variant.items():
        assert c.launches == counts[v] + (v == variant)


def test_forced_variant_reaches_that_kernel(faked_card):
    calls, _ = faked_card
    args, kw = _meta(32, 8, 768, 8, torch.bfloat16)
    tds.ddpm_sampler(*args, **kw, _variant="wide")
    assert [c[0] for c in calls] == ["wide"]
    with pytest.raises(ValueError, match="register kernel does not take"):
        tds.ddpm_sampler(*_meta(32, 8, 768, 28, torch.bfloat16)[0],
                         **kw, _variant="register")
    with pytest.raises(ValueError, match="unknown sampler variant"):
        tds.ddpm_sampler(*args, **kw, _variant="tiled")


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_bad_dtype_still_raises(faked_card, dtype):
    calls, _ = faked_card
    args, kw = _meta(32, 8, 768, 28, dtype)
    with pytest.raises(ValueError, match="unsupported compute dtype"):
        tds.ddpm_sampler(*args, **kw)
    assert calls == []


def test_what_jax_refuses_is_still_refused(faked_card):
    args, kw = _meta(32, 8, 768, 28, torch.bfloat16)
    with pytest.raises(ValueError, match="needs per-step noise"):
        tds.ddpm_sampler(args[0], args[1], None, *args[3:], **kw)
    with pytest.raises(ValueError, match="requires ddim_x0clip"):
        tds.ddpm_sampler(*args, clip_value=5.0, ddim_eps_recompute=True)
    bad = list(args)
    bad[4] = torch.empty(768, 27, device="meta")
    with pytest.raises(ValueError, match="wn: shape"):
        tds.ddpm_sampler(*bad, **kw)


# -- the wide kernel's plan, mirrored -----------------------------------------

def _chip_smoke_wide_shapes():
    """chip_smoke.py's WIDE_SHAPES, the (T, H, A) the card holds the wide
    kernel at (the module imports torch and numpy only)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.WIDE_SHAPES


WIDE_PLAN_CASES = [(t, b, h, a) for t, h, a in _chip_smoke_wide_shapes()
                   for b in (1, 8, 37, 64)]


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("t,b,h,a", WIDE_PLAN_CASES)
def test_wide_plan_cuts_every_shape(t, b, h, a, dtype, mode):
    """The mirror of the wide kernel's plan (phase 2 holds it against the
    kernel's own) at every shape the card holds the kernel at: a block's
    shared memory within the card's, every hidden unit owned by exactly one
    block, a cluster within the portable 8, a block's rows a power of two
    covering the batch, and each barrier phase awaiting exactly the bytes
    its C senders store (rows x A float32 sums each)."""
    elem = torch.empty((), dtype=dtype).element_size()
    p = tds.wide_sampler_plan(t, b, h, a, elem, mode, 132)
    assert p["smem_bytes"] <= 232448 and p["threads"] == 384
    assert 1 <= p["clusters"] <= 8 and p["units"] % 8 == 0
    assert p["units"] * (p["clusters"] - 1) < h <= p["units"] * p["clusters"]
    owner = np.repeat(np.arange(p["clusters"]), p["units"])[:h]
    assert np.array_equal(np.bincount(owner, minlength=p["clusters"]) > 0,
                          np.ones(p["clusters"], bool))
    assert p["rows"] in (1, 2, 4, 8) and p["groups"] * p["rows"] >= b
    assert (p["groups"] - 1) * p["rows"] < b
    assert p["blocks"] == p["clusters"] * p["grid_y"]
    sums_in_smem = bool(p["flags"] & 1)
    sent = p["clusters"] * p["rows"] * a * 4   # C senders' slots
    assert p["expect_bytes"] == (sent if sums_in_smem and p["clusters"] > 1
                                 else 0)
    assert p["expect_bytes"] < 2 ** 20          # an mbarrier's tx count
    if not sums_in_smem:
        assert p["scratch_floats"] >= p["blocks"] * 2 * p["clusters"] * \
            p["rows"] * a
    # the vector loads of both products stay inside their own rows: a
    # sample row and a lane's hidden-layer segment are whole 16-byte
    # vectors of the compute dtype's elements (4 or 8 floats), the segment
    # an odd count of 4-float vectors (distinct banks)
    vec = 16 // elem
    assert p["xs_rs"] % vec == 0 and a <= p["xs_rs"] < a + vec
    per_lane = -(-p["units"] // p["g2"])
    assert p["hs_seg"] % vec in (0, 4) and (p["hs_seg"] // 4) % 2 == 1
    assert p["hs_seg"] >= -(-per_lane // vec) * vec
    # one thread copies a ring stage in bulk where every row it copies
    # (H contexts, and in DDPM A noise floats) is a multiple of 16 bytes
    assert p["bulk"] == int(bool(p["flags"] & 16) and h * elem % 16 == 0
                            and (mode != 0 or a * 4 % 16 == 0))


def test_wide_plan_at_octo_base_chunk28():
    """octo_base_chunk28's sampler (bf16 DDPM, T=100, H=3072, A=28): 8
    blocks of 384 units, one pass of 384 threads each, every buffer in
    shared memory (the 4-stage ring included, its stages copied in bulk),
    one row a block at B=1 and 8 and four at B=64; the partial sums
    exchanged by st.async (896 bytes a phase at one row)."""
    for b, rows in ((1, 1), (8, 1), (64, 4)):
        p = tds.wide_sampler_plan(100, b, 3072, 28, 2, 0, 132)
        assert (p["clusters"], p["units"], p["rows"]) == (8, 384, rows)
        assert p["flags"] == 63 and p["expect_bytes"] == 8 * rows * 28 * 4
        assert p["bulk"] == 1
        assert p["g1"] == 1 and p["g2"] == 8


def test_wide_plan_keeps_the_sum_orders():
    """A row's sums run in an order set by (H, A, dtype) alone: the fields
    that fix it (the cluster's blocks, the units a block, the lanes of a
    sum in each product) are the same at every step count, batch and mode
    of a shape, so a row's result does not depend on its batch (phase 2
    holds that on the card).  At H = 3072 (A = 8, 28) the lanes still
    follow the 256-thread split (at most 256 / A lanes a second-product
    sum) although a block runs 384 threads."""
    orders = {}
    for t, b, h, a in WIDE_PLAN_CASES:
        for elem in (2, 4):
            for mode in (0, 1, 2):
                for batch in (b, 3, 129):
                    p = tds.wide_sampler_plan(t, batch, h, a, elem, mode, 132)
                    key = (p["clusters"], p["units"], p["g1"], p["g2"])
                    orders.setdefault((h, a, elem), set()).add(key)
    assert all(len(v) == 1 for v in orders.values()), orders
    assert orders[(3072, 28, 2)] == {(8, 384, 1, 8)}
    assert orders[(3072, 8, 2)] == {(8, 384, 1, 32)}
