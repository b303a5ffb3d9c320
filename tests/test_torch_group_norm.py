"""The image tower's GroupNorm -> GELU step (``ops/group_norm.py``,
``csrc/group_norm_gelu.cu``) and the embedder's route to it.

On the CPU: the route (CPU tensors take the plain chain; any other
device the kernels, through the custom op outside autograd and through
``GroupNormGelu`` where autograd records, with the statistics scope given
by the patches an element), the route counters, gradients through
``PatchGroupNorm`` as before, the plain version against the chain it
replaces, ``GroupNormGelu``'s backward against autograd through the plain
chain (float64, and float32 with the kernels' forward stood in for), the
wrapper's refusals, the custom op's shape function.  The embedder against
the JAX package is ``tests/test_torch_image.py``.

On the card (marked ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_group_norm.py``): the kernels against the plain chain at
the main path's shapes in both layouts, dtypes and scopes.  Only the order
of the statistics' sums differs, so the mean is held within 1e-5 of the
group's RMS (a mean near zero has no relative scale of its own) and the
variance within 1e-5 relative; the plain chain's elementwise steps on the
kernels' statistics give y bit for bit; in bfloat16 each normalised value
is within one ulp of the plain chain's (within 2^-18 below 2^-10, where
float32 statistics that differ in their last bits move z by more than a
bfloat16 ulp), in float32 y within 1e-5.  Two calls, and a captured graph
of the tower, give the same bits.  The training route's gradients at the
main training shape are no further from a float64 evaluation of the plain
chain than twice the plain chain's own autograd gradients are."""

import pytest
import torch
import torch.nn.functional as F

from multi_modal_transformers_tokenmerge_torch.core.config import (
    ResNetEmbedderConfig,
)
from multi_modal_transformers_tokenmerge_torch.core.hw import on_cuda
from multi_modal_transformers_tokenmerge_torch.modules import (
    image_tokenizer as it,
)
from multi_modal_transformers_tokenmerge_torch.ops import group_norm as gn
from multi_modal_transformers_tokenmerge_torch.utils.profiling import (
    REGISTRY,
)


def _embedder(scope, seed=0):
    """A float32 embedder of 8 features in 4 groups on 16-px patches, its
    norms away from their identity start."""
    cfg = ResNetEmbedderConfig(features=8, group_norm_groups=4,
                               output_features=16, input_kernel=(4, 4),
                               input_stride=(2, 2), norm_stats_scope=scope)
    emb = it.ResNetV2Embedder(cfg, 16, 3)
    g = torch.Generator().manual_seed(seed)
    for m in emb.modules():
        if m is not emb and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    with torch.no_grad():
        for i in range(cfg.num_blocks):
            norm = getattr(emb, f"block{i}_norm")
            norm.weight.copy_(torch.rand(8, generator=g) + 0.5)
            norm.bias.copy_(torch.randn(8, generator=g) * 0.1)
    return emb


def _plain_chain(norm, x, ppe):
    return F.gelu(norm(x, ppe), approximate="tanh")


@pytest.fixture
def counters():
    saved = REGISTRY.counters.copy()
    REGISTRY.counters.clear()
    yield REGISTRY.counters
    REGISTRY.counters.clear()
    REGISTRY.counters.update(saved)


# -- CPU -------------------------------------------------------------------

@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("scope", ["image", "patch"])
def test_cpu_tensors_take_the_plain_chain(scope, grad, counters):
    """On the CPU every block's norm runs the plain chain, with or without
    autograd: the output equals the chain written out, no kernel call."""
    emb = _embedder(scope)
    x = torch.randn(2, 6, 16, 16, 3, generator=torch.Generator()
                    .manual_seed(1))
    launches = gn.group_norm_gelu.launches
    with torch.set_grad_enabled(grad):
        out = emb(x)
    assert counters["image.norm_plain"] == 2
    assert counters["image.norm_kernel"] == 0
    assert gn.group_norm_gelu.launches == launches
    # the chain as the embedder ran it before the route
    c = emb.cfg
    with torch.no_grad():
        y = x.reshape(12, 16, 16, 3).permute(0, 3, 1, 2)
        y = it.max_pool_nchw(emb.input_conv(y), c.pool_window, c.pool_stride,
                             vjp="xla")
        r = y
        for i in range(c.num_blocks):
            y = _plain_chain(getattr(emb, f"block{i}_norm"), y, 6)
            y = getattr(emb, f"block{i}_conv")(y)
        want = emb.output_dense((y + r).reshape(12, -1)).reshape(2, 6, -1)
    assert torch.equal(out.detach(), want)


class _Recorder:
    """Stands in for the kernels' custom op, or for ``GroupNormGelu``
    (``apply``), on a device the CPU tests cannot launch on: records the
    call and returns a fresh tensor."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, weight, bias, num_groups, eps, ppe, dtype):
        self.calls.append((tuple(x.shape), num_groups, eps, ppe, dtype))
        return torch.empty_like(x, dtype=dtype)

    apply = __call__


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference", "frozen"])
@pytest.mark.parametrize("scope", ["image", "patch"])
def test_route_off_the_cpu(scope, mode, monkeypatch, counters):
    """Off the CPU (meta tensors here) the route is always the kernels:
    through ``GroupNormGelu`` where autograd records the call (grad mode on
    with x or a parameter that requires grad), else through the custom op.
    Either gets the scope as patches an element."""
    op, fn = _Recorder(), _Recorder()
    monkeypatch.setattr(it, "group_norm_gelu_op", op)
    monkeypatch.setattr(it, "GroupNormGelu", fn)
    norm = it.PatchGroupNorm(8, 4, 1e-6, scope, device="meta")
    x = torch.empty(12, 8, 5, 5, device="meta")
    if mode == "frozen":
        norm.requires_grad_(False)
    ctx = {"grad": torch.enable_grad(), "no_grad": torch.no_grad(),
           "inference": torch.inference_mode(),
           "frozen": torch.enable_grad()}[mode]
    with ctx:
        y = norm.forward_gelu(x, 6)
    assert tuple(y.shape) == (12, 8, 5, 5)
    want_ppe = 6 if scope == "image" else 1
    call = [((12, 8, 5, 5), 4, 1e-6, want_ppe, torch.float32)]
    assert (fn.calls, op.calls) == ((call, []) if mode == "grad"
                                    else ([], call))
    assert counters["image.norm_kernel"] == 1
    assert counters["image.norm_plain"] == 0


def test_frozen_norm_with_an_input_that_requires_grad_is_plain(counters):
    """On the CPU, x requiring grad alone makes autograd record through the
    plain chain: y requires grad, and the route counts a plain call."""
    norm = it.PatchGroupNorm(8, 4, 1e-6, "image")
    norm.reset_parameters(None)
    norm.requires_grad_(False)
    x = torch.randn(12, 8, 5, 5, requires_grad=True)
    y = norm.forward_gelu(x, 6)
    assert y.requires_grad
    assert counters["image.norm_plain"] == 1
    assert counters["image.norm_kernel"] == 0
    y.sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0


def test_frozen_norm_off_the_cpu_takes_the_training_route(monkeypatch,
                                                          counters):
    """Off the CPU, x requiring grad alone sends the call through
    ``GroupNormGelu``, not the custom op."""
    op, fn = _Recorder(), _Recorder()
    monkeypatch.setattr(it, "group_norm_gelu_op", op)
    monkeypatch.setattr(it, "GroupNormGelu", fn)
    norm = it.PatchGroupNorm(8, 4, 1e-6, "image", device="meta")
    norm.requires_grad_(False)
    x = torch.empty(12, 8, 5, 5, device="meta", requires_grad=True)
    norm.forward_gelu(x, 6)
    assert len(fn.calls) == 1 and op.calls == []
    assert counters["image.norm_kernel"] == 1


@pytest.mark.parametrize("scope", ["image", "patch"])
def test_gradients_flow_through_the_norm_as_before(scope):
    """Training through the embedder: the gradients of every parameter and
    of the input equal those of the plain chain written out, bit for bit."""
    emb = _embedder(scope, seed=3)
    x = torch.randn(2, 6, 16, 16, 3, generator=torch.Generator()
                    .manual_seed(4), requires_grad=True)
    w = torch.randn(2, 6, 16, generator=torch.Generator().manual_seed(5))
    (emb(x) * w).sum().backward()
    got = {n: p.grad.clone() for n, p in emb.named_parameters()}
    got_x = x.grad.clone()
    emb.zero_grad()
    x.grad = None
    c = emb.cfg
    y = x.reshape(12, 16, 16, 3).permute(0, 3, 1, 2)
    y = it.max_pool_nchw(emb.input_conv(y), c.pool_window, c.pool_stride,
                         vjp="xla")
    r = y
    for i in range(c.num_blocks):
        y = _plain_chain(getattr(emb, f"block{i}_norm"), y, 6)
        y = getattr(emb, f"block{i}_conv")(y)
    out = emb.output_dense((y + r).reshape(12, -1)).reshape(2, 6, -1)
    (out * w).sum().backward()
    for n, p in emb.named_parameters():
        assert torch.equal(got[n], p.grad), n
        assert p.grad.abs().sum() > 0, n
    assert torch.equal(got_x, x.grad)


def _stats(x, groups, ppe):
    """The chain's (elements, groups, 2) mean and clamped variance, as
    ``group_norm_stats`` pools them, in float32 (float64 for float64 x)."""
    n, c, h, w = x.shape
    f = x.to(torch.promote_types(x.dtype, torch.float32))
    f = f.reshape(n // ppe, ppe, groups, c // groups, h, w)
    mu = f.mean((1, 3, 4, 5))
    var = ((f * f).mean((1, 3, 4, 5)) - mu * mu).clamp_min(0.0)
    return torch.stack([mu, var], -1)


def _chain_grads(x, weight, bias, gy, groups, ppe, dtype, acc):
    """Autograd's (dx, dweight, dbias) through the plain chain computed in
    ``acc``: ``group_norm_stats``, the affine, the cast to ``dtype``, the
    tanh GELU."""
    x = x.detach().requires_grad_(True)
    weight = weight.detach().requires_grad_(True)
    bias = bias.detach().requires_grad_(True)
    f = it.group_norm_stats(x.to(acc), groups, 1e-6, "image", ppe)
    f = f * weight.to(acc)[:, None, None] + bias.to(acc)[:, None, None]
    y = F.gelu(f.to(dtype), approximate="tanh")
    return torch.autograd.grad(y, (x, weight, bias), gy)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("ppe", [5, 1])
def test_backward_is_the_chains_gradient_in_float64(ppe, layout):
    """group_norm_gelu_backward in float64 equals autograd through the
    plain chain in float64 to rounding, a constant group (variance zero)
    and every layout included."""
    g = torch.Generator().manual_seed(13)
    x = torch.randn(10, 16, 7, 7, generator=g, dtype=torch.float64) + 0.3
    x[:ppe, :2] = 0.5                  # one element's group 0 is constant
    w = torch.rand(16, generator=g, dtype=torch.float64) + 0.5
    b = torch.randn(16, generator=g, dtype=torch.float64)
    gy = torch.randn(10, 16, 7, 7, generator=g, dtype=torch.float64)
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    stats = _stats(x, 8, ppe)
    assert (stats[0, 0] == torch.tensor([0.5, 0.0],
                                        dtype=torch.float64)).all()
    got = gn.group_norm_gelu_backward(gy, x, w, b, stats, 8, 1e-6, ppe,
                                      torch.float64)
    want = _chain_grads(x, w, b, gy, 8, ppe, torch.float64, torch.float64)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and a.shape == e.shape
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-12)


def _cpu_launch(x, weight, bias, num_groups, eps, ppe, dtype,
                with_stats=False):
    """The kernels' outputs computed on the CPU by the plain version."""
    y = gn.group_norm_gelu_reference(x, weight, bias, num_groups, eps, ppe,
                                     dtype)
    return y, _stats(x, num_groups, ppe) if with_stats else None


@pytest.mark.parametrize("scope,ppe", [("image", 5), ("patch", 1)])
def test_group_norm_gelu_function_trains_like_the_chain(scope, ppe,
                                                        monkeypatch):
    """GroupNormGelu, its forward stood in for on the CPU, gives the chain's
    output and, in float32, its gradients within 1e-6 of their norms: the
    backward differs from autograd's only in the order of its sums."""
    monkeypatch.setattr(gn, "_launch", _cpu_launch)
    norm = it.PatchGroupNorm(16, 8, 1e-6, scope)
    g = torch.Generator().manual_seed(17)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(16, generator=g) + 0.5)
        norm.bias.copy_(torch.randn(16, generator=g))
    x = (torch.randn(10, 16, 7, 7, generator=g) * 2 + 0.4
         ).to(memory_format=torch.channels_last).requires_grad_(True)
    gy = torch.randn(10, 16, 7, 7, generator=g)
    y = gn.GroupNormGelu.apply(x, norm.weight, norm.bias, 8, 1e-6, ppe,
                               torch.float32)
    want = _plain_chain(norm, x, ppe)
    assert torch.equal(y, want)
    got = torch.autograd.grad(y, (x, norm.weight, norm.bias), gy)
    plain = torch.autograd.grad(want, (x, norm.weight, norm.bias), gy)
    for a, e in zip(got, plain):
        assert _rel(a, e) < 1e-6


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scope,ppe", [("image", 5), ("patch", 1)])
def test_plain_version_is_the_chain(scope, ppe, dtype, layout):
    """group_norm_gelu (CPU: the plain version) equals PatchGroupNorm then
    the tanh GELU bit for bit, in either layout."""
    norm = it.PatchGroupNorm(16, 8, 1e-6, scope, dtype=dtype)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(16, generator=g) + 0.5)
        norm.bias.copy_(torch.randn(16, generator=g))
    x = (torch.randn(10, 16, 7, 7, generator=g) + 0.4).to(dtype)
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    with torch.no_grad():
        want = _plain_chain(norm, x, 5)
        y = gn.group_norm_gelu(x, norm.weight, norm.bias, 8, 1e-6, ppe,
                               dtype)
    assert y.dtype == dtype
    assert torch.equal(y, want)


@pytest.mark.parametrize("shape,groups,ppe,match", [
    ((10, 12, 5, 5), 5, 5, "not divisible into 5 groups"),
    ((10, 12, 5, 5), 0, 5, "not divisible into 0 groups"),
    ((10, 12, 5, 5), 4, 3, "not divisible into elements of 3"),
    ((10, 12, 5, 5), 4, 0, "not divisible into elements of 0"),
    ((10, 12, 25), 4, 5, r"must be \(N, C, H, W\)"),
])
def test_wrapper_rejects(shape, groups, ppe, match):
    """Channels that do not split into the groups, a batch that does not
    split into elements of ``patches_per_element``, a map that is not 4-D:
    refused before any device path, by the wrapper and the op's shape
    function alike."""
    x = torch.zeros(shape)
    w, b = torch.ones(shape[1]), torch.zeros(shape[1])
    with pytest.raises(ValueError, match=match):
        gn.group_norm_gelu(x, w, b, groups, 1e-6, ppe, torch.float32)
    with pytest.raises(ValueError, match=match):
        gn.group_norm_gelu_op(x, w, b, groups, 1e-6, ppe, torch.float32)


def test_wrapper_rejects_misshapen_affine():
    x = torch.zeros(10, 12, 5, 5)
    with pytest.raises(ValueError, match=r"must be \(12,\)"):
        gn.group_norm_gelu(x, torch.ones(6), torch.zeros(12), 4, 1e-6, 5,
                           torch.float32)


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_op_shape_function_matches_the_kernels_output(layout, dtype):
    """The op's shape function gives y as the wrapper allocates it on the
    card: x's shape and dtype, channels_last where x is (and not also
    contiguous), NCHW otherwise."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    x = torch.randn(4, 8, 6, 6).to(dtype)
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    elif layout == "strided":
        x = torch.randn(4, 8, 6, 12).to(dtype)[..., ::2]
    w, b = torch.ones(8), torch.zeros(8)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = gn.group_norm_gelu_op(mode.from_tensor(x), w, b, 4, 1e-6, 2,
                                     dtype)
    want = torch.empty_like(x, memory_format=(
        torch.channels_last if layout == "channels_last"
        else torch.contiguous_format))
    assert fake.shape == want.shape and fake.dtype == dtype
    assert fake.stride() == want.stride()


# -- card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available() or not on_cuda(
            torch.empty(0, device="cuda")):
        pytest.skip("needs an sm_90 CUDA card")
    return torch.device("cuda")


# the main path's maps: chunk28 at B=1 and B=64 (50 patches a robot),
# octo_deep at B=8 (200)
CARD_SHAPES = [((50, 64, 21, 21), 50), ((3200, 64, 21, 21), 50),
               ((1600, 64, 7, 7), 200)]


def _map(card, shape, dtype, layout, seed):
    """A map shaped like the tower's: per-channel offsets and scales (the
    max pool's output sits above zero), the mean of the order of the
    standard deviation."""
    g = torch.Generator(device=card).manual_seed(seed)
    c = shape[1]
    off = torch.rand(c, generator=g, device=card)[:, None, None] * 0.8
    scale = torch.rand(c, generator=g, device=card)[:, None, None] + 0.5
    x = (torch.randn(shape, generator=g, device=card) * scale + off).to(dtype)
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    return x


def _norm(card, c, scope, dtype, seed):
    norm = it.PatchGroupNorm(c, 32, 1e-6, scope, dtype=dtype, device=card)
    g = torch.Generator(device=card).manual_seed(seed)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(c, generator=g, device=card) + 0.5)
        norm.bias.copy_(torch.randn(c, generator=g, device=card) * 0.2)
    return norm


def _ulp_bf16(v):
    """One bfloat16 ulp at |v| (normal range)."""
    e = torch.floor(torch.log2(v.abs().float().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("scope", ["image", "patch"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("shape,ppe", CARD_SHAPES)
def test_kernels_match_the_plain_chain(card, shape, ppe, layout, dtype,
                                       scope):
    x = _map(card, shape, dtype, layout, seed=shape[0] + ppe)
    norm = _norm(card, shape[1], scope, dtype, seed=ppe)
    eff = ppe if scope == "image" else 1
    launches = gn.group_norm_gelu.launches
    with torch.inference_mode():
        y, stats = gn._launch(x, norm.weight, norm.bias, 32, 1e-6, eff,
                              dtype, with_stats=True)
        want = _plain_chain(norm, x, ppe)
        ref_stats = _stats(x, 32, eff)
        torch.cuda.synchronize()
    assert gn.group_norm_gelu.launches == launches + 1
    assert y.shape == x.shape and y.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last) == (
        layout == "channels_last")
    mu, var = stats.unbind(-1)
    rmu, rvar = ref_stats.unbind(-1)
    rms = (rvar + rmu * rmu).sqrt()
    assert ((mu - rmu).abs() <= 1e-5 * rms).all(), \
        float(((mu - rmu).abs() / rms).max())
    assert ((var - rvar).abs() <= 1e-5 * rvar).all(), \
        float(((var - rvar).abs() / rvar).max())
    # the plain chain's elementwise steps on the kernel's statistics give y
    # bit for bit: only the statistics' sums differ
    cpg = shape[1] // 32
    per_channel = lambda t: t.repeat_interleave(cpg, 1).repeat_interleave(
        eff, 0)[:, :, None, None]
    with torch.inference_mode():
        rstd = torch.rsqrt(per_channel(var) + 1e-6)
        z = ((x.float() - per_channel(mu)) * rstd
             * norm.weight[:, None, None] + norm.bias[:, None, None])
        z = z.to(dtype)
        assert torch.equal(y, F.gelu(z, approximate="tanh"))
        z_plain = norm(x, ppe)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        return
    # bfloat16: each normalised value within one ulp of the plain chain's;
    # below 2^-10, where the float32 statistics' own rounding (some 1e-7 of
    # the map's scale) passes a bfloat16 ulp of z, within 2^-18
    tol = _ulp_bf16(torch.maximum(z.abs(), z_plain.abs()))
    tol = tol.clamp_min(2.0 ** -18)
    dz = (z.float() - z_plain.float()).abs()
    assert (dz <= tol).all(), float((dz / tol).max())
    print(f"{shape} {layout} {scope}: {float((y != want).float().mean()):.2e}"
          f" of y, {float((z != z_plain).float().mean()):.2e} of z differ")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_kernels_are_bit_for_bit_from_call_to_call(card, layout):
    x = _map(card, (3200, 64, 21, 21), torch.bfloat16, layout, seed=9)
    norm = _norm(card, 64, "image", torch.bfloat16, seed=9)
    with torch.inference_mode():
        a = gn._launch(x, norm.weight, norm.bias, 32, 1e-6, 50,
                       torch.bfloat16, with_stats=True)
        b = gn._launch(x, norm.weight, norm.bias, 32, 1e-6, 50,
                       torch.bfloat16, with_stats=True)
        # the serving route, which asks for no statistics, writes the same y
        c = gn._launch(x, norm.weight, norm.bias, 32, 1e-6, 50,
                       torch.bfloat16)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert c[1] is None and torch.equal(c[0], a[0])


@pytest.mark.cuda
def test_main_path_plan(card):
    """At chunk28 B=64 the kernels read 16-byte vectors of channels_last
    bfloat16, 256 threads a block, about eight blocks an SM."""
    plan = gn.library_plan((3200, 64, 21, 21), 32, 50, True, torch.bfloat16)
    assert plan == dict(vec=8, threads=256, rows=50 * 441,
                        rows_per_chunk=1298, chunks=17)
    assert gn.library_plan((50, 64, 21, 21), 32, 50, True,
                           torch.bfloat16)["chunks"] == 64
    assert gn.library_plan((3200, 64, 21, 21), 32, 1, True,
                           torch.bfloat16)["chunks"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("scope", ["image", "patch"])
def test_captured_tower_replays_bit_for_bit(card, scope, counters):
    """The embedder at octo_base's widths (64 features, 32 groups, 56-px
    patches), bf16, 2 robots of 50 patches, captured in a CUDA graph under
    inference mode: every norm took the kernels at capture, and replays
    equal the eager call and each other bit for bit."""
    emb = it.ResNetV2Embedder(ResNetEmbedderConfig(norm_stats_scope=scope),
                              56, 3, dtype=torch.bfloat16, device=card)
    g = torch.Generator(device=card).manual_seed(11)
    for m in emb.modules():
        if m is not emb and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    x = torch.rand(2, 50, 56, 56, 3, generator=g, device=card) * 2 - 1
    static = x.to(torch.bfloat16)
    launches = gn.group_norm_gelu.launches
    with torch.inference_mode():
        eager = emb(static)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            emb(static)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = emb(static)
        graph.replay()
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
    assert counters["image.norm_kernel"] == 3 * 2
    assert counters["image.norm_plain"] == 0
    assert gn.group_norm_gelu.launches == launches + 3 * 2
    assert torch.equal(first, out)
    assert torch.equal(first, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("scope", ["image", "patch"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_training_route_gradients(card, dtype, scope, counters):
    """octo_base training's map (32 robots of 50 patches, channels_last):
    forward_gelu under autograd launches the kernels once and its output
    equals the inference route's bit for bit; its gradients (x, weight,
    bias) are no further from the plain chain evaluated in float64 than
    twice the plain chain's own autograd gradients, in relative norm."""
    shape, ppe = (1600, 64, 21, 21), 50
    x = _map(card, shape, dtype, "channels_last", seed=21)
    norm = _norm(card, 64, scope, dtype, seed=22)
    gy = torch.randn(shape, generator=torch.Generator(device=card)
                     .manual_seed(23), device=card).to(dtype)
    eff = ppe if scope == "image" else 1
    launches = gn.group_norm_gelu.launches
    xg = x.detach().requires_grad_(True)
    y = norm.forward_gelu(xg, ppe)
    assert gn.group_norm_gelu.launches == launches + 1
    assert counters["image.norm_kernel"] == 1
    assert not counters["image.norm_plain"]
    with torch.inference_mode():
        assert torch.equal(y.detach(), norm.forward_gelu(x, ppe))
    got = torch.autograd.grad(y, (xg, norm.weight, norm.bias), gy)
    plain = _chain_grads(x, norm.weight, norm.bias, gy, 32, eff, dtype,
                         torch.float32)
    truth = _chain_grads(x.double(), norm.weight.double(),
                         norm.bias.double(), gy.double(), 32, eff,
                         torch.float64, torch.float64)
    for name, a, p, t in zip(("x", "weight", "bias"), got, plain, truth):
        assert a.dtype == p.dtype and a.shape == p.shape
        err, err_plain = _rel(a, t), _rel(p, t)
        print(f"{dtype} {scope} d{name}: {err:.3e} (plain chain "
              f"{err_plain:.3e}, apart {_rel(a, p):.3e})")
        assert err <= 2 * err_plain + 1e-7, (name, err, err_plain)
