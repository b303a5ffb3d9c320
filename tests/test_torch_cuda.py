"""Kernels of the torch port on the card: each against its plain version at
octo_base shapes.  Marked ``cuda``; they skip where there is no sm_90 card
and run on one with ``python -m pytest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from multi_modal_transformers_tokenmerge_torch.core.hw import on_cuda
from multi_modal_transformers_tokenmerge_torch.heads.diffusion import (
    DiffusionActionHead,
)
from multi_modal_transformers_tokenmerge_torch.core.config import (
    DiffusionHeadConfig,
)
from multi_modal_transformers_tokenmerge_torch.ops.ddpm_sampler import (
    ddpm_sample_reference, ddpm_sampler,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available() or not on_cuda(
            torch.empty(0, device="cuda")):
        pytest.skip("needs an sm_90 CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(card, batch, ddim_steps, eps_mode):
    """Sampler arguments and keywords at octo_base widths (H=768, A=8)."""
    head = DiffusionActionHead(DiffusionHeadConfig(ddim_eps_mode=eps_mode),
                               768, device=card)
    g = torch.Generator(device=card).manual_seed(batch)
    for m in head.modules():
        if m is not head and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    times, coeffs = head.schedule(ddim_steps)
    steps = times.shape[0]
    d = head.denoiser
    args = (torch.randn(batch, 8, generator=g, device=card),
            torch.randn(steps, batch, 768, generator=g, device=card),
            None if ddim_steps else torch.randn(steps, batch, 8, generator=g,
                                                device=card),
            coeffs, d.noisy_proj.weight, d.noisy_proj.bias,
            d.first_out.weight, d.first_out.bias)
    kw = dict(clip_value=5.0, ddim_x0clip=ddim_steps is not None,
              ddim_eps_recompute=ddim_steps is not None
              and eps_mode == "recompute")
    return args, kw


CASES = pytest.mark.parametrize("ddim_steps,eps_mode", [
    (None, "raw"), (8, "raw"), (8, "recompute")])


@pytest.mark.cuda
@CASES
@pytest.mark.parametrize("batch", [1, 8, 37])
def test_sampler_kernel_matches_plain_f32(card, batch, ddim_steps, eps_mode):
    """float32, tolerance 1e-4: the kernel sums its 768-wide products in
    another order than cuBLAS."""
    args, kw = _case(card, batch, ddim_steps, eps_mode)
    before = ddpm_sampler.launches
    out = ddpm_sampler(*args, **kw)
    torch.cuda.synchronize()
    assert ddpm_sampler.launches == before + 1
    torch.testing.assert_close(out, ddpm_sample_reference(*args, **kw),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@CASES
@pytest.mark.parametrize("batch", [1, 8, 37])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_sampler_kernel_matches_plain_low_precision(card, dtype, batch,
                                                    ddim_steps, eps_mode):
    """bfloat16 / float16 compute: |kernel - plain| <= 2 eps(dtype) *
    (1 + |plain|).  The two float32 sums may straddle a rounding boundary
    of the compute dtype and round one unit apart."""
    args, kw = _case(card, batch, ddim_steps, eps_mode)
    args = (args[0], args[1].to(dtype)) + args[2:]
    before = ddpm_sampler.launches
    out = ddpm_sampler(*args, **kw)
    torch.cuda.synchronize()
    assert ddpm_sampler.launches == before + 1
    ref = ddpm_sample_reference(*args, **kw)
    assert torch.isfinite(out).all()
    assert ((out - ref).abs()
            <= 2 * torch.finfo(dtype).eps * (1 + ref.abs())).all()


def _wide_case(card, steps, hidden, adim, batch, mode, seed=0):
    """Sampler arguments and keywords at (T, H, A): the coefficients of a
    T-step head (DDIM: 10 steps over them, as served), random weights
    scaled as a denoiser's."""
    head = DiffusionActionHead(DiffusionHeadConfig(
        diffusion_steps=steps, action_space_dim=adim, mlp_dim=hidden,
        ddim_eps_mode="recompute" if mode == "ddim_recompute" else "raw"),
        hidden, device=card)
    coeffs = head.schedule(None if mode == "ddpm" else min(10, steps))[1]
    t = coeffs.shape[0]
    g = torch.Generator(device=card).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    args = (r(batch, adim), r(t, batch, hidden),
            r(t, batch, adim) if mode == "ddpm" else None, coeffs,
            r(hidden, adim) * (2.0 / adim) ** 0.5, r(hidden) * 1e-2,
            r(adim, hidden) * (2.0 / hidden) ** 0.5, r(adim) * 1e-2)
    kw = dict(clip_value=5.0, ddim_x0clip=mode != "ddpm",
              ddim_eps_recompute=mode == "ddim_recompute")
    return args, kw


# (T, H, A): octo_base_chunk28's sampler, ACT's 1400-wide chunk, and
# octo_base's shape with the wide kernel forced
WIDE_SHAPES = pytest.mark.parametrize("steps,hidden,adim,forced", [
    (100, 3072, 28, None), (16, 768, 1400, None), (32, 768, 8, "wide")])
WIDE_MODES = pytest.mark.parametrize("mode", ["ddpm", "ddim_raw",
                                              "ddim_recompute"])


def _units(got, want, dtype):
    """max |got - want| in units of the gate: 1e-4 (1 + |want|) in
    float32, 2 eps(dtype) (1 + |want|) in bf16 / fp16."""
    tol = 1e-4 if dtype == torch.float32 else 2 * torch.finfo(dtype).eps
    return ((got - want).abs() / (tol * (1 + want.abs()))).max().item()


def _permuted_spread(args, kw, ref, dtype, orders=8):
    """How far the plain version moves, in gates, when its sums run in
    other orders: hidden units and actions permuted, the same function."""
    g = torch.Generator().manual_seed(0)
    noisy, ctx, noise, coeffs, wn, bn, wo, bo = args
    spread = 0.0
    for _ in range(orders):
        p = torch.randperm(wn.shape[0], generator=g).to(ctx.device)
        q = torch.randperm(wn.shape[1], generator=g).to(ctx.device)
        out = ddpm_sample_reference(
            noisy[:, q], ctx[:, :, p],
            None if noise is None else noise[:, :, q], coeffs, wn[p][:, q], bn[p], wo[q][:, p], bo[q], **kw)
        spread = max(spread, _units(out[:, torch.argsort(q)], ref, dtype))
    return spread


def _truth_rule(got, plain, truth, slack=0.05):
    """The kernel's error against ``truth`` over 3 x the plain version's +
    ``slack`` (<= 1 passes)."""
    return ((got.double() - truth).abs().max().item()
            / (3 * (plain.double() - truth).abs().max().item() + slack))


def _exact_step(state, args, t, kw):
    """Step t from ``state`` in float64, with no rounding to a compute
    dtype."""
    _, ctx, noise, coeffs, wn, bn, wo, bo = (
        None if a is None else a.double() for a in args)
    clip = kw["clip_value"]
    s = state.double()
    eps = torch.relu(s @ wn.T + bn + ctx[t]) @ wo.T + bo
    c = coeffs[t]
    if not kw["ddim_x0clip"]:
        nx = c[0] * (s - c[1] * eps) + c[2] * noise[t]
    else:
        x0 = torch.clamp(c[0] * s - c[1] * eps, -clip, clip)
        if kw["ddim_eps_recompute"]:
            eps = (c[0] * s - x0) / c[1]
        nx = c[2] * x0 + c[3] * eps
    return torch.clamp(nx, -clip, clip)


def _stepwise(args, kw, forced, dtype):
    """Each step of the wide kernel against one plain step from the
    kernel's own state (its loop cut after t + 1 steps against the plain
    step from its loop cut after t), by the truth rule: against the exact
    step with slack 1e-4 in float32, against the float32 plain step with
    slack 0.05 in bf16 / fp16."""
    noisy, ctx, noise, coeffs, wn, bn, wo, bo = args
    cut = lambda a, lo, hi: None if a is None else a[lo:hi]
    worst, state = 0.0, noisy
    for t in range(coeffs.shape[0]):
        ker = ddpm_sampler(noisy, ctx[:t + 1], cut(noise, 0, t + 1),
                           coeffs[:t + 1], wn, bn, wo, bo, **kw,
                           _variant=forced)
        step = lambda c: ddpm_sample_reference(
            state, c[t:t + 1], cut(noise, t, t + 1), coeffs[t:t + 1], wn,
            bn, wo, bo, **kw)
        plain = step(ctx)
        worst = max(worst, _truth_rule(
            ker, plain, _exact_step(state, args, t, kw), 1e-4)
            if dtype == torch.float32 else
            _truth_rule(ker, plain, step(ctx.float()).double()))
        state = ker
    return worst


@pytest.mark.cuda
@WIDE_SHAPES
@WIDE_MODES
@pytest.mark.parametrize("batch", [1, 8, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_wide_sampler_kernel_matches_plain(card, steps, hidden, adim,
                                           forced, mode, batch, dtype):
    """The wide kernel against the plain version at the register kernel's
    gates: float32 1e-4 (1 + |plain|); bf16 / fp16 2 eps (1 + |plain|) and
    its error against the float32 plain version within 3 x the plain
    version's + 0.05.  Where the whole loop misses the 1e-4 or 2 eps gate
    (the loop amplifies any sum order's rounding: a failure reports how far
    the plain version moves itself under permuted sums), every step must
    meet the truth rule from the kernel's own state: in float32 against
    the exact step with slack 1e-4."""
    args, kw = _wide_case(card, steps, hidden, adim, batch, mode)
    low = (args[0], args[1].to(dtype)) + args[2:]
    wide = ddpm_sampler.by_variant["wide"].launches
    out = ddpm_sampler(*low, **kw, _variant=forced)
    torch.cuda.synchronize()
    assert ddpm_sampler.by_variant["wide"].launches == wide + 1
    ref = ddpm_sample_reference(*low, **kw)
    assert torch.isfinite(out).all()
    if dtype != torch.float32:
        assert _truth_rule(out, ref,
                           ddpm_sample_reference(*args, **kw).double()) <= 1
    units = _units(out, ref, dtype)
    if units > 1:
        spread = _permuted_spread(low, kw, ref, dtype)
        stepwise = _stepwise(low, kw, forced, dtype)
        assert stepwise <= 1, (units, spread, stepwise)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_sampler_rows_do_not_depend_on_the_batch(card, dtype):
    """A row's result is the same bit for bit whether it is sampled alone,
    in a batch of 8 or of 37 (other blockings of the batch), and in a CUDA
    graph's replay."""
    args, kw = _wide_case(card, 100, 3072, 28, 37, "ddpm", seed=3)
    args = (args[0], args[1].to(dtype)) + args[2:]
    whole = ddpm_sampler(*args, **kw)
    for b in (1, 8):
        part = ddpm_sampler(args[0][:b], args[1][:, :b], args[2][:, :b],
                            *args[3:], **kw)
        torch.testing.assert_close(part, whole[:b], rtol=0, atol=0)
    static = ddpm_sampler(*args, **kw)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = ddpm_sampler(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(static, whole, rtol=0, atol=0)


# -- flash attention and max-pool backward ---------------------------------

FLASH_SHAPES = pytest.mark.parametrize("b,seq,h,d", [
    (4, 74, 3, 256),      # octo_base training (B cut from 32)
    (1, 1024, 12, 64),    # long context of bench.py:1056 (B cut from 8)
    (8, 224, 12, 64),     # octo_deep's stage 0, a ToMe mask (B cut from 32)
    (8, 224, 6, 128),     # octo_deep_h128's stage 0 (B cut from 32)
    (8, 224, 24, 32),     # head dim 32 at octo_deep's stage 0
    (4, 224, 16, 80),     # head dim 80, run zero-padded to 128
])
# the mask of each sequence length of FLASH_SHAPES: (layout strings, stage)
FLASH_MASKS = {
    74: (("[TaskDescriptionPrefix{16}] [Image{25};Readout{4}]*2",), 0),
    1024: (("[TaskDescriptionPrefix{16}] "
            "[Image{100};Image{100};Image{100};Image{100};Image{100};"
            "Readout{4}]*2",), 0),
    224: (("[TaskDescriptionPrefix{16}] [Image{100};Readout{4}]*2",
           "[TaskDescriptionPrefix{0}] [Image{32};Readout{0}]*2"), 0),
}


def _flash_case(card, b, seq, h, d, dtype):
    from multi_modal_transformers_tokenmerge_torch.ops import (
        flash_attention as fa)
    from multi_modal_transformers_tokenmerge_torch.sequence.layout import (
        SequenceLayout)
    strings, stage = FLASH_MASKS[seq]
    mask = SequenceLayout.from_strings(*strings).attention_mask(stage)
    assert mask.shape == (seq, seq)
    g = torch.Generator(device=card).manual_seed(seq + d)
    q, k, v, do = (torch.randn(b, seq, h, d, generator=g, device=card)
                   .to(dtype) for _ in range(4))
    bq, bk = fa.kernel_tiles(d)
    padded, k_hi, q_lo = fa.device_tables(mask, bq, bk, card)
    seed = torch.tensor([11, 22], dtype=torch.int64, device=card)
    return fa, (q, k, v, do), (padded, k_hi, q_lo), seed, (bq, bk)


def _assert_flash_close(got, want, dtype):
    """float32: 1e-4 (1 + |plain|); 16-bit: 2 eps (1 + |plain|)."""
    tol = 1e-4 if dtype == torch.float32 else 2 * torch.finfo(dtype).eps
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= tol * (1 + want.abs())).all(), \
        float((got - want).abs().max())


@pytest.mark.cuda
@FLASH_SHAPES
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_kernels_match_plain(card, b, seq, h, d, rate, dtype):
    fa, (q, k, v, do), (padded, k_hi, q_lo), seed, (bq, bk) = _flash_case(
        card, b, seq, h, d, dtype)
    kw = dict(block_q=bq, block_k=bk, dropout_rate=rate)
    s = seed if rate else None
    before = (fa.flash_fwd_lse.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, s, **kw)
    out_p, lse_p = fa.flash_fwd_lse_reference(q, k, v, padded, k_hi, s, **kw)
    _assert_flash_close(out, out_p, dtype)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    delta = fa.attention_delta(do, out_p, padded.shape[0])
    dq = fa.flash_dq(q, k, v, do, lse_p, delta, padded, k_hi, s, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_p, delta, padded, q_lo, s, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd_lse.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 1 for n in before)
    dq_p = fa.flash_dq_reference(q, k, v, do, lse_p, delta, padded, k_hi, s,
                                 **kw)
    dk_p, dv_p = fa.flash_dkv_reference(q, k, v, do, lse_p, delta, padded,
                                        q_lo, s, **kw)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        _assert_flash_close(got, want, dtype)


@pytest.mark.cuda
@FLASH_SHAPES
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_backward_reads_new_forward_lse(card, b, seq, h, d, dtype):
    """dq and dk/dv on the LSE of the tensor-core flash_fwd_lse, with
    dropout 0.1: its LSE and keep bits fit the backward's."""
    fa, (q, k, v, do), (padded, k_hi, q_lo), seed, (bq, bk) = _flash_case(
        card, b, seq, h, d, dtype)
    kw = dict(block_q=bq, block_k=bk, dropout_rate=0.1)
    out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, seed, **kw)
    delta = fa.attention_delta(do, out, padded.shape[0])
    dq = fa.flash_dq(q, k, v, do, lse, delta, padded, k_hi, seed, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, padded, q_lo, seed, **kw)
    torch.cuda.synchronize()
    dq_p = fa.flash_dq_reference(q, k, v, do, lse, delta, padded, k_hi, seed,
                                 **kw)
    dk_p, dv_p = fa.flash_dkv_reference(q, k, v, do, lse, delta, padded,
                                        q_lo, seed, **kw)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        _assert_flash_close(got, want, dtype)


@pytest.mark.cuda
@FLASH_SHAPES
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_float32_outputs_match_plain(card, b, seq, h, d, dtype):
    """out_dtype=float32 for 16-bit inputs (the ring-attention steps'
    partials): flash_fwd_lse, flash_dq and flash_dkv write float32 from
    their float32 accumulators, within 2 eps(dtype) (1 + |plain|) of the
    plain versions' float32 results, with bits below the input dtype's."""
    fa, (q, k, v, do), (padded, k_hi, q_lo), _, (bq, bk) = _flash_case(
        card, b, seq, h, d, dtype)
    kw = dict(block_q=bq, block_k=bk, out_dtype=torch.float32)
    out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, **kw)
    out_p, lse_p = fa.flash_fwd_lse_reference(q, k, v, padded, k_hi, **kw)
    assert out.dtype == out_p.dtype == torch.float32
    _assert_flash_close(out, out_p, dtype)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    delta = fa.attention_delta(do, out_p, padded.shape[0])
    grads = fa.flash_bwd(q, k, v, do, lse_p, delta, padded, k_hi, q_lo, **kw)
    torch.cuda.synchronize()
    dq_p = fa.flash_dq_reference(q, k, v, do, lse_p, delta, padded, k_hi,
                                 **kw)
    dk_p, dv_p = fa.flash_dkv_reference(q, k, v, do, lse_p, delta, padded,
                                        q_lo, **kw)
    for got, want in zip((out, *grads), (out_p, dq_p, dk_p, dv_p)):
        assert got.dtype == torch.float32
        _assert_flash_close(got, want, dtype)
        assert bool((got != got.to(dtype).float()).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_ring_matches_the_plain_ring(card, dtype):
    """A ring of 4 shards of 256 tokens (D=64) through the kernels against
    the plain ring: P^2 launches of each kernel, 16-bit tolerances as
    above (1e-4 in float32)."""
    from multi_modal_transformers_tokenmerge_torch.ops import (
        flash_attention as fa)
    from multi_modal_transformers_tokenmerge_torch.parallel.ring_attention \
        import ring_attention
    s = 1024
    mask = np.tril(np.ones((s, s), dtype=bool))
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(2, s, 4, 64, generator=g, device=card).to(dtype)
               .requires_grad_(True) for _ in range(3))
    before = (fa.flash_fwd_lse.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    out = ring_attention(q, k, v, mask, 4, impl="flash")
    grads = torch.autograd.grad(out.float().square().mean(), (q, k, v))
    torch.cuda.synchronize()
    assert (fa.flash_fwd_lse.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 16 for n in before)
    out_p = ring_attention(q, k, v, mask, 4, impl="xla")
    grads_p = torch.autograd.grad(out_p.float().square().mean(), (q, k, v))
    _assert_flash_close(out, out_p, dtype)
    for got, want in zip(grads, grads_p):
        _assert_flash_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_fwd_kernel_matches_plain(card, stage, b, dtype):
    """The forward without LSE at octo_deep's ToMe stages (224, 160, 96
    tokens, 12 heads of 64) at the serving and training batches, and its
    recompute backward."""
    from multi_modal_transformers_tokenmerge_torch.ops import (
        flash_attention as fa)
    from multi_modal_transformers_tokenmerge_torch.sequence.layout import (
        SequenceLayout)
    mask = SequenceLayout.from_strings(
        "[TaskDescriptionPrefix{16}] [Image{100};Readout{4}]*2",
        "[TaskDescriptionPrefix{0}] [Image{32};Readout{0}]*2"
    ).attention_mask(stage)
    s = mask.shape[0]
    g = torch.Generator(device=card).manual_seed(stage)
    q, k, v = (torch.randn(b, s, 12, 64, generator=g, device=card).to(dtype)
               for _ in range(3))
    padded, k_hi, _ = fa.device_tables(mask, 64, 64, card)
    before = fa.flash_fwd.launches
    out = fa.flash_fwd(q, k, v, padded, k_hi, block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    _assert_flash_close(out, fa.flash_fwd_reference(
        q, k, v, padded, k_hi, block_q=64, block_k=64), dtype)
    if dtype == torch.float32:
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fa.flash_attention(*leaves, mask, backward="xla").sum().backward()
        want = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fa.xla_reference_attention(*want, torch.as_tensor(
            mask, device=card)).sum().backward()
        for a, c in zip(leaves, want):
            torch.testing.assert_close(a.grad, c.grad, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_flash_forward_refuses_misaligned_operands(card):
    """The tensor-core forward copies 16-byte chunks: an operand that
    starts off a 16-byte boundary is refused, not read wrong."""
    fa, (q, k, v, _), (padded, k_hi, _), _, (bq, bk) = _flash_case(
        card, 1, 1024, 12, 64, torch.bfloat16)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
    q_off = shifted[1:].view(q.shape)
    q_off.copy_(q)
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_fwd(q_off, k, v, padded, k_hi, block_q=bq, block_k=bk)


def _dead_row_mask(s=224):
    """A random blocky mask with dead query rows, one run of them filling a
    whole 64-row tile, and a live diagonal elsewhere."""
    rng = np.random.default_rng(0)
    mask = rng.random((s, s)) < 0.3
    mask[np.arange(s), np.arange(s)] = True
    mask[[5, 200]] = False
    mask[64:128] = False
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["octo_base_deep_S74", "dead_rows_S224"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_fwd_kernel_matches_plain_other_masks(card, case, dtype):
    """octo_base_deep's first stage (74 tokens, 3 heads of 256) and a mask
    with dead rows, which must come out as zeros."""
    from multi_modal_transformers_tokenmerge_torch.ops import (
        flash_attention as fa)
    from multi_modal_transformers_tokenmerge_torch.sequence.layout import (
        SequenceLayout)
    if case == "dead_rows_S224":
        mask, b, h, d = _dead_row_mask(), 2, 12, 64
    else:
        mask = SequenceLayout.from_strings(
            "[TaskDescriptionPrefix{16}] [Image{25};Readout{4}]*2",
            "[TaskDescriptionPrefix{0}] [Image{4};Readout{0}]*2"
        ).attention_mask(0)
        b, h, d = 1, 3, 256
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(b, mask.shape[0], h, d, generator=g,
                           device=card).to(dtype) for _ in range(3))
    bq, bk = fa.KERNEL_TILES[d]
    padded, k_hi, _ = fa.device_tables(mask, bq, bk, card)
    out = fa.flash_fwd(q, k, v, padded, k_hi, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    _assert_flash_close(out, fa.flash_fwd_reference(
        q, k, v, padded, k_hi, block_q=bq, block_k=bk), dtype)
    dead = torch.as_tensor(~mask.any(axis=1), device=card)
    assert not out[:, dead].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_backward_dead_rows(card, rate, dtype):
    """dq and dk/dv on a mask with dead query rows (one run of them filling
    a whole 64-row tile): zero dq on the dead rows, which add nothing to dk
    or dv, and all three within the limits of their plain versions."""
    from multi_modal_transformers_tokenmerge_torch.ops import (
        flash_attention as fa)
    mask = _dead_row_mask()
    b, s, h, d = 2, mask.shape[0], 12, 64
    g = torch.Generator(device=card).manual_seed(6)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=card)
                   .to(dtype) for _ in range(4))
    bq, bk = fa.KERNEL_TILES[d]
    padded, k_hi, q_lo = fa.device_tables(mask, bq, bk, card)
    seed = torch.tensor([3, 4], dtype=torch.int64, device=card)
    kw = dict(block_q=bq, block_k=bk, dropout_rate=rate)
    sw = seed if rate else None
    out, lse = fa.flash_fwd_lse_reference(q, k, v, padded, k_hi, sw, **kw)
    delta = fa.attention_delta(do, out, padded.shape[0])
    dq = fa.flash_dq(q, k, v, do, lse, delta, padded, k_hi, sw, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, padded, q_lo, sw, **kw)
    torch.cuda.synchronize()
    dead = torch.as_tensor(~mask.any(axis=1), device=card)
    assert int(dead.sum()) == 66 and not dq[:, dead].any()
    _assert_flash_close(dq, fa.flash_dq_reference(
        q, k, v, do, lse, delta, padded, k_hi, sw, **kw), dtype)
    dk_p, dv_p = fa.flash_dkv_reference(q, k, v, do, lse, delta, padded,
                                        q_lo, sw, **kw)
    _assert_flash_close(dk, dk_p, dtype)
    _assert_flash_close(dv, dv_p, dtype)


@pytest.mark.cuda
def test_merge_is_deterministic_on_the_card(card):
    """Two runs of one merge on the card give the same bits (no atomics),
    and the plan equals the CPU's on exactly tied scores."""
    from multi_modal_transformers_tokenmerge_torch.ops import tome
    g = torch.Generator().manual_seed(0)
    axis = torch.randint(0, 4, (8, 100), generator=g)
    x = torch.nn.functional.one_hot(axis, 16).float() * 2.0
    feats = torch.randn(8, 100, 64, generator=g).to(torch.bfloat16)
    plan_cpu = tome.bipartite_soft_matching(x, 32, ordering="stable")
    plan = tome.bipartite_soft_matching(x.to(card), 32, ordering="stable")
    for a, c in zip(plan[:3], plan_cpu[:3]):
        assert torch.equal(a.cpu(), c)
    first, size = tome.merge_wavg(plan, feats.to(card))
    again, _ = tome.merge_wavg(plan, feats.to(card))
    assert torch.equal(first, again) and size.sum() == 8 * 100


@pytest.mark.cuda
def test_flash_auto_selects_kernel_from_flash_min_seq(card):
    from multi_modal_transformers_tokenmerge_torch.core.config import (
        TransformerConfig)
    from multi_modal_transformers_tokenmerge_torch.modules.attention import (
        select_attention_fn)
    cfg = TransformerConfig(attention_impl="auto")
    assert select_attention_fn(cfg, np.ones((74, 74), bool), 74,
                               card) is None
    assert select_attention_fn(cfg, np.ones((1024, 1024), bool), 1024, card)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_bwd_kernel_matches_plain_exactly(card, dtype, layout):
    """x (N, 64, 23, 23), g (N, 64, 21, 21) with many ties, contiguous or
    channels_last (the embedder's layout): the kernel routes and sums as
    the plain version does, bit for bit, and dx keeps x's layout."""
    from multi_modal_transformers_tokenmerge_torch.ops import pool
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    g = torch.Generator(device=card).manual_seed(0)
    x = (torch.randn(200, 64, 23, 23, generator=g, device=card) * 2).round()
    x = (x / 2).to(dtype)
    x[0, 0, 5, 5] = float("nan")
    gy = torch.randn(200, 64, 21, 21, generator=g, device=card).to(dtype)
    x, gy = (t.contiguous(memory_format=fmt) for t in (x, gy))
    before = pool.pool_bwd.launches
    dx = pool.pool_bwd(x, gy, (3, 3))
    torch.cuda.synchronize()
    assert pool.pool_bwd.launches == before + 1
    assert dx.is_contiguous(memory_format=fmt)
    assert torch.equal(dx, pool.pool_bwd_reference(x, gy, (3, 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [(9, 9), (3, 12), (16, 16)])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_pool_bwd_kernel_at_windows_above_8(card, window, layout):
    """Windows past 8 a side run on the kernel's second body: bit for bit
    with the plain version on tie-heavy bf16 data with a NaN window, dx in
    x's layout."""
    from multi_modal_transformers_tokenmerge_torch.ops import pool
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    g = torch.Generator(device=card).manual_seed(1)
    x = (torch.randn(64, 64, 23, 23, generator=g, device=card) * 2).round()
    x = (x / 2).to(torch.bfloat16)
    x[0, 0, 11, 11] = float("nan")
    oh, ow = 24 - window[0], 24 - window[1]
    gy = torch.randint(1, 17, (64, 64, oh, ow), generator=g,
                       device=card).to(torch.bfloat16)
    x, gy = (t.contiguous(memory_format=fmt) for t in (x, gy))
    before = pool.pool_bwd.launches
    dx = pool.pool_bwd(x, gy, window)
    torch.cuda.synchronize()
    assert pool.pool_bwd.launches == before + 1
    assert dx.is_contiguous(memory_format=fmt)
    assert torch.equal(dx, pool.pool_bwd_reference(x, gy, window))


# the wide kernels (csrc/flash_attention_wide.cu): octo_deep_h512's stage 0
# (B cut from 32), head dims 320, 768 and 300 (run padded to 320)
WIDE_FLASH_SHAPES = pytest.mark.parametrize("b,seq,h,d", [
    (4, 224, 3, 512),
    (2, 224, 8, 320),
    (2, 224, 1, 768),
    (2, 224, 8, 300),
])


@pytest.mark.cuda
@WIDE_FLASH_SHAPES
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_wide_flash_kernels_match_plain(card, b, seq, h, d, rate, dtype):
    """Above head dim 256 the wrappers launch the wide kernels (counted
    under their own names, no narrow launch), held against the wide plain
    versions, with dropout and a batch and head offset."""
    fa, (q, k, v, do), (padded, k_hi, q_lo), seed, (bq, bk) = _flash_case(
        card, b, seq, h, d, dtype)
    kw = dict(block_q=bq, block_k=bk, dropout_rate=rate, b0=2, h0=1,
              heads_total=h + 2)
    s = seed if rate else None
    names = ("flash_fwd_lse", "flash_dq", "flash_dkv")
    before = {n: (getattr(fa, n).launches, getattr(fa, n + "_wide").launches)
              for n in names}
    out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, s, **kw)
    out_p, lse_p = fa.flash_fwd_lse_wide_reference(q, k, v, padded, k_hi, s,
                                                   **kw)
    _assert_flash_close(out, out_p, dtype)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    delta = fa.attention_delta(do, out_p, padded.shape[0])
    dq = fa.flash_dq(q, k, v, do, lse_p, delta, padded, k_hi, s, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_p, delta, padded, q_lo, s, **kw)
    torch.cuda.synchronize()
    assert {n: (getattr(fa, n).launches, getattr(fa, n + "_wide").launches)
            for n in names} == {n: (a, w + 1)
                                for n, (a, w) in before.items()}
    dq_p = fa.flash_dq_wide_reference(q, k, v, do, lse_p, delta, padded,
                                      k_hi, s, **kw)
    dk_p, dv_p = fa.flash_dkv_wide_reference(q, k, v, do, lse_p, delta,
                                             padded, q_lo, s, **kw)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        _assert_flash_close(got, want, dtype)
    if rate == 0.0:
        plain = fa.flash_fwd(q, k, v, padded, k_hi, block_q=bq, block_k=bk)
        _assert_flash_close(plain, fa.flash_fwd_wide_reference(
            q, k, v, padded, k_hi, block_q=bq, block_k=bk), dtype)


@pytest.mark.cuda
@WIDE_FLASH_SHAPES
def test_wide_flash_float32_outputs_match_plain(card, b, seq, h, d):
    """The wide kernels' float32-output variants (the ring's partials) in
    bf16 against the plain versions, which skip the final cast too."""
    fa, (q, k, v, do), (padded, k_hi, q_lo), _, (bq, bk) = _flash_case(
        card, b, seq, h, d, torch.bfloat16)
    kw = dict(block_q=bq, block_k=bk, out_dtype=torch.float32)
    out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, **kw)
    out_p, lse_p = fa.flash_fwd_lse_wide_reference(q, k, v, padded, k_hi,
                                                   **kw)
    assert out.dtype == torch.float32
    _assert_flash_close(out, out_p, torch.bfloat16)
    delta = fa.attention_delta(do, out_p, padded.shape[0])
    got = (fa.flash_dq(q, k, v, do, lse_p, delta, padded, k_hi, **kw),
           *fa.flash_dkv(q, k, v, do, lse_p, delta, padded, q_lo, **kw))
    want = (fa.flash_dq_wide_reference(q, k, v, do, lse_p, delta, padded,
                                       k_hi, **kw),
            *fa.flash_dkv_wide_reference(q, k, v, do, lse_p, delta, padded,
                                         q_lo, **kw))
    for a, c in zip(got, want):
        assert a.dtype == torch.float32
        _assert_flash_close(a, c, torch.bfloat16)


@pytest.mark.cuda
@FLASH_SHAPES
@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_with_a_batch_offset_match_plain(card, b, seq, h, d,
                                                       out_f32, dtype):
    """``b0``: dropout 0.1 counted from global row b0, kernels against
    their plain versions with the same offset; ``b0=0`` is the call
    without it, bit for bit; another offset draws another mask."""
    if out_f32 and dtype == torch.float32:
        pytest.skip("the float32-output variants take 16-bit inputs")
    fa, (q, k, v, do), (padded, k_hi, q_lo), seed, (bq, bk) = _flash_case(
        card, b, seq, h, d, dtype)
    kw = dict(block_q=bq, block_k=bk, dropout_rate=0.1,
              out_dtype=torch.float32 if out_f32 else None)
    out0, lse0 = fa.flash_fwd_lse(q, k, v, padded, k_hi, seed, **kw)
    out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, seed, b0=0, **kw)
    assert torch.equal(out, out0) and torch.equal(lse, lse0)
    b0 = 5
    out, lse = fa.flash_fwd_lse(q, k, v, padded, k_hi, seed, b0=b0, **kw)
    out_p, lse_p = fa.flash_fwd_lse_reference(q, k, v, padded, k_hi, seed,
                                              b0=b0, **kw)
    _assert_flash_close(out, out_p, dtype)
    assert not torch.equal(out, out0)
    delta = fa.attention_delta(do, out_p, padded.shape[0])
    args = (q, k, v, do, lse_p, delta, padded)
    dq = fa.flash_dq(*args, k_hi, seed, b0=b0, **kw)
    dk, dv = fa.flash_dkv(*args, q_lo, seed, b0=b0, **kw)
    dq_p = fa.flash_dq_reference(*args, k_hi, seed, b0=b0, **kw)
    dk_p, dv_p = fa.flash_dkv_reference(*args, q_lo, seed, b0=b0, **kw)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        _assert_flash_close(got, want, dtype)
    assert torch.equal(fa.flash_dq(*args, k_hi, seed, **kw),
                       fa.flash_dq(*args, k_hi, seed, b0=0, **kw))


# -- CUDA graphs: the compiled train step and engine ------------------------------

def _bf16_train_config():
    """octo_base in bfloat16 with the flash kernels (dropout 0.1 in them)
    and the max-pool backward kernel: every training kernel in the step."""
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base)
    cfg = octo_base(dtype="bfloat16")
    return cfg.replace(
        transformer=cfg.transformer.replace(attention_impl="flash"),
        images=cfg.images.replace(resnet=cfg.images.resnet.replace(
            pool_vjp="pallas")))


def _train_state(cfg, model_seed=0, rng_seed=0):
    from multi_modal_transformers_tokenmerge_torch import (
        Octo, create_train_state, make_optimizer)
    model = Octo(cfg, device="cuda", seed=model_seed)
    tx = make_optimizer(peak_lr=3e-4, warmup_steps=2, total_steps=20,
                        params=model, frozen_prefixes=("text_encoder",),
                        skip_nonfinite_steps=2)
    return create_train_state(model, tx, rngs=rng_seed, ema_decay=0.99)


def _device_batches(cfg, batch, count, seed):
    from multi_modal_transformers_tokenmerge_torch.utils.data import (
        synthetic_octo_batches)
    it = synthetic_octo_batches(
        batch, image_shape=(cfg.num_observation_blocks,
                            *cfg.images.image_size),
        text_length=cfg.text.max_length,
        action_dim=cfg.heads.diffusion.action_space_dim,
        vocab_size=cfg.text.vocab_size, seed=seed)
    return [tuple(torch.as_tensor(a).cuda() for a in next(it))
            for _ in range(count)]


def _assert_same_state(a, b):
    assert a.step == b.step
    for n, p in a.params.items():
        assert torch.equal(p, b.params[n]), n
    for x, y in zip((*a.optimizer.mu, *a.optimizer.nu, a.optimizer.count,
                     *a.ema_params.values()),
                    (*b.optimizer.mu, *b.optimizer.nu, b.optimizer.count,
                     *b.ema_params.values())):
        assert torch.equal(x, y)
    for n in a.metrics.kinds:
        assert torch.equal(a.metrics.sums[n], b.metrics.sums[n])
        assert torch.equal(a.metrics.counts[n], b.metrics.counts[n])
    for n, g in a.rngs.items():
        assert torch.equal(g.get_state(), b.rngs[n].get_state()), n


@pytest.mark.cuda
def test_captured_train_step_equals_the_eager_step(card):
    """make_train_step(jit=True) captures one CUDA graph after one eager
    warm-up and replays it; after 4 steps from the same state, batches and
    generator seeds the state equals the eager step's bit for bit."""
    from multi_modal_transformers_tokenmerge_torch import make_train_step
    cfg = _bf16_train_config()
    batches = _device_batches(cfg, 4, 4, seed=1)
    eager, captured = _train_state(cfg), _train_state(cfg)
    step_e = make_train_step("diffusion", jit=False)
    step_c = make_train_step("diffusion")
    for bt in batches:
        step_e(eager, *bt)
        step_c(captured, *bt)
    torch.cuda.synchronize()
    (entry,) = step_c._graphs[captured].values()
    assert "graph" in entry
    _assert_same_state(eager, captured)


@pytest.mark.cuda
def test_captured_remat_step_equals_the_eager_remat_step(card):
    """``transformer.remat`` with dropout 0.1 in the flash kernels: the
    captured step's recompute draws from the spare generators of its
    RecomputePlan what the eager step's recompute draws, so after 4 steps
    the states are equal bit for bit; and the eager remat step equals the
    eager step without remat."""
    from multi_modal_transformers_tokenmerge_torch import make_train_step
    base = _bf16_train_config()
    cfg = base.replace(transformer=base.transformer.replace(remat=True))
    batches = _device_batches(cfg, 4, 4, seed=2)
    plain, eager, captured = (_train_state(base), _train_state(cfg),
                              _train_state(cfg))
    step_p = make_train_step("diffusion", jit=False)
    step_c = make_train_step("diffusion")
    for bt in batches:
        step_p(plain, *bt)
        step_p(eager, *bt)
        step_c(captured, *bt)
    torch.cuda.synchronize()
    (entry,) = step_c._graphs[captured].values()
    assert "graph" in entry and len(entry["plan"].spares) == \
        cfg.transformer.num_blocks
    _assert_same_state(eager, captured)
    _assert_same_state(plain, eager)


@pytest.mark.cuda
def test_restored_state_is_captured_anew(card, tmp_path):
    """Save after 2 compiled steps, restore into a fresh state, 2 more:
    the unbroken compiled run's state after step 4."""
    from multi_modal_transformers_tokenmerge_torch import (
        CheckpointManager, make_train_step)
    cfg = _bf16_train_config()
    batches = _device_batches(cfg, 4, 4, seed=2)
    step = make_train_step("diffusion")
    unbroken = _train_state(cfg)
    for bt in batches:
        step(unbroken, *bt)
    mgr = CheckpointManager(str(tmp_path))
    first = _train_state(cfg)
    for bt in batches[:2]:
        step(first, *bt)
    mgr.save(first.step, first)
    fresh = mgr.restore(_train_state(cfg, 5, 5))
    for bt in batches[2:]:
        step(fresh, *bt)
    (entry,) = step._graphs[fresh].values()
    assert "graph" in entry
    _assert_same_state(unbroken, fresh)


@pytest.mark.cuda
def test_fit_saving_every_step_equals_fit_without_saves(card, tmp_path):
    """Compiled fit with checkpoint_every=1: the writer of the save after
    the eager warm-up copies its snapshot to the host while the next call
    captures the step, and every later save runs beside a replay; the
    state equals a fit without saves bit for bit, and the last save
    restores it."""
    from multi_modal_transformers_tokenmerge_torch import (
        CheckpointManager, fit)
    cfg = _bf16_train_config()
    batches = _device_batches(cfg, 4, 4, seed=3)
    plain, saved = _train_state(cfg), _train_state(cfg)
    fit(plain, iter(batches), "diffusion", len(batches))
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    fit(saved, iter(batches), "diffusion", len(batches), checkpointer=mgr,
        checkpoint_every=1)
    torch.cuda.synchronize()
    _assert_same_state(plain, saved)
    assert mgr.all_steps() == [len(batches)]
    restored = mgr.restore(_train_state(cfg, 5, 5))
    for n, p in plain.params.items():
        assert torch.equal(p, restored.params[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("batch,ddim_steps", [(1, None), (8, None), (1, 8)])
def test_compiled_engine_replays_the_eager_call(card, batch, ddim_steps):
    """PolicyEngine.compile captures the full and the cached path (DDPM, or
    DDIM, whose coefficients are made before the capture); each replay
    equals the eager engine's call on the same seed bit for bit, and
    compiling consumed none of the engine's noise."""
    from multi_modal_transformers_tokenmerge_torch import Octo, PolicyEngine
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base)
    cfg = octo_base(dtype="bfloat16")
    model = Octo(cfg, device="cuda", seed=0)
    ids = np.arange(cfg.text.max_length)
    shape = (cfg.num_observation_blocks, *cfg.images.image_size)
    kw = dict(batch_size=batch, seed=1, ddim_steps=ddim_steps)
    eager = PolicyEngine(model, **kw).set_instruction(ids)
    compiled = PolicyEngine(model, **kw).compile(
        (cfg.text.max_length,), shape).set_instruction(ids)
    assert set(compiled._graphs) == {"full", "cached"}
    g = torch.Generator(device="cuda").manual_seed(3)
    for i in range(3):
        images = torch.randint(0, 256, (batch, *shape), generator=g,
                               device="cuda").float()
        if i == 2:
            want = eager(images, text_tokens=ids)
            got = compiled(images, text_tokens=ids)
        else:
            want, got = eager(images), compiled(images)
        assert torch.equal(got, want), i


@pytest.mark.cuda
def test_prefetch_to_device_on_the_card(card):
    """Pinned staging, a copy stream and an event per batch: the batches
    arrive on the card, equal and in order, and a consumer reading each at
    once sees its copy finished."""
    from multi_modal_transformers_tokenmerge_torch.utils.data import (
        prefetch_to_device)
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(64, 1024)).astype(np.float32),
                {"ids": rng.integers(0, 9, (64,))}) for _ in range(6)]
    out = []
    for x, d in prefetch_to_device(iter(batches), size=2, device="cuda"):
        assert x.device.type == "cuda"
        out.append((x.sum().item(), d["ids"].cpu().numpy()))
    for (s, ids), (x, d) in zip(out, batches):
        assert s == pytest.approx(float(x.sum()), rel=1e-4)
        np.testing.assert_array_equal(ids, d["ids"])


@pytest.mark.cuda
def test_captured_evaluate_equals_the_eager_losses(card):
    """evaluate on the card (batch 0 eager, batch 1 captured, then
    replays) gives the mean of the eager eval losses drawn from the same
    per-batch generators, and leaves the training generators alone."""
    from multi_modal_transformers_tokenmerge_torch import evaluate
    from multi_modal_transformers_tokenmerge_torch.train.loop import (
        eval_seed)
    cfg = _bf16_train_config()
    state = _train_state(cfg, rng_seed=4)
    batches = _device_batches(cfg, 4, 4, seed=3)
    before = {n: g.get_state() for n, g in state.rngs.items()}
    got = evaluate(state, iter(batches), "diffusion", 4)
    again = evaluate(state, iter(batches), "diffusion", 4)
    rngs = {n: torch.Generator(device="cuda") for n in state.rngs}
    losses = []
    with torch.no_grad():
        for i, bt in enumerate(batches):
            for n, g in rngs.items():
                g.manual_seed(eval_seed(state.rngs[n].initial_seed(), i))
            losses.append(state.model.compute_diffusion_denoise_loss(
                *bt, False, rngs=rngs).mean().float())
    want = float(torch.stack(losses).sum() / len(losses))
    assert got == again
    assert got["loss"] == pytest.approx(want, rel=1e-6)
    assert all(torch.equal(g.get_state(), before[n])
               for n, g in state.rngs.items())


def _refused_config(dtype):
    """octo_base with a three-block denoiser and GELU MLPs (YAML
    overrides)."""
    from multi_modal_transformers_tokenmerge_torch import load_config
    return load_config("octo_base", [f"dtype={dtype}",
                                     "heads.diffusion.num_blocks=3",
                                     "transformer.mlp_activation=gelu"])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_multi_block_engine_replays_the_eager_call(card, batch):
    """The three-block GELU configuration compiled: each replay equals the
    eager call bit for bit, and the eager call launches no sampler (its
    reverse loop is plain PyTorch)."""
    from multi_modal_transformers_tokenmerge_torch import Octo, PolicyEngine
    cfg = _refused_config("bfloat16")
    model = Octo(cfg, device="cuda", seed=0)
    ids = np.arange(cfg.text.max_length)
    shape = (cfg.num_observation_blocks, *cfg.images.image_size)
    eager = PolicyEngine(model, batch_size=batch, seed=1).set_instruction(ids)
    compiled = PolicyEngine(model, batch_size=batch, seed=1).compile(
        (cfg.text.max_length,), shape).set_instruction(ids)
    g = torch.Generator(device="cuda").manual_seed(5)
    before = ddpm_sampler.launches
    for _ in range(2):
        images = torch.randint(0, 256, (batch, *shape), generator=g,
                               device="cuda").float()
        want, got = eager(images), compiled(images)
        assert torch.isfinite(want).all()
        assert torch.equal(got, want)
    assert ddpm_sampler.launches == before


@pytest.mark.cuda
def test_server_thread_replays_the_main_threads_graph(card):
    """A compiled engine's graph replayed from PolicyServer's thread equals
    the same replay on the main thread (the same batch and generator
    state) bit for bit."""
    import threading
    import time
    from multi_modal_transformers_tokenmerge_torch import Octo, PolicyEngine
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base)
    from multi_modal_transformers_tokenmerge_torch.serve.server import (
        PolicyServer)
    cfg = octo_base(dtype="bfloat16")
    shape = (cfg.num_observation_blocks, *cfg.images.image_size)
    eng = PolicyEngine(Octo(cfg, device="cuda", seed=0), batch_size=4,
                       seed=1).compile((cfg.text.max_length,), shape)
    eng.set_instruction(np.arange(cfg.text.max_length))
    calls = []

    class Recording:
        def __getattr__(self, name):
            return getattr(eng, name)

        def __call__(self, images, **kw):
            state = eng._generator.get_state()
            out = eng(images, **kw)
            calls.append((images.clone(), state, out.clone()))
            return out

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(4)]
    answers = [None] * 4
    with PolicyServer(Recording(), max_wait_ms=200.0) as server:
        def call(i):
            answers[i] = server.predict(frames[i])

        threads = []
        for i in range(4):       # in order, into one batch
            threads.append(threading.Thread(target=call, args=(i,)))
            threads[-1].start()
            time.sleep(0.002)
        for t in threads:
            t.join(60)
    (images, state, worker), = calls
    eng._generator.set_state(state)
    assert torch.equal(eng(images), worker)
    for i, a in enumerate(answers):
        np.testing.assert_array_equal(a, worker[i].cpu().numpy())


@pytest.mark.cuda
def test_debug_mode_runs_the_compiled_engine_eagerly(card):
    """Under debug_mode a compiled engine runs its serving copy eagerly
    (the sampler's wrapper launches, no replay) with every operator
    NaN-checked, and answers as the replay does."""
    from multi_modal_transformers_tokenmerge_torch import Octo, PolicyEngine
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        octo_base)
    from multi_modal_transformers_tokenmerge_torch.utils.debug import (
        debug_mode)
    cfg = octo_base(dtype="bfloat16")
    shape = (cfg.num_observation_blocks, *cfg.images.image_size)
    eng = PolicyEngine(Octo(cfg, device="cuda", seed=0), batch_size=2,
                       seed=1).compile((cfg.text.max_length,), shape)
    eng.set_instruction(np.arange(cfg.text.max_length))
    images = torch.randint(0, 256, (2, *shape), device="cuda").float()
    state = eng._generator.get_state()
    before = ddpm_sampler.launches
    replayed = eng(images)
    assert ddpm_sampler.launches == before
    eng._generator.set_state(state)
    with debug_mode():
        checked = eng(images)
    assert ddpm_sampler.launches == before + 1
    assert torch.equal(checked, replayed)


@pytest.mark.cuda
def test_probes_on_the_card_match_the_cpu(card):
    """capture_intermediates on octo_tiny in float32 (no TF32 in cuBLAS or
    cuDNN): the card's probes equal the CPU's to 1e-4 (chip_smoke.py's
    PROBE_F32_TOL), stacked over its two blocks."""
    from multi_modal_transformers_tokenmerge_torch import Octo, octo_tiny
    from multi_modal_transformers_tokenmerge_torch.modules.attention import (
        capture_intermediates)
    cfg = octo_tiny()
    gpu = Octo(cfg, device="cuda", seed=0).eval()
    cpu = Octo(cfg, device="cpu", seed=None).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.text.vocab_size, (2, 16)))
    images = torch.from_numpy(rng.integers(
        0, 256, (2, 1, *cfg.images.image_size)).astype(np.float32))
    probes = {}
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, m in (("cuda", gpu), ("cpu", cpu)):
            with torch.no_grad(), capture_intermediates(m) as probes[name]:
                m.generate_readouts(ids.to(m.device), images.to(m.device))
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    key = "transformer/blocks/attention/attention_weights"
    assert sorted(probes["cuda"]) == sorted(probes["cpu"]) == [key]
    got, want = probes["cuda"][key][0].cpu(), probes["cpu"][key][0]
    assert tuple(got.shape) == (2, 2, 4, 36, 36)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
