"""Kernels of the torch port on the card: each against its plain version at
octo_base shapes.  Marked ``cuda``; they skip where there is no sm_90 card
and run on one with ``python -m pytest -m cuda tests/test_torch_cuda.py``."""

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
