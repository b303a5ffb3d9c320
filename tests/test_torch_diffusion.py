"""Diffusion head and sampler of the port against the JAX package.

The JAX head draws its noise from flax rngs; the tests record the initial
sample and per-step noise it hands to its fused sampler (interpret mode on
the CPU) and give the port the same.  f32, tolerance 2e-5 per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_transformers_tokenmerge_torch import _build
from multi_modal_transformers_tokenmerge_torch.core import hw
from multi_modal_transformers_tokenmerge_torch.heads import diffusion as tdiff
from multi_modal_transformers_tokenmerge_torch.ops import ddpm_sampler as tds
from multi_modal_transformers_tokenmerge_tpu.heads import diffusion as jdiff
from multi_modal_transformers_tokenmerge_tpu.ops import ddpm_sampler as jds
from torch_parity import MODULE_TOL, assert_close, capture_sampler_inputs, \
    micro_pair, octo_micro_t5


def test_schedules_match():
    np.testing.assert_array_equal(tdiff.cosine_beta_schedule(32),
                                  jdiff.cosine_beta_schedule(32))
    ah = np.cumprod(1 - jdiff.cosine_beta_schedule(32))
    for a, b in zip(tdiff.ddim_schedule(32, 8, ah),
                    jdiff.ddim_schedule(32, 8, ah)):
        np.testing.assert_array_equal(a, b)


def _head_cfg(rng_mode="folded", ddim_steps=None, eps_mode="raw",
              impl="fused", **widths):
    """The micro head; ``widths`` overrides fields of its
    DiffusionHeadConfig (action_space_dim, mlp_dim, diffusion_steps)."""
    base = octo_micro_t5()
    return base.replace(heads=base.heads.replace(
        diffusion=base.heads.diffusion.replace(
            sampler_rng_mode=rng_mode, ddim_steps=ddim_steps,
            ddim_eps_mode=eps_mode, sampler_impl=impl, **widths)))


# octo_base_chunk28's head cut to a micro width: Octo's 4 x 7 action chunk
# and Diffusion Policy's 100 steps, past the register kernel's 16 actions
CHUNK28 = dict(action_space_dim=28, diffusion_steps=100, mlp_dim=48)


def _jax_predict(cfg, readouts, seed=5):
    jm, v, _ = micro_pair(cfg)
    return jm.apply(
        v, jnp.asarray(readouts),
        method=lambda m, r: m.diffusion_action_head.predict_action(r, False),
        rngs={"diffusion": jax.random.PRNGKey(seed)})


def test_fourier_time_encoder_matches():
    cfg = _head_cfg()
    jm, v, tm = micro_pair(cfg)
    t = np.arange(31, -1, -1, dtype=np.float32)[:, None]
    ref = jm.apply(v, jnp.asarray(t), method=lambda m, x: (
        m.diffusion_action_head.denoiser.encode_time(x)))
    with torch.no_grad():
        out = tm.diffusion_action_head.denoiser.time_encoder(
            torch.from_numpy(t))
    assert_close(out, ref, MODULE_TOL)


@pytest.mark.parametrize("rng_mode,ddim_steps,eps_mode,widths", [
    pytest.param(*case, {}, id="-".join(map(str, case))) for case in [
        ("folded", None, "raw"), ("reference", None, "raw"),
        ("folded", 8, "raw"), ("folded", 8, "recompute")]] + [
    pytest.param(*case, CHUNK28, id="-".join(map(str, case)) + "-chunk28")
    for case in [("folded", None, "raw"), ("folded", 10, "raw"),
                 ("folded", 10, "recompute")]])
def test_predict_action_matches(monkeypatch, rng_mode, ddim_steps,
                                eps_mode, widths):
    cfg = _head_cfg(rng_mode, ddim_steps, eps_mode, **widths)
    a = cfg.heads.diffusion.action_space_dim
    _, _, tm = micro_pair(cfg)
    readouts = np.random.default_rng(4).normal(
        size=(3, 4, 32)).astype(np.float32)
    cap = capture_sampler_inputs(monkeypatch)
    ref = _jax_predict(cfg, readouts)
    noisy, noise = cap.last()
    with torch.no_grad():
        out = tm.diffusion_action_head.predict_action(
            torch.from_numpy(readouts), noisy=noisy,
            noise=None if ddim_steps else noise)
    assert tuple(out.shape) == ref.shape == (3, a)
    assert_close(out, ref, MODULE_TOL)
    # the JAX scan sampler draws the same noise from the same key
    scan = _jax_predict(_head_cfg(rng_mode, ddim_steps, eps_mode, "scan",
                                  **widths), readouts)
    assert_close(out, scan, MODULE_TOL)


def test_reference_mode_reuses_initial_noise():
    """Drawn by the port: 'reference' adds the initial sample's noise at
    every step, so passing noisy alone equals passing it as every step's
    noise too."""
    cfg = _head_cfg("reference")
    _, _, tm = micro_pair(cfg)
    head = tm.diffusion_action_head
    readouts = torch.randn(2, 4, 32, generator=torch.Generator().manual_seed(0))
    noisy = torch.randn(2, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = head.predict_action(readouts, noisy=noisy)
        b = head.predict_action(readouts, noisy=noisy,
                                noise=noisy.expand(32, 2, 4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _sampler_inputs(t, b, h, a, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(noisy=f(b, a), contexts=f(t, b, h), noise=f(t, b, a),
                coeffs=(np.abs(f(t, 4)) * 0.1 + 0.5).astype(np.float32),
                wn=f(a, h) * 0.1, bn=f(h) * 0.1, wo=f(h, a) * 0.1,
                bo=f(a) * 0.1)


@pytest.mark.parametrize("mode", ["ddpm", "ddim_raw", "ddim_recompute"])
@pytest.mark.parametrize("batch", [1, 5, 13])
def test_sampler_reference_matches_pallas_interpret(batch, mode):
    """ddpm_sample_reference against JAX fused_ddpm_sample in interpret
    mode; 13 rows is no multiple of any tile."""
    t, h, a = 32, 48, 8
    x = _sampler_inputs(t, batch, h, a, seed=batch)
    ddim = mode != "ddpm"
    coeffs = x["coeffs"] if ddim else x["coeffs"][:, :3]
    ref = jds.fused_ddpm_sample(
        jnp.asarray(x["noisy"]), jnp.asarray(x["contexts"]),
        jnp.asarray(x["noise"]), jnp.asarray(coeffs), jnp.asarray(x["wn"]),
        jnp.asarray(x["bn"]), jnp.asarray(x["wo"]), jnp.asarray(x["bo"]),
        clip_value=5.0, compute_dtype=jnp.float32, ddim_x0clip=ddim,
        ddim_eps_recompute=mode == "ddim_recompute", interpret=True)
    T = torch.from_numpy
    before = tds.ddpm_sampler.launches
    out = tds.ddpm_sampler(
        T(x["noisy"]), T(x["contexts"]), None if ddim else T(x["noise"]),
        T(coeffs), T(x["wn"].T.copy()), T(x["bn"]), T(x["wo"].T.copy()),
        T(x["bo"]), clip_value=5.0, ddim_x0clip=ddim,
        ddim_eps_recompute=mode == "ddim_recompute")
    assert tds.ddpm_sampler.launches == before  # CPU: the plain version
    assert_close(out, ref, MODULE_TOL)


def _meta_args():
    x = _sampler_inputs(4, 2, 16, 4, seed=0)
    args = [torch.from_numpy(x[k]).to("meta") for k in
            ("noisy", "contexts", "noise")]
    args.append(torch.from_numpy(x["coeffs"][:, :3]).to("meta"))
    args += [torch.from_numpy(np.ascontiguousarray(x[k].T)).to("meta")
             if x[k].ndim == 2 else torch.from_numpy(x[k]).to("meta")
             for k in ("wn", "bn", "wo", "bo")]
    return args


def test_wrapper_raises_off_cpu_without_card():
    """A tensor that is not on the CPU never takes the plain version."""
    with pytest.raises(RuntimeError, match="sm_90"):
        tds.ddpm_sampler(*_meta_args(), clip_value=5.0)


def test_wrapper_raises_when_kernel_library_missing(monkeypatch):
    """With the device gate passing (as on the card) and no kernel library,
    the wrapper raises instead of falling back."""
    monkeypatch.setattr(tds, "on_cuda", lambda *t: True)

    def missing(name):
        raise _build.KernelBuildError(f"no library for {name}")

    monkeypatch.setattr(_build, "load_library", missing)
    before = tds.ddpm_sampler.launches
    with pytest.raises(_build.KernelBuildError, match="ddpm_sampler"):
        tds.ddpm_sampler(*_meta_args(), clip_value=5.0)
    assert tds.ddpm_sampler.launches == before


def test_on_cuda_false_for_cpu_tensors():
    assert not hw.on_cuda(torch.zeros(2))
    assert not hw.on_cuda()


def test_kernel_sources_present():
    assert "ddpm_sampler" in _build.sources()


# -- the multi-block denoiser (JAX: lax.scan, heads/diffusion.py:350-400) ----

class capture_head_rng:
    """Records every key the JAX diffusion head's ``make_rng`` returns (an
    unjitted ``apply``), so that its draws can be derived with jax.random
    exactly as the head derives them."""

    def __init__(self, monkeypatch):
        self.keys = []
        original = jdiff.DiffusionActionHead.make_rng

        def wrapper(module, name=None):
            key = original(module, name)
            self.keys.append(key)
            return key

        monkeypatch.setattr(jdiff.DiffusionActionHead, "make_rng", wrapper)


def _scan_draws(rng, cfg, batch):
    """(noisy (B, A), noise (T, B, A)) of the JAX scan sampler
    (heads/diffusion.py:249-260, 383-385)."""
    d = cfg.heads.diffusion
    a = d.action_space_dim
    init_key, loop_key = jax.random.split(rng)
    if d.sampler_rng_mode == "reference":
        keys = jax.random.split(rng, batch)
        noisy = jax.vmap(lambda k: jax.random.normal(k, (a,)))(keys)
        noise = jnp.broadcast_to(noisy, (d.diffusion_steps, batch, a))
    else:
        noisy = jax.random.normal(init_key, (batch, a))
        noise = jnp.stack([
            jax.random.normal(jax.random.fold_in(loop_key, t), (batch, a))
            for t in range(d.diffusion_steps - 1, -1, -1)])
    return (torch.tensor(np.asarray(noisy)), torch.tensor(np.asarray(noise)))


def _multi_cfg(num_blocks, rng_mode="folded", ddim_steps=None,
               eps_mode="raw"):
    """The micro head with ``num_blocks`` denoiser blocks; 'auto' runs the
    JAX scan sampler on the CPU."""
    cfg = _head_cfg(rng_mode, ddim_steps, eps_mode, impl="auto")
    return cfg.replace(heads=cfg.heads.replace(
        diffusion=cfg.heads.diffusion.replace(num_blocks=num_blocks)))


def test_multi_block_denoiser_structure():
    """first_out widens to mlp_dim, then mlp_1 .. mlp_{n-1}, the last out
    to the action dim; relu and dropout 0.1 whatever the config says."""
    _, v, tm = micro_pair(_multi_cfg(3))
    d = tm.diffusion_action_head.denoiser
    flax = v["params"]["diffusion_action_head"]["denoiser"]
    assert sorted(k for k in flax if k.startswith("mlp_")) == ["mlp_1",
                                                               "mlp_2"]
    assert tuple(d.first_out.weight.shape) == (32, 32)
    assert tuple(d.mlp_2.dense_out.weight.shape) == (4, 32)
    assert d.mlp_1.dropout_rate == d.mlp_2.dropout_rate == 0.1
    assert d.mlp_1.act is torch.relu


@pytest.mark.parametrize("num_blocks,rng_mode,ddim_steps,eps_mode", [
    (2, "folded", None, "raw"),
    (3, "folded", None, "raw"),
    (3, "reference", None, "raw"),
    (2, "folded", 8, "raw"),
    (3, "folded", 8, "raw"),
    (3, "folded", 8, "recompute"),
])
def test_multi_block_predict_action_matches_scan(monkeypatch, num_blocks,
                                                 rng_mode, ddim_steps,
                                                 eps_mode):
    """The port's plain reverse loop against the JAX scan path, the JAX
    draws handed in as noisy / noise; f32, 2e-5.  No sampler launch."""
    cfg = _multi_cfg(num_blocks, rng_mode, ddim_steps, eps_mode)
    _, _, tm = micro_pair(cfg)
    readouts = np.random.default_rng(9).normal(
        size=(3, 4, 32)).astype(np.float32)
    cap = capture_head_rng(monkeypatch)
    ref = _jax_predict(cfg, readouts, seed=11)
    noisy, noise = _scan_draws(cap.keys[-1], cfg, 3)
    before = tds.ddpm_sampler.launches
    with torch.no_grad():
        out = tm.diffusion_action_head.predict_action(
            torch.from_numpy(readouts), noisy=noisy,
            noise=None if ddim_steps else noise)
    assert tds.ddpm_sampler.launches == before
    assert tuple(out.shape) == ref.shape == (3, 4)
    assert_close(out, ref, MODULE_TOL)


@pytest.mark.parametrize("num_blocks", [1, 2, 3])
def test_denoise_loss_and_gradients_match(monkeypatch, num_blocks):
    """denoise_loss (eval mode) and its gradients on every head parameter
    against jax.grad of the JAX loss, with the JAX time and noise draws;
    f32: loss 2e-5, gradients rtol 1e-4 / atol 1e-5."""
    from multi_modal_transformers_tokenmerge_torch import convert
    from torch_parity import to_torch_config
    cfg = _multi_cfg(num_blocks)
    jm, v, tm = micro_pair(cfg)
    rng = np.random.default_rng(num_blocks)
    readouts = rng.normal(size=(3, 4, 32)).astype(np.float32)
    actions = rng.uniform(-1, 1, (3, 4)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    cap = capture_head_rng(monkeypatch)

    def loss_fn(params):
        return jm.apply({"params": params}, jnp.asarray(readouts),
                        jnp.asarray(actions), method=lambda m, r, a: (
                            m.diffusion_action_head.denoise_loss(r, a,
                                                                 False)),
                        rngs={"diffusion": key})

    ref_loss = loss_fn(v["params"])
    ref_grads = jax.grad(loss_fn)(v["params"])
    time_key, noise_key = jax.random.split(cap.keys[0])
    time = jax.random.randint(time_key, (3, 1), 0,
                              cfg.heads.diffusion.diffusion_steps)
    noise = jax.random.normal(noise_key, (3, 4), dtype=jnp.float32)
    head = tm.diffusion_action_head
    head.zero_grad()
    flags = [p.requires_grad for p in head.parameters()]
    head.requires_grad_(True)
    loss = head.denoise_loss(torch.from_numpy(readouts),
                             torch.from_numpy(actions), train=False,
                             time=torch.tensor(np.asarray(time)),
                             noise=torch.tensor(np.asarray(noise)))
    loss.backward()
    assert_close(loss, ref_loss, MODULE_TOL)
    want = convert.from_flax(jax.tree.map(np.asarray, ref_grads),
                             to_torch_config(cfg))
    names = [n for n, _ in head.named_parameters()]
    assert any(".mlp_" in n for n in names) == (num_blocks > 1)
    for n, p in head.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want[f"diffusion_action_head.{n}"].numpy(),
            rtol=1e-4, atol=1e-5, err_msg=n)
    for p, flag in zip(head.parameters(), flags):
        p.requires_grad_(flag)
        p.grad = None
