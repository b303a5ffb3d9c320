"""The port's policy export (``serve/export.py``), ``PolicyEngine.
load_artifact`` and the kernels' custom ops, on the CPU.

An exported program run on the same parameters and draws returns the eager
call's actions bit for bit (the same operations in the same order).  The
custom ops' shape functions give the shapes and dtypes of the plain
versions.
"""

import io

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from torch_parity import (inputs, octo_micro_t5, octo_micro_tome_staged,
                          to_torch_config)
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
from multi_modal_transformers_tokenmerge_torch.ops import (
    ddpm_sampler as sampler_ops, flash_attention as fa)
from multi_modal_transformers_tokenmerge_torch.serve import export as ex
from multi_modal_transformers_tokenmerge_torch.serve.policy import (
    PolicyEngine)


def _model(cfg_jax, seed=0):
    return Octo(to_torch_config(cfg_jax), device="cpu", seed=seed).eval()


def _deep_micro():
    """The staged micro ToMe model on the flash forward (its plain version
    here, through the ``tokenmerge::flash_fwd`` op), as octo_deep serves."""
    cfg = octo_micro_tome_staged(attention_impl="flash",
                                 flash_backward="xla")
    return cfg.replace(transformer=cfg.transformer.replace(
        attention=cfg.transformer.attention.replace(dropout_rate=0.0)))


def _draws(model, head, batch, seed=3):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g)
            for s in ex.draw_shapes(model, head, batch).values()]


def _ops_in(blob):
    program = torch.export.load(io.BytesIO(blob))
    return sorted({str(n.target) for n in program.graph.nodes
                   if str(n.target).startswith("tokenmerge.")}), program


@pytest.fixture(scope="module")
def t5_model():
    cfg = octo_micro_t5()
    ids, images = inputs(cfg)
    return _model(cfg), torch.tensor(ids, dtype=torch.long), \
        torch.tensor(images)


@pytest.mark.parametrize("cached", [False, True])
def test_diffusion_round_trip_equals_eager(t5_model, cached):
    model, ids, images = t5_model
    text = model.encode_text(ids).detach() if cached else ids
    export = ex.export_cached_policy if cached else ex.export_policy
    blob = export(model, "diffusion", 2, ids.shape[1:], images.shape[1:])
    ops, program = _ops_in(blob)
    assert ops == ["tokenmerge.ddpm_sampler.default"]
    assert not program.state_dict          # the weights are inputs
    noisy, noise = _draws(model, "diffusion", 2)
    got = ex.load_policy(blob)(ex.parameters_of(model), text, images, noisy,
                               noise)
    method = (model.predict_diffusion_action_with_text if cached
              else model.predict_diffusion_action)
    with torch.no_grad():
        want = method(text, images, noisy=noisy, noise=noise)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_artifact_serves_another_checkpoint(t5_model, tmp_path):
    """Parameters are call-time inputs: one artifact, any checkpoint of the
    same structure.  Written to and loaded from a path."""
    model, ids, images = t5_model
    path = str(tmp_path / "policy.pt2")
    blob = ex.export_policy(model, "diffusion", 2, ids.shape[1:],
                            images.shape[1:], path=path)
    with open(path, "rb") as f:
        assert f.read() == blob
    other = _model(octo_micro_t5(), seed=5)
    noisy, noise = _draws(other, "diffusion", 2)
    got = ex.load_policy(path)(ex.parameters_of(other), ids, images, noisy,
                               noise)
    with torch.no_grad():
        want = other.predict_diffusion_action(ids, images, noisy=noisy,
                                              noise=noise)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_engine_load_artifact_equals_the_eager_engine(t5_model):
    """The engine draws the artifact's inputs from its generator in the
    head's order, so the same seed gives the eager engine's actions."""
    model, ids, images = t5_model
    full = ex.export_policy(model, "diffusion", 2, ids.shape[1:],
                            images.shape[1:])
    cached = ex.export_cached_policy(model, "diffusion", 2, ids.shape[1:],
                                     images.shape[1:])
    eager = PolicyEngine(model, batch_size=2, seed=7).set_instruction(ids)
    loaded = PolicyEngine(model, batch_size=2, seed=7).load_artifact(
        full, cached).set_instruction(ids)
    for _ in range(2):
        torch.testing.assert_close(loaded(images), eager(images), rtol=0,
                                   atol=0)
        torch.testing.assert_close(loaded(images, text_tokens=ids),
                                   eager(images, text_tokens=ids), rtol=0,
                                   atol=0)
    noisy = torch.zeros(2, 4)
    torch.testing.assert_close(loaded(images, noisy=noisy),
                               eager(images, noisy=noisy), rtol=0, atol=0)


def test_deep_round_trip_names_both_kernels():
    model = _model(_deep_micro())
    cfg = _deep_micro()
    ids, images = inputs(cfg)
    ids, images = torch.tensor(ids, dtype=torch.long), torch.tensor(images)
    text = model.encode_text(ids).detach()
    blob = ex.export_cached_policy(model, "diffusion", 2, ids.shape[1:],
                                   images.shape[1:])
    ops, _ = _ops_in(blob)
    assert ops == ["tokenmerge.ddpm_sampler.default",
                   "tokenmerge.flash_fwd.default"]
    noisy, noise = _draws(model, "diffusion", 2)
    got = ex.load_policy(blob)(ex.parameters_of(model), text, images, noisy,
                               noise)
    with torch.no_grad():
        want = model.predict_diffusion_action_with_text(
            text, images, noisy=noisy, noise=noise)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("head", ["continuous", "categorical"])
def test_deterministic_heads_round_trip(t5_model, head):
    model, ids, images = t5_model
    assert ex.draw_shapes(model, head, 2) == {}
    blob = ex.export_policy(model, head, 2, ids.shape[1:], images.shape[1:])
    got = ex.load_policy(blob)(ex.parameters_of(model), ids, images)
    with torch.no_grad():
        want = getattr(model, ex.PREDICT_METHODS[head])(ids, images)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_draw_shapes_follow_the_sampler(t5_model):
    model, _, _ = t5_model
    cfg = model.config.heads.diffusion
    assert ex.draw_shapes(model, "diffusion", 3) == {
        "noisy": (3, cfg.action_space_dim),
        "noise": (cfg.diffusion_steps, 3, cfg.action_space_dim)}
    for change in ({"ddim_steps": 4}, {"sampler_rng_mode": "reference"}):
        other = _model(octo_micro_t5().replace(
            heads=octo_micro_t5().heads.replace(
                diffusion=octo_micro_t5().heads.diffusion.replace(
                    **change))))
        assert list(ex.draw_shapes(other, "diffusion", 3)) == ["noisy"]


def test_load_artifact_refusals(t5_model):
    model, ids, images = t5_model
    blob = ex.export_policy(model, "continuous", 2, ids.shape[1:],
                            images.shape[1:])
    for kw in ({"image_tower": "int8"}, {"image_tower": "w8"}):
        with pytest.raises(ValueError, match="image tower"):
            PolicyEngine(model, head="continuous", batch_size=2,
                         **kw).load_artifact(blob)
    with pytest.raises(ValueError, match="ddim_steps"):
        PolicyEngine(model, batch_size=2, ddim_steps=4).load_artifact(blob)
    with pytest.raises(ValueError, match="unknown head"):
        ex.export_policy(model, "pointer", 2, ids.shape[1:],
                         images.shape[1:])


# -- the custom ops' shape functions -----------------------------------------

def _fake_matches_plain(op, *args):
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args))
    assert tuple(fake.shape) == tuple(real.shape)
    assert fake.dtype == real.dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["ddpm", "ddim", "ddim_recompute"])
def test_ddpm_sampler_op_fake_matches_plain(dtype, mode):
    rng = np.random.default_rng(0)
    t, b, h, a = 5, 3, 16, 4
    f = lambda *s: torch.tensor(rng.normal(0, 0.3, s), dtype=torch.float32)
    ddim = mode != "ddpm"
    args = (f(b, a), f(t, b, h).to(dtype), None if ddim else f(t, b, a),
            f(t, 4 if ddim else 3), f(h, a), f(h), f(a, h), f(a), 1.0, ddim,
            mode == "ddim_recompute")
    _fake_matches_plain(sampler_ops.ddpm_sampler_op, *args)
    torch.testing.assert_close(
        sampler_ops.ddpm_sampler_op(*args),
        sampler_ops.ddpm_sampler(*args[:8], clip_value=1.0, ddim_x0clip=ddim,
                                 ddim_eps_recompute=mode == "ddim_recompute"),
        rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_op_fake_matches_plain(dtype):
    rng = np.random.default_rng(1)
    b, s, h, d = 2, 20, 2, 64
    mask = np.tril(np.ones((s, s), bool))
    bq, bk = fa.KERNEL_TILES[d]
    mask_i8, k_hi, _ = fa.device_tables(mask, bq, bk, torch.device("cpu"))
    q, k, v = (torch.tensor(rng.normal(0, 1, (b, s, h, d)),
                            dtype=torch.float32).to(dtype) for _ in range(3))
    args = (q, k, v, mask_i8, k_hi, bq, bk)
    _fake_matches_plain(fa.flash_fwd_op, *args)
    torch.testing.assert_close(
        fa.flash_fwd_op(*args),
        fa.flash_fwd(q, k, v, mask_i8, k_hi, block_q=bq, block_k=bk),
        rtol=0, atol=0)
