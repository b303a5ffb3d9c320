"""The port's int8 / w8 serving towers (``serve/quantize.py``) against the
JAX package's, on the same float inputs made with numpy.

* Quantized weights: the int8 values equal, the scales within 1 ulp
  (rounding is half to even in both; the scale is amax / 127 in both).
* int8 products: on equal float inputs the int8 activations and the int32
  accumulators are equal, and so are the float results (the same
  multiplications in the same order).
* The towers in float32, within float32 summation error (``TOL``, the
  port's module tolerance); the w8 towers also in bfloat16, against the
  JAX towers run op by op (``BF16_DIFF_SHARE``, ``BF16_STEP``).  The int8 towers quantize activations that
  come out of float reductions (RMSNorm, GroupNorm, softmax), which the two
  frameworks sum in different orders; an ulp there could move a value
  across an int8 rounding boundary (a near-tie) and change it by one int8
  step of its row's scale.  No such flip occurs on these inputs (largest
  differences: T5 4.8e-7 int8 / 7.2e-7 w8, image tower 1.7e-5 / 1.5e-5,
  engines 1.2e-7 to 5.4e-7), so the int8 towers are held to ``TOL`` too;
  a flip would fail it by about one int8 step (1e-3 to 1e-2 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_configs import octo_micro
from torch_parity import micro_pair, octo_micro_t5, to_torch_config
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_torch.serve import quantize as tq
from multi_modal_transformers_tokenmerge_torch.serve.policy import (
    PolicyEngine as TEngine)
from multi_modal_transformers_tokenmerge_tpu.serve import quantize as jq
from multi_modal_transformers_tokenmerge_tpu.serve.policy import (
    PolicyEngine as JEngine)

TOL = 2e-5          # float32 towers: summation order only
# serving tolerances of the JAX package's tests (test_quantize.py:110,225,
# test_quantize_image.py:117,189), on the continuous head's actions
SERVE_TOL = {"int8": (0.05, 0.02), "w8": (0.02, 0.01)}
IMAGE_SERVE_ATOL = {"int8": 0.1, "w8": 0.05}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def assert_qtensor(port, ref, perm=None):
    """int8 values equal, scales within 1 ulp."""
    q = _np(port.q)
    if perm is not None:
        q = perm(q)
    np.testing.assert_array_equal(q, np.asarray(ref.q))
    np.testing.assert_array_max_ulp(_np(port.scale),
                                    np.asarray(ref.scale, np.float32), 1)


@pytest.mark.parametrize("shape,seed", [((64, 48), 0), ((768, 24), 1),
                                        ((40, 8), 2)])
def test_quantize_matrix_matches_jax(shape, seed):
    w = np.random.default_rng(seed).normal(0, 0.05, shape).astype(np.float32)
    w[:, 0] = 0.0                      # an all-zero column: the 1e-8 clamp
    assert_qtensor(tq.quantize_matrix(torch.tensor(w)),
                   jq.quantize_matrix(jnp.asarray(w)))


def test_quantize_conv_kernel_matches_jax():
    hwio = np.random.default_rng(3).normal(0, 0.1, (3, 3, 8, 16)).astype(
        np.float32)
    port = tq.quantize_conv_kernel(torch.tensor(hwio.transpose(3, 2, 0, 1)))
    assert_qtensor(port, jq.quantize_conv_kernel(jnp.asarray(hwio)),
                   perm=lambda q: q.transpose(2, 3, 1, 0))


def _int8_pair(rng, k, n):
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    return w, tq.quantize_matrix(torch.tensor(w)), jq.quantize_matrix(
        jnp.asarray(w))


@pytest.mark.parametrize("lead", [(24,), (2, 5)])
def test_int8_matmul_accumulators_match_jax(lead):
    rng = np.random.default_rng(4)
    a = rng.normal(0, 1.0, (*lead, 64)).astype(np.float32)
    _, wt, wj = _int8_pair(rng, 64, 48)
    qa, _ = tq._quant_rows(torch.tensor(a))
    a32 = jnp.asarray(a)
    a_scale = jnp.maximum(jnp.max(jnp.abs(a32), -1, keepdims=True),
                          1e-8) / 127.0
    qa_j = jnp.clip(jnp.round(a32 / a_scale), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(_np(qa), np.asarray(qa_j))
    acc = tq.int_mm(qa.reshape(-1, 64), wt.q)
    acc_j = jax.lax.dot_general(qa_j.reshape(-1, 64), wj.q,
                                (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(_np(acc), np.asarray(acc_j))
    np.testing.assert_array_equal(
        _np(tq.int8_matmul(torch.tensor(a), wt)),
        np.asarray(jq.int8_matmul(a32, wj)))


def test_int8_matmul_tn_accumulators_match_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(0, 1.0, (96, 20)).astype(np.float32)     # (K, N)
    _, wt, wj = _int8_pair(rng, 96, 16)
    qa, scale = tq._quant_act_lanes(torch.tensor(a))
    qa_j, scale_j = jq._quant_act_lanes(jnp.asarray(a))
    np.testing.assert_array_equal(_np(qa), np.asarray(qa_j))
    np.testing.assert_array_equal(_np(scale), np.asarray(scale_j))
    acc = tq.int_mm(qa.t(), wt.q)
    acc_j = jax.lax.dot_general(qa_j, wj.q, (((0,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(_np(acc), np.asarray(acc_j))
    np.testing.assert_array_equal(
        _np(tq.int8_matmul_tn(torch.tensor(a), wt)),
        np.asarray(jq.int8_matmul_tn(jnp.asarray(a), wj)))


@pytest.mark.parametrize("kernel,strides,padding", [
    ((3, 3), (1, 1), "SAME"), ((8, 8), (4, 4), "VALID"),
    ((4, 4), (2, 2), "SAME")])
def test_int8_conv_hwcn_matches_jax(kernel, strides, padding):
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1.0, (17, 17, 8, 6)).astype(np.float32)   # HWCN
    hwio = rng.normal(0, 0.1, (*kernel, 8, 16)).astype(np.float32)
    wt = tq.quantize_conv_kernel(torch.tensor(hwio.transpose(3, 2, 0, 1)))
    wj = jq.quantize_conv_kernel(jnp.asarray(hwio))
    got = tq.int8_conv_hwcn(torch.tensor(x), wt, strides, padding)
    want = jq.int8_conv_hwcn(jnp.asarray(x), wj, strides, padding)
    # equal int32 sums times the same scale products
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    w8 = tq.conv_w8_hwcn(torch.tensor(x), wt, strides, padding,
                         compute_dtype=torch.float32)
    w8_j = jq.conv_w8_hwcn(jnp.asarray(x), wj, strides, padding,
                           compute_dtype=jnp.float32)
    np.testing.assert_allclose(_np(w8), np.asarray(w8_j), rtol=TOL,
                               atol=TOL)


# w8 towers in bfloat16 against the JAX towers run op by op
# (``jax.disable_jit``: jitted, XLA's CPU backend fuses the bf16 elementwise
# ops in float32 and skips roundings the functions write): at most
# BF16_DIFF_SHARE of the elements differ, each by at most BF16_STEP of the
# largest |value| (one bf16 rounding step).  With the products rounded to
# bf16 before the scale, as the port's were, 32-74% of the elements
# differ, by up to 0.0093 (text) and 0.0044 (image) of the largest value.
BF16_DIFF_SHARE, BF16_STEP = 0.01, 2.0 ** -8


@pytest.mark.parametrize("tower", ["text", "image"])
def test_w8_towers_match_jax_in_bfloat16(pair, tower):
    """The w8 products return float32 unrounded, as JAX's
    ``preferred_element_type=float32``: the bf16 towers agree."""
    cfg, jm, v, tm, ids, images = pair
    with jax.disable_jit():
        if tower == "text":
            t = cfg.text
            kw = dict(rel_pos_buckets=t.t5_rel_pos_buckets,
                      rel_pos_max_distance=t.t5_rel_pos_max_distance,
                      mode="w8")
            got = tq.t5_encode_int8(
                tq.quantize_t5_params(tm.text_encoder.t5_encoder),
                torch.tensor(ids, dtype=torch.long), dtype=torch.bfloat16,
                **kw)
            want = jq.t5_encode_int8(
                jq.quantize_t5_params(
                    v["params"]["text_encoder"]["t5_encoder"]),
                jnp.asarray(ids), dtype=jnp.bfloat16, **kw)
        else:
            got = tq.image_embed_w8(tq.quantize_image_tower(tm),
                                    torch.tensor(images), tm.config.images,
                                    dtype=torch.bfloat16)
            want = jq.image_embed_w8(jq.quantize_image_tower(jm, v),
                                     jnp.asarray(images), cfg.images,
                                     dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    got = _np(got.float())
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= BF16_DIFF_SHARE
    assert diff.max() <= BF16_STEP * np.abs(want).max()


def test_w8_product_is_float32_and_unrounded():
    """bf16 operands: the product is float32 and equals the float32
    product of the same values (an int8 kernel is exact in bf16)."""
    rng = np.random.default_rng(10)
    _, wt, _ = _int8_pair(rng, 64, 24)
    a = torch.tensor(rng.normal(0, 1.0, (5, 64)).astype(np.float32)
                     ).bfloat16()
    out = tq.float32_product(a, wt.q.bfloat16())
    assert out.dtype == torch.float32
    assert torch.equal(out, a.float() @ wt.q.float())
    assert tq.W8_PRODUCT_ROUTE in ("mm_out_dtype", "upcast")
    assert tq.matmul_w8(a, wt).dtype == torch.float32


def test_w8_matmuls_match_jax_in_float32():
    rng = np.random.default_rng(7)
    _, wt, wj = _int8_pair(rng, 64, 24)
    a = rng.normal(0, 1.0, (5, 64)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tq.matmul_w8(torch.tensor(a), wt, torch.float32)),
        np.asarray(jq.matmul_w8(jnp.asarray(a), wj, jnp.float32)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        _np(tq.matmul_w8_tn(torch.tensor(a.T), wt, torch.float32)),
        np.asarray(jq.matmul_w8_tn(jnp.asarray(a.T), wj, jnp.float32)),
        rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(_np(tq.dequant(wt, torch.float32)),
                                  np.asarray(jq.dequant(wj, jnp.float32)))


# -- the towers, on a micro Octo with a T5 text tower and two frames ---------

@pytest.fixture(scope="module")
def pair():
    cfg = octo_micro_t5()
    jm, v, tm = micro_pair(cfg)
    rng = np.random.default_rng(8)
    ids = rng.integers(0, cfg.text.vocab_size,
                       (2, cfg.text.max_length)).astype(np.int32)
    images = (rng.random((2, 2, *cfg.images.image_size)) * 255.0).astype(
        np.float32)
    return cfg, jm, v, tm, ids, images


def test_quantize_t5_params_match_jax(pair):
    _, _, v, tm, _, _ = pair
    port = tq.quantize_t5_params(tm.text_encoder.t5_encoder)
    ref = jq.quantize_t5_params(v["params"]["text_encoder"]["t5_encoder"])
    assert len(port["layers"]) == ref["layers"]["qkv"].q.shape[0]
    for i, layer in enumerate(port["layers"]):
        for name in ("qkv", "o", "wi", "wo"):
            r = ref["layers"][name]
            assert_qtensor(layer[name], jq.QTensor(q=r.q[i],
                                                   scale=r.scale[i]))


@pytest.mark.parametrize("mode", ["int8", "w8"])
def test_t5_encode_matches_jax_in_float32(pair, mode):
    cfg, _, v, tm, ids, _ = pair
    t = cfg.text
    kw = dict(rel_pos_buckets=t.t5_rel_pos_buckets,
              rel_pos_max_distance=t.t5_rel_pos_max_distance)
    port = tq.t5_encode_int8(
        tq.quantize_t5_params(tm.text_encoder.t5_encoder),
        torch.tensor(ids, dtype=torch.long), dtype=torch.float32, mode=mode,
        **kw)
    ref = jq.t5_encode_int8(
        jq.quantize_t5_params(v["params"]["text_encoder"]["t5_encoder"]),
        jnp.asarray(ids), dtype=jnp.float32, mode=mode, **kw)
    np.testing.assert_allclose(_np(port), np.asarray(ref), rtol=TOL, atol=TOL)


def test_quantize_image_tower_matches_jax(pair):
    cfg, jm, v, tm, _, _ = pair
    port = tq.quantize_image_tower(tm)
    ref = jq.quantize_image_tower(jm, v)
    oihw = lambda q: q.transpose(2, 3, 1, 0)
    assert_qtensor(port["input_conv"], ref["input_conv"], perm=oihw)
    for pb, rb in zip(port["blocks"], ref["blocks"]):
        assert_qtensor(pb["conv"], rb["conv"], perm=oihw)
    # the dense's rows: the port's (c, h, w) against flax's (h, w, c)
    c = cfg.images.resnet.features
    side = int(round((port["dense"].q.shape[0] // c) ** 0.5))
    chw_to_hwc = lambda q: q.reshape(c, side, side, -1).transpose(
        1, 2, 0, 3).reshape(side * side * c, -1)
    assert_qtensor(port["dense"], ref["dense"], perm=chw_to_hwc)


@pytest.mark.parametrize("mode", ["int8", "w8"])
@pytest.mark.parametrize("frames", [None, 2])
def test_image_embed_matches_jax_in_float32(pair, mode, frames):
    cfg, jm, v, tm, _, images = pair
    imgs = images[:, 0] if frames is None else images
    port_fn = tq.image_embed_int8 if mode == "int8" else tq.image_embed_w8
    jax_fn = jq.image_embed_int8 if mode == "int8" else jq.image_embed_w8
    port = port_fn(tq.quantize_image_tower(tm), torch.tensor(imgs),
                   tm.config.images, dtype=torch.float32)
    ref = jax_fn(jq.quantize_image_tower(jm, v), jnp.asarray(imgs),
                 cfg.images, dtype=jnp.float32)
    np.testing.assert_allclose(_np(port), np.asarray(ref), rtol=TOL, atol=TOL)


def test_factories_match_the_functions(pair):
    cfg, _, _, tm, ids, images = pair
    ids_t, img_t = torch.tensor(ids, dtype=torch.long), torch.tensor(images)
    qp = tq.quantize_image_tower(tm)
    np.testing.assert_array_equal(
        _np(tq.make_int8_image_embedder(tm, torch.float32)(img_t)),
        _np(tq.image_embed_int8(qp, img_t, tm.config.images, torch.float32)))
    np.testing.assert_array_equal(
        _np(tq.make_w8_image_embedder(tm, torch.float32)(img_t)),
        _np(tq.image_embed_w8(qp, img_t, tm.config.images, torch.float32)))
    t = cfg.text
    np.testing.assert_array_equal(
        _np(tq.make_int8_text_encoder(tm, torch.float32)(ids_t)),
        _np(tq.t5_encode_int8(
            tq.quantize_t5_params(tm.text_encoder.t5_encoder), ids_t,
            rel_pos_buckets=t.t5_rel_pos_buckets,
            rel_pos_max_distance=t.t5_rel_pos_max_distance,
            dtype=torch.float32)))
    embed_tm = TOcto(to_torch_config(octo_micro()), device="meta", seed=None)
    with pytest.raises(ValueError, match="t5"):
        tq.make_int8_text_encoder(embed_tm)


# -- the engine --------------------------------------------------------------

def _continuous_pair(pair):
    """The micro pair as continuous-head engines (deterministic actions)."""
    return pair[1], pair[2], pair[3]


@pytest.mark.parametrize("image_tower,text_tower", [
    ("int8", "bf16"), ("w8", "bf16"), ("bf16", "int8"), ("bf16", "w8"),
    ("int8", "w8")])
def test_engine_towers_match_jax_engine(pair, image_tower, text_tower):
    """Same towers, same weights: the port's engine against the JAX engine
    on the continuous head, the instruction cached, float32."""
    jm, v, tm = _continuous_pair(pair)
    _, _, _, _, ids, images = pair
    kw = dict(head="continuous", batch_size=2, image_tower=image_tower,
              text_tower=text_tower)
    port = TEngine(tm, **kw).set_instruction(ids)
    ref = JEngine(jm, v, **kw).set_instruction(ids)
    np.testing.assert_allclose(_np(port(torch.tensor(images))),
                               np.asarray(ref(jnp.asarray(images))),
                               rtol=TOL, atol=TOL)
    # the full path (ids per call) runs the model's own text tower, as JAX
    np.testing.assert_allclose(
        _np(port(torch.tensor(images), text_tokens=ids)),
        np.asarray(ref(jnp.asarray(images), text_tokens=jnp.asarray(ids))),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["int8", "w8"])
def test_quantized_engines_track_the_float_engine(pair, mode):
    """The JAX tests' serving tolerances, held by the port's engines."""
    jm, v, tm = _continuous_pair(pair)
    _, _, _, _, ids, images = pair
    base = TEngine(tm, head="continuous", batch_size=2).set_instruction(ids)
    img = torch.tensor(images)
    a_f = _np(base(img))
    a_t = _np(TEngine(tm, head="continuous", batch_size=2,
                      text_tower=mode).set_instruction(ids)(img))
    rtol, atol = SERVE_TOL[mode]
    np.testing.assert_allclose(a_t, a_f, rtol=rtol, atol=atol)
    a_i = _np(TEngine(tm, head="continuous", batch_size=2,
                      image_tower=mode).set_instruction(ids)(img))
    assert np.max(np.abs(a_i - a_f)) < IMAGE_SERVE_ATOL[mode]


@pytest.mark.parametrize("mode", ["int8", "w8"])
def test_quantized_diffusion_engine_compiled_equals_eager(pair, mode):
    """The diffusion head through the quantized towers: ``compile`` (the
    serving copy on the CPU) gives the eager call's actions on the same
    draws, and the cached path equals the full one given the same text."""
    _, _, tm = _continuous_pair(pair)
    _, _, _, _, ids, images = pair
    img = torch.tensor(images)
    eng = TEngine(tm, batch_size=2, image_tower=mode, text_tower=mode)
    eager = eng(img, text_tokens=ids, noisy=torch.zeros(2, 4))
    eng.compile(ids.shape[1:], images.shape[1:])
    compiled = eng(img, text_tokens=ids, noisy=torch.zeros(2, 4))
    np.testing.assert_array_equal(_np(compiled), _np(eager))
    emb = tm.encode_text(torch.tensor(ids, dtype=torch.long))
    g = torch.Generator().manual_seed(1)
    noise = torch.randn(32, 2, 4, generator=g)
    np.testing.assert_array_equal(
        _np(eng(img, text_embeddings=emb, noisy=torch.zeros(2, 4),
                noise=noise)),
        _np(eng(img, text_tokens=ids, noisy=torch.zeros(2, 4), noise=noise)))


def test_engine_rejects_unknown_and_non_t5_towers(pair):
    _, _, tm = _continuous_pair(pair)
    with pytest.raises(ValueError, match="image_tower"):
        TEngine(tm, image_tower="fp8")
    with pytest.raises(ValueError, match="text_tower"):
        TEngine(tm, text_tower="int4")
    embed_tm = TOcto(to_torch_config(octo_micro()), device="cpu", seed=0)
    with pytest.raises(ValueError, match="t5"):
        TEngine(embed_tm, head="continuous", text_tower="int8")
    with pytest.raises(ValueError, match="mode"):
        tq.t5_encode_int8(tq.quantize_t5_params(tm.text_encoder.t5_encoder),
                          torch.zeros(1, 4, dtype=torch.long), mode="fp4")


def test_int_mm_pads_what_the_card_refuses():
    """The operands ``int_mm`` hands ``torch._int_mm`` on the card (``a``
    row-major; rows <= 16, K or N not a multiple of 8 padded with zeros)
    meet its rules and leave the sums unchanged, checked here with the
    CPU's product."""
    rng = np.random.default_rng(9)
    a = torch.tensor(rng.integers(-127, 128, (16, 12)), dtype=torch.int8)
    b = torch.tensor(rng.integers(-127, 128, (12, 20)), dtype=torch.int8)
    want = _np(a.long() @ b.long())
    pa, pb = tq.card_operands(a, b)
    assert pa.shape[0] > 16 and pa.shape[1] % 8 == 0 and pb.shape[1] % 8 == 0
    assert tq.card_operands(a.t().contiguous().t(), b)[0].is_contiguous()
    np.testing.assert_array_equal(_np(torch._int_mm(pa, pb)[:16, :20]), want)
    np.testing.assert_array_equal(_np(tq.int_mm(a, b)), want)
    big = torch.tensor(rng.integers(-127, 128, (24, 16)), dtype=torch.int8)
    narrow = big[:, :8]
    assert all(x is y for x, y in zip(tq.card_operands(big, narrow),
                                      (big, narrow)))
