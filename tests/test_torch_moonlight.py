"""The latent-attention / routed-expert stack of the port (the
``octo_moonlight`` preset's transformer) against the plain float32
reference ``tests/moonlight_reference.py``, seeded and at a small size on
the CPU: hidden 64, 4 heads of qk 16 + 8 and v 16, kv_lora_rank 32, 8
experts of which 2 a token plus 1 shared, 3 blocks (the first dense) in
stages of one block with a ToMe merge between stages.

Tolerances.  The port runs here in float32 (parameters and compute), the
reference in float32 too; the two differ by the order of float32 sums (the
flash path's tiles and online softmax, the grouped layout's products), a
few float32 ulps a product carried through 3 blocks.  Each limit is below
what one bfloat16 rounding of the operands moves the same output (2^-8 of
its scale and more; ``test_limits_fail_a_bfloat16_route`` shows the
reference itself, fed bfloat16-rounded weights, fails them).

Also here: the benchmark's configurations still resolve to the models their
files state, and the parameter counts of the existing presets, which set
their cells' memory, are unchanged; the serving copy holds one copy of a
bfloat16 model's weights and the float32 models' copies as before.
"""

import dataclasses
import json
import weakref
from pathlib import Path

import pytest
import torch

import moonlight_reference as R
from multi_modal_transformers_tokenmerge_torch import Octo, load_config
from multi_modal_transformers_tokenmerge_torch.core.config import (
    AttentionConfig, DiffusionHeadConfig, HeadsConfig, ImageTokenizerConfig,
    LatentMoETransformerConfig, MoEConfig, OctoConfig, ResNetEmbedderConfig,
    TextEncoderConfig)
from multi_modal_transformers_tokenmerge_torch.models.octo import (
    TokenEmbeddings)
from multi_modal_transformers_tokenmerge_torch.models.presets import PRESETS
from multi_modal_transformers_tokenmerge_torch.modules import latent_moe
from multi_modal_transformers_tokenmerge_torch.modules.latent_moe import (
    rope_angles)
from multi_modal_transformers_tokenmerge_torch.modules.tome_stack import (
    _merge_sets)
from multi_modal_transformers_tokenmerge_torch.ops.grouped_experts import (
    grouped_experts, grouped_experts_reference, route, sort_pairs, tile_plan)
from multi_modal_transformers_tokenmerge_torch.serve import policy
from multi_modal_transformers_tokenmerge_torch.serve.policy import (
    PolicyEngine, serving_copy)
from multi_modal_transformers_tokenmerge_torch.utils.profiling import REGISTRY

REPO = Path(__file__).resolve().parents[1]
# float32 against float32: a few ulps of sums in another order, carried
# through the blocks; a bfloat16 rounding moves these outputs by 1e-3 and
# more of their scale
TOL_BLOCK = 1e-5
TOL_STACK = 5e-5


def micro(**kw) -> OctoConfig:
    cfg = OctoConfig(
        input_sequence="[TaskDescriptionPrefix{4}] [Image{16};Readout{2}]*2",
        compression_sequence=(
            "[TaskDescriptionPrefix{0}] [Image{2};Readout{0}]*2"),
        token_embedding_dim=64, num_observation_blocks=2,
        tokens_per_readout=2,
        text=TextEncoderConfig(kind="t5", vocab_size=64, max_length=4,
                               embedding_dim=32, t5_num_layers=1,
                               t5_num_heads=2, t5_d_ff=64, t5_d_kv=16),
        images=ImageTokenizerConfig(
            image_size=(64, 64, 3), patch_size=16, position_interval=16,
            embedding_dim=64,
            resnet=ResNetEmbedderConfig(num_blocks=1, features=8,
                                        input_kernel=(8, 8),
                                        input_stride=(4, 4),
                                        group_norm_groups=4,
                                        output_features=64)),
        transformer=LatentMoETransformerConfig(
            num_blocks=3,
            attention=AttentionConfig(num_heads=4, qkv_features=64,
                                      dropout_rate=0.0, use_bias=False),
            mlp_dim=96, mlp_activation="silu", dropout_rate=0.0,
            attention_impl="flash", compression_mode="merge",
            tome_merge_every=1, final_norm=True, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            moe_intermediate_size=32, n_routed_experts=8,
            num_experts_per_tok=2, n_shared_experts=1),
        heads=HeadsConfig(diffusion=DiffusionHeadConfig(
            diffusion_steps=4, action_space_dim=4, time_dim=16,
            mlp_dim=32)))
    return cfg.replace(**kw)


def _model(seed=0, **kw):
    model = Octo(micro(**kw), device="cpu", seed=seed)
    # random norm scales and selection biases, so that every weight counts
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model.eval()


def _rel(got, want):
    return ((got - want).norm() / want.norm()).item()


def _tcfg(model):
    return dataclasses.asdict(model.config.transformer)


def _inputs(seed, batch=2):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 64, (batch, 4), generator=g)
    images = torch.randint(0, 256, (batch, 2, 64, 64, 3), generator=g,
                           dtype=torch.uint8)
    return ids, images


def _stack_io(model, seed):
    """The assembled tokens of a batch, and the stack's output."""
    ids, images = _inputs(seed)
    with torch.no_grad():
        text = model.encode_text(ids)
        img = model.image_encoder(images)
        x = model.assemble_embeddings(TokenEmbeddings(
            text=text, images=img,
            readouts=model.readout_encoder(images.shape[0])))
        return x, model.transformer(x)


def _layout_args(model):
    lay = model.layout
    stages = model.transformer.num_stages
    masks = [torch.as_tensor(lay.attention_mask(s)) for s in range(stages)]
    counts = [lay.set_counts_at_layer(s) for s in range(stages)]
    sets = [list(c) for c in zip(*counts)]
    return masks, sets


# -- latent attention ---------------------------------------------------------

@pytest.mark.parametrize("flash", [True, False])
def test_latent_attention_matches_reference(flash):
    """One block's attention at fractional positions (as after a merge),
    under a block-causal mask, on the flash path and the plain one."""
    model = _model(3)
    attn = model.transformer.stage_0[0].attention
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 40, 64, generator=g)
    positions = torch.rand(2, 40, generator=g) * 40
    mask = torch.as_tensor(model.layout.attention_mask(0))
    cos, sin = rope_angles(positions[..., None], 8, 50000.0)
    fn = model.transformer.attention_fns[0] if flash else None
    assert (fn is not None) == flash
    with torch.no_grad():
        got = attn(x, cos, sin, mask, fn)
    w = R.float32_weights(model)
    want = R.latent_attention(x, w, "transformer.stage_0.0.attention.",
                              _tcfg(model), positions, mask)
    assert _rel(got, want) < TOL_BLOCK


def test_rope_turns_interleaved_pairs_by_position():
    """A rotation: norms kept, and q.k depends on the difference of the
    positions alone."""
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 1, 1, 8, generator=g).unbind(0)
    dots = []
    for shift in (0.0, 7.5):
        pos = torch.tensor([[[3.0 + shift], [11.0 + shift]]])
        cos, sin = rope_angles(pos, 8, 50000.0)
        qr = latent_moe.apply_rope(q.expand(1, 2, 1, 8), cos, sin)
        kr = latent_moe.apply_rope(k.expand(1, 2, 1, 8), cos, sin)
        assert torch.allclose(qr.norm(dim=-1), q.norm(dim=-1).expand(1, 2, 1))
        dots.append((qr[0, 0] * kr[0, 1]).sum())
        ref = R.rope(q.expand(1, 2, 1, 8), pos[..., 0], 50000.0)
        assert torch.allclose(qr, ref, atol=1e-6)
    assert torch.allclose(dots[0], dots[1], atol=1e-5)


# -- router -------------------------------------------------------------------

def test_router_bias_chooses_and_weighs_nothing():
    g = torch.Generator().manual_seed(1)
    scores = torch.sigmoid(torch.randn(32, 8, generator=g))
    bias = torch.zeros(8)
    bias[7] = 10.0                   # expert 7 always chosen
    w, e = route(scores, bias, 2, 2.446)
    assert (e[:, 0] == 7).all()
    # the weights are the chosen scores, normalised, times the scale
    chosen = torch.gather(scores, 1, e)
    assert torch.allclose(w, chosen / chosen.sum(-1, keepdim=True) * 2.446)
    assert torch.allclose(w.sum(-1), torch.full((32,), 2.446))
    wr, er = R.route(torch.logit(scores), torch.eye(8), bias, 2, 2.446)
    assert torch.equal(e, er) and torch.allclose(w, wr, atol=1e-6)


def test_router_ties_go_to_the_lower_index():
    scores = torch.full((3, 8), 0.5)
    bias = torch.tensor([0.0, 0.1, 0.0, 0.1, 0.0, 0.0, 0.1, 0.0])
    _, e = route(scores, bias, 4, 1.0)
    assert e.tolist() == [[1, 3, 6, 0]] * 3
    _, er = R.route(torch.zeros(3, 8), torch.zeros(8, 8), bias, 4, 1.0)
    assert torch.equal(e, er)


# -- the dropless layer -------------------------------------------------------

def _experts_case(seed, t=24, d=64, f=32, e=8, k=2, routing="random"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, d, generator=g)
    wgu = torch.randn(e, 2 * f, d, generator=g) / d ** 0.5
    wd = torch.randn(e, d, f, generator=g) / f ** 0.5
    shared = torch.randn(t, d, generator=g)
    if routing == "random":
        experts = torch.stack([torch.randperm(e, generator=g)[:k]
                               for _ in range(t)])
    elif routing == "empty_and_full":
        # expert 0 holds every token, experts 5-7 none
        others = torch.stack([torch.randperm(4, generator=g)[:k - 1] + 1
                              for _ in range(t)])
        experts = torch.cat([torch.zeros(t, 1, dtype=torch.long), others], 1)
    else:                                  # one expert, every choice
        experts = torch.zeros(t, k, dtype=torch.long)
        experts[:, 1:] = torch.arange(1, k)
    weights = torch.rand(t, k, generator=g)
    return x, wgu, wd, weights, experts, shared


@pytest.mark.parametrize("routing", ["random", "empty_and_full", "single"])
def test_dropless_plain_path_matches_per_expert_loop(routing):
    x, wgu, wd, weights, experts, shared = _experts_case(2, routing=routing)
    got = grouped_experts(x, wgu, wd, weights, experts, shared)
    want = shared.clone()
    for e in range(wgu.shape[0]):
        for t, slot in (experts == e).nonzero().tolist():
            want[t] += weights[t, slot] * R.swiglu(x[t], wgu[e], wd[e])
    assert _rel(got, want) < TOL_BLOCK
    assert torch.equal(got, grouped_experts_reference(x, wgu, wd, weights,
                                                      experts, shared))


def test_routed_layer_matches_reference():
    model = _model(4)
    moe = model.transformer.stage_1[0].moe
    g = torch.Generator().manual_seed(8)
    x = torch.randn(30, 64, generator=g)
    before = REGISTRY.counters["moe.plain"]
    with torch.no_grad():
        got = moe(x)
    assert REGISTRY.counters["moe.plain"] == before + 1
    want = R.routed_layer(x, R.float32_weights(model),
                          "transformer.stage_1.0.moe.", _tcfg(model))
    assert _rel(got, want) < TOL_BLOCK


@pytest.mark.parametrize("routing", ["random", "empty_and_full", "single"])
def test_pair_layout_and_tile_plan(routing):
    """The sorted layout groups pairs by expert, stable by token; the tile
    plan covers every expert's rows in tiles of at most ``block``, and its
    grid bounds any routing."""
    experts = _experts_case(3, t=40, routing=routing)[4]
    lay = sort_pairs(experts, 8)
    flat = experts.reshape(-1)
    assert torch.equal(flat[lay.order], flat[lay.order].sort().values)
    assert torch.equal(lay.order[lay.inverse.long()], torch.arange(80))
    counts = torch.bincount(flat, minlength=8)
    assert lay.offsets.tolist() == [0] + counts.cumsum(0).tolist()
    assert torch.equal(lay.tokens.long(), lay.order // 2)
    block = 16
    tile_expert, tile_row = tile_plan(lay.offsets, 80, block)
    assert tile_expert.numel() == 5 + 8
    covered = []
    for e, r in zip(tile_expert.tolist(), tile_row.tolist()):
        if e < 8:
            end = lay.offsets[e + 1].item()
            assert lay.offsets[e].item() <= r < end
            covered += list(range(r, min(r + block, end)))
    assert covered == list(range(80))


# -- merges carry the positions -----------------------------------------------

def test_positions_carried_through_a_merge():
    model = _model(6)
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 40, 64, generator=g)
    size = torch.ones(2, 40, 1)
    pos = torch.arange(40, dtype=torch.float32).expand(2, 40)[..., None]
    nx, nsize, npos = _merge_sets(x, size, x, model.layout, 0, pos)
    assert nx.shape[1] == npos.shape[1] == 36
    plain = _merge_sets(x, size, x, model.layout, 0)
    assert torch.equal(plain[0], nx) and torch.equal(plain[1], nsize)
    _, sets = _layout_args(model)
    parts, cur = [], 0
    for counts in sets:
        n, r = counts[0], counts[0] - counts[1]
        piece = (x[:, cur:cur + n], size[:, cur:cur + n],
                 pos[:, cur:cur + n, 0])
        parts.append(R.merge(*piece, r)[2] if r else piece[2])
        cur += n
    want = torch.cat(parts, 1)
    assert torch.allclose(npos[..., 0], want, atol=1e-5)
    # two tokens merged: a position between those they stand for
    assert not torch.equal(npos[..., 0], npos[..., 0].round())


# -- the stack and the policy -------------------------------------------------

def test_stack_matches_reference():
    model = _model(7)
    x, got = _stack_io(model, 11)
    masks, sets = _layout_args(model)
    with R.exact_float32():
        want = R.stack(x, R.float32_weights(model), _tcfg(model), masks,
                       sets)
    assert got.shape == want.shape == (2, 32, 64)
    assert _rel(got, want) < TOL_STACK


def test_limits_fail_a_bfloat16_route():
    """The reference fed bfloat16-rounded weights moves the stack's output
    by more than ``TOL_STACK``: the tolerance would catch a bfloat16
    route."""
    model = _model(7)
    x, _ = _stack_io(model, 11)
    masks, sets = _layout_args(model)
    w = R.float32_weights(model)
    half = {k: v.bfloat16().float() for k, v in w.items()}
    a = R.stack(x, w, _tcfg(model), masks, sets)
    b = R.stack(x.bfloat16().float(), half, _tcfg(model), masks, sets)
    assert _rel(b, a) > 20 * TOL_STACK


def test_policy_actions_match_reference():
    """The whole policy through the compiled engine path (here eager) against
    the benchmark's plain reference of the policy, with the same noise."""
    import sys
    sys.path.insert(0, str(REPO))
    from portbench.reference.moonlight import MoonlightReference
    model = _model(12)
    ids, images = _inputs(13)
    cfg = json.loads(json.dumps(dataclasses.asdict(model.config)))
    weights = {k: v.detach() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(14)
    noisy = torch.randn(2, 4, generator=g)
    noise = torch.randn(4, 2, 4, generator=g)
    engine = PolicyEngine(model, batch_size=2, seed=0)
    engine.set_instruction(ids)
    engine.compile((4,), images.shape[1:])
    got = engine(images, noisy=noisy, noise=noise)
    ref = MoonlightReference(cfg, weights, "cpu")
    with torch.no_grad():
        text = ref.encode_text(ids)
        want = ref.policy(text, images, noisy, noise)
    # the actions pass through the 4-step loop, which may clip: compare all
    assert _rel(got, want) < TOL_STACK


def test_check_divides_by_the_bfloat16_witness():
    """The cell's compared number is the program's error against the float32
    reference over the error of the reference itself with every product's
    operands cast to bfloat16 (a plain cast: the configuration's precision)
    on the same rows."""
    import sys
    sys.path.insert(0, str(REPO))
    from portbench.drivers.fleet_tick_bf16 import Workload
    from portbench.reference.moonlight import MoonlightReference
    want = torch.tensor([[3.0, 4.0], [0.0, 1.0]])
    witness = want + torch.tensor([[0.0, 0.1], [0.0, 0.0]])
    got = want + torch.tensor([[0.3, 0.0], [0.0, 0.0]])
    ratio = Workload.compared_to_witness(got, want, witness)
    assert ratio == {"actions_err_over_bf16": pytest.approx(3.0)}
    ref = MoonlightReference.__new__(MoonlightReference)
    ref.operands = torch.bfloat16
    x = torch.randn(64, generator=torch.Generator().manual_seed(0)) * 1e3
    assert torch.equal(ref.q(x), x.bfloat16().float())


def test_engine_counts_the_plain_route():
    model = _model(1)
    ids, images = _inputs(2)
    REGISTRY.counters.clear()
    engine = PolicyEngine(model, batch_size=2, seed=0)
    engine.set_instruction(ids)
    engine.compile((4,), images.shape[1:])
    # two paths' warm-up runs, two routed blocks each
    assert REGISTRY.counters["moe.plain"] == 4
    assert REGISTRY.counters["moe.grouped_kernel"] == 0


# -- configurations and memory ------------------------------------------------

BENCH_CONFIGS = sorted((REPO / "portbench" / "configs").glob("*.json"))


@pytest.mark.parametrize("path", BENCH_CONFIGS, ids=lambda p: p.stem)
def test_benchmark_configurations_resolve_to_their_files(path):
    c = json.loads(path.read_text())
    cfg = load_config(c["preset"], c["overrides"])
    assert json.loads(json.dumps(dataclasses.asdict(cfg))) == c["model"]


@pytest.mark.parametrize("name,count", [("octo_deep", 200_147_664),
                                        ("octo_base_chunk28", 145_032_932)])
def test_existing_presets_keep_their_parameter_count(name, count):
    c = json.loads((REPO / "portbench" / "configs" / f"{name}.json")
                   .read_text())
    model = Octo(load_config(c["preset"], c["overrides"]), device="meta",
                 seed=None)
    assert sum(p.numel() for p in model.parameters()) == count


def test_moonlight_preset_at_its_published_widths():
    cfg = load_config("octo_moonlight")
    assert cfg == PRESETS["octo_moonlight"]()
    model = Octo(cfg, device="meta", seed=None)
    stack = {n: p for n, p in model.named_parameters()
             if n.startswith("transformer.")}
    assert sum(p.numel() for p in stack.values()) == 15_289_021_568
    layer = lambda pre: sum(p.numel() for n, p in stack.items()
                            if n.startswith(pre))
    assert layer("transformer.stage_0.0.") == 82_973_184
    assert layer("transformer.stage_0.1.") == 584_847_936
    assert layer("transformer.stage_0.1.moe.w_") == 553_648_128
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


@pytest.mark.parametrize("field,value", [
    ("moe", MoEConfig(num_experts=64)), ("mlp_type", "moe"),
    ("dropout_rate", 0.1), ("layer_norm_epsilon", 1e-5),
    ("mlp_activation", "gelu"), ("remat", True),
    ("attention.use_bias", True), ("attention.dropout_rate", 0.1)])
def test_stack_refuses_a_setting_it_does_not_read(field, value):
    """A base field of TransformerConfig that the latent stack never reads
    can hold only the value the stack computes: another would be a knob with
    no effect."""
    t = micro().transformer
    if field.startswith("attention."):
        t = t.replace(attention=t.attention.replace(
            **{field.split(".")[1]: value}))
    else:
        t = t.replace(**{field: value})
    with pytest.raises(ValueError, match=field.split(".")[-1]):
        Octo(micro(transformer=t), device="cpu", seed=0)


def _bytes(module, exclude=()):
    seen = {t.data_ptr() for t in exclude}
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers())
               if t.data_ptr() not in seen)


def test_serving_copy_of_bfloat16_parameters_shares_their_storage():
    model = _model(0, dtype="bfloat16", param_dtype="bfloat16")
    model.requires_grad_(True)
    copy_ = serving_copy(model)
    pairs = list(zip(model.parameters(), copy_.parameters()))
    assert all(a.data_ptr() == b.data_ptr() and a is not b for a, b in pairs)
    assert not any(p.requires_grad for p in copy_.parameters())
    assert all(p.requires_grad for p in model.parameters())
    # the copy's own bytes are its buffers (masks, positions) alone
    assert _bytes(copy_, exclude=list(model.parameters())) == sum(
        b.numel() * b.element_size() for b in copy_.buffers())


def test_serving_copy_of_float32_parameters_is_its_own():
    """float32 parameters served in bfloat16 (the existing cells): the copy
    holds every parameter apart, the cast ones in bfloat16, as before."""
    model = _model(0, dtype="bfloat16")
    copy_ = serving_copy(model)
    ptrs = {p.data_ptr() for p in model.parameters()}
    assert not any(p.data_ptr() in ptrs for p in copy_.parameters())
    want = sum(p.numel() * (2 if any(
        p is getattr(m, n, None) for m in model.modules()
        for n in getattr(m, "CAST_PARAMS", ())) else 4)
        for p in model.parameters())
    assert sum(p.numel() * p.element_size()
               for p in copy_.parameters()) == want


def test_serving_copy_frees_each_float32_copy_as_it_is_cast(monkeypatch):
    """The copy's float32 deep copies of the cast parameters die one by one
    as each is cast, so the float32 copies and the bfloat16 casts together
    never hold more than one copy of the weights and one cast (a memo held
    past the deep copy would keep every float32 copy alive to the end: a
    second, bfloat16 copy of the weights at the peak)."""
    model = _model(0, dtype="bfloat16")
    cast = sum(1 for m in model.modules()
               for n in getattr(m, "CAST_PARAMS", ())
               if getattr(m, n, None) is not None)
    kept = sum(1 for _ in model.parameters()) - cast
    copies, alive, depth = [], [], []
    deepcopy = policy.copy.deepcopy

    def recording_deepcopy(x, memo=None, *rest):
        # ``copy.deepcopy`` calls itself on every part: record the whole
        depth.append(x)
        try:
            out = deepcopy(x, memo, *rest)
        finally:
            depth.pop()
        if not depth:
            copies.extend(weakref.ref(p) for p in out.parameters())
        return out

    parameter = torch.nn.Parameter

    def counting_parameter(data, requires_grad=True):
        alive.append(sum(r() is not None and r().dtype == torch.float32
                         for r in copies))
        return parameter(data, requires_grad)

    monkeypatch.setattr(policy.copy, "deepcopy", recording_deepcopy)
    monkeypatch.setattr(policy.nn, "Parameter", counting_parameter)
    serving_copy(model)
    # one float32 copy fewer at every cast, down to the uncast ones and the
    # one being cast
    assert alive == list(range(kept + cast, kept, -1))
