"""Training on sharded parameters: the port's ``make_train_step``, ``fit``,
``evaluate``, AdamW, checkpoints and serving on a model that
``parallel.mesh.shard_params`` sharded (tensor parallel, FSDP, expert
parallel), against the JAX package on the CPU.

The JAX side runs its step on the virtual CPU mesh (the first 2 devices,
``param_shardings`` at the same mesh shape): ``jax.value_and_grad`` of the
train loss under ``jit`` on the sharded parameters, with numpy draws
injected into both packages, then an SGD update.  The TP x FSDP case at
(2, 2) is held against the JAX one-device step instead: on the virtual
mesh that step, with the image tower's input convolution kernel sharded
over ``data`` beside a model axis, gives another loss (4.53 against
4.81 here) than the same step unsharded or at (2, 1), a fault of that run,
not of the semantics.  Everything that needs more than one rank runs in
two launches (2 and 4 gloo ranks, ``torch_dist.launch``) and each check
reads its result.

Tolerances are the JAX tests' (``tests/test_parallel.py``): loss rtol
2e-5, parameters after an SGD step 2e-4 / 1e-5, the tensor-parallel
forward 2e-5 / 1e-6.  Gradients, and the AdamW moments beside the
one-process ones, are held as the port's whole-model gradient tests hold
theirs (``test_torch_train._assert_grads_close``; ``test_torch_moe``'s
stacks): each leaf within 1e-4 of its largest |value|.  Steps with dropout
0.1 (the attention's in the flash kernels' plain versions, with their head
offset) are held against the port's one-process step at the same
tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from test_torch_moe import _moe
from test_torch_train import (_assert_grads_close, _draws, _inject_jax,
                              _no_dropout)
from torch_dist import launch, results
from torch_dist_workers import FSDP_MIN_SIZE, SGD
from torch_parity import (inputs, micro_pair, octo_micro_t5,
                          octo_micro_tome_layers, octo_micro_tome_staged,
                          to_torch_config)
from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_torch.modules.attention import (
    capture_intermediates)
from multi_modal_transformers_tokenmerge_torch.modules.layers import dropout
from multi_modal_transformers_tokenmerge_torch.ops import flash_attention as fa
from multi_modal_transformers_tokenmerge_torch.serve.policy import (
    PolicyEngine)
from multi_modal_transformers_tokenmerge_torch.train import loop as tloop
from multi_modal_transformers_tokenmerge_torch.train import state as tstate
from multi_modal_transformers_tokenmerge_torch.train import steps as tsteps
from multi_modal_transformers_tokenmerge_torch.train.optim import (
    make_optimizer)
from multi_modal_transformers_tokenmerge_tpu.modules import moe as jmoe
from multi_modal_transformers_tokenmerge_tpu.parallel import mesh as jmesh

LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-5
FWD_RTOL, FWD_ATOL = 2e-5, 1e-6
SERVE_TOL = 1e-5
LR = 1e-2
B = 4


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


# -- the head offset of the flash kernels' dropout, in process -------------------

def _flash_inputs(heads, d=16, s=40, b=2, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(rng.normal(size=(b, s, heads, d)),
                                dtype=torch.float32) for _ in range(4))
    mask = np.tril(np.ones((s, s), bool)) | (rng.random((s, s)) < 0.3)
    mask_i8, k_hi, q_lo = (torch.as_tensor(a) for a in
                           fa.mask_tables(mask, 16, 16))
    seed_words = torch.tensor([12345, 678], dtype=torch.int64)
    return q, k, v, do, mask_i8, k_hi, q_lo, seed_words


@pytest.mark.parametrize("h0,n", [(0, 2), (2, 2), (1, 3), (3, 1)])
def test_head_slice_equals_the_whole_heads(h0, n):
    """The plain forward with LSE, dq and dk/dv on heads [h0, h0 + n) of
    four, with the head offset, equal those heads of the whole-head call
    bit for bit, dropout 0.1 on."""
    q, k, v, do, mask_i8, k_hi, q_lo, seed = _flash_inputs(4)
    kw = dict(block_q=16, block_k=16, dropout_rate=0.1, b0=1)
    out, lse = fa.flash_fwd_lse(q, k, v, mask_i8, k_hi, seed, **kw)
    delta = fa.attention_delta(do, out, mask_i8.shape[0])
    dq = fa.flash_dq(q, k, v, do, lse, delta, mask_i8, k_hi, seed, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, mask_i8, q_lo, seed,
                          **kw)
    cut = lambda x: x[:, :, h0:h0 + n].contiguous()
    part = dict(kw, h0=h0, heads_total=4)
    out_s, lse_s = fa.flash_fwd_lse(cut(q), cut(k), cut(v), mask_i8, k_hi,
                                    seed, **part)
    assert torch.equal(out_s, cut(out))
    assert torch.equal(lse_s, lse[:, h0:h0 + n])
    lse_c, delta_c = (x[:, h0:h0 + n].contiguous() for x in (lse, delta))
    args = (cut(q), cut(k), cut(v), cut(do), lse_c, delta_c, mask_i8)
    assert torch.equal(fa.flash_dq(*args, k_hi, seed, **part), cut(dq))
    dk_s, dv_s = fa.flash_dkv(*args, q_lo, seed, **part)
    assert torch.equal(dk_s, cut(dk)) and torch.equal(dv_s, cut(dv))


def test_head_offset_places_the_philox_counter():
    """The keep bits of heads [h0, h0 + n) of H_total at rows b0.. are
    those of the whole call at counter (b0 + b) H_total + h0 + h; at
    h0 = 0 and H_total = H the mask is the one without the offset."""
    seed = torch.tensor([7, 9], dtype=torch.int64)
    idx = torch.arange(12)
    whole = fa.dropout_keep_mask(seed, 3, 6, idx, idx, 0.3)
    for b0, h0, n in ((0, 2, 3), (1, 4, 2), (2, 0, 6)):
        part = fa.dropout_keep_mask(seed, 3 - b0, n, idx, idx, 0.3, b0=b0,
                                    h0=h0, heads_total=6)
        assert torch.equal(part, whole[b0:, h0:h0 + n])
    assert torch.equal(
        fa.dropout_keep_mask(seed, 2, 6, idx, idx, 0.3, b0=1, h0=0,
                             heads_total=6),
        fa.dropout_keep_mask(seed, 2, 6, idx, idx, 0.3, b0=1))
    with pytest.raises(ValueError, match="outside"):
        fa._launch_tail((1, 8, 4, 64, 64, 1, 1.0, 1.0, 0, 1, None),
                        torch.zeros(1), None, 0, 3, 6)


def test_dropout_cut_draws_the_whole_mask():
    """A dropout of a cut (a rank's heads or columns) keeps the cut of
    the whole tensor's mask, and draws as much from the generator."""
    x = torch.ones(2, 6, 5)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    whole = dropout(x, 0.5, True, g1)
    part = dropout(x[:, 2:4], 0.5, True, g2, cut=(1, 2, 6))
    assert torch.equal(part, whole[:, 2:4])
    assert torch.equal(torch.rand(3, generator=g1),
                       torch.rand(3, generator=g2))


def test_parameter_names_drop_the_parametrization():
    from multi_modal_transformers_tokenmerge_torch.core.tensor_parallel import (
        param_name as name)
    assert name("a.b.parametrizations.weight.original") == "a.b.weight"
    assert name("parametrizations.weight.original") == "weight"
    assert name("a.parametrizations_x.weight") == "a.parametrizations_x.weight"


# -- many ranks ----------------------------------------------------------------

def _jax_step(jm, v_params, mesh_shape, fsdp, ids, images, actions, d,
              total):
    """The JAX package's train loss and gradients under jit on the first
    devices of the virtual mesh, with the parameters placed by its
    ``param_shardings`` (``mesh_shape`` None: one device); then an SGD
    update.  (loss, parameters, gradients) as numpy."""
    if mesh_shape is None:
        params = v_params
        put = jnp.asarray
    else:
        n = mesh_shape[0] * mesh_shape[1]
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(mesh_shape),
                    ("data", "model"))
        params = jax.device_put(v_params, jmesh.param_shardings(
            v_params, mesh, model_parallel=True, fsdp=fsdp,
            fsdp_min_size=FSDP_MIN_SIZE))
        rows = NamedSharding(mesh, P("data"))
        put = lambda x: jax.device_put(jnp.asarray(x), rows)
    ids, images, actions = (put(x) for x in (ids, images, actions))
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        loss, mut = jm.apply(
            {"params": p}, ids, images, actions, train=True,
            rngs={"dropout": key, "patch_encoding": key, "diffusion": key},
            method="compute_l2_loss", mutable=["losses"])
        loss = jnp.mean(loss)
        return loss + jmoe.moe_aux_loss(mut) if total else loss

    with pytest.MonkeyPatch.context() as mp:
        queues = _inject_jax(mp, d, diffusion=False)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    assert not any(queues.values()), "a JAX draw was not consumed"
    grads = jax.tree.map(np.asarray, grads)
    new = jax.tree.map(lambda p, g: np.asarray(p) - LR * g, v_params, grads)
    return float(loss), new, grads


# name -> (JAX config, mesh shape, fsdp, JAX mesh shape of the reference)
SGD_CASES = {
    "tp": (lambda: _no_dropout(octo_micro_t5()), (1, 2), False, (1, 2)),
    "fsdp": (lambda: _no_dropout(octo_micro_t5()), (2, 1), True, (2, 1)),
    "ep": (lambda: _no_dropout(_moe(octo_micro_t5)), (1, 2), False, (1, 2)),
    "tome_layers_merge": (lambda: _no_dropout(octo_micro_tome_layers()),
                          (1, 2), False, (1, 2)),
    "tome_layers_prune": (lambda: _no_dropout(octo_micro_tome_layers(
        compression_mode="prune", prestack_merge=True)), (1, 2), False,
        (1, 2)),
    "tome_staged": (lambda: _no_dropout(octo_micro_tome_staged()), (1, 2),
                    False, (1, 2)),
    "tp_fsdp": (lambda: _no_dropout(octo_micro_t5()), (2, 2), True, None),
}
# the port's configuration beside the JAX one (the JAX side runs its
# plain attention)
PORT_ATTENTION = {"tome_staged": dict(attention_impl="flash",
                                      flash_backward="pallas")}


def _flash_cfg(jcfg):
    tc = to_torch_config(jcfg)
    return tc.replace(transformer=tc.transformer.replace(
        attention_impl="flash", flash_backward="pallas"))


# name -> (port config with every dropout at 0.1, mesh shape, fsdp)
DROP_CASES = {
    "tp": (lambda: _flash_cfg(octo_micro_t5()), (1, 2), False),
    "tome_layers": (lambda: to_torch_config(octo_micro_tome_layers()),
                    (1, 2), False),
    "tome_staged": (lambda: _flash_cfg(octo_micro_tome_staged()), (1, 2),
                    False),
    "tp_fsdp": (lambda: _flash_cfg(octo_micro_t5()), (2, 2), True),
}


def _port(cfg, state):
    m = TOcto(cfg, device="cpu", seed=None)
    m.load_state_dict(state)
    return m


def _whole_params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _batch(jcfg, seed):
    ids, images = inputs(jcfg, batch=B, frames=2, seed=seed)
    actions = np.random.default_rng(seed + 1).uniform(
        -1, 1, (B, 4)).astype(np.float32)
    return ids, images, actions


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    """Every multi-rank check, run once in two launches (2 and 4 ranks):
    the inputs and the JAX and one-process references made here."""
    work = tmp_path_factory.mktemp("sharded")
    inp = {"sgd": {}, "drop": {}}
    ref = {"sgd": {}, "drop": {}}
    for name, (make, mesh, fsdp, jax_mesh) in SGD_CASES.items():
        jcfg = make()
        jm, v, tm = micro_pair(jcfg)
        ids, images, actions = _batch(jcfg, 70)
        d = _draws(jcfg, B, 72)
        loss, params, grads = _jax_step(
            jm, v["params"], jax_mesh, fsdp, ids, images, actions, d,
            total=name == "ep")
        tc = to_torch_config(jcfg)
        if name in PORT_ATTENTION:
            tc = tc.replace(transformer=tc.transformer.replace(
                **PORT_ATTENTION[name]))
        with torch.no_grad(), capture_intermediates(
                model := _port(tc, tm.state_dict())) as probes:
            # the replicated forward the sharded one is held against
            fwd = model.predict_continuous_action(torch.as_tensor(ids),
                                                  torch.as_tensor(images))
        ref["sgd"][name] = {"loss": loss, "forward": fwd, "probes": probes,
                            "params": convert.from_flax(params, tc),
                            "grads": convert.from_flax(grads, tc)}
        inp["sgd"][name] = {"cfg": tc, "state": tm.state_dict(), "ids": ids,
                            "images": images, "actions": actions,
                            "positions": (torch.tensor(d["rows"]),
                                          torch.tensor(d["cols"])),
                            "mesh": mesh, "fsdp": fsdp,
                            "world": mesh[0] * mesh[1]}
    for name, (make, mesh, fsdp) in DROP_CASES.items():
        tc = make()
        jcfg = (octo_micro_tome_layers() if "layers" in name else
                octo_micro_tome_staged() if "staged" in name else
                octo_micro_t5())
        tm = micro_pair(jcfg)[2]
        batch = _batch(jcfg, 80)
        case = {"cfg": tc, "state": tm.state_dict(), "batch": batch,
                "seed": 6, "mesh": mesh, "fsdp": fsdp,
                "world": mesh[0] * mesh[1]}
        inp["drop"][name] = case
        m = _port(tc, case["state"])
        st = tstate.create_train_state(m, SGD(), rngs=case["seed"])
        _, loss = tsteps.make_train_step("continuous", jit=False)(
            st, *(torch.as_tensor(x) for x in batch))
        ref["drop"][name] = {"loss": float(loss), "params": _whole_params(m)}
    # AdamW, fit / evaluate, serving and checkpoints on the TP model
    jcfg = _no_dropout(octo_micro_t5())
    tm = micro_pair(jcfg)[2]
    inp["adam"] = {"cfg": to_torch_config(jcfg), "state": tm.state_dict(),
                   "batch": _batch(jcfg, 90), "seed": 7, "mesh": (1, 2),
                   "fsdp": False}
    m = _port(inp["adam"]["cfg"], inp["adam"]["state"])
    tx = make_optimizer(1e-3, 0, 10, params=m,
                        frozen_prefixes=("text_encoder",))
    st = tstate.create_train_state(m, tx, rngs=7)
    tsteps.make_train_step("continuous", jit=False)(
        st, *(torch.as_tensor(x) for x in inp["adam"]["batch"]))
    ref["adam"] = {k: {n: t.clone() for n, t in tx.state_dict()[k].items()}
                   for k in ("mu", "nu")}
    ref["adam"]["grad_norm"] = float(st.metrics.compute()["grad_norm"])
    fcfg = octo_micro_t5()
    fm = micro_pair(fcfg)[2]
    inp["fit"] = {"cfg": to_torch_config(fcfg), "state": fm.state_dict(),
                  "batches": [_batch(fcfg, 100 + 2 * i) for i in range(2)],
                  "seed": 5, "mesh": (1, 2), "fsdp": False}
    f = inp["fit"]
    m = _port(f["cfg"], f["state"])
    st = tstate.create_train_state(m, SGD(), rngs=f["seed"])
    tloop.fit(st, iter(f["batches"]), "continuous", len(f["batches"]))
    ref["fit"] = _whole_params(m)
    ref["evaluate"] = tloop.evaluate(
        tstate.create_train_state(_port(f["cfg"], f["state"]), SGD(),
                                  rngs=f["seed"]),
        iter(f["batches"]), "diffusion", len(f["batches"]))
    ids, images, _ = _batch(jcfg, 110)
    inp["serve"] = {"cfg": inp["adam"]["cfg"], "state": tm.state_dict(),
                    "ids": ids, "images": images, "mesh": (1, 2),
                    "fsdp": False}
    for head in ("continuous", "diffusion"):
        eng = PolicyEngine(_port(inp["serve"]["cfg"], tm.state_dict()),
                           head=head, batch_size=B, seed=3)
        ref[f"{head}_eager"] = eng(images, text_tokens=ids)
        eng.compile(ids.shape[1:], images.shape[1:])
        ref[f"{head}_compiled"] = eng(images, text_tokens=ids)
    ranks = {}
    for world in (2, 4):
        (work / f"w{world}").mkdir()
        torch.save(inp, work / f"w{world}" / "inputs.pt")
        ranks[world] = launch("sharded_checks", world, work / f"w{world}")
    return ranks, ref


def _ranks_of(sharded_ranks, case):
    ranks, ref = sharded_ranks
    world = SGD_CASES[case][1][0] * SGD_CASES[case][1][1]
    return ranks[world], ref


@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_sharded_step_matches_jax(sharded_ranks, case):
    """One SGD step through make_train_step on the sharded model: the loss,
    the parameters after the step and the gradients equal the JAX
    package's (on its mesh; one device for TP x FSDP), and the sharded
    forward and its attention probes (every head) the replicated ones (as
    the JAX test holds its forward).  The
    'tp' case, two ranks training the tensor-parallel octo_micro_t5, is
    the one a port without sharded training fails: its global norm
    refused the DTensor gradients."""
    ranks, ref = _ranks_of(sharded_ranks, case)
    want = ref["sgd"][case]
    for r in results(ranks, f"sgd_{case}"):
        assert abs(r["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
        for n, p in r["params"].items():
            _close(p, want["params"][n], PARAM_RTOL, PARAM_ATOL)
        _close(r["forward"], want["forward"], FWD_RTOL, FWD_ATOL)
        _assert_grads_close(r["grads"], want["grads"])
        # the attention probes report every head, as the replicated model's
        # (the per-layer compressed blocks record none)
        assert bool(want["probes"]) == ("layers" not in case)
        assert r["probes"].keys() == want["probes"].keys()
        for key, calls in want["probes"].items():
            for got, w in zip(r["probes"][key], calls):
                _close(got, w, FWD_RTOL, FWD_ATOL)


@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_sharded_storage_follows_the_rules(sharded_ranks, case):
    """Every parameter the JAX rules shard is a 1/P shard on its rank; no
    parameter split over model is gathered (no parametrization, no
    full_tensor during the step)."""
    ranks, _ = _ranks_of(sharded_ranks, case)
    for r in results(ranks, f"sgd_{case}"):
        assert r["storage"]["wrong"] == []
        assert r["storage"]["split"] > 0
        assert r["gathered_split"] == []
        assert r["parametrized_split"] == []


@pytest.mark.parametrize("case", sorted(DROP_CASES))
def test_sharded_dropout_step_matches_one_process(sharded_ranks, case):
    """Every dropout at 0.1 drawn from the generators: the sharded step
    draws the one-process step's masks (heads cut from the whole draw, the
    flash kernels' counters offset by the rank's first head) and reaches
    its loss and parameters; the flash kernels run on H/P heads."""
    ranks, ref = sharded_ranks
    mesh = DROP_CASES[case][1]
    want = ref["drop"][case]
    for rank, r in enumerate(results(ranks[mesh[0] * mesh[1]],
                                     f"drop_{case}")):
        assert abs(r["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
        for n, p in r["params"].items():
            _close(p, want["params"][n], PARAM_RTOL, PARAM_ATOL)
        assert r["storage"]["wrong"] == []
        if "layers" not in case:
            heads = {h for h, _, _ in r["flash"]}
            assert heads == {1}, r["flash"]       # two heads over model=2
            model_rank = rank % mesh[1]
            assert {(h0, total) for _, h0, total in r["flash"]} == {
                (model_rank, 2)}


def test_sharded_adamw_moments_match_one_process(sharded_ranks):
    """One AdamW step on the tensor-parallel model (decay mask and frozen
    text tower by name): the moments, gathered, equal the one-process
    moments; each is held as the parameter's shard."""
    ranks, ref = sharded_ranks
    for r in results(ranks[2], "adamw"):
        assert r["count"] == 1
        assert set(r["mu"]) == set(ref["adam"]["mu"])
        assert not any(n.startswith("text_encoder") for n in r["mu"])
        for k in ("mu", "nu"):
            _assert_grads_close(r[k], ref["adam"][k])
        for storage in r["storage"]:
            assert storage["wrong"] == [] and storage["split"] > 0
        assert abs(r["grad_norm"] - ref["adam"]["grad_norm"]) <= (
            LOSS_RTOL * ref["adam"]["grad_norm"])
        assert r["masks_by_name"]


def test_sharded_fit_and_evaluate_match_one_process(sharded_ranks):
    """fit(mesh=) over two continuous-head steps with dropout on and
    evaluate(mesh=) of the diffusion head on the tensor-parallel model
    equal the one-process runs.  fit takes the continuous head: the
    diffusion head's Fourier time kernel (entries up to 20) carries one
    step's rounding (3e-6 here, from the split sums) into relative
    differences of 1e-3 after the next."""
    ranks, ref = sharded_ranks
    for r in results(ranks[2], "fit_evaluate"):
        for n, want in ref["fit"].items():
            _close(r["params"][n], want, PARAM_RTOL, PARAM_ATOL)
        assert abs(r["evaluate"]["loss"] - ref["evaluate"]["loss"]) <= (
            LOSS_RTOL * abs(ref["evaluate"]["loss"]))


@pytest.mark.parametrize("head", ["continuous", "diffusion"])
@pytest.mark.parametrize("path", ["eager", "compiled"])
def test_sharded_serving_matches_one_engine(sharded_ranks, head, path):
    ranks, ref = sharded_ranks
    for r in results(ranks[2], "serving"):
        _close(r[f"{head}_{path}"], ref[f"{head}_{path}"], SERVE_TOL,
               SERVE_TOL)


def test_replicated_checkpoint_restores_into_sharded_layouts(sharded_ranks):
    """A replicated AdamW state, saved as one file, restores into the
    tensor-parallel and the FSDP layouts: every parameter and moment comes
    back whole; a sharded state round-trips through .dcp, one file a rank,
    its moments on their shards."""
    ranks, _ = sharded_ranks
    got = results(ranks[2], "checkpoints")
    for r in got:
        assert "1.pt" in r["files"]
        for layout in ("tp", "fsdp"):
            assert r[layout]["equal"] and r[layout]["split"] > 0
            assert r[layout]["masks_by_name"]
        assert r["dcp"]["equal"]
        assert r["dcp"]["moments_split"]["wrong"] == []
        assert r["dcp"]["moments_split"]["split"] > 0
    files = got[0]["dcp"]["files"]
    assert sum(f.endswith(".distcp") for f in files) == 2, files


def test_world_of_one_shards_nothing_and_changes_nothing(tmp_path):
    """At a mesh of one rank shard_params leaves every parameter whole and
    the step under the mesh equals the step without it bit for bit."""
    import torch.distributed as dist
    from multi_modal_transformers_tokenmerge_torch.parallel import (
        mesh as tmesh)
    cfg = _flash_cfg(octo_micro_t5())
    state = micro_pair(octo_micro_t5())[2].state_dict()
    batch = [torch.as_tensor(x) for x in _batch(octo_micro_t5(), 120)]
    try:
        mesh = tmesh.make_mesh()
        runs = []
        for m_arg in (None, mesh):
            model = _port(cfg, state)
            if m_arg is not None:
                tmesh.shard_params(model, mesh, fsdp=True, fsdp_min_size=1)
                assert not any(hasattr(p, "placements")
                               for p in model.parameters())
            st = tstate.create_train_state(model, make_optimizer(
                1e-3, 0, 10, params=model), rngs=4)
            _, loss = tsteps.make_train_step("continuous", jit=False,
                                             mesh=m_arg)(st, *batch)
            runs.append((loss, _whole_params(model)))
        assert torch.equal(runs[0][0], runs[1][0])
        for n, p in runs[0][1].items():
            assert torch.equal(p, runs[1][1][n]), n
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
