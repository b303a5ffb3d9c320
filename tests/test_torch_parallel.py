"""The port's ``parallel/mesh.py`` and ``parallel/distributed.py``, and
the data-parallel training, evaluation and serving and the sharded
checkpoints built on them, against the JAX package on the CPU.

The sharding rules are held in process against the JAX ``param_shardings``
for every parameter of every preset at data=4, model=2.  Everything that
needs more than one rank runs once for the module on two gloo ranks
(``torch_dist.launch``: spawned children, a file rendezvous, a time limit)
and each check below reads its result.  Tolerances are the JAX tests'
(``tests/test_parallel.py``): loss rtol 2e-5, parameters after an SGD step
2e-4 / 1e-5, the tensor-parallel forward 2e-5 / 1e-6, serving 1e-5.  The
accumulated step under a mesh is held against the JAX one-device
accumulated step, run op by op (``jax.disable_jit``) so that each
microbatch takes its own injected draws; the steps with dropout against
the port's one-process steps."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding

from micro_configs import octo_micro
from test_torch_moe import _jax_total_loss_and_grads, _moe
from test_torch_train import _draws, _jax_loss_and_grads, _no_dropout
from torch_dist import launch, results
from torch_dist_workers import SGD
from torch_parity import inputs, micro_pair, octo_micro_t5, to_torch_config
from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_torch.parallel import mesh as tmesh
from multi_modal_transformers_tokenmerge_torch.sequence.layout import (
    SequenceLayout)
from multi_modal_transformers_tokenmerge_torch.serve.policy import (
    PolicyEngine)
from multi_modal_transformers_tokenmerge_torch.train import loop as tloop
from multi_modal_transformers_tokenmerge_torch.train import state as tstate
from multi_modal_transformers_tokenmerge_torch.train import steps as tsteps
from multi_modal_transformers_tokenmerge_tpu.models import presets as jpre
from multi_modal_transformers_tokenmerge_tpu.models.octo import Octo as JOcto
from multi_modal_transformers_tokenmerge_tpu.parallel import mesh as jmesh
from multi_modal_transformers_tokenmerge_tpu.train import state as jstate
from multi_modal_transformers_tokenmerge_tpu.train import steps as jsteps

LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-5
FWD_RTOL, FWD_ATOL = 2e-5, 1e-6
SERVE_TOL = 1e-5
LR = 1e-2
WORLD = 2
B = 4


# -- the sharding rules, in process ------------------------------------------------

def _flax_specs(name, fsdp):
    """flax path -> (per-layer flax shape, per-layer spec, scanned) of
    every leaf of the JAX preset, from ``param_shardings`` on an 8-device
    (4, 2) mesh."""
    cfg = jpre.get_preset(name)
    model = JOcto(cfg)
    f = SequenceLayout.from_strings(cfg.input_sequence).modality_tokens(
        "images") // cfg.images.tokens_per_image
    shapes = jax.eval_shape(
        lambda: model.init(
            {"params": jax.random.PRNGKey(0),
             "diffusion": jax.random.PRNGKey(1)},
            jnp.zeros((1, cfg.text.max_length), jnp.int32),
            jnp.zeros((1, f, *cfg.images.image_size))))["params"]
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                ("data", "model"))
    shard = jmesh.param_shardings(shapes, mesh, model_parallel=True,
                                  fsdp=fsdp)
    flat_s = jax.tree_util.tree_flatten_with_path(
        shard, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    flat_p = dict((tuple(k.key for k in path), leaf) for path, leaf in
                  jax.tree_util.tree_flatten_with_path(shapes)[0])
    tc = to_torch_config(cfg)
    stacks = convert.scanned_stacks(tc)
    out = {}
    for path, sh in flat_s:
        path = tuple(k.key for k in path)
        shape = tuple(flat_p[path].shape)
        spec = tuple(sh.spec) + (None,) * (len(shape) - len(sh.spec))
        scanned = next((s for s in stacks if path[:len(s)] == s), None)
        if scanned is not None:
            out[(path, scanned)] = (shape[1:], spec[1:], shape[0])
        else:
            out[(path, None)] = (shape, spec, None)
    return tc, out


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp_fsdp"])
@pytest.mark.parametrize("name", sorted(jpre.PRESETS))
def test_spec_for_param_matches_jax(name, fsdp):
    """Each port parameter maps (``convert.flax_layout``) to its flax leaf's
    tail and per-layer shape, and gets the JAX spec of that leaf.  With
    FSDP the scanned stacks' leaves are left out: JAX takes the size
    threshold and the largest axis on the stacked (L, ...) leaf, the port
    on the per-layer one."""
    tc, flax = _flax_specs(name, fsdp)
    model = TOcto(tc, device="meta", seed=None)
    modules = dict(model.named_modules())
    params = dict(model.named_parameters())
    seen = set()
    compared = 0
    for (path, scanned), (shape, spec, num_layers) in flax.items():
        is_scanned = num_layers is not None
        for i in (range(num_layers) if is_scanned else [None]):
            p = path if i is None else scanned + (str(i),) + path[len(scanned):]
            names, _ = convert._leaf(p, np.zeros(shape, np.float32), tc)
            port_name = ".".join(names)
            assert port_name in params, port_name
            seen.add(port_name)
            mod_name = port_name.rsplit(".", 1)[0]
            parent = modules.get(mod_name.rsplit(".", 1)[0])
            got, tail, fshape, fspec = tmesh.spec_for_param(
                port_name, params[port_name], modules[mod_name], parent, 4, 2,
                model_parallel=True, fsdp=fsdp)
            assert tail == "/".join(path[-2:]), (port_name, tail)
            assert fshape == shape, (port_name, fshape, shape)
            if fsdp and is_scanned:
                continue
            assert fspec == spec, (port_name, fspec, spec)
            assert sum(a is not None for a in got) == sum(
                a is not None for a in spec), port_name
            compared += 1
    assert seen == set(params)
    assert compared > 0


def test_model_parallel_rules_shard_the_megatron_pairs():
    """At model=2 the micro model's MLP dense_in splits its output rows,
    dense_out its input columns, the heads of q/k/v their rows and the
    attention out its columns (the JAX test's specs in the port's
    layouts)."""
    tc = to_torch_config(octo_micro())
    model = TOcto(tc, device="meta", seed=None)
    specs = tmesh.param_specs(model, 4, 2)
    blk = "transformer.blocks.0"
    assert specs[f"{blk}.mlp.dense_in.weight"] == ("model", None)
    assert specs[f"{blk}.mlp.dense_out.weight"] == (None, "model")
    assert specs[f"{blk}.attention.query.weight"] == ("model", None)
    assert specs[f"{blk}.attention.out.weight"] == (None, "model")
    assert specs[f"{blk}.ln_mlp.weight"] == (None,)


@pytest.fixture
def world_of_one():
    """make_mesh in this process makes a gloo world of one; undone after."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_single_process(world_of_one):
    m = tmesh.make_mesh()
    assert m.mesh_dim_names == ("data", "model")
    assert tuple(m.shape) == (1, 1)
    assert tmesh.data_info(m) == (0, 1)
    with pytest.raises(ValueError, match="available devices"):
        tmesh.make_mesh(data=2, model=2)
    x = torch.arange(6).reshape(3, 2)
    assert tmesh.data_slice(x, m) is x
    assert [str(p) for p in tmesh.batch_sharding(m)] == ["S(0)", "R"]
    assert [str(p) for p in tmesh.replicated(m)] == ["R", "R"]


def test_data_slice_refuses_an_indivisible_batch():
    class Two:
        mesh_dim_names = ("data", "model")

        def get_local_rank(self, axis):
            return 1

        def size(self, dim):
            return 2
    assert np.array_equal(tmesh.data_slice(np.arange(6), Two()), [3, 4, 5])
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.data_slice(np.arange(5), Two())
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.data_slice(np.arange(6), Two(), microbatches=2)


def test_data_slice_cuts_each_microbatch():
    """With microbatches M, rank r of P takes its rows of each global
    microbatch [k B/M, (k+1) B/M), microbatch after microbatch."""
    class Two:
        mesh_dim_names = ("data", "model")

        def get_local_rank(self, axis):
            return 1

        def size(self, dim):
            return 2
    want = [2, 3, 6, 7]
    assert np.array_equal(
        tmesh.data_slice(np.arange(8), Two(), microbatches=2), want)
    x = torch.arange(16).reshape(8, 2)
    assert torch.equal(tmesh.data_slice(x, Two(), microbatches=2),
                       x[want])
    assert torch.equal(tmesh.data_slice(x.T, Two(), dim=1, microbatches=2),
                       x[want].T)


# -- two ranks ----------------------------------------------------------------------

def _dense_cfg():
    return _no_dropout(octo_micro_t5())


def _sgd_params(params, grads):
    return jax.tree.map(lambda p, g: np.asarray(p) - LR * np.asarray(g),
                        params, grads)


def _jax_accumulated_step(mp, jm, v, ids, images, actions, mb_draws):
    """The JAX package's make_train_step('continuous', accum_steps=2) with
    optax.sgd, op by op: its microbatch k (rows [2k, 2k + 2)) draws the
    patch positions of ``mb_draws[k]``.  (loss, parameters)."""
    queue = collections.deque(
        a for d in mb_draws for a in (d["rows"], d["cols"]))

    def randint(key, shape, *a, **k):
        value = queue.popleft()
        assert tuple(shape) == value.shape
        return jnp.asarray(value)

    key = jax.random.PRNGKey(0)
    st = jstate.create_train_state(jm, v, optax.sgd(LR),
                                   rngs={"dropout": key,
                                         "patch_encoding": key})
    with mp.context() as m:
        m.setattr(jax.random, "randint", randint)
        with jax.disable_jit():
            st, loss = jsteps.make_train_step(
                "continuous", jit=False, accum_steps=len(mb_draws))(
                    st, jnp.asarray(ids), jnp.asarray(images),
                    jnp.asarray(actions))
    assert not queue, "a JAX draw was not consumed"
    return float(loss), jax.tree.map(np.asarray, st.params)


def _one_process(case, accum, head="continuous"):
    """The port's one-process step (and fit over both batches) of the
    dropout case: what each rank's data-parallel run must equal.  The
    continuous head: the diffusion head's Fourier time features carry a
    step's float rounding into larger differences in the next."""
    def model():
        m = TOcto(case["cfg"], device="cpu", seed=None)
        m.load_state_dict(case["state"])
        return m
    out = {}
    for a in accum:
        m = model()
        st = tstate.create_train_state(m, SGD(), rngs=case["seed"])
        _, loss = tsteps.make_train_step(head, jit=False, accum_steps=a)(
            st, *(torch.as_tensor(x) for x in case["batches"][0]))
        out[a] = {"loss": float(loss),
                  "params": {n: p.detach().clone()
                             for n, p in m.named_parameters()}}
    m = model()
    st = tstate.create_train_state(m, SGD(), rngs=case["seed"])
    tloop.fit(st, iter(case["batches"]), head, len(case["batches"]),
              accum_steps=2)
    out["fit"] = {"params": {n: p.detach().clone()
                             for n, p in m.named_parameters()}}
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every two-rank check, run once: the inputs and the JAX / one-process
    references made here, the ranks' results read back."""
    work = tmp_path_factory.mktemp("parallel")
    inp, ref = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for name, make, jax_fn in (
                ("dense", _dense_cfg, _jax_loss_and_grads),
                ("moe", lambda: _no_dropout(_moe(octo_micro_t5)),
                 _jax_total_loss_and_grads)):
            jcfg = make()
            jm, v, tm = micro_pair(jcfg)
            ids, images = inputs(jcfg, batch=B, frames=2, seed=70)
            actions = np.random.default_rng(71).uniform(
                -1, 1, (B, 4)).astype(np.float32)
            d = _draws(jcfg, B, 72)
            loss, grads = jax_fn(mp, jm, v["params"], ids, images, actions,
                                 d, method="compute_l2_loss")
            tc = to_torch_config(jcfg)
            ref[name] = {"loss": loss, "params": convert.from_flax(
                _sgd_params(v["params"], grads), tc)}
            inp[name] = {"cfg": tc, "state": tm.state_dict(), "ids": ids,
                         "images": images, "actions": actions,
                         "positions": (torch.tensor(d["rows"]),
                                       torch.tensor(d["cols"]))}
            if name == "dense":
                # two microbatches of two rows, each with its draws
                mb = [_draws(jcfg, B // 2, 76 + k) for k in range(2)]
                loss, params = _jax_accumulated_step(mp, jm, v, ids, images,
                                                     actions, mb)
                ref["accum"] = {"loss": loss,
                                "params": convert.from_flax(params, tc)}
                inp[name]["accum_positions"] = tuple(
                    torch.tensor(np.concatenate([m[k] for m in mb]))
                    for k in ("rows", "cols"))
    # fit and evaluate with the generators and dropout on, against the
    # port's own one-process runs
    fcfg = octo_micro_t5()
    _, _, fm = micro_pair(fcfg)
    batches = [(*inputs(fcfg, batch=B, frames=2, seed=73 + i),
                np.random.default_rng(75 + i).uniform(
                    -1, 1, (B, 4)).astype(np.float32)) for i in range(2)]
    inp["fit"] = {"cfg": to_torch_config(fcfg), "state": fm.state_dict(),
                  "batches": batches, "seed": 5}
    # every dropout at 0.1, the attention's in the flash kernels (their
    # plain versions here)
    dcfg = to_torch_config(fcfg)
    dcfg = dcfg.replace(transformer=dcfg.transformer.replace(
        attention_impl="flash", flash_backward="pallas"))
    assert dcfg.transformer.attention.dropout_rate == 0.1
    inp["dropout"] = {"cfg": dcfg, "state": fm.state_dict(),
                      "batches": batches, "seed": 6}
    ref["dropout"] = _one_process(inp["dropout"], (1, 2))
    torch.save(inp, work / "inputs.pt")
    ranks = launch("parallel_checks", WORLD, work)

    def port_model(case):
        m = TOcto(case["cfg"], device="cpu", seed=None)
        m.load_state_dict(case["state"])
        return m

    f = inp["fit"]
    m = port_model(f)
    st = tstate.create_train_state(m, SGD(), rngs=f["seed"])
    tloop.fit(st, iter(batches), "diffusion", len(batches))
    ref["fit"] = {n: p.detach().clone() for n, p in m.named_parameters()}
    st = tstate.create_train_state(port_model(f), SGD(), rngs=f["seed"])
    ref["evaluate"] = tloop.evaluate(st, iter(batches), "diffusion",
                                     len(batches))
    dense = inp["dense"]
    with torch.no_grad():
        ref["forward"] = port_model(dense).predict_continuous_action(
            torch.as_tensor(dense["ids"]), torch.as_tensor(dense["images"]))
    for head in ("continuous", "diffusion"):
        eng = PolicyEngine(port_model(dense), head=head, batch_size=B, seed=3)
        ref[f"{head}_eager"] = eng(dense["images"], text_tokens=dense["ids"])
        eng.compile(dense["ids"].shape[1:], dense["images"].shape[1:])
        ref[f"{head}_compiled"] = eng(dense["images"],
                                      text_tokens=dense["ids"])
        eng.set_instruction(dense["ids"])
        ref[f"{head}_cached"] = eng(dense["images"])
    return ranks, ref


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ["dense", "moe"])
def test_data_parallel_step_matches_jax(two_ranks, case):
    """One continuous-head SGD step on 2 ranks (2 rows each) against the
    JAX one-device step on the 4 rows; the MoE case's balance loss takes
    its statistics over all 4 rows."""
    ranks, ref = two_ranks
    got = results(ranks, f"dp_{case}")
    for r in got:
        assert abs(r["loss"] - ref[case]["loss"]) <= LOSS_RTOL * abs(
            ref[case]["loss"])
        for n, p in r["params"].items():
            _close(p, ref[case]["params"][n], PARAM_RTOL, PARAM_ATOL)
    if case == "moe":
        assert got[0]["aux"] is not None and got[0]["aux"] == got[1]["aux"]


def test_accumulated_step_with_a_mesh_matches_jax(two_ranks):
    """accum_steps=2 on 2 ranks of 2 rows: each rank's microbatch k is its
    row of global microbatch k, with that microbatch's draws; loss and
    parameters equal the JAX one-device accumulated step's."""
    ranks, ref = two_ranks
    for r in results(ranks, "dp_accum"):
        assert abs(r["loss"] - ref["accum"]["loss"]) <= LOSS_RTOL * abs(
            ref["accum"]["loss"])
        for n, p in r["params"].items():
            _close(p, ref["accum"]["params"][n], PARAM_RTOL, PARAM_ATOL)


@pytest.mark.parametrize("accum", [1, 2])
def test_data_parallel_kernel_dropout_matches_one_process(two_ranks, accum):
    """Attention dropout 0.1 inside the flash kernels (plain versions):
    each rank's Philox counters start at its first global row of the
    (micro)batch, so 2 ranks draw the one-process step's masks and reach
    its loss and parameters."""
    ranks, ref = two_ranks
    want = ref["dropout"][accum]
    for r in results(ranks, "dp_dropout"):
        got = r[accum]
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(
            want["loss"])
        for n, p in got["params"].items():
            _close(p, want["params"][n], PARAM_RTOL, PARAM_ATOL)


def test_fit_with_a_mesh_and_accumulation_matches_one_process(two_ranks):
    """fit(mesh=, accum_steps=2) over two batches with every dropout on
    equals the one-process fit(accum_steps=2)."""
    ranks, ref = two_ranks
    for r in results(ranks, "dp_dropout"):
        for n, want in ref["dropout"]["fit"]["params"].items():
            _close(r["fit"]["params"][n], want, PARAM_RTOL, PARAM_ATOL)


def test_fit_over_prefetched_microbatches_matches_one_process(two_ranks):
    """fit(prefetch_to_device(..., mesh=mesh, microbatches=2), mesh=mesh,
    accum_steps=2): batches cut to the rank's rows of each global
    microbatch equal the one-process fit(accum_steps=2); batches cut as one
    microbatch are refused."""
    ranks, ref = two_ranks
    for r in results(ranks, "dp_dropout"):
        for n, want in ref["dropout"]["fit"]["params"].items():
            _close(r["fit_prefetched"]["params"][n], want, PARAM_RTOL,
                   PARAM_ATOL)
        assert r["refused"] is not None and "microbatches" in r["refused"]


def test_fit_with_a_mesh_matches_one_process(two_ranks):
    """fit(mesh=) over two diffusion steps with dropout on, every draw made
    for the global batch: the parameters equal the one-process fit's."""
    ranks, ref = two_ranks
    for r in results(ranks, "dp_fit"):
        for n, want in ref["fit"].items():
            _close(r["params"][n], want, PARAM_RTOL, PARAM_ATOL)


def test_evaluate_with_a_mesh_matches_one_process(two_ranks):
    ranks, ref = two_ranks
    for r in results(ranks, "dp_evaluate"):
        assert abs(r["loss"] - ref["evaluate"]["loss"]) <= LOSS_RTOL * abs(
            ref["evaluate"]["loss"])


def test_fit_over_prefetched_batches_matches_one_process(two_ranks):
    """fit(prefetch_to_device(..., mesh=mesh), mesh=mesh): the prefetched
    batches are the rank's rows already and are not cut again, so the
    parameters equal the one-process fit's; fit without the mesh refuses
    them."""
    ranks, ref = two_ranks
    for r in results(ranks, "dp_prefetched"):
        for n, want in ref["fit"].items():
            _close(r["params"][n], want, PARAM_RTOL, PARAM_ATOL)
        assert r["refused"] is not None and "mesh" in r["refused"]


def test_evaluate_over_prefetched_batches_matches_one_process(two_ranks):
    ranks, ref = two_ranks
    for r in results(ranks, "dp_prefetched"):
        assert abs(r["evaluate"]["loss"] - ref["evaluate"]["loss"]) <= (
            LOSS_RTOL * abs(ref["evaluate"]["loss"]))


def test_tensor_parallel_forward_matches_replicated(two_ranks):
    ranks, ref = two_ranks
    for r in results(ranks, "tp_forward"):
        _close(r["out"], ref["forward"], FWD_RTOL, FWD_ATOL)
        # split over model, computed on its shard: no gathering
        # parametrization, so the parameter keeps its own name
        name = "transformer.blocks.0.mlp.dense_in.weight"
        local, full, placements = r["sharded"][name]
        assert local[0] * WORLD == full[0] and placements == ["R", "S(0)"]


@pytest.mark.parametrize("head", ["continuous", "diffusion"])
@pytest.mark.parametrize("path", ["eager", "compiled", "cached"])
def test_data_parallel_serving_matches_one_engine(two_ranks, head, path):
    """Every rank returns the global actions, equal to an un-meshed engine
    of the same seed (the diffusion draws made for the global batch)."""
    ranks, ref = two_ranks
    for r in results(ranks, "serving"):
        _close(r[f"{head}_{path}"], ref[f"{head}_{path}"], SERVE_TOL,
               SERVE_TOL)


def test_serving_refuses_an_indivisible_batch(two_ranks):
    ranks, _ = two_ranks
    for r in results(ranks, "serving"):
        assert r["not_divisible"] is not None
        assert "not divisible" in r["not_divisible"]


def test_sharded_checkpoint_round_trip(two_ranks):
    """A tensor-parallel state saved through torch.distributed.checkpoint,
    zeroed and restored: every parameter comes back; each rank holds half
    of a sharded one and wrote its own file."""
    ranks, _ = two_ranks
    got = results(ranks, "sharded_checkpoint")
    for r in got:
        assert r["equal"]
        assert any(shape[0] for shape in r["local"].values())
    files = got[0]["files"]
    assert sum(f.endswith(".distcp") for f in files) == WORLD, files


def test_process_info_on_two_ranks(two_ranks):
    ranks, _ = two_ranks
    for rank, info in enumerate(results(ranks, "process")):
        assert info["process_index"] == rank
        assert info["process_count"] == WORLD
        assert set(info) == {"process_index", "process_count",
                             "local_device_count", "global_device_count"}
