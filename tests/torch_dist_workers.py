"""What each rank of the port's multi-process tests runs (see
``torch_dist.launch``).  Imports torch, numpy and the port only: the JAX
side of every comparison runs in the pytest process, which hands its
inputs over in ``workdir/inputs.pt``."""

import pathlib
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from multi_modal_transformers_tokenmerge_torch.models.octo import Octo
from multi_modal_transformers_tokenmerge_torch.parallel import (
    distributed as pdist)
from multi_modal_transformers_tokenmerge_torch.parallel.mesh import (
    data_slice, make_mesh, shard_params)
from multi_modal_transformers_tokenmerge_torch.parallel.pipeline import (
    pipelined_apply, split_stages)
from multi_modal_transformers_tokenmerge_torch.parallel.ring_attention import (
    ring_attention)
from multi_modal_transformers_tokenmerge_torch.serve.policy import (
    PolicyEngine)
from multi_modal_transformers_tokenmerge_torch.train import loop, state, steps
from multi_modal_transformers_tokenmerge_torch.train.checkpoint import (
    CheckpointManager)
from multi_modal_transformers_tokenmerge_torch.utils.data import (
    prefetch_to_device)


class SGD:
    """Plain SGD with the optimizer interface of ``train.state``: updates
    linear in the gradients, so data-parallel and one-device steps stay
    comparable (as the JAX tests' ``optax.sgd``).  Keeps the gradients it
    was handed."""

    def __init__(self, lr: float = 1e-2):
        self.lr = lr
        self.grads = []

    def init(self, named_params):
        self.count = torch.zeros((), dtype=torch.int32)

    def state_dict(self):
        return {"count": self.count}

    def load_state_dict(self, saved):
        self.count.copy_(saved["count"])

    @torch.no_grad()
    def step(self, params, grads):
        """A sharded parameter (a DTensor) is updated on its local shard,
        the gradient it is handed."""
        self.grads.append({n: g.detach().clone() for n, g in grads.items()
                           if g is not None})
        for n, g in grads.items():
            if g is not None:
                p = params[n]
                (p.to_local() if hasattr(p, "to_local") else p).sub_(
                    self.lr * g)
        self.count += 1


def _inputs(workdir):
    return torch.load(pathlib.Path(workdir) / "inputs.pt", weights_only=False)


def _model(case):
    model = Octo(case["cfg"], device="cpu", seed=None)
    model.load_state_dict(case["state"])
    return model


def _run(checks):
    """name -> result of each check; a failing check records its
    traceback and the others still run."""
    out = {}
    for name, fn in checks:
        try:
            out[name] = fn()
        except Exception:
            out[name] = {"__error__": traceback.format_exc()}
    return out


def _rows(x, rank, world):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


# -- parallel/mesh, train, serve, checkpoint: two ranks -------------------------

def parallel_checks(rank, world, workdir):
    inp = _inputs(workdir)
    mesh = make_mesh(data=world)

    def dp_step(case_name):
        case = inp[case_name]
        model = _model(case)
        opt = SGD()
        st = state.create_train_state(model, opt, rngs=0)
        step = steps.make_train_step("continuous", jit=False, mesh=mesh)
        rows, cols = case["positions"]
        draws = {"positions": (_rows(rows, rank, world),
                               _rows(cols, rank, world))}
        _, loss = step(st, *(torch.as_tensor(_rows(x, rank, world))
                             for x in (case["ids"], case["images"],
                                       case["actions"])), draws=draws)
        return {"loss": float(loss), "params": _params(model),
                "aux": (None if model.moe_aux_loss() is None
                        else float(model.moe_aux_loss()))}

    def dp_accum():
        """accum_steps=2 under the mesh, explicit draws: this rank's rows of
        each global microbatch, of the batch and of the draws alike."""
        case = inp["dense"]
        model = _model(case)
        st = state.create_train_state(model, SGD(), rngs=0)
        step = steps.make_train_step("continuous", jit=False, mesh=mesh,
                                     accum_steps=2)
        cut = lambda x: torch.as_tensor(data_slice(x, mesh, microbatches=2))
        draws = {"positions": tuple(cut(x) for x in case["accum_positions"])}
        _, loss = step(st, *(cut(x) for x in (case["ids"], case["images"],
                                              case["actions"])),
                       draws=draws)
        return {"loss": float(loss), "params": _params(model)}

    def dp_dropout():
        """Every dropout at 0.1, the attention's in the flash kernels'
        plain versions, drawn from the generators: a continuous-head step
        at accum_steps=1 and 2, and fit(accum_steps=2) over two batches,
        given whole or as prefetch_to_device(microbatches=2)'s rows; fit
        refuses batches cut for another number of microbatches."""
        case = inp["dropout"]
        n = len(case["batches"])
        out = {}
        for accum in (1, 2):
            model = _model(case)
            st = state.create_train_state(model, SGD(), rngs=case["seed"])
            step = steps.make_train_step("continuous", jit=False,
                                         mesh=mesh, accum_steps=accum)
            _, loss = step(st, *(torch.as_tensor(data_slice(
                x, mesh, microbatches=accum)) for x in case["batches"][0]))
            out[accum] = {"loss": float(loss), "params": _params(model)}
        for name, batches in (
                ("fit", iter(case["batches"])),
                ("fit_prefetched", prefetch_to_device(
                    iter(case["batches"]), device="cpu", mesh=mesh,
                    microbatches=2))):
            model = _model(case)
            st = state.create_train_state(model, SGD(), rngs=case["seed"])
            loop.fit(st, batches, "continuous", n, mesh=mesh, accum_steps=2)
            out[name] = {"params": _params(model)}
        try:
            loop.fit(state.create_train_state(_model(case), SGD(), rngs=0),
                     prefetch_to_device(iter(case["batches"]), device="cpu",
                                        mesh=mesh),
                     "continuous", n, mesh=mesh, accum_steps=2)
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
        return out

    def dp_fit():
        case = inp["fit"]
        model = _model(case)
        st = state.create_train_state(model, SGD(), rngs=case["seed"])
        st = loop.fit(st, iter(case["batches"]), "diffusion",
                      len(case["batches"]), mesh=mesh)
        return {"params": _params(model)}

    def dp_evaluate():
        case = inp["fit"]
        model = _model(case)
        st = state.create_train_state(model, SGD(), rngs=case["seed"])
        return loop.evaluate(st, iter(case["batches"]), "diffusion",
                             len(case["batches"]), mesh=mesh)

    def dp_prefetched():
        """fit and evaluate over prefetch_to_device(mesh=)'s batches, which
        are the rank's rows already; the same batches with no mesh given
        to fit are refused."""
        case = inp["fit"]
        n = len(case["batches"])
        batches = lambda: prefetch_to_device(iter(case["batches"]),
                                             device="cpu", mesh=mesh)
        model = _model(case)
        st = state.create_train_state(model, SGD(), rngs=case["seed"])
        loop.fit(st, batches(), "diffusion", n, mesh=mesh)
        ev = loop.evaluate(
            state.create_train_state(_model(case), SGD(), rngs=case["seed"]),
            batches(), "diffusion", n, mesh=mesh)
        try:
            loop.fit(state.create_train_state(_model(case), SGD(), rngs=0),
                     batches(), "diffusion", n)
            refused = None
        except ValueError as e:
            refused = str(e)
        return {"params": _params(model), "evaluate": ev,
                "refused": refused}

    def tp_forward():
        case = inp["dense"]
        tp = make_mesh(data=1, model=world)
        model = shard_params(_model(case), tp)
        sharded = {n: (tuple(p.to_local().shape), tuple(p.shape),
                       [str(x) for x in p.placements])
                   for n, p in model.named_parameters()
                   if hasattr(p, "placements")}
        with torch.no_grad():
            out = model.predict_continuous_action(
                torch.as_tensor(case["ids"]),
                torch.as_tensor(case["images"]))
        return {"out": out, "sharded": sharded}

    def serving():
        case = inp["dense"]
        ids, images = case["ids"], case["images"]
        out = {}
        for head in ("continuous", "diffusion"):
            eng = PolicyEngine(_model(case), head=head,
                               batch_size=ids.shape[0], seed=3, mesh=mesh)
            out[f"{head}_eager"] = eng(images, text_tokens=ids)
            eng.compile(ids.shape[1:], images.shape[1:])
            out[f"{head}_compiled"] = eng(images, text_tokens=ids)
            eng.set_instruction(ids)
            out[f"{head}_cached"] = eng(images)
        try:
            PolicyEngine(_model(case), head="continuous", batch_size=3,
                         mesh=mesh)
            out["not_divisible"] = None
        except ValueError as e:
            out["not_divisible"] = str(e)
        return out

    def sharded_checkpoint():
        case = inp["dense"]
        tp = make_mesh(data=1, model=world)
        model = shard_params(_model(case), tp)
        st = state.create_train_state(model, SGD(), rngs=0)
        mgr = CheckpointManager(str(pathlib.Path(workdir) / "ckpt"))
        saved = {n: p.detach().full_tensor().clone()
                 if hasattr(p, "full_tensor") else p.detach().clone()
                 for n, p in st.params.items()}
        mgr.save(1, st)
        with torch.no_grad():
            for p in st.params.values():
                p.zero_()
        mgr.restore(st)
        restored = {n: p.detach().full_tensor()
                    if hasattr(p, "full_tensor") else p.detach()
                    for n, p in st.params.items()}
        local = {n: tuple(p.to_local().shape) for n, p in st.params.items()
                 if hasattr(p, "to_local")}
        files = sorted(q.name for q in (pathlib.Path(workdir) / "ckpt"
                                        / "1.dcp").iterdir())
        return {"equal": all(torch.equal(saved[n], restored[n])
                             for n in saved),
                "local": local, "files": files}

    def process():
        pdist.initialize_multihost()   # already initialised: a no-op
        return pdist.process_info()

    return _run([("dp_dense", lambda: dp_step("dense")),
                 ("dp_moe", lambda: dp_step("moe")),
                 ("dp_accum", dp_accum), ("dp_dropout", dp_dropout),
                 ("dp_fit", dp_fit), ("dp_evaluate", dp_evaluate),
                 ("dp_prefetched", dp_prefetched),
                 ("tp_forward", tp_forward), ("serving", serving),
                 ("sharded_checkpoint", sharded_checkpoint),
                 ("process", process)])


# -- parallel/ring_attention: two and four ranks ---------------------------------

def _ring_case(q, k, v, mask, group, impl, rank, p, n_total, **kw):
    """This rank's shard of the output and of dq, dk, dv for the loss
    mean(out^2) over the whole global output (``n_total`` elements)."""
    s = q.shape[1] // p
    sl = slice(rank * s, (rank + 1) * s)
    qs, ks, vs = (x[:, sl].clone().requires_grad_(True) for x in (q, k, v))
    out = ring_attention(qs, ks, vs, mask, group, impl=impl, **kw)
    loss = out.float().square().sum() / float(n_total)
    grads = torch.autograd.grad(loss, (qs, ks, vs))
    return {"out": out.detach(), "grads": [g.detach() for g in grads]}


def ring_checks(rank, world, workdir):
    inp = _inputs(workdir)
    checks = []
    for name, case in inp["cases"].items():
        if case["world"] != world:
            continue

        def run(case=case):
            q, k, v = (torch.as_tensor(case[x]) for x in ("q", "k", "v"))
            n_total = q.numel()
            if case.get("cp_dp"):
                mesh = init_device_mesh(
                    "cpu", (2, world // 2), mesh_dim_names=("data", "seq"))
                d = mesh.get_local_rank("data")
                s_rank = mesh.get_local_rank("seq")
                rows = slice(d * q.shape[0] // 2, (d + 1) * q.shape[0] // 2)
                res = _ring_case(q[rows], k[rows], v[rows], case["mask"],
                                 mesh, case["impl"], s_rank, world // 2,
                                 n_total, axis="seq", batch_axis="data",
                                 **case.get("kw", {}))
                res["rows"] = (rows.start, rows.stop)
                res["seq_rank"] = s_rank
                return res
            return _ring_case(q, k, v, case["mask"], None, case["impl"],
                              rank, world, n_total, **case.get("kw", {}))
        checks.append((name, run))

    def unaligned():
        if world != 2:
            return "ring of 2 only"
        q = torch.zeros(1, 32, 2, 8)
        try:
            ring_attention(q, q, q, np.ones((64, 64), bool), None,
                           impl="flash")
            return None
        except ValueError as e:
            return str(e)
    checks.append(("unaligned", unaligned))
    return _run(checks)


# -- parallel/pipeline: four ranks -----------------------------------------------

def pipeline_checks(rank, world, workdir):
    from multi_modal_transformers_tokenmerge_torch.modules.attention import (
        EncoderBlock)
    inp = _inputs(workdir)
    mask = torch.as_tensor(inp["mask"])

    def blocks():
        out = []
        for sd in inp["layers"]:
            blk = EncoderBlock(inp["cfg"], inp["features"])
            blk.load_state_dict(sd)
            out.append(blk)
        return out

    def layer_fn(block, h):
        return block(h, mask)

    def run_pipe(group, stages, m, x, data_axis=None, loss_rows=None):
        blks = blocks()
        out = pipelined_apply(layer_fn, split_stages(blks, stages), x,
                              group, m, axis="pipe", data_axis=data_axis)
        n = float(np.prod(inp["x"].shape))
        loss = out.square().sum() / n
        named = [(f"{li}.{pn}", q) for li, b in enumerate(blks)
                 for pn, q in b.named_parameters()]
        grads = torch.autograd.grad(loss, [q for _, q in named],
                                    allow_unused=True)
        return out.detach(), {n_: g for (n_, _), g in zip(named, grads)}

    def grads_by_layer(blks_grads):
        return {k: (None if g is None else g.detach())
                for k, g in blks_grads.items()}

    def four_stages():
        x = torch.as_tensor(inp["x"])
        out, named = run_pipe(None, world, inp["m4"], x)
        return {"out": out, "grads": grads_by_layer(named)}

    def two_stages_and_pp_dp():
        x = torch.as_tensor(inp["x"])
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "pipe"))
        out2, g2 = run_pipe(mesh, 2, inp["m2"], x)
        out_dp, g_dp = run_pipe(mesh, 2, inp["m_dp"], x, data_axis="data")
        # every rank takes the loss on the global output; the blocks'
        # gradients are each data rank's share of it: sum them
        group = mesh.get_group("data")
        summed = {}
        for k, g in g_dp.items():
            if g is not None:
                g = g.clone()
                dist.all_reduce(g, group=group)
            summed[k] = g
        try:
            pipelined_apply(layer_fn, split_stages(blocks(), 2), x[:6],
                            mesh, 6, axis="pipe", data_axis="data")
            err = None
        except ValueError as e:
            err = str(e)
        return {"out2": out2, "grads2": grads_by_layer(g2),
                "out_dp": out_dp, "grads_dp": grads_by_layer(summed),
                "data_rank": mesh.get_local_rank("data"),
                "pipe_rank": mesh.get_local_rank("pipe"), "dp_error": err}

    return _run([("four_stages", four_stages),
                 ("two_stages_and_pp_dp", two_stages_and_pp_dp)])


# -- training on sharded parameters: two and four ranks ---------------------------

FSDP_MIN_SIZE = 256


def _whole(t):
    t = t.detach()
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).clone()


def _layout(model, mesh, fsdp):
    """name -> expected local shape under ``param_shardings`` (taken on
    the unsharded model) and whether the parameter is split over model."""
    from multi_modal_transformers_tokenmerge_torch.parallel.mesh import (
        param_shardings)
    out = {}
    for n, placements in param_shardings(model, mesh, True, fsdp,
                                         FSDP_MIN_SIZE).items():
        p = model.get_parameter(n)
        shape = list(p.shape)
        for i, pl in enumerate(placements):
            if pl.is_shard():
                shape[pl.dim] //= mesh.size(i)
        out[n] = (tuple(shape), placements[
            mesh.mesh_dim_names.index("model")].is_shard())
    return out


def _storage(layout, named):
    """Local shapes that differ from ``layout`` (expected empty) and the
    number of tensors held as 1/P shards."""
    wrong = [(n, tuple(_local(t).shape), layout[n][0])
             for n, t in named.items()
             if tuple(_local(t).shape) != layout[n][0]]
    split = sum(tuple(_local(t).shape) != tuple(t.shape)
                for t in named.values())
    return {"wrong": wrong, "split": split}


class _Spy:
    """Records DTensor.full_tensor calls (by tensor id) and the heads of
    every flash_fwd_lse launch while active."""

    def __init__(self):
        self.gathered, self.flash = [], []

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from multi_modal_transformers_tokenmerge_torch.ops import (
            flash_attention as fa)
        self._full, self._fwd = DTensor.full_tensor, fa.flash_fwd_lse
        spy = self

        def full_tensor(t, *a, **k):
            spy.gathered.append(id(t))
            return spy._full(t, *a, **k)

        def fwd(q, *a, **k):
            spy.flash.append((q.shape[2], k.get("h0", 0),
                              k.get("heads_total")))
            return spy._fwd(q, *a, **k)
        DTensor.full_tensor = full_tensor
        fa.flash_fwd_lse = fwd
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor import DTensor
        from multi_modal_transformers_tokenmerge_torch.ops import (
            flash_attention as fa)
        DTensor.full_tensor = self._full
        fa.flash_fwd_lse = self._fwd


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def sharded_checks(rank, world, workdir):
    from multi_modal_transformers_tokenmerge_torch.train.optim import (
        make_optimizer)
    inp = _inputs(workdir)

    def sharded(case):
        """(mesh, the sharded model, its expected layout)."""
        mesh = make_mesh(*case["mesh"])
        model = _model(case)
        layout = _layout(model, mesh, case["fsdp"])
        return mesh, shard_params(model, mesh, fsdp=case["fsdp"],
                                  fsdp_min_size=FSDP_MIN_SIZE), layout

    def sgd_step(case):
        """The sharded forward with its attention probes, then one SGD
        step with the JAX case's draws: the whole parameters and gradients
        after it, the storage, the parameters gathered during the step."""
        from multi_modal_transformers_tokenmerge_torch.modules.attention import (
            capture_intermediates)
        mesh, model, layout = sharded(case)
        with torch.no_grad(), capture_intermediates(model) as probes:
            fwd = model.predict_continuous_action(
                torch.as_tensor(case["ids"]), torch.as_tensor(case["images"]))
        st = state.create_train_state(model, SGD(), rngs=0)
        step = steps.make_train_step("continuous", jit=False, mesh=mesh)
        cut = lambda x: torch.as_tensor(data_slice(x, mesh))
        draws = {"positions": tuple(cut(x) for x in case["positions"])}
        with _Spy() as spy:
            _, loss = step(st, *(cut(case[x]) for x in ("ids", "images",
                                                        "actions")),
                           draws=draws)
        names = {id(p): n for n, p in st.params.items()}
        grads = {}
        for n, g in st.optimizer.grads[0].items():
            p = st.params[n]
            if hasattr(p, "placements"):
                from torch.distributed.tensor import DTensor
                g = DTensor.from_local(g, p.device_mesh, p.placements,
                                       run_check=False).full_tensor()
            grads[n] = g
        return {"loss": float(loss),
                "params": {n: _whole(p) for n, p in st.params.items()},
                "grads": grads, "forward": fwd, "probes": probes,
                "storage": _storage(layout, st.params),
                "gathered_split": sorted(
                    names[i] for i in spy.gathered
                    if i in names and layout[names[i]][1]),
                "parametrized_split": sorted(
                    n for n, p in model.named_parameters()
                    if "parametrizations" in n and layout[
                        n.replace(".parametrizations.", ".").replace(
                            ".original", "")][1])}

    def drop_step(case):
        """One continuous-head step with every dropout at 0.1, drawn from
        the generators; the flash launches' heads."""
        mesh, model, layout = sharded(case)
        st = state.create_train_state(model, SGD(), rngs=case["seed"])
        step = steps.make_train_step(case.get("head", "continuous"),
                                     jit=False, mesh=mesh)
        with _Spy() as spy:
            _, loss = step(st, *(torch.as_tensor(data_slice(x, mesh))
                                 for x in case["batch"]))
        return {"loss": float(loss),
                "params": {n: _whole(p) for n, p in st.params.items()},
                "flash": spy.flash, "storage": _storage(layout, st.params)}

    def adamw():
        """One AdamW step (decay mask and frozen text tower by name) on the
        sharded model: its moments gathered and their local shapes."""
        case = inp["adam"]
        mesh, model, layout = sharded(case)
        tx = make_optimizer(1e-3, 0, 10, params=model,
                            frozen_prefixes=("text_encoder",))
        st = state.create_train_state(model, tx, rngs=case["seed"])
        steps.make_train_step("continuous", jit=False, mesh=mesh)(
            st, *(torch.as_tensor(data_slice(x, mesh))
                  for x in case["batch"]))
        sd = tx.state_dict()
        whole = make_optimizer(1e-3, 0, 10, params=_model(case),
                               frozen_prefixes=("text_encoder",))
        return {"masks_by_name": (tx.decay, tx.trainable) == (
                    whole.decay, whole.trainable),
                "mu": {n: _whole(t) for n, t in sd["mu"].items()},
                "nu": {n: _whole(t) for n, t in sd["nu"].items()},
                "count": int(sd["count"]),
                "storage": [_storage(layout, sd[k]) for k in ("mu", "nu")],
                "grad_norm": float(st.metrics.compute()["grad_norm"])}

    def fit_evaluate():
        """fit(mesh=) over two continuous-head steps with dropout on, then
        evaluate(mesh=) of the diffusion head, on the tensor-parallel
        model."""
        case = inp["fit"]
        mesh, model, _ = sharded(case)
        st = state.create_train_state(model, SGD(), rngs=case["seed"])
        loop.fit(st, iter(case["batches"]), "continuous",
                 len(case["batches"]), mesh=mesh)
        mesh2, model2, _ = sharded(case)
        ev = loop.evaluate(
            state.create_train_state(model2, SGD(), rngs=case["seed"]),
            iter(case["batches"]), "diffusion", len(case["batches"]),
            mesh=mesh2)
        return {"params": {n: _whole(p) for n, p in st.params.items()},
                "evaluate": ev}

    def serving():
        case = inp["serve"]
        ids, images = case["ids"], case["images"]
        out = {}
        for head in ("continuous", "diffusion"):
            _, model, _ = sharded(case)
            eng = PolicyEngine(model, head=head, batch_size=ids.shape[0],
                               seed=3)
            out[f"{head}_eager"] = eng(images, text_tokens=ids)
            eng.compile(ids.shape[1:], images.shape[1:])
            out[f"{head}_compiled"] = eng(images, text_tokens=ids)
        return out

    def checkpoints():
        """A replicated AdamW state saved as one file restores into the
        tensor-parallel and the FSDP layouts; a sharded state round-trips
        through .dcp with its moments on their shards."""
        case = inp["adam"]
        root = pathlib.Path(workdir) / "ckpt_sharded"
        whole_model = _model(case)
        tx = make_optimizer(1e-3, 0, 10, params=whole_model)
        st = state.create_train_state(whole_model, tx, rngs=case["seed"])
        steps.make_train_step("continuous", jit=False)(
            st, *(torch.as_tensor(x) for x in case["batch"]))
        want = {"params": {n: _whole(p) for n, p in st.params.items()},
                "mu": {n: _whole(t) for n, t in tx.state_dict()["mu"].items()}}
        mgr = CheckpointManager(str(root / "replicated"))
        mgr.save(1, st)
        mgr.wait()      # rank 0 writes the one file
        dist.barrier()
        out = {"files": sorted(q.name for q in (root / "replicated").iterdir())}
        for name, (data, model_size, fsdp) in (("tp", (1, world, False)),
                                               ("fsdp", (world, 1, True))):
            c = dict(case, mesh=(data, model_size), fsdp=fsdp)
            mesh, model, layout = sharded(c)
            tx2 = make_optimizer(1e-3, 0, 10, params=model)
            st2 = state.create_train_state(model, tx2, rngs=0)
            mgr.restore(st2)
            got_p = {n: _whole(p) for n, p in st2.params.items()}
            got_mu = {n: _whole(t)
                      for n, t in tx2.state_dict()["mu"].items()}
            out[name] = {
                "masks_by_name": tx2.decay == tx.decay,
                "equal": all(torch.equal(got_p[n], want["params"][n])
                             for n in want["params"]) and all(
                    torch.equal(got_mu[n], want["mu"][n])
                    for n in want["mu"]),
                "split": _storage(layout, st2.params)["split"]}
        # the tensor-parallel state through .dcp
        mesh, model, layout = sharded(dict(case, mesh=(1, world),
                                           fsdp=False))
        tx3 = make_optimizer(1e-3, 0, 10, params=model)
        st3 = state.create_train_state(model, tx3, rngs=0)
        steps.make_train_step("continuous", jit=False, mesh=mesh)(
            st3, *(torch.as_tensor(x) for x in case["batch"]))
        saved = {n: _whole(t) for n, t in tx3.state_dict()["nu"].items()}
        mgr3 = CheckpointManager(str(root / "sharded"))
        mgr3.save(2, st3)
        with torch.no_grad():
            for t in tx3.state_dict()["nu"].values():
                _local(t).zero_()
        mgr3.restore(st3)
        out["dcp"] = {
            "equal": all(torch.equal(_whole(t), saved[n]) for n, t in
                         tx3.state_dict()["nu"].items()),
            "files": sorted(q.name for q in (root / "sharded" / "2.dcp")
                            .iterdir()),
            "moments_split": _storage(layout, tx3.state_dict()["nu"])}
        return out

    checks = []
    for name, case in inp["sgd"].items():
        if case["world"] == world:
            checks.append((f"sgd_{name}", lambda case=case: sgd_step(case)))
    for name, case in inp["drop"].items():
        if case["world"] == world:
            checks.append((f"drop_{name}",
                           lambda case=case: drop_step(case)))
    if world == 2:
        checks += [("adamw", adamw), ("fit_evaluate", fit_evaluate),
                   ("serving", serving), ("checkpoints", checkpoints)]
    return _run(checks)
