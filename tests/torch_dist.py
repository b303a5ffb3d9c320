"""Launch a group of gloo ranks on the CPU for the port's multi-process
tests.

``launch(fn, world, workdir)`` starts ``world`` children with the
``spawn`` start method (a fresh interpreter each, never a fork of the
pytest process, which holds JAX), each with one torch thread, joined by
``torch.distributed`` on gloo through a ``file://`` rendezvous in
``workdir`` (no port is fixed).  Rank r runs ``fn(rank, world, workdir)``
(a function of ``torch_dist_workers``, which imports torch and the port
only) and saves what it returns as ``workdir/rank{r}.pt``.  Every launch
has its own time limit: past it the children are killed and the launch
raises.  An exception in a child is saved in its place and re-raised by
:func:`results` for the checks that read it.
"""

import multiprocessing
import os
import pathlib
import sys
import time
import traceback

import torch

LAUNCH_TIMEOUT = 180.0


def _child(fn_name, rank, world, workdir, sys_path):
    sys.path[:0] = [p for p in sys_path if p not in sys.path]
    torch.set_num_threads(1)
    import torch.distributed as dist
    import torch_dist_workers
    out = pathlib.Path(workdir) / f"rank{rank}.pt"
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{workdir}/rendezvous",
            world_size=world, rank=rank)
        result = getattr(torch_dist_workers, fn_name)(rank, world, workdir)
    except BaseException:
        result = {"__error__": traceback.format_exc()}
    torch.save(result, out)
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(fn_name: str, world: int, workdir, timeout: float = LAUNCH_TIMEOUT):
    """Run ``torch_dist_workers.<fn_name>`` on ``world`` gloo ranks; returns
    the list of the ranks' results."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    here = str(pathlib.Path(__file__).resolve().parent)
    root = str(pathlib.Path(here).parent)
    procs = [ctx.Process(target=_child,
                         args=(fn_name, r, world, str(workdir),
                               [here, root]))
             for r in range(world)]
    env_threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
    finally:
        if env_threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env_threads
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive:
        raise TimeoutError(f"{fn_name} on {world} ranks passed its "
                           f"{timeout:.0f} s limit; the children were killed")
    out = []
    for r, p in enumerate(procs):
        path = workdir / f"rank{r}.pt"
        if not path.exists():
            raise RuntimeError(f"{fn_name}: rank {r} exited with code "
                               f"{p.exitcode} and saved nothing")
        out.append(torch.load(path, weights_only=False))
    return out


def results(ranks, key):
    """Every rank's result under ``key``; a child's failure raises here."""
    got = []
    for r, res in enumerate(ranks):
        if "__error__" in res:
            raise AssertionError(f"rank {r} failed:\n{res['__error__']}")
        value = res[key]
        if isinstance(value, dict) and "__error__" in value:
            raise AssertionError(f"rank {r}, {key}:\n{value['__error__']}")
        got.append(value)
    return got
