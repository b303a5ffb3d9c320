"""Checkpointing and fit's hooks in the port, on the CPU.

A run of n steps equals a run of k steps, a save, a restore into a fresh
state and n - k more steps, bit for bit (parameters, moments, count, EMA,
metrics and every generator's state).  Retention keeps the steps the JAX
package's orbax-backed ``CheckpointManager`` keeps for the same saves and
metrics.  ``fit`` saves every ``checkpoint_every`` steps and at the end,
logs ``eval_fn`` under ``eval/`` and stops on ``should_stop``, with
``graceful_stop``'s SIGINT and SIGTERM semantics.
"""

import os
import signal
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import octo_micro_t5, to_torch_config
from multi_modal_transformers_tokenmerge_torch import (
    CheckpointManager, evaluate, fit, graceful_stop)
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_torch.train import optim as toptim
from multi_modal_transformers_tokenmerge_torch.train import state as tstate
from multi_modal_transformers_tokenmerge_torch.utils import data as tdata
from multi_modal_transformers_tokenmerge_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager)


def _config():
    """The micro T5 Octo with every dropout at 0.1, so that each step draws
    from all three generators."""
    cfg = to_torch_config(octo_micro_t5())
    tr = cfg.transformer
    return cfg.replace(
        transformer=tr.replace(dropout_rate=0.1, attention=tr.attention
                               .replace(dropout_rate=0.1)),
        heads=cfg.heads.replace(diffusion=cfg.heads.diffusion.replace(
            dropout_rate=0.1)))


def _state(model_seed, rng_seed):
    model = TOcto(_config(), device="cpu", seed=model_seed)
    tx = toptim.make_optimizer(peak_lr=1e-3, warmup_steps=2, total_steps=8,
                               params=model,
                               frozen_prefixes=("text_encoder",),
                               skip_nonfinite_steps=2)
    return tstate.create_train_state(model, tx, rngs=rng_seed,
                                     ema_decay=0.9)


def _batches(n, seed=0):
    cfg = _config()
    it = tdata.synthetic_octo_batches(
        2, image_shape=(2, *cfg.images.image_size),
        text_length=cfg.text.max_length,
        action_dim=cfg.heads.diffusion.action_space_dim,
        vocab_size=cfg.text.vocab_size, seed=seed)
    return [next(it) for _ in range(n)]


def _assert_states_equal(a, b):
    assert a.step == b.step
    for n, p in a.params.items():
        assert torch.equal(p, b.params[n]), n
    oa, ob = a.optimizer, b.optimizer
    assert oa.names == ob.names
    for x, y in zip((*oa.mu, *oa.nu), (*ob.mu, *ob.nu)):
        assert torch.equal(x, y)
    for name in ("count", "notfinite_count", "total_notfinite",
                 "last_finite"):
        assert torch.equal(getattr(oa, name), getattr(ob, name)), name
    for n, e in a.ema_params.items():
        assert torch.equal(e, b.ema_params[n]), n
    assert a.metrics.kinds == b.metrics.kinds
    for n in a.metrics.kinds:
        assert torch.equal(a.metrics.sums[n], b.metrics.sums[n])
        assert torch.equal(a.metrics.counts[n], b.metrics.counts[n])
    for n, g in a.rngs.items():
        assert torch.equal(g.get_state(), b.rngs[n].get_state()), n


@pytest.mark.parametrize("k", [1, 3])
def test_resumed_run_equals_unbroken_run(tmp_path, k):
    """n = 5 steps through fit against k steps, a save, a restore into a
    fresh state (other initial weights and generator seeds) and 5 - k
    steps on the following batches."""
    n = 5
    batches = _batches(n)
    unbroken = fit(_state(0, 3), iter(batches), "diffusion", n)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    first = fit(_state(0, 3), iter(batches[:k]), "diffusion", k,
                checkpointer=mgr, checkpoint_every=k)
    assert mgr.latest_step() == k == first.step
    fresh = _state(11, 99)
    assert not torch.equal(fresh.params["readout_encoder.pos_embedding"],
                           first.params["readout_encoder.pos_embedding"])
    resumed = mgr.restore(fresh)
    assert resumed is fresh
    _assert_states_equal(resumed, first)
    resumed = fit(resumed, iter(batches[k:]), "diffusion", n - k)
    _assert_states_equal(resumed, unbroken)


RETENTION = {
    "newest": (dict(max_to_keep=3), [(i, None) for i in range(1, 7)]),
    "newest_with_metrics": (dict(max_to_keep=2),
                            [(1, {"loss": 0.1}), (2, None), (3, {"loss": 5.0}),
                             (4, {"loss": 0.2})]),
    "best_min_after_unscored": (
        dict(max_to_keep=2, best_metric="loss"),
        [(1, None), (2, None), (3, {"loss": 3.0}), (4, {"loss": 1.0}),
         (5, {"loss": 2.0}), (6, {"loss": 5.0})]),
    "best_ties": (dict(max_to_keep=2, best_metric="loss"),
                  [(1, {"loss": 1.0}), (2, {"loss": 1.0}),
                   (3, {"loss": 1.0}), (4, {"loss": 2.0})]),
    "best_max": (dict(max_to_keep=2, best_metric="acc", best_mode="max"),
                 [(1, {"acc": 0.1}), (2, {"acc": 0.5}), (3, {"acc": 0.3}),
                  (4, None), (5, {"acc": 0.2})]),
    "best_metric_missing": (dict(max_to_keep=1, best_metric="loss"),
                            [(1, {"x": 1.0}), (2, {"loss": 3.0}),
                             (3, {"loss": 2.0})]),
    "interval": (dict(max_to_keep=3, save_interval_steps=2),
                 [(i, None) for i in range(1, 8)]),
}


@pytest.mark.parametrize("case", sorted(RETENTION))
def test_retention_keeps_the_steps_orbax_keeps(tmp_path, case):
    """The same saves and metrics through the JAX package's manager (orbax)
    and the port's: the same steps kept, the same data-state sidecars."""
    kw, saves = RETENTION[case]
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"), **kw)
    tmgr = CheckpointManager(str(tmp_path / "torch"), **kw)
    stub = types.SimpleNamespace(state_dict=lambda: {"x": torch.zeros(2)})
    for step, metrics in saves:
        jmgr.save(step, {"x": jnp.zeros(2)}, data_state={"i": step},
                  metrics=metrics)
        tmgr.save(step, stub, data_state={"i": step}, metrics=metrics)
    jmgr.wait()
    want = sorted(jmgr._mgr.all_steps())
    jdata = [s for s, _ in saves if jmgr.restore_data_state(s) is not None]
    jmgr.close()
    assert tmgr.all_steps() == want
    assert tmgr.latest_step() == max(want)
    assert [s for s, _ in saves
            if tmgr.restore_data_state(s) is not None] == jdata
    assert tmgr.restore_data_state() == {"i": max(want)}


def test_restore_data_state_and_empty_directory(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None and mgr.restore_data_state() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(0, 0))
    stub = types.SimpleNamespace(state_dict=lambda: {})
    assert mgr.save(3, stub, data_state={"consumed": 7})
    assert mgr.save(4, stub)
    assert not mgr.save(4, stub)        # a step is saved once
    assert mgr.restore_data_state(3) == {"consumed": 7}
    assert mgr.restore_data_state() is None     # step 4 carried none
    # written atomically: no temporary file is left behind
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def _counting_step(state, text, images, actions):
    """A step that only counts (fit's hooks are under test, not the
    model)."""
    state.step += 1
    loss = torch.tensor(float(state.step))
    state.metrics.update(loss=loss, grad_norm=loss)
    return state, loss


class _Logger:
    def __init__(self):
        self.logged = []

    def log(self, metrics, step):
        self.logged.append((step, metrics))


def test_fit_checkpoints_and_evaluates_on_schedule(tmp_path):
    """checkpoint_every=2 over 5 steps saves at 2 and 4 and once at the
    end; eval_fn every 2 steps is logged under eval/ and rides along with
    the saves; data_state_fn's value is saved beside each."""
    state = _state(0, 0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10)
    logger = _Logger()
    evals = []

    def eval_fn(st):
        evals.append(st.step)
        return {"loss": torch.tensor(10.0 + st.step)}

    fit(state, iter(_batches(5)), "diffusion", 5, logger=logger,
        log_every=10, checkpointer=mgr, checkpoint_every=2,
        step_fn=_counting_step, eval_fn=eval_fn, eval_every=2,
        data_state_fn=lambda: {"consumed": state.step})
    assert evals == [2, 4]
    assert logger.logged == [(2, {"eval/loss": 12.0}),
                             (4, {"eval/loss": 14.0})]
    assert mgr.all_steps() == [2, 4, 5]
    assert [mgr.restore_data_state(s) for s in (2, 4, 5)] == [
        {"consumed": 2}, {"consumed": 4}, {"consumed": 5}]
    assert mgr._metrics(2) == {"loss": 12.0}
    assert mgr._metrics(5) == {"loss": 14.0}     # the latest eval
    assert mgr.restore(_state(5, 5)).step == 5


@pytest.fixture
def plain_signal_handlers():
    """SIGINT and SIGTERM at Python's defaults for the test, restored
    after it (graceful_stop chains to what it finds)."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    signal.signal(signal.SIGINT, signal.default_int_handler)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def test_fit_stops_on_the_first_sigint_and_saves(tmp_path,
                                                 plain_signal_handlers):
    """A SIGINT sent to the process during step 3 of 10: fit finishes that
    step, saves a last checkpoint and returns; a second SIGINT raises
    KeyboardInterrupt."""
    stop = graceful_stop()
    state = _state(0, 0)
    mgr = CheckpointManager(str(tmp_path))

    def step_fn(st, *batch):
        st, loss = _counting_step(st, *batch)
        if st.step == 3:
            os.kill(os.getpid(), signal.SIGINT)
        return st, loss

    state = fit(state, iter(_batches(10)), "diffusion", 10,
                checkpointer=mgr, step_fn=step_fn, should_stop=stop)
    assert stop() and state.step == 3 and mgr.all_steps() == [3]
    _second_sigint_raises()


def _second_sigint_raises():
    """The installed handler, called as a second SIGINT calls it, raises
    KeyboardInterrupt (called directly: a raise from a signal handler can
    land in whatever Python code runs when the signal is handled, such as
    a garbage-collector callback)."""
    handler = signal.getsignal(signal.SIGINT)
    with pytest.raises(KeyboardInterrupt):
        handler(signal.SIGINT, None)


def test_graceful_stop_sigterm_does_not_arm_the_second_sigint(
        plain_signal_handlers):
    stop = graceful_stop()
    assert not stop()
    os.kill(os.getpid(), signal.SIGTERM)
    assert stop()
    os.kill(os.getpid(), signal.SIGINT)     # the first SIGINT: no raise
    _second_sigint_raises()


def test_evaluate_inside_fit_leaves_training_unchanged():
    """fit with evaluate as eval_fn gives the state fit without it gives:
    evaluate draws from generators of its own."""
    batches = _batches(4)
    plain = fit(_state(0, 1), iter(batches), "diffusion", 4)
    logger = _Logger()
    held_out = _batches(2, seed=5)
    hooked = fit(_state(0, 1), iter(batches), "diffusion", 4, logger=logger,
                 log_every=100, eval_every=2,
                 eval_fn=lambda st: evaluate(st, iter(held_out),
                                             "diffusion", 2))
    _assert_states_equal(hooked, plain)
    assert [s for s, _ in logger.logged] == [2, 4]
    assert all(np.isfinite(m["eval/loss"]) for _, m in logger.logged)


# -- asynchronous saves ----------------------------------------------------------

class _HeldWriter:
    """Holds the writer thread's ``torch.save`` until released, so a test
    can act while a save is in flight."""

    def __init__(self, monkeypatch, fail=False):
        import threading
        from multi_modal_transformers_tokenmerge_torch.train import (
            checkpoint as tckpt)
        self.release = threading.Event()
        self.started = threading.Event()
        original = tckpt.torch.save

        def save(obj, f):
            self.started.set()
            assert self.release.wait(30), "the held save was never released"
            if fail:
                raise OSError("disk full")
            return original(obj, f)

        monkeypatch.setattr(tckpt.torch, "save", save)


def test_save_returns_before_the_write_lands(tmp_path, monkeypatch):
    """``save`` returns with the write held in flight: no step is visible
    yet, the state keeps training (three more steps, updated in place),
    and once ``wait`` has joined the writer a restore equals the state at
    the saved step bit for bit, not the later one."""
    batches = _batches(5)
    state = fit(_state(0, 3), iter(batches[:2]), "diffusion", 2)
    saved = _state(0, 3)
    saved.load_state_dict(state.state_dict())
    held = _HeldWriter(monkeypatch)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(state.step, state)
    assert held.started.wait(30)
    assert mgr.all_steps() == [] and mgr.latest_step() is None
    assert not any(n.endswith(".pt") for n in os.listdir(tmp_path))
    state = fit(state, iter(batches[2:]), "diffusion", 3)
    assert state.step == 5
    held.release.set()
    mgr.wait()
    assert mgr.all_steps() == [2]
    restored = mgr.restore(_state(11, 99))
    _assert_states_equal(restored, saved)
    assert not torch.equal(restored.params["readout_encoder.pos_embedding"],
                           state.params["readout_encoder.pos_embedding"])


def test_a_second_save_waits_for_the_first(tmp_path, monkeypatch):
    import threading
    state = _state(0, 3)
    held = _HeldWriter(monkeypatch)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    mgr.save(1, state)
    assert held.started.wait(30)
    done = threading.Event()
    second = threading.Thread(target=lambda: (mgr.save(2, state),
                                              done.set()))
    second.start()
    assert not done.wait(0.3)        # blocked behind the save in flight
    held.release.set()
    second.join(30)
    assert done.is_set()
    mgr.wait()
    # retention pruned step 1 once step 2 had landed
    assert mgr.all_steps() == [2]


def test_a_writer_fault_surfaces_at_wait(tmp_path, monkeypatch):
    """An error of the writer thread is raised by the next ``wait`` (once),
    and leaves no checkpoint and no temporary file behind as a step."""
    state = _state(0, 3)
    held = _HeldWriter(monkeypatch, fail=True)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(1, state)
    held.release.set()
    with pytest.raises(RuntimeError, match="save") as err:
        mgr.wait()
    assert isinstance(err.value.__cause__, OSError)
    assert mgr.all_steps() == []
    mgr.wait()                        # raised once
    monkeypatch.undo()
    assert mgr.save(1, state)
    mgr.close()
    assert mgr.all_steps() == [1]


def test_a_writer_fault_surfaces_at_the_next_save(tmp_path, monkeypatch):
    state = _state(0, 3)
    held = _HeldWriter(monkeypatch, fail=True)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    held.release.set()
    with pytest.raises(RuntimeError, match="save"):
        mgr.save(2, state)


def test_fit_waits_for_its_last_save(tmp_path):
    """fit returns once its last save has landed: the step is on disk."""
    mgr = CheckpointManager(str(tmp_path))
    state = fit(_state(0, 3), iter(_batches(3)), "diffusion", 3,
                checkpointer=mgr, checkpoint_every=2)
    assert mgr._writer is None
    assert os.path.exists(tmp_path / "3.pt") and mgr.all_steps() == [2, 3]
    assert state.step == 3
