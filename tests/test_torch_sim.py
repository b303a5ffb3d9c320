"""The port's copy of ``utils/sim.py`` (the closed-loop reach task)
against the JAX package's: the same seeds give identical scenes, renders,
expert actions, episodes and state pairs (exact), an expert-policy rollout
gives identical metrics (exact), and a rollout driven by the port's
PolicyEngine equals one driven by the JAX engine on the same weights
(success exact, final distance to 1e-5)."""

import numpy as np
import pytest

from multi_modal_transformers_tokenmerge_torch.utils import sim as tsim
from multi_modal_transformers_tokenmerge_tpu.utils import sim as jsim


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_constants_and_instruction_ids():
    assert tsim.COLORS == jsim.COLORS
    for color in tsim.COLORS:
        for length in (4, 16):
            _equal_trees(tsim.instruction_ids(color, length),
                         jsim.instruction_ids(color, length))
    for mod in (tsim, jsim):
        with pytest.raises(ValueError):
            mod.instruction_ids("red", 3)


@pytest.mark.parametrize("kw", [{}, {"image_size": 64, "num_blocks": 4},
                                {"num_blocks": 2, "step_scale": 0.4}])
@pytest.mark.parametrize("seed", [0, 7])
def test_reset_render_step_expert_match(kw, seed):
    tt, jt = tsim.ReachTask(**kw), jsim.ReachTask(**kw)
    ts = tt.reset(np.random.default_rng(seed), 5)
    js = jt.reset(np.random.default_rng(seed), 5)
    _equal_trees(ts, js)
    assert tt.target_color_names(ts) == jt.target_color_names(js)
    _equal_trees(tt.instruction_batch(ts), jt.instruction_batch(js))
    for _ in range(3):
        _equal_trees(tt.render(ts), jt.render(js))
        a_t = tt.expert_action(ts, np.random.default_rng(seed), noise=0.1)
        a_j = jt.expert_action(js, np.random.default_rng(seed), noise=0.1)
        _equal_trees(a_t, a_j)
        ts, js = tt.step(ts, a_t), jt.step(js, a_j)
        _equal_trees(ts, js)
        _equal_trees(tt.succeeded(ts), jt.succeeded(js))
        _equal_trees(tt.distance_to_target(ts), jt.distance_to_target(js))


def test_episodes_and_state_pairs_match():
    tt, jt = tsim.ReachTask(image_size=64), jsim.ReachTask(image_size=64)
    for a, b in zip(tt.generate_episodes(np.random.default_rng(3), 4),
                    jt.generate_episodes(np.random.default_rng(3), 4)):
        _equal_trees(a, b)
    for a, b in zip(tt.generate_state_pairs(np.random.default_rng(4), 6),
                    jt.generate_state_pairs(np.random.default_rng(4), 6)):
        _equal_trees(a, b)


def _tracking_task(mod):
    """A ReachTask that keeps its live state, so the expert can act on it
    as the policy of a closed loop."""
    live = {}

    class Tracking(mod.ReachTask):
        def reset(self, rng, batch):
            live["s"] = super().reset(rng, batch)
            return live["s"]

        def step(self, state, actions):
            live["s"] = super().step(state, actions)
            return live["s"]

    return Tracking(image_size=64), live


@pytest.mark.parametrize("frames", [1, 2])
def test_expert_rollout_metrics_match(frames):
    """The expert as the policy: identical metrics and observations."""
    out, seen = {}, {}
    for key, mod in (("port", tsim), ("jax", jsim)):
        task, live = _tracking_task(mod)
        seen[key] = []

        def policy(obs, text, task=task, live=live, log=seen[key]):
            log.append((obs.copy(), text.copy()))
            return task.expert_action(live["s"])

        out[key] = task.rollout(policy, np.random.default_rng(11), 6,
                                frames=frames)
    assert out["port"] == out["jax"]
    assert out["port"]["success_rate"] == 1.0
    assert len(seen["port"]) == len(seen["jax"])
    for (o1, t1), (o2, t2) in zip(seen["port"], seen["jax"]):
        _equal_trees(o1, o2)
        _equal_trees(t1, t2)
        assert o1.dtype == np.uint8 and o1.shape[1] == frames


def test_initial_state_rollout_and_batch_check():
    tt, jt = tsim.ReachTask(image_size=64), jsim.ReachTask(image_size=64)
    scenes = tt.reset(np.random.default_rng(2), 3)
    null = lambda obs, text: np.zeros((obs.shape[0], 8), np.float32)
    got = tt.rollout(null, None, 3, initial_state=scenes)
    assert np.isnan(got["mean_steps_to_success"])   # none succeeds
    np.testing.assert_equal(got, jt.rollout(null, None, 3,
                                            initial_state=scenes))
    for task in (tt, jt):
        with pytest.raises(ValueError):
            task.rollout(null, None, 4, initial_state=scenes)


def test_rollout_through_port_engine_matches_jax_engine():
    """A closed loop through PolicyEngine (continuous head, one frame of
    64x64 uint8, per-row instructions) in both packages, same weights."""
    import jax
    import jax.numpy as jnp
    import torch
    from micro_configs import octo_micro
    from multi_modal_transformers_tokenmerge_torch import convert
    from multi_modal_transformers_tokenmerge_torch.models.octo import (
        Octo as TOcto)
    from multi_modal_transformers_tokenmerge_torch.serve.policy import (
        PolicyEngine as TEngine)
    from multi_modal_transformers_tokenmerge_tpu.models.octo import (
        Octo as JOcto)
    from multi_modal_transformers_tokenmerge_tpu.serve.policy import (
        PolicyEngine as JEngine)
    from torch_parity import to_torch_config

    cfg = octo_micro()
    cfg = cfg.replace(text=cfg.text.replace(vocab_size=16),
                      heads=cfg.heads.replace(
                          continuous=cfg.heads.continuous.replace(
                              action_space_dim=8)))
    jm = JOcto(cfg)
    v = jm.init({"params": jax.random.PRNGKey(0)},
                jnp.ones((4, 4), jnp.int32), jnp.ones((4, 64, 64, 3)))
    tc = to_torch_config(cfg)
    tm = TOcto(tc, device="cpu", seed=None)
    tm.load_state_dict(convert.from_flax(jax.tree.map(np.asarray,
                                                      v["params"]), tc))
    je = JEngine(jm, v, head="continuous", batch_size=4)
    te = TEngine(tm, head="continuous", batch_size=4)

    def jpolicy(obs, text):
        return np.asarray(je(jnp.asarray(obs[:, 0]),
                             text_tokens=jnp.asarray(text)))[:, 0]

    def tpolicy(obs, text):
        assert obs.dtype == np.uint8
        return te(torch.from_numpy(obs[:, 0]), text_tokens=text)[:, 0].numpy()

    task_t = tsim.ReachTask(image_size=64, max_steps=4)
    task_j = jsim.ReachTask(image_size=64, max_steps=4)
    got = task_t.rollout(tpolicy, np.random.default_rng(1), 4, frames=1,
                         text_length=4)
    want = task_j.rollout(jpolicy, np.random.default_rng(1), 4, frames=1,
                          text_length=4)
    assert got["success_rate"] == want["success_rate"]
    assert got["episodes"] == want["episodes"] == 4
    np.testing.assert_allclose(got["mean_final_distance"],
                               want["mean_final_distance"], rtol=1e-5)
