"""Fleet control ticks through the port's compiled ``PolicyEngine``.

A fleet controller hands one observation batch of ``batch`` robots (two
frames each, uint8, in page-locked host memory, as a serving stack stages
its inputs) to ``PolicyEngine.__call__`` under one cached instruction and
waits for the (batch, A) float32 actions in host memory, then hands the
next: a closed loop with one caller.  A tick's latency runs from handing
the batch to the engine until its actions are in host memory; the
actions delivered per second are the engine's throughput.

Traffic parameters (``traffic/<name>.json``): ``batch``, ``pool``
(distinct observation batches drawn from the seed and cycled, so that no
two consecutive ticks share inputs), ``warmup_s`` (seconds of ticks run in
set-up, after the compile, until the tick time has settled),
``check_rows`` (rows the reference recomputes after the window).

The engine draws its diffusion noise from its own generator, seeded by the
benchmark; the reference draws the same stream itself (torch's Philox, the
same calls in the same order) and recomputes every sampled tick from the
observation, the instruction and the weights, all drawn from the seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import random
import time
from typing import Dict, List

import numpy as np
import torch

from .. import weights as W
from ..counts import octo as counts
from ..reference import layout as L
from ..reference.octo import OctoReference, exact_float32

__all__ = ["Workload"]

def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % 2**63


class Workload:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 engine_kw: Dict = None):
        """``engine_kw``: further ``PolicyEngine`` arguments (the quantized
        towers), for the control readings of ``tools/calibrate.py``."""
        self.engine_kw = engine_kw or {}
        self.config = config
        self.model_cfg = config["model"]
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.batch = traffic["batch"]
        self.ticks: List[tuple] = []      # (index, begin, end)
        self.actions: Dict[int, torch.Tensor] = {}
        self.calls = 0                    # engine calls, warm-up included

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        """Draw the weights, the instruction and the observations; build,
        compile and warm up the engine."""
        from multi_modal_transformers_tokenmerge_torch import (
            Octo, PolicyEngine, load_config)
        m = self.model_cfg
        cfg = load_config(self.config["preset"], self.config["overrides"])
        resolved = json.loads(json.dumps(dataclasses.asdict(cfg)))
        if resolved != m:
            diff = sorted(k for k in set(resolved) | set(m)
                          if resolved.get(k) != m.get(k))
            raise SystemExit(
                f"the program's {self.config['preset']!r} with the "
                f"configuration's overrides is no longer the model the "
                f"configuration file states (keys {diff} differ)")
        model = Octo(cfg, device=self.device, seed=None)
        self.shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        model.load_state_dict(W.draw(self.shapes, sub_seed(self.seed, 0),
                                     self.device, m), assign=True)
        rng = np.random.default_rng(sub_seed(self.seed, 1))
        img = m["images"]
        frames = m["num_observation_blocks"]
        sets = L.parse(m["input_sequence"], m["compression_sequence"])
        self.text_tokens = sum(s.tokens for s in sets
                               if L.STREAM[s.kind] == "text")
        self.instruction = rng.integers(0, m["text"]["vocab_size"],
                                        self.text_tokens, dtype=np.int64)
        shape = (self.batch, frames, *img["image_size"])
        self.pool = [torch.from_numpy(rng.integers(0, 256, shape,
                                                   dtype=np.uint8))
                     for _ in range(self.traffic["pool"])]
        if self.device.type == "cuda":
            self.pool = [x.pin_memory() for x in self.pool]
        self.engine_seed = sub_seed(self.seed, 2)
        self.engine = PolicyEngine(model, head="diffusion",
                                   batch_size=self.batch,
                                   seed=self.engine_seed, **self.engine_kw)
        self.engine.set_instruction(self.instruction)
        self.engine.compile((self.text_tokens,), shape[1:])
        stop = time.perf_counter() + self.traffic["warmup_s"]
        while True:
            self._call(self.calls % len(self.pool))
            if time.perf_counter() >= stop:
                break

    def _call(self, slot: int) -> torch.Tensor:
        out = self.engine(self.pool[slot]).cpu()
        self.calls += 1
        return out

    # -- the window --------------------------------------------------------

    def window(self, seconds: float, annotate: bool = False) -> Dict:
        """Ticks back to back until ``seconds`` have passed; returns the
        window's length and counts.  ``annotate`` marks each tick for the
        profiler."""
        mark = (torch.profiler.record_function if annotate
                else lambda name: contextlib.nullcontext())
        start = time.perf_counter()
        stop = start + seconds
        end = start
        while end < stop:
            index = self.calls
            with mark("fleet_tick.call"):
                begin = time.perf_counter()
                self.actions[index] = self._call(index % len(self.pool))
                end = time.perf_counter()
            self.ticks.append((index, begin, end))
        return {"window_s": end - start, "units": len(self.ticks),
                "rows": len(self.ticks) * self.batch}

    def end_to_end(self, stats: Dict) -> Dict[str, float]:
        """Every end-to-end metric this traffic can give: the 95th
        percentile (nearest rank) of every tick's latency, and the rows
        of every tick over the window."""
        lat = sorted(end - begin for _, begin, end in self.ticks)
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
        return {"action_p95_ms": p95 * 1e3,
                "actions_per_s": stats["rows"] / stats["window_s"]}

    def layer_counts(self) -> Dict:
        """What the per-layer readers need of one unit (one tick)."""
        m = self.model_cfg
        return {"flops_per_unit": counts.request_flops(m, self.batch)["total"],
                "flash_fwd_calls": counts.flash_fwd_calls(m, self.batch),
                "sampler_call": counts.sampler_call(m, self.batch),
                "dtype": m["dtype"]}

    # -- after the window --------------------------------------------------

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> List[int]:
        """Engine-call indices of the ticks the reference recomputes: the
        window's first and last, and others drawn from the seed."""
        done = [t[0] for t in self.ticks]
        want = max(1, math.ceil(self.traffic["check_rows"] / self.batch))
        picked = [done[-1]] if want == 1 else sorted({done[0], done[-1]})
        rest = [i for i in done if i not in picked]
        rng = random.Random(sub_seed(self.seed, 3))
        picked += rng.sample(rest, min(len(rest), want - len(picked)))
        return sorted(picked)

    def reference_actions(self, calls: List[int], operands=None):
        """(rows, A) actions of the given engine calls by the reference
        (the control with ``operands`` set)."""
        m = self.model_cfg
        c = m["heads"]["diffusion"]
        steps, adim = c["diffusion_steps"], c["action_space_dim"]
        weights = W.draw(self.shapes, sub_seed(self.seed, 0), self.device, m)
        ref = OctoReference(m, weights, self.device, operands=operands)
        g = torch.Generator(device=self.device)
        g.manual_seed(self.engine_seed)
        noise = {}
        for i in range(max(calls) + 1):
            noisy = torch.randn((self.batch, adim), generator=g,
                                device=self.device)
            per_step = torch.randn((steps, self.batch, adim), generator=g,
                                   device=self.device)
            if i in calls:
                noise[i] = (noisy, per_step)
        out = []
        with torch.no_grad(), exact_float32():
            text = ref.encode_text(torch.as_tensor(
                self.instruction, device=self.device)[None])
            for i in calls:
                images = self.pool[i % len(self.pool)].to(self.device)
                out.append(ref.policy(text.expand(self.batch, -1, -1), images,
                                      *noise[i]).cpu())
        return torch.cat(out)

    @staticmethod
    def compared(got: torch.Tensor, want: torch.Tensor) -> Dict:
        """The root mean square of the actions' error over that of the
        reference's actions, over every sampled row."""
        return {"actions_rms_rel": ((got - want).norm() / want.norm()).item()}

    def check(self) -> Dict[str, float]:
        """The compared numbers of the ticks the reference recomputes."""
        calls = self.sample()
        got = torch.cat([self.actions[i] for i in calls])
        return self.compared(got, self.reference_actions(calls))
