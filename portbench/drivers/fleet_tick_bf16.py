"""Fleet control ticks, as ``fleet_tick``, for a configuration whose
parameters are bfloat16 and too many for one float32 buffer
(``octo_moonlight``: 15.4 B parameters, 57 GiB in float32).

``weights.draw`` puts every parameter in one float32 buffer; here each
tensor is drawn on its own and stored in bfloat16, straight into the
program's parameters (or, for the reference, into a dict), so that no
second copy of the weights is held:

- every tensor outside the transformer (T5, the image tower, the readouts,
  the text projection, the diffusion head) by ``weights.draw`` over all of
  them at once, from the weights' seed, under its rules (the tied
  denoiser, T5's query scale), then rounded to bfloat16;
- each transformer tensor from a seed of its own (the weights' seed and
  its index), normal with ``weights.std_of``'s mean and std, except the
  stacked experts ((E, out, in): std 1 / sqrt(in), each expert a matrix of
  its own), then rounded to bfloat16.  The router's selection bias is a
  bias (std 0.02).

The reference (``reference/moonlight.py``) recomputes all the sampled
ticks' rows in one batch, from the weights drawn again after the program
has been freed, each upcast to float32 where it is used.

The check compares the program's error against the float32 reference with
the error that the reference itself reads at the configuration's precision
(every product's operands rounded to bfloat16, the witness) on the same
rows: ``actions_err_over_bf16``, the ratio of the two norms.  At bfloat16
this stack's actions move 6-16% from float32 on a sound run (many routing
choices flip with the rounding and 26 routed layers and 32 denoising steps
carry them), and by how much depends on the seed: the witness moves with
it, so the ratio holds still (1.11-1.37 over 12 seeds on the H100) where
the raw error spreads over 2.5x, and a fault or a float8 route, which read
2-3 times the error of their own seed, stand apart from it.
"""

from __future__ import annotations

import json
import math
import time
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .. import weights as W
from ..counts import moonlight as counts
from ..reference import layout as L
from ..reference.moonlight import MoonlightReference
from ..reference.octo import exact_float32
from .fleet_tick import Workload as FleetTick
from .fleet_tick import sub_seed

__all__ = ["Workload", "draws", "EXPERT_STACKS"]

# stacked expert weights (E, out, in): each expert's fan-in is its own
EXPERT_STACKS = (".w_gate_up", ".w_down")


def _std(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    if name.endswith(EXPERT_STACKS):
        return 0.0, 1.0 / math.sqrt(shape[-1])
    return W.std_of(name, shape)


def draws(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
          model: Dict) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, bfloat16 tensor on ``device``) for every parameter of
    ``shapes``, as the module docstring draws them; one tensor of the
    transformer's in float32 at a time."""
    rest = {k: v for k, v in shapes.items()
            if not k.startswith("transformer.")}
    for name, t in W.draw(rest, seed, device, model).items():
        yield name, t.to(torch.bfloat16)
    stack = [k for k in shapes if k.startswith("transformer.")]
    g = torch.Generator(device=device)
    for i, name in enumerate(stack):
        g.manual_seed(sub_seed(seed, 1 + i))
        mean, std = _std(name, tuple(shapes[name]))
        t = torch.randn(shapes[name], generator=g, device=device)
        yield name, t.mul_(std).add_(mean).to(torch.bfloat16)
        del t


class Workload(FleetTick):
    def setup(self) -> None:
        """Build the model with empty bfloat16 parameters, draw each into
        place, then the instruction, the observations and the engine as
        ``fleet_tick`` does."""
        from multi_modal_transformers_tokenmerge_torch import (
            Octo, PolicyEngine, load_config)
        import dataclasses
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
        params = dict(model.named_parameters())
        self.shapes = {k: tuple(v.shape) for k, v in params.items()}
        with torch.no_grad():
            for name, t in draws(self.shapes, sub_seed(self.seed, 0),
                                 self.device, m):
                params[name].copy_(t)
        del params
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
        del model
        self.engine.set_instruction(self.instruction)
        self.engine.compile((self.text_tokens,), shape[1:])
        stop = time.perf_counter() + self.traffic["warmup_s"]
        while True:
            self._call(self.calls % len(self.pool))
            if time.perf_counter() >= stop:
                break

    def layer_counts(self) -> Dict:
        m = self.model_cfg
        return {"flops_per_unit": counts.request_flops(m, self.batch)["total"],
                "expert_calls": counts.expert_calls(m, self.batch),
                "dtype": m["dtype"]}

    @staticmethod
    def compared_to_witness(got: torch.Tensor, want: torch.Tensor,
                            witness: torch.Tensor) -> Dict:
        """The actions' error against the float32 reference over the
        witness's, over every sampled row."""
        return {"actions_err_over_bf16":
                ((got - want).norm() / (witness - want).norm()).item()}

    def check(self) -> Dict[str, float]:
        """The compared number of the ticks the reference recomputes."""
        calls = self.sample()
        got = torch.cat([self.actions[i] for i in calls])
        want = self.reference_actions(calls)
        witness = self.reference_actions(calls, operands=torch.bfloat16)
        return self.compared_to_witness(got, want, witness)

    def reference_actions(self, calls, operands=None):
        """(rows, A) actions of the given engine calls by the reference, all
        rows in one batch."""
        m = self.model_cfg
        c = m["heads"]["diffusion"]
        steps, adim = c["diffusion_steps"], c["action_space_dim"]
        weights = dict(draws(self.shapes, sub_seed(self.seed, 0),
                             self.device, m))
        ref = MoonlightReference(m, weights, self.device, operands=operands)
        g = torch.Generator(device=self.device)
        g.manual_seed(self.engine_seed)
        noisy, noise = [], []
        for i in range(max(calls) + 1):
            a = torch.randn((self.batch, adim), generator=g,
                            device=self.device)
            b = torch.randn((steps, self.batch, adim), generator=g,
                            device=self.device)
            if i in calls:
                noisy.append(a)
                noise.append(b)
        images = torch.cat([self.pool[i % len(self.pool)] for i in calls])
        rows = images.shape[0]
        with torch.no_grad(), exact_float32():
            text = ref.encode_text(torch.as_tensor(
                self.instruction, device=self.device)[None])
            out = ref.policy(text.expand(rows, -1, -1),
                             images.to(self.device), torch.cat(noisy),
                             torch.cat(noise, dim=1)).cpu()
        del weights, ref
        return out
