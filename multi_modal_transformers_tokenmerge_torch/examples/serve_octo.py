"""Serve an OCTO policy: compile, cache the instruction, run a
micro-batched request loop.

Usage:
    python -m multi_modal_transformers_tokenmerge_torch.examples.serve_octo
        [--preset octo_tiny] [--head continuous] [--batch 4]
        [--requests 16] [--image-tower bf16] [--text-tower bf16]
        [--ddim-steps S] [--device cuda] [--override KEY=VALUE ...]

The port's counterpart of the JAX package's ``examples/serve_octo.py``,
with its flags and its messages: ``PolicyEngine.compile`` (CUDA graphs on
the card, the serving copy on the CPU), a cached instruction, and
``--requests`` single observations from as many threads through a
``PolicyServer``.  ``--device``: the card unless ``cpu`` is asked for;
``--override``: any field of the preset's config (``dtype=bfloat16``).
"""

import argparse
import threading
import time

import numpy as np
import torch

from .. import Octo, get_preset
from ..core.yaml_loader import apply_overrides
from ..modules.text import WordTokenizer
from ..serve.policy import PolicyEngine
from ..serve.server import PolicyServer


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="octo_tiny")
    p.add_argument("--head", default="continuous")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--image-tower", default="bf16",
                   choices=["bf16", "int8", "w8"],
                   help="the patch embedder: the model's own, or quantized "
                        "(serve/quantize.py)")
    p.add_argument("--text-tower", default="bf16",
                   choices=["bf16", "int8", "w8"],
                   help="the frozen T5 instruction encoder: the model's "
                        "own, or quantized (t5 presets only)")
    p.add_argument("--ddim-steps", type=int, default=None,
                   help="serve with S-step deterministic DDIM instead of "
                        "the full DDPM reverse loop; requires "
                        "--head diffusion")
    p.add_argument("--device", default="cuda",
                   help="where the policy runs: the card (default) or "
                        "'cpu' when asked for")
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="set a field of the preset's config, as the CLI's "
                        "config overrides (e.g. dtype=bfloat16, "
                        "transformer.attention_impl=flash); repeatable")
    args = p.parse_args(argv)
    if args.ddim_steps is not None and args.head != "diffusion":
        p.error("--ddim-steps requires --head diffusion")
    return args


def main(argv=None):
    args = parse_args(argv)
    cfg = apply_overrides(get_preset(args.preset), args.override)
    model = Octo(cfg, device=torch.device(args.device), seed=0).eval()
    frames = cfg.num_observation_blocks
    image_shape = ((frames, *cfg.images.image_size) if frames > 1
                   else cfg.images.image_size)
    text_shape = (cfg.text.max_length,)

    engine = PolicyEngine(model, head=args.head, batch_size=args.batch,
                          image_tower=args.image_tower,
                          text_tower=args.text_tower,
                          ddim_steps=args.ddim_steps)
    t0 = time.time()
    engine.compile(text_shape, image_shape)
    print(f"AOT compile: {time.time() - t0:.1f}s")

    tok = WordTokenizer.from_corpus(
        ["pick up the red block and place it on the green block"],
        max_length=cfg.text.max_length)
    instruction = np.repeat(tok(["pick up the red block"]), args.batch, 0)
    engine.set_instruction(instruction)
    print("instruction cached (text tower will not run again)")

    rng = np.random.default_rng(0)
    with PolicyServer(engine, max_wait_ms=2.0) as server:
        results = [None] * args.requests
        errors = []

        def call(i):
            obs = rng.uniform(0, 255, image_shape).astype(np.float32)
            t = time.perf_counter()
            try:
                results[i] = (server.predict(obs), time.perf_counter() - t)
            except Exception as e:  # surface it, don't die in the thread
                errors.append((i, e))

        t0 = time.time()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(args.requests)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        wall = time.time() - t0

    if errors:
        i, e = errors[0]
        raise RuntimeError(
            f"{len(errors)}/{args.requests} requests failed "
            f"(first: request {i})") from e
    lats = sorted(r[1] for r in results)
    sample = np.asarray(torch.as_tensor(results[0][0]).float().cpu())
    print(f"{args.requests} requests in {wall * 1e3:.0f}ms "
          f"(p50 latency {lats[len(lats) // 2] * 1e3:.1f}ms); "
          f"sample action: {sample.ravel()[:4].round(3)}")


if __name__ == "__main__":
    main()
