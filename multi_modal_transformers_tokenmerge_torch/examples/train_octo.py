"""Train an OCTO policy end to end on synthetic data.

Usage:
    python -m multi_modal_transformers_tokenmerge_torch.examples.train_octo
        [--preset octo_tiny] [--head continuous] [--steps 200] [--batch 8]
        [--data-parallel] [--ckpt DIR] [--resume] [--recordio FILE]
        [--episodes FILE] [--cached-text] [--device cuda] [--remat]
        [--accum-steps N] [--override KEY=VALUE ...]

The port's counterpart of the JAX package's ``examples/train_octo.py``,
with its flags and its messages: config -> model -> optimizer with warmup,
cosine decay and clipping -> prefetched data -> the train step (a CUDA
graph on the card) -> metrics -> checkpoints.  ``--recordio FILE`` writes
a synthetic dataset to FILE on first use and streams batches through the
record reader; ``--episodes FILE`` does the same with frame-history
windows.  With ``--ckpt`` a SIGTERM or SIGINT stops the run through
``graceful_stop``: the last checkpoint is saved, ``final:`` printed and
the exit code is 0; ``--resume`` then restores the train state and the
data stream's position.  The port's own flags: ``--device`` (the card
unless ``cpu`` is asked for), ``--remat`` (``transformer.remat``),
``--accum-steps`` (the step's ``accum_steps``) and ``--override`` (any
field of the preset's config, e.g. ``dtype=bfloat16``, as the CLI's
``config`` command takes it); ``--data-parallel`` makes a mesh over the
process group's ranks (a world of one without one).
"""

import argparse
import itertools
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import (CheckpointManager, Octo, create_train_state, fit,
                get_preset, graceful_stop, make_optimizer)
from ..core.yaml_loader import apply_overrides
from ..parallel.mesh import make_mesh
from ..utils.data import prefetch_to_device, synthetic_octo_batches
from ..utils.logging import MetricLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="octo_tiny")
    p.add_argument("--head", default="continuous",
                   choices=["continuous", "categorical", "diffusion"])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in --ckpt (train "
                        "state AND data-stream position for --recordio) "
                        "and run --steps more steps")
    p.add_argument("--cached-text", action="store_true",
                   help="precompute the frozen text tower's embeddings per "
                        "distinct instruction and train on them (requires "
                        "a t5-kind frozen text tower)")
    p.add_argument("--recordio", default=None, metavar="FILE",
                   help="stream batches from FILE via the record "
                        "loader (synthetic data written there on first use)")
    p.add_argument("--shards", type=int, default=None,
                   help="shard the record stream across N processes "
                        "(default: the process group's size); this process "
                        "reads shard --shard-id (default: its rank)")
    p.add_argument("--shard-id", type=int, default=None)
    p.add_argument("--episodes", default=None, metavar="FILE",
                   help="stream frame-history windows from an EPISODE "
                        "file (utils/episodes.py; synthetic episodes "
                        "written there on first use)")
    p.add_argument("--device", default="cuda",
                   help="where the model trains: the card (default) or "
                        "'cpu' when asked for")
    p.add_argument("--remat", action="store_true",
                   help="recompute each transformer block in the backward "
                        "(transformer.remat)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="accumulate the gradients of this many "
                        "microbatches per update")
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="set a field of the preset's config, as the CLI's "
                        "config overrides (e.g. dtype=bfloat16, "
                        "transformer.attention_impl=flash); repeatable")
    return p.parse_args(argv)


def _episode_batches(args, cfg, head_cfg, frames, ckpt, resume_step):
    from ..utils.episodes import EpisodeWindowSampler, write_episodes
    img_cfg = cfg.images
    if not os.path.exists(args.episodes):
        rng = np.random.default_rng(0)
        n_eps, written = max(args.batch, 16), 0

        def eps():
            nonlocal written
            for _ in range(n_eps):
                t = int(rng.integers(6, 14))
                written += t
                yield {
                    "images": rng.integers(
                        0, 255, (t, *img_cfg.image_size), np.uint8),
                    "actions": rng.normal(
                        0, 0.3, (t, head_cfg.action_space_dim)
                    ).astype(np.float32),
                    "text_ids": rng.integers(
                        0, cfg.text.vocab_size,
                        (cfg.text.max_length,)).astype(np.int32),
                }

        write_episodes(args.episodes, eps())
        print(f"wrote {n_eps} synthetic episodes ({written} steps) "
              f"to {args.episodes}")
    sampler = EpisodeWindowSampler(args.episodes, args.batch, frames=frames,
                                   shuffle_seed=0)
    print(f"episode windows: {sampler.num_steps} steps, "
          f"{frames}-frame history")
    if resume_step is not None:
        ds = ckpt.restore_data_state(resume_step)
        if ds is not None:
            sampler.restore_state(ds)
            print(f"resumed episode stream at batch {ds['consumed']}")

    def batches():
        for b in sampler:
            img = b["images"].astype(np.float32)
            if frames == 1:
                img = img[:, 0]
            yield (b["text_ids"].astype(np.int32), img, b["actions"])

    return batches(), sampler.state


def _record_batches(args, cfg, head_cfg, image_shape, ckpt, resume_step):
    from ..utils.recordio import RecordReader, write_records
    if not os.path.exists(args.recordio):
        n = max(4 * args.batch, 64)
        examples = (
            {"text": t[0], "images": im[0], "actions": a[0]}
            for t, im, a in itertools.islice(
                synthetic_octo_batches(
                    1, image_shape=image_shape,
                    text_length=cfg.text.max_length,
                    action_dim=head_cfg.action_space_dim,
                    vocab_size=cfg.text.vocab_size), n))
        wrote = write_records(args.recordio, examples)
        print(f"wrote {wrote} synthetic records to {args.recordio}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    num_shards = args.shards or world
    shard_id = args.shard_id if args.shard_id is not None else rank
    reader = RecordReader(args.recordio, batch_size=args.batch,
                          shuffle_seed=0, shard_id=shard_id,
                          num_shards=num_shards)
    print(f"record loader: backend={reader.backend}, "
          f"{reader.num_records} records"
          + (f", shard {shard_id}/{num_shards}" if num_shards > 1 else ""))
    if resume_step is not None:
        ds = ckpt.restore_data_state(resume_step)
        if ds is not None:
            reader.restore_state(ds)
            print(f"resumed data stream at batch {ds['consumed']}")
    return ((b["text"], b["images"], b["actions"]) for b in reader), \
        reader.state


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    cfg = apply_overrides(get_preset(args.preset), args.override)
    if args.remat:
        cfg = cfg.replace(transformer=cfg.transformer.replace(remat=True))
    head_cfg = getattr(cfg.heads, args.head)
    if head_cfg is None:
        raise SystemExit(f"preset {args.preset} has no {args.head} head")
    model = Octo(cfg, device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{args.preset}: {n_params / 1e6:.1f}M params, head={args.head}")

    img_cfg = cfg.images
    frames = cfg.num_observation_blocks
    image_shape = ((frames, *img_cfg.image_size) if frames > 1
                   else img_cfg.image_size)

    # a frozen t5 tower carries no optimizer state (embed-kind towers train)
    frozen = ("text_encoder",) if cfg.text.kind == "t5" else ()
    tx = make_optimizer(peak_lr=3e-4, warmup_steps=20,
                        total_steps=args.steps, params=model,
                        frozen_prefixes=frozen)
    state = create_train_state(model, tx, rngs=0)

    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    resume_step = None
    if ckpt is not None and args.resume:
        resume_step = ckpt.latest_step()
        if resume_step is not None:
            ckpt.restore(state)
            print(f"resumed train state from step {resume_step}")

    mesh = None
    if args.data_parallel:
        mesh = make_mesh(model=1)
        print(f"data-parallel over {tuple(mesh.shape)} devices")

    data_state_fn = None
    if args.episodes:
        batches, data_state_fn = _episode_batches(
            args, cfg, head_cfg, frames, ckpt, resume_step)
    elif args.recordio:
        batches, data_state_fn = _record_batches(
            args, cfg, head_cfg, image_shape, ckpt, resume_step)
    else:
        batches = synthetic_octo_batches(
            args.batch, image_shape=image_shape,
            text_length=cfg.text.max_length,
            action_dim=head_cfg.action_space_dim,
            vocab_size=cfg.text.vocab_size)

    if args.cached_text:
        from ..utils.data import cache_text_embeddings
        batches = cache_text_embeddings(batches, model)
        print("cached-text training: frozen tower runs once per "
              "distinct instruction")

    data = prefetch_to_device(batches, size=2, device=device, mesh=mesh,
                              microbatches=args.accum_steps)

    # SIGTERM / SIGINT (preemption, ctrl-C) checkpoints and exits cleanly;
    # restart with --resume to continue
    state = fit(state, data, head=args.head, num_steps=args.steps,
                mesh=mesh, logger=MetricLogger(), log_every=25,
                checkpointer=ckpt, checkpoint_every=100,
                text_input="embeddings" if args.cached_text else "ids",
                data_state_fn=data_state_fn,
                should_stop=graceful_stop() if ckpt else None,
                accum_steps=args.accum_steps)
    print("final:", {k: float(v) for k, v in
                     state.metrics.compute().items()})
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
