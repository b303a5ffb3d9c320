"""Episode storage and frame-history windowing for policy training.

The port's own copy of the JAX package's ``utils/episodes.py`` (numpy
only, same file format).  Robot training data arrives as variable-length
episodes of steps, but the model consumes fixed-shape windows:
``num_observation_blocks`` frames of image history plus the current step's
action and the episode's instruction.

* episodes are flattened to per-step records in the fixed-record format
  (``utils/recordio.py``), every record the same byte size;
* a training window is a memmap gather at computed offsets: frame indices
  ``[t-F+1 .. t]`` clamped at the episode start (the first frame repeats);
* sampling shuffles step indices per epoch, so every step of every episode
  is a training example once per epoch, with fixed output shapes
  ``images (B, F, H, W, C)``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator

import numpy as np

from .recordio import _read_header, write_records

__all__ = ["write_episodes", "EpisodeWindowSampler"]


def write_episodes(path: str,
                   episodes: Iterable[Dict[str, np.ndarray]]) -> int:
    """Write episodes to ``path`` as per-step records.

    Each episode is a dict with ``images (T, H, W, C)``,
    ``actions (T, A)``, and ``text_ids (L,)`` (the instruction, repeated
    into every step's record so a window is one contiguous gather).
    Returns the number of STEP records written.
    """

    def steps():
        for ep in episodes:
            images, actions = ep["images"], ep["actions"]
            text = np.asarray(ep["text_ids"])
            t = images.shape[0]
            if actions.shape[0] != t:
                raise ValueError(
                    f"episode has {t} frames but {actions.shape[0]} "
                    f"actions")
            for s in range(t):
                yield {
                    "image": images[s],
                    "action": actions[s],
                    "text_ids": text,
                    "step": np.asarray([s], np.int32),
                }

    return write_records(path, steps())


class EpisodeWindowSampler:
    """Yield shuffled frame-history training windows from an episode file.

    Batches are dicts: ``images (B, F, H, W, C)`` (frame dtype preserved,
    oldest frame first), ``actions (B, A)`` for the newest frame,
    ``text_ids (B, L)``.  Iteration is infinite (epochs stream back to
    back, remainder steps beyond the last full batch are dropped);
    shuffling is a per-epoch permutation when ``shuffle_seed`` is given.

    ``shard_id``/``num_shards`` restrict this sampler to a disjoint
    1/num_shards slice of every epoch's permutation (per-host data
    partitioning, same semantics as ``RecordReader``), and
    ``state()``/``restore_state()`` give exact mid-epoch resume.
    """

    def __init__(self, path: str, batch_size: int, frames: int,
                 shuffle_seed=None, shard_id: int = 0, num_shards: int = 1):
        if frames < 1:
            raise ValueError(f"frames must be >= 1, got {frames}")
        self.path = path
        self.batch_size = batch_size
        self.frames = frames
        self.shuffle_seed = shuffle_seed
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.shard_id, self.num_shards = shard_id, num_shards
        schema, rec_size, num, data_off = _read_header(path)
        names = [name for name, _, _ in schema]
        for req in ("image", "action", "text_ids", "step"):
            if req not in names:
                raise ValueError(
                    f"{path}: field {req!r} missing (schema {names}); "
                    f"write the file with write_episodes()")
        self._rec_dtype = np.dtype([(name, np.dtype(dt), tuple(shape))
                                    for name, shape, dt in schema])
        assert self._rec_dtype.itemsize == rec_size
        self.num_steps = int(num)
        self._shard_span = self.num_steps // num_shards
        if batch_size <= 0 or batch_size > self._shard_span:
            raise ValueError(
                f"batch_size {batch_size} invalid for {self._shard_span} "
                f"steps per shard ({self.num_steps} total / "
                f"{num_shards} shards)")
        self._mm = np.memmap(path, dtype=np.uint8, mode="r",
                             offset=data_off,
                             shape=(self.num_steps, rec_size))
        # per-step episode start, for clamping history at episode
        # boundaries: step[i] is the index within its episode, so the
        # episode start of record i is i - step[i].  Windows are derived
        # PER BATCH from this vector (frame f of step i's window is
        # max(i - (F-1) + f, start[i])) — a full (num_steps, F) index
        # table would scale host RAM with dataset size, not batch size.
        step = np.array(self._mm.view(self._rec_dtype)["step"]
                        ).reshape(self.num_steps).astype(np.int64)
        self._ep_start = np.arange(self.num_steps, dtype=np.int64) - step
        self._offs = np.arange(frames, dtype=np.int64) - (frames - 1)
        self._epoch = 0
        self._pos = 0
        self._perm = None
        self._consumed = 0

    @property
    def batches_per_epoch(self) -> int:
        return self._shard_span // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if self.shuffle_seed is not None:
            rng = np.random.default_rng(self.shuffle_seed + epoch)
            return rng.permutation(self.num_steps)
        return np.arange(self.num_steps)

    def __next__(self) -> Dict[str, np.ndarray]:
        limit = self.batches_per_epoch * self.batch_size
        if self._perm is None or self._pos + self.batch_size > limit:
            self._perm = self._epoch_perm(self._epoch)
            self._epoch += 1
            self._pos = 0
        base = self.shard_id * self._shard_span
        sel = self._perm[base + self._pos:base + self._pos + self.batch_size]
        self._pos += self.batch_size
        self._consumed += 1

        frame_idx = np.maximum(sel[:, None] + self._offs,
                               self._ep_start[sel][:, None])  # (B, F)
        recs = np.ascontiguousarray(
            self._mm[frame_idx.ravel()]).view(self._rec_dtype).reshape(
            self.batch_size, self.frames)
        return {
            "images": recs["image"],                     # (B, F, H, W, C)
            "actions": np.ascontiguousarray(recs["action"][:, -1]),
            "text_ids": np.ascontiguousarray(recs["text_ids"][:, -1]),
        }

    # -- mid-epoch resume (same contract as RecordReader) ------------------

    def state(self) -> Dict[str, int]:
        """Serializable position for checkpointing next to the train
        state (``fit(data_state_fn=sampler.state)``)."""
        return {"consumed": self._consumed}

    def restore_state(self, state: Dict[str, int]) -> "EpisodeWindowSampler":
        """Fast-forward a FRESH sampler (same path/batch_size/frames/
        shuffle_seed/shard config) to a ``state()`` snapshot — O(1)."""
        consumed = int(state["consumed"])
        if self._consumed:
            raise ValueError(
                "restore_state requires a fresh sampler (already consumed "
                f"{self._consumed} batches)")
        full_epochs, rem = divmod(consumed, self.batches_per_epoch)
        self._perm = self._epoch_perm(full_epochs)
        self._epoch = full_epochs + 1
        self._pos = rem * self.batch_size
        self._consumed = consumed
        return self
