"""Host-to-device prefetching, synthetic batches and the frozen text
tower's embedding cache.

Counterpart of the JAX package's ``utils/data.py``
(``prefetch_to_device``, ``synthetic_octo_batches``,
``cache_text_embeddings``).
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator

import numpy as np
import torch

__all__ = ["prefetch_to_device", "Prefetched", "synthetic_octo_batches",
           "cache_text_embeddings"]


def _map(fn, batch):
    """``fn`` over the arrays of a tuple, list or dict batch."""
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _host_tensor(x) -> torch.Tensor:
    """``x`` as a tensor; a numpy array is made contiguous first (a
    reader's fields may be strided views into its batch buffer)."""
    return torch.as_tensor(np.ascontiguousarray(x)
                           if isinstance(x, np.ndarray) else x)


class Prefetched:
    """The iterator :func:`prefetch_to_device` returns.  ``rows_of`` is
    the mesh whose data-axis rows each batch already is (None: whole
    batches), of ``microbatches`` global microbatches:
    ``train.loop.fit`` and ``evaluate`` do not cut such batches again."""

    def __init__(self, batches: Iterator, rows_of=None,
                 microbatches: int = 1):
        self._batches = batches
        self.rows_of = rows_of
        self.microbatches = microbatches

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._batches)


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device="cuda", mesh=None,
                       microbatches: int = 1) -> Prefetched:
    """Yield batches (tuples, lists or dicts of arrays) as tensors on
    ``device`` with ``size`` more already on their way.

    On a CUDA device each batch is staged in pinned host memory and copied
    on a stream of its own, and an event recorded after its copies is
    waited on by the consumer's stream before the batch is yielded: a step
    never reads a batch before its copy has ended, and the copy of batch
    N+size overlaps the step on batch N.  On the CPU batches are converted
    in order, ``size`` ahead as on the card.  With a ``mesh``
    (``parallel.mesh.make_mesh``) each global batch is cut to this rank's
    rows of the data axis before its copy (of each of ``microbatches``
    global microbatches, ``parallel.mesh.data_slice``), and
    ``fit(..., mesh=mesh, accum_steps=microbatches)`` takes the batches as
    they are."""
    device = torch.device(device)
    it = iter(iterator)
    if mesh is not None:
        from ..parallel.mesh import data_slice
        cut = lambda x: data_slice(x, mesh, microbatches=microbatches)
        it = (_map(cut, batch) for batch in it)
    return Prefetched(_prefetch(it, size, device), mesh, microbatches)


def _prefetch(it: Iterator, size: int, device: torch.device) -> Iterator:
    if device.type != "cuda":
        # no copy to overlap, but the same look-ahead: ``size`` batches are
        # taken from the source before the first is yielded, as on the card
        # (a reader's ``state()`` counts them)
        place = lambda batch: _map(lambda x: _host_tensor(x).to(device),
                                   batch)
        if size <= 0:
            yield from map(place, it)
            return
        queue = collections.deque(place(b)
                                  for b in itertools.islice(it, size))
        while queue:
            nxt = next(it, None)
            if nxt is not None:
                queue.append(place(nxt))
            yield queue.popleft()
        return
    stream = torch.cuda.Stream(device)

    def place(batch):
        def copy(x):
            host = _host_tensor(x)
            if host.device.type == "cpu":
                host = host.pin_memory()
            return host.to(device, non_blocking=True)
        with torch.cuda.stream(stream):
            out = _map(copy, batch)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def hand_over(entry):
        out, done = entry
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        # the consumer's stream now uses memory the copy stream allocated
        _map(lambda t: t.record_stream(consumer), out)
        return out

    if size <= 0:
        for batch in it:
            yield hand_over(place(batch))
        return
    queue = collections.deque(place(b) for b in itertools.islice(it, size))
    while queue:
        nxt = next(it, None)
        if nxt is not None:
            queue.append(place(nxt))
        yield hand_over(queue.popleft())


def synthetic_octo_batches(batch_size: int, image_shape=(2, 280, 280, 3),
                           text_length: int = 16, action_dim: int = 8,
                           vocab_size: int = 32128, seed: int = 0):
    """Endless synthetic (text_tokens, images, actions) numpy batches:
    int32 ids, uint8-valued float32 images, float32 actions in [-1, 1)."""
    rng = np.random.default_rng(seed)
    while True:
        yield (
            rng.integers(0, vocab_size, (batch_size, text_length),
                         dtype=np.int32),
            rng.integers(0, 256, (batch_size, *image_shape)).astype(
                np.float32),
            rng.uniform(-1, 1, (batch_size, action_dim)).astype(np.float32),
        )


def cache_text_embeddings(batch_iter: Iterable, model,
                          max_cache_rows: int = 1024) -> Iterator:
    """Map ``(text_ids, images, actions)`` batches to ``(text_embeddings,
    images, actions)``, running the frozen text tower once per distinct
    instruction row (an LRU of ``max_cache_rows`` rows on the model's
    device).  Exact, not approximate: the frozen tower's output per
    instruction is a constant.  A batch with any miss encodes the whole
    batch.  Pair with ``make_train_step(..., text_input='embeddings')``."""
    tcfg = model.config.text
    if not (tcfg.kind == "t5" and tcfg.frozen):
        raise ValueError(
            "cache_text_embeddings requires a frozen text tower "
            "(config.text.kind='t5' with frozen=True); got "
            f"kind={tcfg.kind!r}, frozen={tcfg.frozen!r}"
            " - a trainable tower's output changes every step")
    device = model.device

    def gen():
        cache: "collections.OrderedDict[bytes, torch.Tensor]" = \
            collections.OrderedDict()
        for ids, *rest in batch_iter:
            ids_np = np.asarray(ids)
            keys = [row.tobytes() for row in ids_np]
            if all(k in cache for k in keys):
                for k in keys:
                    cache.move_to_end(k)
                emb = torch.stack([cache[k] for k in keys])
            else:
                with torch.no_grad():
                    emb = model.encode_text(torch.as_tensor(ids_np,
                                                            device=device))
                for k, row in zip(keys, emb):
                    # a clone: a view would pin the whole batch
                    cache[k] = row.clone()
                    cache.move_to_end(k)
                while len(cache) > max_cache_rows:
                    cache.popitem(last=False)
            yield (emb, *rest)

    return gen()
