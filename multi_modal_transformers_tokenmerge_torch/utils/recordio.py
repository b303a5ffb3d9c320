"""Fixed-record binary dataset format with a memmap batch reader.

The port's own copy of the JAX package's ``utils/recordio.py`` (numpy
only; the file format is the same, so either package reads the other's
files).  Every record has the same byte size, so a batch is one gather
from per-file memmaps at computed offsets, with no parsing on the hot path.
Pair with ``utils.data.prefetch_to_device`` to overlap host reads with
device work.

Format (little-endian):
  magic "MMTRECv1" | u32 schema_len | schema JSON | u32 record_size |
  u64 num_records | records...
Schema JSON: ``[[name, [shape...], dtype_str], ...]``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, List, Tuple

import numpy as np

__all__ = ["write_records", "RecordReader", "record_schema_of"]

_MAGIC = b"MMTRECv1"

Schema = List[Tuple[str, Tuple[int, ...], str]]


def record_schema_of(example: Dict[str, np.ndarray]) -> Schema:
    return [(k, tuple(v.shape), str(v.dtype))
            for k, v in sorted(example.items())]


def _record_nbytes(schema: Schema) -> int:
    return sum(int(np.prod(shape)) * np.dtype(dt).itemsize
               for _, shape, dt in schema)


def write_records(path: str, examples: Iterable[Dict[str, np.ndarray]],
                  schema: Schema = None) -> int:
    """Write examples (dicts of fixed-shape arrays) to ``path``.
    Returns the number of records written."""
    it = iter(examples)
    first = None
    if schema is None:
        try:
            first = next(it)
        except StopIteration:
            raise ValueError(
                "write_records: no examples and no schema to infer one "
                "from") from None
        schema = record_schema_of(first)
    blob = json.dumps(schema).encode("utf-8")
    rec_size = _record_nbytes(schema)
    n = 0
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(blob)))
        f.write(blob)
        f.write(struct.pack("<I", rec_size))
        count_pos = f.tell()
        f.write(struct.pack("<Q", 0))

        def emit(ex):
            nonlocal n
            for name, shape, dt in schema:
                arr = np.ascontiguousarray(ex[name], dtype=np.dtype(dt))
                if arr.shape != tuple(shape):
                    raise ValueError(
                        f"field {name!r}: shape {arr.shape} != "
                        f"schema {tuple(shape)}")
                f.write(arr.tobytes())
            n += 1

        if first is not None:
            emit(first)
        for ex in it:
            emit(ex)
        f.seek(count_pos)
        f.write(struct.pack("<Q", n))
    return n


def _read_header(path: str):
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError(f"{path}: not an MMTRECv1 file")
        (schema_len,) = struct.unpack("<I", f.read(4))
        schema = json.loads(f.read(schema_len).decode("utf-8"))
        schema = [(name, tuple(shape), dt) for name, shape, dt in schema]
        (rec_size,) = struct.unpack("<I", f.read(4))
        (num_records,) = struct.unpack("<Q", f.read(8))
        data_off = f.tell()
    return schema, rec_size, num_records, data_off


class RecordReader:
    """Iterate batches (dicts of numpy arrays) from record file(s).

    ``path`` may be one file or a sequence of files sharing a schema (a
    dataset split into shardable pieces); records are addressed through
    one concatenated index space.  ``shard_id``/``num_shards`` restrict
    this reader to a DISJOINT 1/num_shards slice of every epoch's
    permutation — per-process data partitioning for data-parallel
    training (pass the process's rank and world size); remainder records
    beyond ``num_records // num_shards`` are dropped.

    Batches are assembled from per-file memmaps in one copy.  Iteration
    is infinite (epochs stream back to back); batches within an epoch
    cover distinct records (shuffled by a per-epoch permutation when
    ``shuffle_seed`` is given; remainder records beyond the last full
    batch of an epoch are dropped).  The shuffle is deterministic given
    the seed, which ``restore_state`` relies on for exact resume.
    """

    def __init__(self, path, batch_size: int, shuffle_seed=None,
                 backend: str = "auto", copy_fields: bool = False,
                 shard_id: int = 0, num_shards: int = 1):
        paths = [path] if isinstance(path, (str, os.PathLike)) else list(path)
        if not paths:
            raise ValueError("need at least one record file")
        self.path = paths[0]
        self.paths = [os.fspath(p) for p in paths]
        self.batch_size = batch_size
        headers = [_read_header(p) for p in self.paths]
        self.schema, self.record_size = headers[0][0], headers[0][1]
        for p, (schema, rec_size, _, _) in zip(self.paths[1:], headers[1:]):
            if schema != self.schema or rec_size != self.record_size:
                raise ValueError(
                    f"{p}: schema/record_size differs from {self.paths[0]}")
        self.num_records = sum(h[2] for h in headers)
        self._data_offs = [h[3] for h in headers]
        self._cum_records = np.cumsum([0] + [h[2] for h in headers])
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.shard_id, self.num_shards = shard_id, num_shards
        self._shard_span = self.num_records // num_shards
        if batch_size <= 0 or batch_size > self._shard_span:
            raise ValueError(
                f"batch_size {batch_size} invalid for "
                f"{self._shard_span} records per shard "
                f"({self.num_records} total / {num_shards} shards)")
        self.shuffle_seed = shuffle_seed
        self.copy_fields = copy_fields
        if backend not in ("auto", "numpy"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = "numpy"
        self._epoch = 0
        self._pos = 0
        self._perm = None
        self._mm = None  # lazy memmaps for the numpy backend
        self._consumed = 0  # batches handed out (for state()/restore_state)
        self._closed = False

    @property
    def batches_per_epoch(self) -> int:
        return self._shard_span // self.batch_size

    def _split(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        """One batch buffer -> per-field arrays, ZERO-copy by default: the
        records are reinterpreted through a structured dtype, so each field
        is a view into the batch buffer.  Caveat of views: every field shares the batch buffer as
        ``.base`` — retaining one small field pins the whole batch's
        memory, and the fields alias one mutable buffer.  Consumers that
        hold fields beyond the step (or mutate them) should construct the
        reader with ``copy_fields=True`` for independent per-field arrays.
        """
        rec_dtype = np.dtype([(name, np.dtype(dt), tuple(shape))
                              for name, shape, dt in self.schema])
        assert rec_dtype.itemsize == self.record_size, (
            rec_dtype.itemsize, self.record_size)
        recs = flat.view(rec_dtype)
        if self.copy_fields:
            return {name: np.ascontiguousarray(recs[name])
                    for name, _, _ in self.schema}
        return {name: recs[name] for name, _, _ in self.schema}

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        """THE epoch->order function: restore_state's exact-continuation
        guarantee depends on it being the single source of truth."""
        if self.shuffle_seed is not None:
            rng = np.random.default_rng((self.shuffle_seed or 0) + epoch)
            return rng.permutation(self.num_records)
        return np.arange(self.num_records)

    def _next_numpy(self) -> np.ndarray:
        if self._perm is None or self._pos + self.batch_size > (
                self.batches_per_epoch * self.batch_size):
            self._perm = self._epoch_perm(self._epoch)
            self._epoch += 1
            self._pos = 0
        base = self.shard_id * self._shard_span
        idx = self._perm[base + self._pos:base + self._pos + self.batch_size]
        self._pos += self.batch_size
        if self._mm is None:
            # one memmap per file for the reader's lifetime (episodes.py
            # uses the same approach)
            self._mm = [np.memmap(p, dtype=np.uint8, mode="r")
                        for p in self.paths]
        rs = self.record_size
        # vectorized file routing: one searchsorted per batch, not per
        # record (this is the training hot path)
        fs = np.searchsorted(self._cum_records, idx, side="right") - 1
        offs = (np.asarray(self._data_offs)[fs]
                + (idx - self._cum_records[fs]) * rs)
        buf = np.empty(self.batch_size * rs, dtype=np.uint8)
        for i in range(self.batch_size):
            off = int(offs[i])
            buf[i * rs:(i + 1) * rs] = self._mm[int(fs[i])][off:off + rs]
        return buf

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._closed:
            # a closed reader must stop (e.g. a prefetch thread draining
            # after cleanup), not re-open memmaps and re-serve epoch 0
            raise StopIteration
        buf = self._next_numpy()
        self._consumed += 1
        return self._split(buf)

    # -- mid-epoch resume --------------------------------------------------

    def state(self) -> Dict[str, int]:
        """Serializable position: checkpoint it next to the train state so
        a resumed run continues the data order instead of replaying (or
        skipping) examples."""
        return {"consumed": self._consumed}

    def restore_state(self, state: Dict[str, int]) -> "RecordReader":
        """Fast-forward a FRESH reader (same paths/batch_size/shuffle_seed/
        shard config) to a ``state()`` snapshot.  The order is
        deterministic given the seed, so the resumed stream continues
        exactly — and the fast-forward is O(1): record selection is a pure
        function of the batch counter (permutation/position math), so
        nothing is read or replayed no matter how long the original run
        was.
        """
        consumed = int(state["consumed"])
        if self._consumed:
            raise ValueError(
                "restore_state requires a fresh reader (already consumed "
                f"{self._consumed} batches)")
        full_epochs, rem = divmod(consumed, self.batches_per_epoch)
        self._perm = self._epoch_perm(full_epochs)
        self._epoch = full_epochs + 1
        self._pos = rem * self.batch_size
        self._consumed = consumed
        return self

    def close(self):
        self._closed = True
        self._mm = None  # drop the memmaps (and their file descriptors)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
