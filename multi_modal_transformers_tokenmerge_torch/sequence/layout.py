"""Static sequence layout: slice tables, assembly permutation, and the
block-causal attention mask.

Everything is computed **once, in numpy, at model-build time** and baked into
the jitted computation as constants — the reference builds these with traced
``jnp`` ops on every mask request
(reference: multi_modal_transformers/tokenizers/token_sequencer.py:255-334).

Mask semantics (OCTO block-causal; reference token_sequencer.py:55-183):

* ``TaskDescriptionPrefix``: attends only to itself; full intra-attention.
* ``Text``: causal within its own set; attends to all *past-or-present*
  non-readout sets; never to readouts.
* ``Image``: full within its own set; attends to all past-or-present
  non-readout sets; never to readouts.
* ``Readout``: full within its own set; attends to everything at or before
  its timestep **except** any readout set.

"Intra" applies when the key set shares the query set's timestep and the key
kind is a behavioural instance of the query kind (TaskDescriptionPrefix is a
Text).  This mirrors the reference's ``isinstance`` checks exactly
(reference attention_rule: ``(tokenset.timestep == self.timestep) and
isinstance(tokenset, self.__class__)`` — token_sequencer.py:84-90,:143-145,
:178-180), which keys on **(kind, timestep), not set identity**.  Two
consequences, both reference-faithful and pinned by tests:

* two DISTINCT same-kind sets at the same timestep treat each other as
  intra — e.g. ``[Image{2};Readout{2};Readout{2}]`` gives the two readout
  sets full attention over each other (the reference's "never attend to
  other readout sets" rule only applies across timesteps / via the inter
  rule);
* a Text query meeting a TaskDescriptionPrefix key at the same timestep
  resolves to the causal *intra* rule.  The reference emits a
  wrongly-shaped ``(q, q)`` block there (its intra rule ignores the key
  set's size) and silently builds a misaligned mask; we raise instead —
  see ``_intra_block``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np

from .dsl import (
    KIND_IMAGE,
    KIND_READOUT,
    KIND_TASK,
    KIND_TEXT,
    TokenSetSpec,
    kind_isinstance,
    parse_sequence,
)

__all__ = ["SequenceLayout", "attention_rule_block"]

MODALITIES = ("text", "images", "readouts")


def _intra_block(kind: str, q_tokens: int, k_tokens: int) -> np.ndarray:
    """Mask block for a key set that is 'intra' w.r.t. the query set."""
    if kind in (KIND_TEXT,):
        # causal lower-triangular (reference uses nn.make_causal_mask)
        if q_tokens != k_tokens:
            # the reference hits this with e.g. a same-timestep
            # Text{q}/TaskDescriptionPrefix{k} pair and silently emits a
            # (q, q) block into a (q, k) slot (token_sequencer.py:84-90);
            # fail loudly instead of building a misaligned mask
            raise ValueError(
                f"causal intra-attention requires equal set sizes, got "
                f"query {q_tokens} vs key {k_tokens}; distinct text-like "
                f"sets sharing a timestep resolve to the intra rule "
                f"(reference isinstance semantics) — give them different "
                f"timesteps or equal sizes")
        return np.tril(np.ones((q_tokens, k_tokens), dtype=bool))
    # TaskDescriptionPrefix, Image, Readout: full intra attention
    return np.ones((q_tokens, k_tokens), dtype=bool)


def _inter_block(q: TokenSetSpec, k: TokenSetSpec,
                 q_tokens: int, k_tokens: int) -> np.ndarray:
    """Mask block for a key set that is 'inter' w.r.t. the query set."""
    shape = (q_tokens, k_tokens)
    if q.kind == KIND_TASK:
        # task prefix attends to nothing outside itself
        return np.zeros(shape, dtype=bool)
    if q.kind in (KIND_TEXT, KIND_IMAGE):
        if kind_isinstance(k.kind, KIND_READOUT):
            return np.zeros(shape, dtype=bool)
        return np.full(shape, k.timestep <= q.timestep, dtype=bool)
    if q.kind == KIND_READOUT:
        if kind_isinstance(k.kind, KIND_READOUT):
            return np.zeros(shape, dtype=bool)
        return np.full(shape, k.timestep <= q.timestep, dtype=bool)
    raise ValueError(f"no inter rule for kind {q.kind!r}")


def attention_rule_block(q: TokenSetSpec, k: TokenSetSpec,
                         q_tokens: Optional[int] = None,
                         k_tokens: Optional[int] = None) -> np.ndarray:
    """(q_tokens, k_tokens) boolean mask block for one (query set, key set)
    pair.  Token counts may be overridden for per-layer compressed layouts.
    """
    q_tokens = q.num_tokens if q_tokens is None else q_tokens
    k_tokens = k.num_tokens if k_tokens is None else k_tokens
    same_ts = k.timestep == q.timestep
    if same_ts and kind_isinstance(k.kind, q.kind):
        return _intra_block(q.kind, q_tokens, k_tokens)
    return _inter_block(q, k, q_tokens, k_tokens)


@dataclasses.dataclass(frozen=True)
class SequenceLayout:
    """Immutable, hashable description of a multimodal token sequence.

    Built from DSL strings; provides every static table the model needs:

    * ``attention_mask(layer)`` — dense boolean (S_l, S_l) mask.
    * ``assembly_permutation`` — gather indices assembling the interleaved
      sequence from ``concat([text, images, readouts], axis=seq)``.
    * ``modality_index(m)`` — positions in the sequence holding modality m.
    * ``set_slices(layer)`` — (start, size) of each token set in the
      layer-l sequence.
    """

    sets: Tuple[TokenSetSpec, ...]

    # -- construction ------------------------------------------------------

    @classmethod
    def from_strings(cls, sequence: str,
                     compression: Optional[str] = None) -> "SequenceLayout":
        return cls(sets=parse_sequence(sequence, compression))

    # -- sizes -------------------------------------------------------------

    @property
    def total_tokens(self) -> int:
        return sum(s.num_tokens for s in self.sets)

    def tokens_at_layer(self, layer: int) -> int:
        return sum(s.tokens_at_layer(layer) for s in self.sets)

    def modality_tokens(self, modality: str) -> int:
        return sum(s.num_tokens for s in self.sets if s.modality == modality)

    @property
    def num_timesteps(self) -> int:
        return 1 + max(s.timestep for s in self.sets)

    @property
    def compressible(self) -> bool:
        return any(s.compressed_per_layer > 0 for s in self.sets)

    def set_counts_at_layer(self, layer: int) -> Tuple[int, ...]:
        return tuple(s.tokens_at_layer(layer) for s in self.sets)

    # -- slice tables ------------------------------------------------------

    def set_slices(self, layer: int = 0) -> Tuple[Tuple[int, int], ...]:
        """(start, size) of each token set within the layer-l sequence."""
        out, cur = [], 0
        for s in self.sets:
            n = s.tokens_at_layer(layer)
            out.append((cur, n))
            cur += n
        return tuple(out)

    def modality_slices(self) -> Tuple[Tuple[int, int], ...]:
        """(start within its modality stream, size) for each token set."""
        cursor: Dict[str, int] = {m: 0 for m in MODALITIES}
        out = []
        for s in self.sets:
            start = cursor[s.modality]
            out.append((start, s.num_tokens))
            cursor[s.modality] = start + s.num_tokens
        return tuple(out)

    # -- assembly ----------------------------------------------------------

    @functools.cached_property
    def assembly_permutation(self) -> np.ndarray:
        """int32 (total_tokens,) gather indices.

        With ``combined = concat([text, images, readouts], axis=1)`` (in
        MODALITIES order), ``combined[:, perm]`` yields the interleaved
        sequence.  One static gather replaces the reference's per-set
        dynamic_slice + concat loop (token_sequencer.py:255-269).
        """
        stream_offset: Dict[str, int] = {}
        acc = 0
        for m in MODALITIES:
            stream_offset[m] = acc
            acc += self.modality_tokens(m)
        perm = np.empty(self.total_tokens, dtype=np.int32)
        pos = 0
        for s, (mstart, n) in zip(self.sets, self.modality_slices()):
            base = stream_offset[s.modality] + mstart
            perm[pos:pos + n] = np.arange(base, base + n, dtype=np.int32)
            pos += n
        return perm

    def modality_index(self, modality: str, layer: int = 0) -> np.ndarray:
        """Positions in the (layer-l) sequence holding tokens of a modality."""
        idx = []
        for s, (start, n) in zip(self.sets, self.set_slices(layer)):
            if s.modality == modality:
                idx.append(np.arange(start, start + n, dtype=np.int32))
        if not idx:
            return np.empty((0,), dtype=np.int32)
        return np.concatenate(idx)

    # -- masks ---------------------------------------------------------------

    def attention_mask(self, layer: int = 0) -> np.ndarray:
        """Dense boolean (S_l, S_l) block-causal mask for transformer layer
        ``layer`` (sequence compressed ``layer`` times)."""
        counts = self.set_counts_at_layer(layer)
        rows = []
        for q, qn in zip(self.sets, counts):
            row = [
                attention_rule_block(q, k, q_tokens=qn, k_tokens=kn)
                for k, kn in zip(self.sets, counts)
            ]
            rows.append(np.concatenate(row, axis=1))
        return np.concatenate(rows, axis=0)

    # -- compression tables --------------------------------------------------

    def keep_counts(self, layer: int) -> Tuple[int, ...]:
        """Per-set token count surviving the compression applied *inside*
        transformer layer ``layer`` (i.e. the layer-(l+1) counts)."""
        return self.set_counts_at_layer(layer + 1)

    def __hash__(self):
        return hash(self.sets)
