"""The token sequence of an Octo policy, written out plainly: which token
sets the sequence holds, how many tokens each keeps at each compression
stage, and the block-causal attention mask between them.

Written from the Octo sequence semantics (arXiv:2405.12213, section 3),
not from the program under test:

- ``[...]`` is one timestep block, ``;`` separates its token sets, ``*K``
  repeats a block for K timesteps, ``Kind{N}`` is a set of N tokens.
- A task prefix attends only to itself.  An image set attends in full to
  its own set and to every non-readout set of its timestep or an earlier
  one.  A readout set attends in full to itself and to every non-readout
  set of its timestep or an earlier one.  Nothing attends to a readout
  set but itself.
- A compression string of the same shape gives the tokens each set sheds
  at every compression event.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

KINDS = ("TaskDescriptionPrefix", "Text", "Image", "Readout")
STREAM = {"TaskDescriptionPrefix": "text", "Text": "text", "Image": "images",
          "Readout": "readouts"}


@dataclass(frozen=True)
class TokenSet:
    kind: str
    tokens: int
    timestep: int
    shed: int = 0       # tokens removed at each compression event

    def at(self, event: int) -> int:
        return self.tokens - event * self.shed


def _blocks(text: str) -> List[Tuple[List[Tuple[str, int]], int]]:
    out = []
    for body, rep in re.findall(r"\[([^\]]*)\]\s*(?:\*\s*(\d+))?", text):
        groups = []
        for g in body.split(";"):
            m = re.fullmatch(r"\s*([A-Za-z_]\w*)\s*\{\s*(\d+)\s*\}\s*", g)
            if m is None or m.group(1) not in KINDS:
                raise ValueError(f"bad token group {g!r} in {text!r}")
            groups.append((m.group(1), int(m.group(2))))
        out.append((groups, int(rep) if rep else 1))
    if not out:
        raise ValueError(f"no [..] block in {text!r}")
    return out


def parse(sequence: str, compression: Optional[str] = None
          ) -> Tuple[TokenSet, ...]:
    blocks = _blocks(sequence)
    shed = None
    if compression is not None:
        shed = _blocks(compression)
        if [(len(g), r) for g, r in shed] != [(len(g), r) for g, r in blocks]:
            raise ValueError("the compression string's blocks differ from "
                             "the sequence's")
    sets, t = [], 0
    for i, (groups, rep) in enumerate(blocks):
        for _ in range(rep):
            for j, (kind, n) in enumerate(groups):
                s = shed[i][0][j][1] if shed is not None else 0
                sets.append(TokenSet(kind, n, t, s))
            t += 1
    return tuple(sets)


def tokens(sets, event: int = 0) -> int:
    return sum(s.at(event) for s in sets)


def _block(q: TokenSet, k: TokenSet, qn: int, kn: int) -> np.ndarray:
    # a task prefix is a kind of text: a text query meets it as its own kind
    kinds_of_key = ({"TaskDescriptionPrefix", "Text"}
                    if k.kind == "TaskDescriptionPrefix" else {k.kind})
    if q.timestep == k.timestep and q.kind in kinds_of_key:
        if q.kind == "Text":
            return np.tril(np.ones((qn, kn), dtype=bool))
        return np.ones((qn, kn), dtype=bool)
    if q.kind == "TaskDescriptionPrefix" or k.kind == "Readout":
        return np.zeros((qn, kn), dtype=bool)
    return np.full((qn, kn), k.timestep <= q.timestep, dtype=bool)


def attention_mask(sets, event: int = 0) -> np.ndarray:
    """(S, S) bool, True where a query (row) attends to a key (column)."""
    return np.concatenate([
        np.concatenate([_block(q, k, q.at(event), k.at(event)) for k in sets],
                       axis=1)
        for q in sets], axis=0)


def stream_order(sets) -> np.ndarray:
    """Gather indices that interleave concat([text, images, readouts]) into
    the sequence's order."""
    base, acc = {}, 0
    for stream in ("text", "images", "readouts"):
        base[stream] = acc
        acc += sum(s.tokens for s in sets if STREAM[s.kind] == stream)
    cursor = dict.fromkeys(base, 0)
    order = []
    for s in sets:
        start = base[STREAM[s.kind]] + cursor[STREAM[s.kind]]
        order.extend(range(start, start + s.tokens))
        cursor[STREAM[s.kind]] += s.tokens
    return np.asarray(order, dtype=np.int64)


def positions(sets, kind: str, event: int = 0) -> np.ndarray:
    """Positions of the tokens of ``kind`` in the sequence after ``event``
    compression events."""
    out, cur = [], 0
    for s in sets:
        n = s.at(event)
        if s.kind == kind:
            out.extend(range(cur, cur + n))
        cur += n
    return np.asarray(out, dtype=np.int64)


def live_pairs(sets, event: int = 0) -> int:
    """Query-key pairs the mask lets attend, per batch row and head."""
    return int(attention_mask(sets, event).sum())
