"""Token-sequence DSL.

Parses declarative sequence strings such as::

    "[TaskDescriptionPrefix{16}] [Image{25};Readout{4}]*2"

into a static tuple of :class:`TokenSetSpec`.  An optional *compression*
string with identical structure, e.g. ``"[TaskDescriptionPrefix{0}]
[Image{2};Readout{0}]*2"``, declares how many tokens each set sheds per
transformer layer (token merging / pruning), so every layer of the stack has
a statically known sequence layout.

Semantics match the reference DSL
(reference: multi_modal_transformers/tokenizers/token_sequencer.py:199-253):

* ``[...]`` delimits a *timestep block*; every block advances the timestep
  counter by one per repetition.
* ``;`` separates token sets within a block.
* ``Name{N}`` declares a token set of kind ``Name`` with ``N`` tokens.
* ``*K`` after a block repeats it for ``K`` consecutive timesteps.

Everything here is plain Python/regex executed once at model-build time —
no tracing, no jnp.  The output is hashable and feeds static mask/layout
construction (see layout.py / masks.py).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

__all__ = [
    "TokenSetSpec",
    "parse_sequence",
    "KIND_TASK",
    "KIND_TEXT",
    "KIND_IMAGE",
    "KIND_READOUT",
    "MODALITY_OF_KIND",
]

# Token-set kinds.  ``TaskDescriptionPrefix`` is a behavioural subtype of
# ``Text`` in the reference (class TaskDescriptionPrefix(Text)); the kind
# lattice below preserves that for mask semantics.
KIND_TASK = "TaskDescriptionPrefix"
KIND_TEXT = "Text"
KIND_IMAGE = "Image"
KIND_READOUT = "Readout"

_KNOWN_KINDS = (KIND_TASK, KIND_TEXT, KIND_IMAGE, KIND_READOUT)

# Modality stream each kind draws its embeddings from.
MODALITY_OF_KIND = {
    KIND_TASK: "text",
    KIND_TEXT: "text",
    KIND_IMAGE: "images",
    KIND_READOUT: "readouts",
}

# kind -> set of ancestor kinds (for isinstance-like checks in mask rules).
_KIND_BASES = {
    KIND_TASK: frozenset({KIND_TASK, KIND_TEXT}),
    KIND_TEXT: frozenset({KIND_TEXT}),
    KIND_IMAGE: frozenset({KIND_IMAGE}),
    KIND_READOUT: frozenset({KIND_READOUT}),
}


def kind_isinstance(kind: str, of: str) -> bool:
    """True when a token set of ``kind`` behaves as an instance of ``of``."""
    return of in _KIND_BASES[kind]


@dataclasses.dataclass(frozen=True)
class TokenSetSpec:
    """A contiguous group of same-modality tokens at one timestep."""

    kind: str
    num_tokens: int
    timestep: int
    # Tokens removed from this set per transformer layer (ToMe merge or
    # attention-score pruning).  0 = never compressed.
    compressed_per_layer: int = 0

    def __post_init__(self):
        if self.kind not in _KNOWN_KINDS:
            raise ValueError(f"unknown token-set kind: {self.kind!r}")
        if self.num_tokens < 0:
            raise ValueError(f"negative token count in {self}")

    @property
    def modality(self) -> str:
        return MODALITY_OF_KIND[self.kind]

    def tokens_at_layer(self, layer: int) -> int:
        """Token count of this set at the input of transformer ``layer``."""
        n = self.num_tokens - layer * self.compressed_per_layer
        if n < 0:
            raise ValueError(
                f"{self.kind}{{{self.num_tokens}}} compressed by "
                f"{self.compressed_per_layer}/layer is exhausted at layer {layer}"
            )
        return n


_BLOCK_RE = re.compile(r"\[(.*?)\]")
_REPEAT_RE = re.compile(r"(?<=\])(.*?)(?=\[|$)")
_GROUP_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*\{\s*(\d+)\s*\}\s*$")


def _parse_blocks(sequence: str):
    blocks = _BLOCK_RE.findall(sequence)
    if not blocks:
        raise ValueError(f"no [..] blocks found in sequence string: {sequence!r}")
    repeats = []
    for rep in _REPEAT_RE.findall(sequence):
        rep = rep.strip()
        if not rep:
            repeats.append(1)
        else:
            m = re.search(r"\*\s*(\d+)", rep)
            if not m:
                raise ValueError(f"bad repeat specifier {rep!r} in {sequence!r}")
            repeats.append(int(m.group(1)))
    if len(repeats) < len(blocks):
        repeats += [1] * (len(blocks) - len(repeats))
    return blocks, repeats


def _parse_group(group: str) -> Tuple[str, int]:
    m = _GROUP_RE.match(group)
    if not m:
        raise ValueError(f"bad token group {group!r}")
    return m.group(1), int(m.group(2))


def parse_sequence(
    sequence: str,
    compression: Optional[str] = None,
) -> Tuple[TokenSetSpec, ...]:
    """Parse a sequence DSL string (and optional compression string).

    Returns the layer-0 tuple of :class:`TokenSetSpec`, with
    ``compressed_per_layer`` filled in from ``compression`` when given.
    """
    blocks, repeats = _parse_blocks(sequence)

    comp_blocks = None
    if compression is not None:
        comp_blocks, comp_repeats = _parse_blocks(compression)
        if len(comp_blocks) != len(blocks):
            raise ValueError(
                "compression string must have the same block structure as the "
                f"sequence string ({len(comp_blocks)} vs {len(blocks)} blocks)"
            )
        if tuple(comp_repeats) != tuple(repeats):
            raise ValueError(
                f"compression string repeat counts {list(comp_repeats)} do "
                f"not match the sequence string's {list(repeats)} — a "
                f"mismatched *K would silently apply the wrong per-timestep "
                f"compression schedule")

    specs = []
    timestep = 0
    for block_idx, (block, repeat) in enumerate(zip(blocks, repeats)):
        groups = [g for g in block.split(";")]
        comp_groups = None
        if comp_blocks is not None:
            comp_groups = comp_blocks[block_idx].split(";")
            if len(comp_groups) != len(groups):
                raise ValueError(
                    f"block {block_idx}: compression block {comp_blocks[block_idx]!r}"
                    f" does not match sequence block {block!r}"
                )
        for _ in range(repeat):
            for g_idx, group in enumerate(groups):
                kind, num = _parse_group(group)
                comp = 0
                if comp_groups is not None:
                    comp_kind, comp = _parse_group(comp_groups[g_idx])
                    if comp_kind != kind:
                        raise ValueError(
                            f"compression kind {comp_kind!r} does not match "
                            f"sequence kind {kind!r}"
                        )
                specs.append(
                    TokenSetSpec(
                        kind=kind,
                        num_tokens=num,
                        timestep=timestep,
                        compressed_per_layer=comp,
                    )
                )
            timestep += 1

    return tuple(specs)
