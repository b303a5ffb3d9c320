"""Token-sequence core: the DSL parser and the static SequenceLayout
(slice tables, modality index tables, block-causal attention masks).

Re-exports the public surface of ``dsl`` and ``layout`` so callers can
write ``from ...sequence import SequenceLayout`` (reference analogue:
``tokenizers/token_sequencer.py``).
"""

from .dsl import (  # noqa: F401
    KIND_IMAGE,
    KIND_READOUT,
    KIND_TASK,
    KIND_TEXT,
    MODALITY_OF_KIND,
    TokenSetSpec,
    parse_sequence,
)
from .layout import SequenceLayout, attention_rule_block  # noqa: F401

__all__ = [
    "TokenSetSpec",
    "parse_sequence",
    "KIND_TASK",
    "KIND_TEXT",
    "KIND_IMAGE",
    "KIND_READOUT",
    "MODALITY_OF_KIND",
    "SequenceLayout",
    "attention_rule_block",
]
