"""Faults planted in the program's transformer stack, for the readings on
the card and the CPU tests that show the check sees the stack:

- ``block_dropped``: the last block of the stack passes its input on
  unchanged (its attention and MLP output projections zeroed in the
  serving copy after set-up, so the captured graphs replay it so);
- ``mask_off``: every block attends over the whole sequence, the
  block-causal mask left out (the program's layout gives an all-true mask
  to the model, and to its flash tables, as they are built);
- ``merge_reversed``: every ToMe merge joins each source to its least
  similar destination (the similarity of the destinations negated).

    with planted("mask_off") as hook:
        work.setup()
        if hook is not None:
            hook(work)

Module switches are made on entry and undone on exit; ``hook`` is the
change made to the driver after set-up, or None.
"""

from __future__ import annotations

import contextlib
import re

import numpy as np
import torch

__all__ = ["FAULTS", "planted", "merges"]

FAULTS = ("block_dropped", "mask_off", "merge_reversed")
BLOCK = re.compile(r"^(transformer\.(?:stage_\d+\.\d+|blocks\.\d+))\."
                   r"attention\.out\.weight$")


def merges(model: dict) -> bool:
    """Whether the configuration ``model`` merges tokens (where
    ``merge_reversed`` can act)."""
    return (model["transformer"]["compression_mode"] == "merge"
            and model["compression_sequence"] is not None)


def _drop_last_block(work) -> None:
    params = dict(work.engine._model.named_parameters())
    blocks = sorted((m.group(1) for m in map(BLOCK.match, params) if m),
                    key=lambda name: [int(n) for n in re.findall(r"\d+",
                                                                 name)])
    last = blocks[-1]
    with torch.no_grad():
        for part in ("attention.out", "mlp.dense_out"):
            for leaf in ("weight", "bias"):
                if f"{last}.{part}.{leaf}" in params:
                    params[f"{last}.{part}.{leaf}"].zero_()


@contextlib.contextmanager
def planted(name: str):
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    saved = []

    def switch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    hook = None
    if name == "block_dropped":
        hook = _drop_last_block
    elif name == "mask_off":
        from multi_modal_transformers_tokenmerge_torch.sequence.layout import (
            SequenceLayout)
        mask = SequenceLayout.attention_mask
        switch(SequenceLayout, "attention_mask",
               lambda self, layer=0: np.ones_like(mask(self, layer)))
    else:
        from multi_modal_transformers_tokenmerge_torch.modules import (
            tome_stack)
        match = tome_stack.bipartite_soft_matching

        def least_similar(metric, r, **kw):
            metric = metric.clone()
            metric[:, 1::2] = -metric[:, 1::2]
            return match(metric, r, **kw)

        switch(tome_stack, "bipartite_soft_matching", least_similar)
    try:
        yield hook
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
