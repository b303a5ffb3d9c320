"""The port's copy of the sequence DSL and layout against the JAX package's:
equal masks, slice tables, modality indices and assembly permutation for
every preset's input and compression strings."""

import numpy as np
import pytest

from multi_modal_transformers_tokenmerge_torch.models import presets as tp
from multi_modal_transformers_tokenmerge_torch.sequence import (
    SequenceLayout as TLayout,
)
from multi_modal_transformers_tokenmerge_tpu.models import presets as jp
from multi_modal_transformers_tokenmerge_tpu.sequence import (
    SequenceLayout as JLayout,
)
from torch_parity import octo_micro_t5, to_torch_config


def _strings():
    out = []
    for name, fn in jp.PRESETS.items():
        cfg = fn()
        out.append((name, cfg.input_sequence, cfg.compression_sequence))
    cfg = octo_micro_t5()
    out.append(("micro_t5", cfg.input_sequence, cfg.compression_sequence))
    return out


@pytest.mark.parametrize("name,seq,comp", _strings(),
                         ids=[s[0] for s in _strings()])
def test_layout_tables_match(name, seq, comp):
    j, t = JLayout.from_strings(seq, comp), TLayout.from_strings(seq, comp)
    assert t.total_tokens == j.total_tokens
    np.testing.assert_array_equal(t.assembly_permutation,
                                  j.assembly_permutation)
    layers = [0, 1] if j.compressible else [0]
    for layer in layers:
        np.testing.assert_array_equal(t.attention_mask(layer),
                                      j.attention_mask(layer))
        assert t.set_slices(layer) == j.set_slices(layer)
        for m in ("text", "images", "readouts"):
            np.testing.assert_array_equal(t.modality_index(m, layer),
                                          j.modality_index(m, layer))
    assert t.modality_slices() == j.modality_slices()


@pytest.mark.parametrize("name", sorted(jp.PRESETS))
def test_presets_match(name):
    assert tp.get_preset(name) == to_torch_config(jp.get_preset(name))
