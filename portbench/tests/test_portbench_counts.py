"""The frozen counters against hand counts at the cells' shapes."""

import json
from pathlib import Path

import numpy as np
import pytest

from multi_modal_transformers_tokenmerge_torch import SequenceLayout
from portbench.counts import kernels as K
from portbench.counts import octo as C
from portbench.reference import layout as L

BENCH = Path(__file__).resolve().parents[1]
DEEP = json.loads((BENCH / "configs" / "octo_deep.json").read_text())["model"]
CHUNK = json.loads((BENCH / "configs" / "octo_base_chunk28.json")
                   .read_text())["model"]


def test_live_pairs_by_hand():
    """octo_deep's stages: text 16 (itself only); per timestep t an image
    set of n and a readout set of 4, each attending to the text, every
    image set up to t, and (readouts) itself."""
    sets = L.parse(DEEP["input_sequence"], DEEP["compression_sequence"])
    for event, n in ((0, 100), (1, 68), (2, 36)):
        hand = (16 * 16 + n * (16 + n) + 4 * (16 + n + 4)
                + n * (16 + 2 * n) + 4 * (16 + 2 * n + 4))
        assert L.live_pairs(sets, event) == hand
        assert L.tokens(sets, event) == 16 + 2 * (n + 4)


@pytest.mark.parametrize("model", [DEEP, CHUNK], ids=["deep", "chunk28"])
def test_masks_and_order_are_the_programs(model):
    """The benchmark's own layout agrees with the program's at every
    stage (the program is read here only to hold the copy to it)."""
    sets = L.parse(model["input_sequence"], model["compression_sequence"])
    prog = SequenceLayout.from_strings(model["input_sequence"],
                                       model["compression_sequence"])
    for event in range(3 if model["compression_sequence"] else 1):
        assert np.array_equal(L.attention_mask(sets, event),
                              prog.attention_mask(event))
        assert np.array_equal(L.positions(sets, "Readout", event),
                              prog.modality_index("readouts", layer=event))
    assert np.array_equal(L.stream_order(sets), prog.assembly_permutation)


def test_deep_request_flops_by_hand():
    b = 8
    parts = C.request_flops(DEEP, b)
    # image tower a patch of 28: conv 12/2 -> 9x9x64, pool 3/1 -> 7x7, two
    # 3x3 convs, dense 7*7*64 -> 768; 200 patches a row
    conv = 2 * 81 * 64 * 3 * 144
    blocks = 2 * 2 * 49 * 64 * 64 * 9
    dense = 2 * 49 * 64 * 768
    assert parts["image_tower"] == b * 200 * (conv + blocks + dense)
    per_block = lambda s: 2 * s * 768 * 3 * 768 + 2 * s * 768 * 768 \
        + 4 * s * 768 * 3072
    dense_t = 4 * (per_block(224) + per_block(160) + per_block(96))
    merge = 2 * (2 * 50 * 50 * 768) + 2 * (2 * 34 * 34 * 768)
    assert parts["transformer"] == b * (dense_t + merge)
    nnz = (34816, 17280, 5888)
    assert parts["attention"] == b * 4 * 4 * 768 * sum(nnz)
    head = 32 * (768 + 3 * 2 * 768 * 768) + b * (2 * 768 * 768
                                                  + 32 * 4 * 8 * 768)
    assert parts["head"] == head
    assert parts["total"] == sum(v for k, v in parts.items()
                                 if k != "total")
    # about 31.5 GFLOP a row, as PERF.md reckons
    assert 25e9 < parts["total"] / b < 35e9


def test_flash_calls_and_bound():
    calls = C.flash_fwd_calls(DEEP, 8)
    assert calls == [(8, 224, 12, 64, 34816)] * 4 + \
        [(8, 160, 12, 64, 17280)] * 4 + [(8, 96, 12, 64, 5888)] * 4
    nbytes, flops = K.flash_bytes_flops(1, 224, 12, 64, 34816, "bfloat16",
                                        "fwd_plain")
    assert nbytes == 4 * 224 * 12 * 64 * 2 + 224 * 224
    assert flops == 2 * 2 * 12 * 64 * 34816
    t, by = K.bound(nbytes, flops, "bfloat16")
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)


def test_chunk28_sampler_and_head():
    assert C.sampler_call(CHUNK, 1) == (1, 100, 3072, 28)
    nbytes, flops = K.sampler_bytes_flops(1, 100, 3072, 28, "bfloat16")
    assert flops == 100 * 4 * 3072 * 28
    assert nbytes == (28 * 4 + 100 * 3072 * 2 + 100 * 28 * 4 + 100 * 3 * 4
                      + 2 * 3072 * 28 * 2 + (3072 + 28) * 2 + 28 * 4)
    # chip_smoke.py's 0.000292 ms bound at B=1
    assert K.bound(nbytes, flops, "bfloat16")[0] * 1e3 == pytest.approx(
        0.000292, rel=0.01)
    parts = C.request_flops(CHUNK, 1)
    assert parts["attention"] == 4 * 768 * L.live_pairs(
        L.parse(CHUNK["input_sequence"]))
    # 7.5 GFLOP a row (PERF.md), most of it the image tower
    assert 6e9 < parts["total"] < 9e9
