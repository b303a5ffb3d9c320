"""``PolicyEngine.compile`` and string instructions in the port, on the CPU.

A compiled engine on the CPU serves from its serving copy (compute-dtype
parameters stored in that dtype) and captures nothing; its outputs equal
the uncompiled engine's bit for bit for all three heads, on the cached and
the full path, in float32 and in bfloat16, and compiling consumes none of
the engine's noise.  String instructions go through ``WordTokenizer`` and
``T5StyleTokenizer`` (vocabularies built here) with the JAX engine's
broadcast rules, and give its text embeddings to MODULE_TOL.
"""

import numpy as np
import pytest
import torch

from torch_parity import MODULE_TOL, inputs, micro_pair, octo_micro_t5, \
    to_torch_config
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_torch.modules.layers import (
    Dense, LayerNorm)
from multi_modal_transformers_tokenmerge_torch.modules.text import (
    WordTokenizer)
from multi_modal_transformers_tokenmerge_torch.serve.policy import (
    PolicyEngine, serving_copy)
from multi_modal_transformers_tokenmerge_torch.utils import spm as tspm
from multi_modal_transformers_tokenmerge_tpu.modules import text as jtext
from multi_modal_transformers_tokenmerge_tpu.serve.policy import (
    PolicyEngine as JaxPolicyEngine)
from multi_modal_transformers_tokenmerge_tpu.utils import spm as jspm

HEADS = ("diffusion", "continuous", "categorical")


def _model(dtype):
    cfg = to_torch_config(octo_micro_t5()).replace(dtype=dtype)
    return TOcto(cfg, device="cpu", seed=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", HEADS)
def test_compiled_cpu_engine_equals_uncompiled(head, dtype):
    model = _model(dtype)
    cfg = model.config
    ids, _ = inputs(octo_micro_t5(), batch=2, seed=3)
    image_shape = (cfg.num_observation_blocks, *cfg.images.image_size)
    plain = PolicyEngine(model, head=head, batch_size=2, seed=1)
    compiled = PolicyEngine(model, head=head, batch_size=2, seed=1).compile(
        (cfg.text.max_length,), image_shape)
    assert compiled._graphs == {}           # nothing captured on the CPU
    for eng in (plain, compiled):
        eng.set_instruction(ids[0])
    assert torch.equal(plain._text_embeddings, compiled._text_embeddings)
    for i in range(3):
        images = inputs(octo_micro_t5(), batch=2, seed=10 + i)[1]
        want, got = plain(images), compiled(images)
        assert got.dtype == want.dtype and torch.equal(got, want), i
    images = inputs(octo_micro_t5(), batch=2, seed=20)[1]
    assert torch.equal(compiled(images, text_tokens=ids),
                       plain(images, text_tokens=ids))


def test_serving_copy_stores_cast_parameters_only():
    """bfloat16 compute: Dense weights and biases (and every other
    parameter a forward casts) are stored in bf16 in the copy; the norms'
    parameters, which forwards use in float32, and the model itself are
    untouched."""
    model = _model("bfloat16")
    copy = serving_copy(model)
    dense = [m for m in copy.modules() if isinstance(m, Dense)]
    norms = [m for m in copy.modules() if isinstance(m, LayerNorm)]
    assert dense and norms
    assert all(m.weight.dtype == torch.bfloat16 for m in dense)
    assert all(m.weight.dtype == torch.float32 for m in norms)
    assert copy.readout_encoder.pos_embedding.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert not any(p.requires_grad for p in copy.parameters())


WORDS = ["pick up the red block", "put the cup down", "open drawer"]
PIECES = [("<pad>", 0.0, jspm.CONTROL), ("</s>", 0.0, jspm.CONTROL),
          ("<unk>", -10.0, jspm.UNKNOWN), ("▁", -2.0, jspm.NORMAL),
          ("▁pick", -3.0, jspm.NORMAL), ("▁up", -3.1, jspm.NORMAL),
          ("▁the", -2.5, jspm.NORMAL), ("▁red", -3.5, jspm.NORMAL),
          ("▁block", -3.6, jspm.NORMAL), ("▁b", -5.0, jspm.NORMAL),
          ("lock", -5.5, jspm.NORMAL), ("p", -6.0, jspm.NORMAL)]


def _tokenizers(kind, max_length):
    if kind == "word":
        return (WordTokenizer.from_corpus(WORDS, max_length),
                jtext.WordTokenizer.from_corpus(WORDS, max_length))
    blob = jspm.build_model_proto(PIECES)
    assert tspm.build_model_proto(PIECES) == blob
    return (tspm.T5StyleTokenizer(tspm.SentencePieceUnigramModel.from_bytes(
                blob), max_length),
            jspm.T5StyleTokenizer(jspm.SentencePieceUnigramModel.from_bytes(
                blob), max_length))


@pytest.mark.parametrize("kind", ["word", "t5"])
def test_string_instructions_match_the_jax_engine(kind):
    cfg = octo_micro_t5()
    jm, v, model = micro_pair(cfg)
    ours_tok, their_tok = _tokenizers(kind, cfg.text.max_length)
    texts = ["pick up the red block", "put the blocklock down"]
    for t in texts:
        assert ours_tok([t]).tolist() == their_tok([t]).tolist()
    ours = PolicyEngine(model, batch_size=2, tokenizer=ours_tok)
    theirs = JaxPolicyEngine(jm, v, batch_size=2, tokenizer=their_tok)
    for instruction in (texts[0], texts):    # broadcast, and one per row
        ours.set_instruction(instruction)
        theirs.set_instruction(instruction)
        np.testing.assert_allclose(ours._text_embeddings.numpy(),
                                   np.asarray(theirs._text_embeddings),
                                   rtol=MODULE_TOL, atol=MODULE_TOL)
    row = ours.encode_instruction(texts[1])
    np.testing.assert_allclose(row.numpy(),
                               np.asarray(theirs.encode_instruction(texts[1])),
                               rtol=MODULE_TOL, atol=MODULE_TOL)
    for eng in (ours, theirs):
        with pytest.raises(ValueError, match="instruction strings"):
            eng.set_instruction(texts + texts[:1])
    untokenized = PolicyEngine(model, batch_size=2)
    with pytest.raises(ValueError, match="no tokenizer"):
        untokenized.set_instruction(texts[0])
