"""Dependency-free SentencePiece *unigram* model reader and encoder.

The port's own copy of the JAX package's ``utils/spm.py`` (numpy only).
It serves raw instruction strings from a local ``.model`` file without the
``sentencepiece`` package:

* a minimal protobuf wire-format parser for the ``ModelProto`` messages a
  T5-style unigram model uses (``pieces`` with piece/score/type);
* Viterbi segmentation over the piece vocabulary (max total log-prob),
  with sentencepiece's whitespace convention (space -> U+2581, dummy
  prefix) and unknown-character fallback (unk score minus the standard
  penalty of 10).

:func:`build_model_proto` writes the same subset, so vocabularies can be
built offline and the round trip is testable without the sentencepiece
package.  Host-side preprocessing only.
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["SentencePieceUnigramModel", "T5StyleTokenizer",
           "build_model_proto"]

_SPACE = "▁"  # ▁
_UNK_PENALTY = 10.0  # sentencepiece kUnkPenalty

# SentencePiece.Type enum (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# ---------------------------------------------------------------------------
# protobuf wire format (only what ModelProto needs)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.
    Values: varint -> int, fixed32/64 -> raw bytes, length-delimited -> bytes.
    """
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:  # fixed32
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_piece(buf: bytes) -> Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, NORMAL
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            piece = val.decode("utf-8")
        elif field == 2 and wire == 5:
            score = struct.unpack("<f", val)[0]
        elif field == 3 and wire == 0:
            ptype = val
    return piece, score, ptype


def build_model_proto(
    pieces: Sequence[Tuple[str, float, int]]
) -> bytes:
    """Serialize ``(piece, score, type)`` triples as a ModelProto blob
    readable by :class:`SentencePieceUnigramModel` (and by the real
    sentencepiece library)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        pb = piece.encode("utf-8")
        msg = (_write_varint((1 << 3) | 2) + _write_varint(len(pb)) + pb
               + _write_varint((2 << 3) | 5) + struct.pack("<f", score)
               + _write_varint((3 << 3) | 0) + _write_varint(ptype))
        out += _write_varint((1 << 3) | 2) + _write_varint(len(msg)) + msg
    return bytes(out)


# ---------------------------------------------------------------------------
# unigram model
# ---------------------------------------------------------------------------

class SentencePieceUnigramModel:
    """Unigram sentencepiece model: vocabulary + Viterbi segmentation."""

    def __init__(self, pieces: Sequence[Tuple[str, float, int]]):
        if not pieces:
            raise ValueError("empty sentencepiece model")
        self.pieces: List[str] = [p for p, _, _ in pieces]
        self.scores = np.asarray([s for _, s, _ in pieces], dtype=np.float64)
        self.types: List[int] = [t for _, _, t in pieces]
        self.vocab: Dict[str, int] = {}
        for i, (p, _, t) in enumerate(pieces):
            if p not in self.vocab:
                self.vocab[p] = i
        unks = [i for i, t in enumerate(self.types) if t == UNKNOWN]
        self.unk_id = unks[0] if unks else 0
        self.max_piece_len = max(len(p) for p in self.pieces)
        min_score = float(self.scores.min())
        self._unk_score = min_score - _UNK_PENALTY

    @classmethod
    def from_bytes(cls, blob: bytes) -> "SentencePieceUnigramModel":
        pieces = [_parse_piece(val) for field, wire, val in _iter_fields(blob)
                  if field == 1 and wire == 2]
        return cls(pieces)

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceUnigramModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    def piece_to_id(self, piece: str) -> int:
        return self.vocab.get(piece, self.unk_id)

    def id_to_piece(self, idx: int) -> str:
        return self.pieces[idx]

    def normalize(self, text: str) -> str:
        """NFKC + sentencepiece whitespace convention with dummy prefix
        (the t5 normalizer is nmt_nfkc; NFKC covers its character mapping
        for ordinary instruction text)."""
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())  # collapse whitespace runs
        return _SPACE + text.replace(" ", _SPACE)

    def _segmentable(self, pid: int) -> bool:
        return self.types[pid] in (NORMAL, USER_DEFINED)

    def encode(self, text: str) -> List[int]:
        """Viterbi max-score segmentation; unknown characters fall back to
        one ``unk`` per char, with consecutive unks merged (sentencepiece
        behavior)."""
        s = self.normalize(text)
        n = len(s)
        neg_inf = float("-inf")
        best = [neg_inf] * (n + 1)
        best[0] = 0.0
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)
        for i in range(1, n + 1):
            for j in range(max(0, i - self.max_piece_len), i):
                if best[j] == neg_inf:
                    continue
                pid = self.vocab.get(s[j:i])
                if pid is None or not self._segmentable(pid):
                    continue
                sc = best[j] + float(self.scores[pid])
                if sc > best[i]:
                    best[i], back[i] = sc, (j, pid)
            if best[i] == neg_inf and best[i - 1] != neg_inf:
                best[i] = best[i - 1] + self._unk_score
                back[i] = (i - 1, self.unk_id)
        ids: List[int] = []
        i = n
        while i > 0:
            j, pid = back[i]
            if j < 0:
                raise ValueError(f"cannot segment {s!r} at {i}")
            if not (pid == self.unk_id and ids and ids[-1] == self.unk_id):
                ids.append(pid)
            i = j
        return ids[::-1]

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.pieces[i] for i in ids
                       if self.types[i] in (NORMAL, USER_DEFINED))
        return text.replace(_SPACE, " ").strip()


class T5StyleTokenizer:
    """HF-T5 calling convention over a local unigram model: appends EOS,
    pads with ``<pad>`` (id 0) to ``max_length``, truncates (as
    ``max_length=16, padding='max_length', truncation=True``)."""

    def __init__(self, model, max_length: int = 16):
        if isinstance(model, (str, bytes)):
            model = (SentencePieceUnigramModel.from_file(model)
                     if isinstance(model, str)
                     else SentencePieceUnigramModel.from_bytes(model))
        self.model = model
        self.max_length = max_length
        self.pad_id = 0
        # piece_to_id falls back to unk for missing pieces — an EOS that
        # silently became unk (or piece 0) would corrupt every encoded
        # instruction with no error, so require the piece explicitly
        if "</s>" not in model.vocab:
            raise ValueError(
                "sentencepiece model has no '</s>' piece; a T5-style "
                "tokenizer needs the EOS control piece (t5 layout: "
                "<pad>=0, </s>=1, <unk>=2)")
        self.eos_id = model.vocab["</s>"]
        self.vocab_size = len(model.pieces)

    def encode(self, text: str) -> List[int]:
        ids = self.model.encode(text)
        ids = ids[: self.max_length - 1] + [self.eos_id]
        ids += [self.pad_id] * (self.max_length - len(ids))
        return ids

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return np.asarray([self.encode(t) for t in texts], dtype=np.int32)
