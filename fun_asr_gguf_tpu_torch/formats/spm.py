"""SentencePiece (SPM) vocabulary support — no sentencepiece dependency.

Covers the reference's SentencePiece paths with pure Python:

- :func:`parse_spm_model` reads a ``tokenizer.model`` protobuf
  (sentencepiece ``ModelProto``) by walking the protobuf wire format
  directly — the environment has no sentencepiece package, and the
  format is stable: repeated field 1 holds ``SentencePiece {piece=1,
  score=2, type=3}``, field 2 the ``TrainerSpec`` with
  ``unk_id/bos_id/eos_id/pad_id`` at 40-43. Replaces the reference's
  ``SentencePieceProcessor`` usage in
  ``fun_asr_gguf/gguf/vocab.py:431-503`` (SentencePieceVocab).
- :func:`gguf_vocab_from_spm` yields the llama.cpp GGUF vocab layout
  (tokens / scores / token types, with ``added_tokens.json`` overlay)
  the way ``SentencePieceVocab.all_tokens`` does
  (``vocab.py:469-501``).
- :class:`SpmTokenizer` is the runtime: the bigram-merge SPM encoder
  and piece decoder llama.cpp implements in C++ (``llm_tokenizer_spm``)
  — the reference delegates these to ``llama.dll``; here they back
  llama/mistral-family GGUFs end-to-end (generate/server/tokenize CLI).

SPM piece types map 1:1 onto GGUF token types (both enums use
NORMAL=1 … BYTE=6), so no translation table is needed.
"""

import json
import os
import struct
from heapq import heappop, heappush
from typing import Dict, List, Optional, Sequence, Tuple

from .tokenizer import (BaseTokenizer, TOKEN_TYPE_BYTE, TOKEN_TYPE_CONTROL,
                        TOKEN_TYPE_NORMAL, TOKEN_TYPE_UNKNOWN,
                        TOKEN_TYPE_USER_DEFINED)

SPM_SPACE = "▁"  # ▁ (lower one eighth block): SPM's space escape


# ---------------------------------------------------------------------------
# protobuf wire-format walk (just enough for ModelProto)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 63:
            raise ValueError("varint too long (corrupt protobuf)")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message level.

    LEN fields yield bytes; VARINT ints; I32/I64 raw 4/8 bytes.
    """
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wtype = tag >> 3, tag & 7
        if wtype == 0:          # varint
            val, i = _read_varint(buf, i)
        elif wtype == 1:        # fixed64
            val, i = buf[i:i + 8], i + 8
        elif wtype == 2:        # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wtype == 5:        # fixed32
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wtype}")
        yield field, wtype, val


def _zigzag_to_signed(v: int) -> int:
    # TrainerSpec ids are plain int32 varints; negative values (pad_id
    # defaults to -1) arrive two's-complement over 10 bytes
    return v - (1 << 64) if v >= (1 << 63) else v


class SpmModel:
    """Parsed tokenizer.model: pieces + trainer special ids."""

    def __init__(self, pieces: List[Tuple[str, float, int]],
                 unk_id: int = 0, bos_id: int = 1, eos_id: int = 2,
                 pad_id: int = -1):
        self.pieces = pieces          # [(text, score, spm_type)]
        self.unk_id = unk_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id


def parse_spm_model(path_or_bytes) -> SpmModel:
    """Parse a sentencepiece ``tokenizer.model`` (ModelProto)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    pieces: List[Tuple[str, float, int]] = []
    trainer = {}
    for field, wtype, val in _iter_fields(buf):
        if field == 1 and wtype == 2:             # repeated SentencePiece
            text, score, ptype = "", 0.0, 1       # type defaults to NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    text = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append((text, score, ptype))
        elif field == 2 and wtype == 2:           # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if w2 == 0 and f2 in (40, 41, 42, 43):
                    trainer[f2] = _zigzag_to_signed(v2)
    return SpmModel(pieces,
                    unk_id=trainer.get(40, 0), bos_id=trainer.get(41, 1),
                    eos_id=trainer.get(42, 2), pad_id=trainer.get(43, -1))


# ---------------------------------------------------------------------------
# GGUF vocab export (reference vocab.py:469-501 semantics)
# ---------------------------------------------------------------------------

def gguf_vocab_from_spm(model_path: str,
                        added_tokens_path: Optional[str] = None):
    """tokenizer.model (+ optional added_tokens.json) → the llama.cpp
    GGUF vocab triple (tokens, scores, token_types).

    Added tokens must extend the base vocab contiguously after ids
    already inside the base vocab are dropped (the same filter + check
    the reference applies at ``vocab.py:435-466`` — HF repos routinely
    restate <unk>/<s>/</s> in added_tokens.json); new entries are
    emitted as USER_DEFINED with score -1000.0, matching
    ``SentencePieceVocab.added_tokens``.
    """
    model = parse_spm_model(model_path)
    tokens = [p[0] for p in model.pieces]
    scores = [float(p[1]) for p in model.pieces]
    types = [int(p[2]) for p in model.pieces]

    added: Dict[str, int] = {}
    if added_tokens_path is None and os.path.isfile(model_path):
        cand = os.path.join(os.path.dirname(model_path),
                            "added_tokens.json")
        added_tokens_path = cand if os.path.isfile(cand) else None
    if added_tokens_path:
        with open(added_tokens_path, encoding="utf-8") as f:
            added = json.load(f)
    if added:
        base = len(tokens)
        # ids already inside the base vocab are restatements, not
        # extensions — drop them (reference vocab.py:447-452)
        added = {t: i for t, i in added.items() if i >= base}
    if added:
        expected = list(range(base, base + len(added)))
        actual = sorted(added.values())
        if expected != actual:
            raise ValueError(
                f"added_tokens.json ids are not a contiguous extension of "
                f"the base vocab (expected {expected[0]}..{expected[-1]}, "
                f"got {actual[0]}..{actual[-1]})")
        for text, _id in sorted(added.items(), key=lambda kv: kv[1]):
            tokens.append(text)
            scores.append(-1000.0)
            types.append(TOKEN_TYPE_USER_DEFINED)
    return tokens, scores, types, model


# ---------------------------------------------------------------------------
# runtime tokenizer (llama.cpp llm_tokenizer_spm, reimplemented)
# ---------------------------------------------------------------------------

class SpmTokenizer(BaseTokenizer):
    """SentencePiece BPE runtime for llama/mistral-family vocabs.

    Encode is the bigram-merge algorithm llama.cpp's ``llm_tokenizer_spm``
    runs: split into UTF-8 characters, repeatedly merge the adjacent
    pair whose concatenation is the highest-scoring vocab piece
    (ties → leftmost), then resegment leftovers through byte-fallback
    pieces (``<0xXX>``) or UNK. The reference reaches this code through
    ``llama.dll``; no python equivalent exists there.
    """

    def __init__(self, tokens: Sequence[str], scores: Sequence[float],
                 types: Sequence[int], unk_id: int = 0,
                 bos_id: int = 1, eos_id: int = 2,
                 add_space_prefix: bool = True):
        self.tokens = list(tokens)
        self.scores = list(scores)
        self.types = list(types)
        self.vocab_size = len(self.tokens)
        self.unk_id = unk_id
        self.add_space_prefix = add_space_prefix
        self._index = {t: i for i, t in enumerate(self.tokens)}
        self._bytes = {}
        for i, (t, ty) in enumerate(zip(self.tokens, self.types)):
            if ty == TOKEN_TYPE_BYTE and len(t) == 6 and t.startswith("<0x"):
                self._bytes[int(t[3:5], 16)] = i
        self.eos_token = eos_id
        self.bos_token = bos_id
        self.stop_tokens = (eos_id,)
        # user-defined/control pieces match verbatim before SPM escaping
        self._specials = sorted(
            (t for t, ty in zip(self.tokens, self.types)
             if ty in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED) and t),
            key=len, reverse=True)

    @classmethod
    def from_gguf(cls, gguf_path: str, reader=None) -> "SpmTokenizer":
        """Build from GGUF ``tokenizer.ggml.*`` KVs (model == llama)."""
        from .gguf import GGUFReader
        r = reader if reader is not None else GGUFReader(gguf_path)
        if r.fields.get("tokenizer.ggml.model") != "llama":
            raise ValueError(f"{gguf_path}: not an SPM (llama) vocab")
        tokens = list(r.fields["tokenizer.ggml.tokens"])
        scores = list(r.fields.get("tokenizer.ggml.scores",
                                   [0.0] * len(tokens)))
        types = list(r.fields.get("tokenizer.ggml.token_type",
                                  [TOKEN_TYPE_NORMAL] * len(tokens)))
        def _id(key, default):
            v = r.fields.get(key)
            return int(v) if v is not None else default
        return cls(tokens, scores, types,
                   unk_id=_id("tokenizer.ggml.unknown_token_id", 0),
                   bos_id=_id("tokenizer.ggml.bos_token_id", 1),
                   eos_id=_id("tokenizer.ggml.eos_token_id", 2),
                   add_space_prefix=bool(r.fields.get(
                       "tokenizer.ggml.add_space_prefix", True)))

    # -- encode ------------------------------------------------------------

    def _encode_fragment(self, text: str) -> List[int]:
        if not text:
            return []
        sym = [c for c in text]                    # UTF-8 characters
        nxt = list(range(1, len(sym))) + [-1]
        prv = [-1] + list(range(0, len(sym) - 1))
        alive = [True] * len(sym)

        heap: List[Tuple[float, int, int, str]] = []

        def try_pair(left: int):
            right = nxt[left]
            if right < 0:
                return
            merged = sym[left] + sym[right]
            idx = self._index.get(merged)
            if idx is not None and self.types[idx] == TOKEN_TYPE_NORMAL:
                heappush(heap, (-self.scores[idx], left, right, merged))

        for i in range(len(sym) - 1):
            try_pair(i)
        while heap:
            _negscore, left, right, merged = heappop(heap)
            if (left >= len(sym) or not alive[left] or right >= len(sym)
                    or not alive[right] or sym[left] + sym[right] != merged):
                continue
            sym[left] = merged
            alive[right] = False
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prv[nxt[right]] = left
            try_pair(left)
            if prv[left] >= 0:
                try_pair(prv[left])

        out: List[int] = []
        i = 0
        while i >= 0 and i < len(sym):
            if alive[i]:
                piece = sym[i]
                idx = self._index.get(piece)
                if idx is not None and self.types[idx] != TOKEN_TYPE_BYTE:
                    out.append(idx)
                else:
                    for b in piece.encode("utf-8"):
                        out.append(self._bytes.get(b, self.unk_id))
            i = nxt[i]
        return out

    def encode(self, text: str) -> List[int]:
        # split on special pieces first (parse_special=True semantics,
        # matching QwenTokenizer.encode's contract)
        frags: List[Tuple[bool, str]] = [(False, text)]
        for sp in self._specials:
            nf: List[Tuple[bool, str]] = []
            for is_sp, frag in frags:
                if is_sp:
                    nf.append((is_sp, frag))
                    continue
                parts = frag.split(sp)
                for j, part in enumerate(parts):
                    if j:
                        nf.append((True, sp))
                    if part:
                        nf.append((False, part))
            frags = nf
        ids: List[int] = []
        # llama.cpp's llm_tokenizer_spm space-prefixes a text fragment
        # at the start AND after every special token (is_prev_special),
        # so "</s><s>again" tokenizes "again" as "\u2581again"
        prev_special = True
        for is_sp, frag in frags:
            if is_sp:
                ids.append(self._index[frag])
                prev_special = True
                continue
            if prev_special and self.add_space_prefix:
                frag = " " + frag
            prev_special = False
            ids.extend(self._encode_fragment(
                frag.replace(" ", SPM_SPACE)))
        return ids

    # -- decode ------------------------------------------------------------

    def token_bytes(self, token_id: int) -> bytes:
        if not 0 <= token_id < self.vocab_size:
            return b""
        ty = self.types[token_id]
        piece = self.tokens[token_id]
        if ty == TOKEN_TYPE_BYTE:
            return bytes([int(piece[3:5], 16)])
        if ty in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_UNKNOWN):
            return piece.encode("utf-8")
        return piece.replace(SPM_SPACE, " ").encode("utf-8")
