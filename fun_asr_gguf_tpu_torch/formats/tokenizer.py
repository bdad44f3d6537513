"""LLM tokenizer layer.

Replaces the reference's native ``llama_tokenize`` / ``llama_token_to_piece``
ctypes bindings (reference ``fun_asr_gguf/llama.py:738-748``) with a pure
host-side tokenizer:

* :class:`QwenTokenizer` — loads the HF ``tokenizer.json`` (Qwen3 byte-level
  BPE) via the ``tokenizers`` library, matching the reference's semantics of
  ``add_special=False, parse_special=True``, and exposes *byte-level* pieces
  so streaming UTF-8 assembly works exactly like ``ASRStreamDecoder``
  (``llama.py:661-690``).
* :class:`ByteTokenizer` — tiny deterministic fallback used by unit tests
  and random-weight benchmarks (maps UTF-8 bytes to ids directly).
"""

import codecs
import json
import os
from functools import lru_cache
from typing import List, Optional, Sequence


@lru_cache(maxsize=1)
def _bytes_to_unicode():
    """GPT-2 byte<->unicode table used by byte-level BPE vocabularies."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("\xa1"), ord("\xac") + 1)) +
          list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


@lru_cache(maxsize=1)
def _unicode_to_bytes():
    return {v: k for k, v in _bytes_to_unicode().items()}


class BaseTokenizer:
    """Interface shared by all tokenizers in this package."""

    vocab_size: int
    eos_token: int
    stop_tokens: Sequence[int]

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def token_bytes(self, token_id: int) -> bytes:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        return b"".join(self.token_bytes(i) for i in ids).decode(
            "utf-8", errors="replace")


# the Qwen2/Qwen3 pre-tokenization split (llama.cpp's LLAMA_VOCAB_PRE_QWEN2
# regex; also the pattern inside the HF tokenizer.json)
QWEN_SPLIT_REGEX = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
                    r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
                    r"\s+(?!\S)|\s+")

# GGUF tokenizer.ggml.token_type values (ggml llama_token_type)
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6


def qwen_tokenizer_spec(vocab: dict, merges: List[str],
                        added: List[dict]) -> dict:
    """The HF tokenizer.json schema for Qwen's byte-level BPE.

    ``vocab``: piece → id (byte-level unicode form); ``merges``: "a b"
    strings; ``added``: added_tokens entries (id/content/special).
    """
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN_SPLIT_REGEX},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": False, "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "",
                  "end_of_word_suffix": "", "fuse_unk": False,
                  "byte_fallback": False, "vocab": vocab,
                  "merges": merges},
    }


class QwenTokenizer(BaseTokenizer):
    """Qwen3 byte-level BPE from a HF tokenizer.json.

    Stop ids follow the reference's hardcoded set (``core/decoder.py:53``):
    151643 (<|endoftext|>) and 151645 (<|im_end|>).
    """

    def __init__(self, tokenizer_json_path: str):
        from tokenizers import Tokenizer
        self._init_from(Tokenizer.from_file(tokenizer_json_path))

    @classmethod
    def from_gguf(cls, gguf_path: str, reader=None) -> "QwenTokenizer":
        """Build from the vocab embedded in a llama.cpp GGUF
        (``tokenizer.ggml.tokens/merges/token_type`` KVs) — the same
        self-contained loading ``llama.dll`` does, so a stock llama.cpp
        export works without a separate tokenizer.json.

        The tokenizers runtime numbers added tokens base-vocab-size +
        insertion order, so control/user-defined entries must sit
        contiguously at the tail of the GGUF token list (they do for
        every Qwen export; validated here).
        """
        import json as _json
        from tokenizers import Tokenizer
        from .gguf import GGUFReader
        r = reader if reader is not None else GGUFReader(gguf_path)
        tokens = r.fields.get("tokenizer.ggml.tokens")
        merges = r.fields.get("tokenizer.ggml.merges")
        if tokens is None or merges is None:
            raise ValueError(f"{gguf_path} has no embedded tokenizer "
                             "(tokenizer.ggml.tokens/merges KVs missing)")
        types = r.fields.get("tokenizer.ggml.token_type",
                             [TOKEN_TYPE_NORMAL] * len(tokens))
        n_base = len(tokens)
        while n_base > 0 and types[n_base - 1] in (TOKEN_TYPE_CONTROL,
                                                   TOKEN_TYPE_USER_DEFINED):
            n_base -= 1
        for i in range(n_base):
            if types[i] in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED):
                raise ValueError(
                    f"{gguf_path}: added token {tokens[i]!r} (id {i}) is "
                    "not at the tail of the vocab; the tokenizers runtime "
                    "cannot reproduce its id")
        vocab = {t: i for i, t in enumerate(tokens[:n_base])}
        added = [{"id": n_base + j, "content": t, "single_word": False,
                  "lstrip": False, "rstrip": False, "normalized": False,
                  "special": types[n_base + j] == TOKEN_TYPE_CONTROL}
                 for j, t in enumerate(tokens[n_base:])]
        spec = qwen_tokenizer_spec(vocab, list(merges), added)
        obj = cls.__new__(cls)
        obj._init_from(Tokenizer.from_str(_json.dumps(spec)))
        return obj

    def _init_from(self, tok):
        self._tok = tok
        self.vocab_size = self._tok.get_vocab_size(with_added_tokens=True)
        # special ids from the RUNTIME, not the file's declared ids: the
        # tokenizers library assigns added-token ids as base-vocab-size +
        # insertion order, silently ignoring the JSON "id" field (they
        # coincide for the real Qwen file, whose base vocab is exactly
        # 151643 entries — but keying off the file would break decode on
        # any file where they diverge)
        self._special = {
            tid: tok.content
            for tid, tok in self._tok.get_added_tokens_decoder().items()}
        by_content = {c: t for t, c in self._special.items()}
        self.eos_token = by_content.get("<|im_end|>", 151645)
        # reference stop set {<|endoftext|>, <|im_end|>}, core/decoder.py:53
        self.stop_tokens = tuple(sorted(
            {by_content.get("<|endoftext|>", 151643), self.eos_token}))
        self._u2b = _unicode_to_bytes()

    def encode(self, text: str) -> List[int]:
        # add_special_tokens=False == reference add_special=False; the
        # tokenizers library always parses added special tokens in the text,
        # matching parse_special=True.
        return self._tok.encode(text, add_special_tokens=False).ids

    def token_bytes(self, token_id: int) -> bytes:
        if token_id in self._special:
            return self._special[token_id].encode("utf-8")
        piece = self._tok.id_to_token(token_id)
        if piece is None:
            return b""
        try:
            return bytes(self._u2b[c] for c in piece)
        except KeyError:
            return piece.encode("utf-8")


class ByteTokenizer(BaseTokenizer):
    """Deterministic byte-level tokenizer for tests/benchmarks.

    ids 0..255 are raw bytes; special tokens get ids >= 256. Mirrors the shape
    of the real tokenizer API so the engine stack can run without model
    artifacts.
    """

    def __init__(self, specials: Optional[Sequence[str]] = None,
                 vocab_size: Optional[int] = None):
        specials = list(specials or
                        ["<|endoftext|>", "<|im_start|>", "<|im_end|>"])
        self._special_by_text = {s: 256 + i for i, s in enumerate(specials)}
        self._special_by_id = {v: k for k, v in self._special_by_text.items()}
        self.vocab_size = vocab_size or (256 + len(specials))
        self.eos_token = self._special_by_text.get("<|im_end|>", 256)
        self.stop_tokens = tuple(sorted(self._special_by_id))

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        i = 0
        while i < len(text):
            matched = None
            for s, tid in self._special_by_text.items():
                if text.startswith(s, i):
                    matched = (s, tid)
                    break
            if matched:
                ids.append(matched[1])
                i += len(matched[0])
            else:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def token_bytes(self, token_id: int) -> bytes:
        if token_id in self._special_by_id:
            return self._special_by_id[token_id].encode("utf-8")
        if 0 <= token_id < 256:
            return bytes([token_id])
        return b""


class StreamTextDecoder:
    """Incremental UTF-8 assembly of generated token pieces.

    Behavioral port of ``ASRStreamDecoder`` (reference ``llama.py:661-690``):
    multi-byte characters split across tokens are buffered by an incremental
    codec, each completed piece is appended and optionally streamed to a
    reporter.
    """

    def __init__(self, tokenizer: BaseTokenizer, reporter=None):
        self.tokenizer = tokenizer
        self.reporter = reporter
        self.byte_decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")
        self.generated_text = ""
        self.tokens_generated = 0
        self.tokens: List[str] = []

    def push(self, token_id: int) -> str:
        raw = self.tokenizer.token_bytes(int(token_id))
        piece = self.byte_decoder.decode(raw, final=False)
        self.tokens.append(piece)
        self.tokens_generated += 1
        self.generated_text += piece
        if self.reporter:
            self.reporter.stream(piece)
        return piece

    def flush(self) -> str:
        remaining = self.byte_decoder.decode(b"", final=True)
        self.tokens.append(remaining)
        self.generated_text += remaining
        return remaining


SPECIAL_TOKEN_TYPES = ("bos", "eos", "unk", "sep", "pad", "cls", "mask")


def special_vocab_kvs(hf_dir: str, tokens: Sequence[str]) -> dict:
    """Special-token ids, add_bos/eos flags and the chat template as
    ``tokenizer.*`` GGUF KVs, from a HF checkpoint directory.

    Behavioral port of the reference's ``SpecialVocab``
    (``fun_asr_gguf/gguf/vocab.py:50-330``): token *contents* come from
    tokenizer_config.json (string or ``{"content": ...}`` forms) and
    resolve to ids against the vocab; explicit ``<typ>_token_id``
    entries in config.json fill the gaps; ``add_bos_token`` /
    ``add_eos_token`` and ``chat_template`` pass through.
    """
    kvs: dict = {}
    by_content = {t: i for i, t in enumerate(tokens)}

    def _read(name):
        p = os.path.join(hf_dir, name)
        if os.path.isfile(p):
            with open(p, encoding="utf-8") as f:
                return json.load(f)
        return {}

    tok_cfg = _read("tokenizer_config.json")
    cfg = _read("config.json")

    for typ in SPECIAL_TOKEN_TYPES:
        tid = None
        content = tok_cfg.get(f"{typ}_token")
        if isinstance(content, dict):
            content = content.get("content")
        if isinstance(content, str):
            tid = by_content.get(content)
        if tid is None:
            cand = cfg.get(f"{typ}_token_id",
                           cfg.get("text_config", {}).get(f"{typ}_token_id"))
            if isinstance(cand, int) and 0 <= cand < len(tokens):
                tid = cand
        if tid is not None:
            key = {"bos": "bos_token_id", "eos": "eos_token_id",
                   "unk": "unknown_token_id", "sep": "separator_token_id",
                   "pad": "padding_token_id", "cls": "cls_token_id",
                   "mask": "mask_token_id"}[typ]
            kvs[f"tokenizer.ggml.{key}"] = tid
    for typ in ("bos", "eos"):
        flag = tok_cfg.get(f"add_{typ}_token")
        if isinstance(flag, bool):
            kvs[f"tokenizer.ggml.add_{typ}_token"] = flag
    template = tok_cfg.get("chat_template")
    if isinstance(template, str):
        kvs["tokenizer.chat_template"] = template
    return kvs


def tokenizer_from_gguf(gguf_path: str) -> BaseTokenizer:
    """Build the right runtime for a GGUF's embedded vocab by its
    ``tokenizer.ggml.model`` key: ``gpt2`` (byte-BPE, Qwen-family) →
    :class:`QwenTokenizer`; ``llama`` (SentencePiece) →
    :class:`~.spm.SpmTokenizer` — the same dispatch llama.cpp's
    ``llm_load_vocab`` performs."""
    from .gguf import GGUFReader
    reader = GGUFReader(gguf_path)
    if reader.fields.get("tokenizer.ggml.model") == "llama":
        from .spm import SpmTokenizer
        return SpmTokenizer.from_gguf(gguf_path, reader=reader)
    return QwenTokenizer.from_gguf(gguf_path, reader=reader)


def load_tokenizer(path: Optional[str]) -> BaseTokenizer:
    """Load the best available tokenizer for a checkpoint.

    ``path`` may be a tokenizer.json file or a directory containing one.
    Falls back to :class:`ByteTokenizer` when nothing is found (keeps the
    pipeline runnable for tests/benchmarks without artifacts).
    """
    if path:
        cand = path
        if os.path.isdir(cand):
            cand = os.path.join(cand, "tokenizer.json")
        if os.path.exists(cand):
            return QwenTokenizer(cand)
        # a raw SentencePiece checkpoint (llama/mistral family)
        spm_cand = path if path.endswith(".model") else (
            os.path.join(path, "tokenizer.model") if os.path.isdir(path)
            else "")
        if spm_cand and os.path.exists(spm_cand):
            from .spm import SpmTokenizer, gguf_vocab_from_spm
            tokens, scores, types, model = gguf_vocab_from_spm(spm_cand)
            return SpmTokenizer(tokens, scores, types, unk_id=model.unk_id,
                                bos_id=model.bos_id, eos_id=model.eos_id)
        # no tokenizer.json: a llama.cpp GGUF carries its own vocab
        base = path if os.path.isdir(path) else os.path.dirname(path)
        if os.path.isdir(base):
            for name in sorted(os.listdir(base)):
                if name.endswith(".gguf"):
                    try:
                        return tokenizer_from_gguf(os.path.join(base, name))
                    except (ValueError, OSError, KeyError):
                        continue
    return ByteTokenizer()


def gguf_vocab_from_tokenizer_json(path: str):
    """Extract (tokens, token_types, merges) in llama.cpp GGUF layout
    from a HF tokenizer.json — runtime ids, not the file's declared ids
    (the tokenizers library numbers added tokens base-vocab-size +
    insertion order)."""
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)
    vocab = spec["model"]["vocab"]
    tokens: List[Optional[str]] = [None] * len(vocab)
    for piece, i in vocab.items():
        tokens[i] = piece
    if any(t is None for t in tokens):
        raise ValueError(f"{path}: base vocab ids are not contiguous")
    types = [TOKEN_TYPE_NORMAL] * len(tokens)
    for a in spec.get("added_tokens") or []:
        if a["content"] in vocab:
            continue                    # already a base piece, keeps its id
        tokens.append(a["content"])
        types.append(TOKEN_TYPE_CONTROL if a.get("special")
                     else TOKEN_TYPE_USER_DEFINED)
    merges = [m if isinstance(m, str) else " ".join(m)
              for m in spec["model"]["merges"]]
    return tokens, types, merges
