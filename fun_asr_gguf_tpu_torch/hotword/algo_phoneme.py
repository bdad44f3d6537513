# coding: utf-8
"""Text → phoneme sequence with language attributes.

Behavioral port of the reference phoneme extraction
(``fun_asr_gguf/hotword/algo_phoneme.py``), backed by :mod:`.pinyin`
instead of pypinyin. Each hanzi decomposes into [initial, final, tone]
phonemes carrying word-boundary flags and char spans; English/number runs
become single tokens (or per-char in ``ascii_split_char`` mode) with
camelCase and letter/digit boundary splitting.
"""

import re
from dataclasses import dataclass
from typing import List, Literal, Tuple

from .pinyin import char_pinyin


@dataclass(frozen=True)
class Phoneme:
    """A phoneme with language attributes (reference ``algo_phoneme.py:17-56``).

    info 7-tuple: (value, lang, is_word_start, is_word_end, is_tone,
    char_start, char_end).
    """
    value: str
    lang: Literal["zh", "en", "num", "other"]
    is_word_start: bool = False
    is_word_end: bool = False
    char_start: int = 0
    char_end: int = 0

    @property
    def is_tone(self) -> bool:
        return self.value.isdigit()

    @property
    def is_english(self) -> bool:
        return self.lang == "en"

    @property
    def info(self) -> Tuple[str, str, bool, bool, bool, int, int]:
        return (self.value, self.lang, self.is_word_start, self.is_word_end,
                self.is_tone, self.char_start, self.char_end)

    def __str__(self) -> str:
        return self.value

    def __repr__(self) -> str:
        return (f"Phoneme({self.value}, {self.lang}, "
                f"start={self.is_word_start}, end={self.is_word_end})")


def _is_hanzi(ch: str) -> bool:
    return "一" <= ch <= "鿿"


# boundary rules match the reference's unicode-aware char walk: hanzi
# are "letters" for the digit boundary (isalpha() is true for them) but
# never part of a camelCase step (they are neither upper nor lower)
_CAMEL_RE = re.compile(
    r"(?<=[a-z])(?=[A-Z])"
    r"|(?<=[^\W\d_])(?=[0-9])"
    r"|(?<=[0-9])(?=[^\W\d_])")
_SEP_RE = re.compile(r"[\W_]+")
_MIXED_TOKEN_RE = re.compile(r"[a-z]+|[0-9]+|\S")
# span scan: hanzi runs / digit runs / alpha runs that break at a
# lower->upper step (camelCase); everything else is skipped
_SCAN_RE = re.compile(
    r"(?P<zh>[\u4e00-\u9fff]+)|(?P<num>[0-9]+)|"
    r"(?P<en>[A-Z]*[a-z]+|[A-Z]+)")


def _has_exotic_case(text: str) -> bool:
    return any(ord(c) > 127 and (c.islower() or c.isupper()) for c in text)


def normalize_text(text: str) -> str:
    """camelCase/digit-boundary splitting + separators → spaces +
    lowercase (regex formulation of the reference's char walk)."""
    if _has_exotic_case(text):
        # rare path: non-ASCII cased letters (é, Cyrillic, …) — regex
        # character classes cannot express unicode isupper()/islower(),
        # so boundary-split pairwise (separators never trigger a
        # boundary: they are neither alpha nor digit)
        out = list(text[:1])
        for a, b in zip(text, text[1:]):
            if ((b.isupper() and a.islower())
                    or (b.isdigit() and a.isalpha())
                    or (b.isalpha() and a.isdigit())):
                out.append(" ")
            out.append(b)
        text = "".join(out)
    else:
        text = _CAMEL_RE.sub(" ", text)
    return _SEP_RE.sub(" ", text).strip().lower()


def split_mixed_label(input_str: str) -> List[str]:
    """Mixed zh/en string → tokens: english words, digit runs, single
    non-space chars (hanzi included)."""
    return _MIXED_TOKEN_RE.findall(input_str.lower())


def _zh_char_phonemes(ch: str, idx: int = 0, with_span: bool = False
                      ) -> List[Phoneme]:
    """One hanzi → [initial?, final, tone] phonemes."""
    span = dict(char_start=idx, char_end=idx + 1) if with_span else {}
    py = char_pinyin(ch)
    if py is None:
        return [Phoneme(ch, "zh", is_word_start=True, is_word_end=True, **span)]
    ini, fin, tone = py
    out: List[Phoneme] = []
    if ini:
        out.append(Phoneme(ini, "zh", is_word_start=True, **span))
    if fin:
        out.append(Phoneme(fin, "zh", is_word_start=not ini, **span))
    if tone:
        out.append(Phoneme(tone, "zh", is_word_end=True, **span))
    if not out:
        out.append(Phoneme(ch, "zh", is_word_start=True, is_word_end=True,
                           **span))
    return out


def get_phoneme_seq(text: str, ascii_split_char: bool = False) -> List[Phoneme]:
    """Text → phoneme sequence (no char spans; reference ``:170-197``)."""
    normalized = normalize_text(text)
    seq: List[Phoneme] = []
    for token in split_mixed_label(normalized):
        if token.isascii() and token.isalnum():
            lang = "num" if token.isdigit() else "en"
            if ascii_split_char:
                seq.extend(Phoneme(c, lang, is_word_start=True,
                                   is_word_end=True) for c in token)
            else:
                seq.append(Phoneme(token, lang, is_word_start=True,
                                   is_word_end=True))
            continue
        if len(token) == 1:
            seq.extend(_zh_char_phonemes(token))
        else:
            seq.append(Phoneme(token, "zh", is_word_start=True,
                               is_word_end=True))
    return seq


def get_phoneme_info(text: str, ascii_split_char: bool = True) -> List[Phoneme]:
    """Text → phoneme sequence with char spans (reference ``:200-223``).

    Non-alnum/hanzi characters (spaces, punctuation) are skipped so the
    phoneme stream stays contiguous for matching.
    """
    seq: List[Phoneme] = []
    for m in _SCAN_RE.finditer(text):
        if m.lastgroup == "zh":
            for i in range(m.start(), m.end()):
                seq.extend(_zh_char_phonemes(text[i], i, with_span=True))
            continue
        token = m.group().lower()
        lang = "num" if m.lastgroup == "num" else "en"
        if ascii_split_char:
            last = len(token) - 1
            seq.extend(
                Phoneme(c, lang, is_word_start=(i == 0),
                        is_word_end=(i == last),
                        char_start=m.start() + i,
                        char_end=m.start() + i + 1)
                for i, c in enumerate(token))
        else:
            seq.append(Phoneme(token, lang, is_word_start=True,
                               is_word_end=True,
                               char_start=m.start(), char_end=m.end()))
    return seq
