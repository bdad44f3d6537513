"""Hanzi → pinyin (initial, final, tone) with no external dependencies.

The reference uses pypinyin (``hotword/algo_phoneme.py``); this module
prefers pypinyin when installed and otherwise falls back to an embedded
table of common characters (:mod:`.pinyin_data`, syllable+tone → hanzi
string, most-common reading per character).

Syllable decomposition is orthographic (pypinyin's strict=False behavior):
the initial is the longest prefix among the standard initials including
``y``/``w``; the final is the remainder spelled as written (ü written
``v``). Tones are 1–5 (5 = neutral, exposed as ``0``-suffix '0'..'4'
handling mirrors Style.TONE3 semantics where neutral tone may be absent).
"""

from functools import lru_cache
from typing import Dict, Optional, Tuple

# longest-match-first initial list (orthographic, non-strict: y/w included)
_INITIALS = ("zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l",
             "g", "k", "h", "j", "q", "x", "r", "z", "c", "s", "y", "w")


def split_syllable(syllable: str) -> Tuple[str, str]:
    """'zhang' → ('zh', 'ang'); 'an' → ('', 'an'); 'yue' → ('y', 'ue')."""
    for ini in _INITIALS:
        if syllable.startswith(ini):
            return ini, syllable[len(ini):]
    return "", syllable


_HAS_PYPINYIN: Optional[bool] = None


def _try_pypinyin():
    global _HAS_PYPINYIN
    if _HAS_PYPINYIN is None:
        try:
            import pypinyin  # noqa: F401
            _HAS_PYPINYIN = True
        except ImportError:
            _HAS_PYPINYIN = False
    return _HAS_PYPINYIN


@lru_cache(maxsize=1)
def _char_table() -> Dict[str, Tuple[str, str, str]]:
    """char → (initial, final, tone-digit) from the embedded table."""
    from .pinyin_data import PINYIN_DATA
    table: Dict[str, Tuple[str, str, str]] = {}
    for key, chars in PINYIN_DATA.items():
        syllable, tone = key[:-1], key[-1]
        ini, fin = split_syllable(syllable)
        for ch in chars:
            # first occurrence wins → list most-common readings first
            table.setdefault(ch, (ini, fin, tone))
    return table


def char_pinyin(ch: str) -> Optional[Tuple[str, str, str]]:
    """Single hanzi → (initial, final, tone '1'-'5') or None if unknown."""
    if _try_pypinyin():
        from pypinyin import Style, pinyin
        t3 = pinyin(ch, style=Style.TONE3, strict=False,
                    neutral_tone_with_five=True)
        if not t3 or not t3[0] or not t3[0][0]:
            return None
        val = t3[0][0]
        tone = val[-1] if val[-1].isdigit() else "5"
        ini = pinyin(ch, style=Style.INITIALS, strict=False)[0][0]
        fin = pinyin(ch, style=Style.FINALS, strict=False)[0][0]
        if not ini and not fin:
            return None
        return ini, fin, tone
    got = _char_table().get(ch)
    return got


def text_pinyin(text: str):
    """Per-char readings for a string (None for unknown/non-hanzi)."""
    return [char_pinyin(c) for c in text]


def known_char(ch: str) -> bool:
    return char_pinyin(ch) is not None
