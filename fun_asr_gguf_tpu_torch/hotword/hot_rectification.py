# coding: utf-8
"""Correction-history RAG ("wrong => right" retrieval for LLM context).

Behavioral equivalent of the reference RectificationRAG
(``fun_asr_gguf/hotword/hot_rectification.py``): each stored correction
pair is reduced to the spans that actually changed (token-level diff),
those spans are pre-phonemized, and incoming transcripts are fuzzy-scored
against them; matching records become a "纠错历史" prompt block for the
LLM. Opt-in via the engine's ``rectify_path`` (the reference ships the
module unwired).

Internals are organized around a token-slice representation — text is
tokenized ONCE into ``(start, end, token)`` triples and every later step
(diffing, widening, slicing) works in token indices — rather than the
reference's char-offset boundary walking.
"""

import re
import threading
import time
from difflib import SequenceMatcher
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from . import logger
from .algo_calc import fuzzy_substring_distance
from .algo_phoneme import Phoneme, get_phoneme_seq

# unicode alnum runs, underscores excluded (they separate words here)
_WORD_RUN = re.compile(r"[^\W_]+", re.UNICODE)

Token = Tuple[int, int, str]  # (start, end, text) — end exclusive


def _cjk(ch: str) -> bool:
    return "一" <= ch <= "鿿"


def tokenize_words(text: str) -> List[Token]:
    """Split into word tokens with char spans.

    CJK chars stand alone; latin/digit runs additionally split at
    camelCase steps (a lowercase→uppercase transition), so "CapsWriter"
    yields two tokens and "原句子" three.
    """
    tokens: List[Token] = []
    for run in _WORD_RUN.finditer(text):
        s, body = run.start(), run.group()
        # cut before index i when either neighbor is CJK or at aB steps
        cuts = [i for i in range(1, len(body))
                if _cjk(body[i]) or _cjk(body[i - 1])
                or (body[i].isupper() and body[i - 1].islower())]
        edges = [0, *cuts, len(body)]
        tokens.extend((s + a, s + b, body[a:b])
                      for a, b in zip(edges, edges[1:]))
    return tokens


def _slice_text(source: str, tokens: Sequence[Token],
                lo: int, hi: int) -> str:
    """Original text covered by tokens[lo:hi] (separators included)."""
    if not 0 <= lo < hi <= len(tokens):
        return ""
    return source[tokens[lo][0]:tokens[hi - 1][1]]


def extract_diff_fragments(wrong: str, right: str, zh_min_phonemes: int = 4,
                           expand_words: int = 1) -> List[str]:
    """Substrings of either sentence that differ from the other.

    Pure-Chinese spans shorter than ``zh_min_phonemes`` phonemes are too
    ambiguous to retrieve on, so they are widened by ``expand_words``
    neighboring tokens on each side. Order-preserving, deduplicated.
    """
    wrong_toks = tokenize_words(wrong)
    right_toks = tokenize_words(right)
    diff = SequenceMatcher(None, [t[2] for t in wrong_toks],
                           [t[2] for t in right_toks])

    spans: List[Tuple[str, List[Token], int, int]] = []
    for op, w_lo, w_hi, r_lo, r_hi in diff.get_opcodes():
        if op in ("replace", "delete"):
            spans.append((wrong, wrong_toks, w_lo, w_hi))
        if op in ("replace", "insert"):
            spans.append((right, right_toks, r_lo, r_hi))

    out: Dict[str, None] = {}
    for source, toks, lo, hi in spans:
        text = _slice_text(source, toks, lo, hi)
        if not text:
            continue
        phonemes = get_phoneme_seq(text)
        if not phonemes:
            continue
        if (len(phonemes) < zh_min_phonemes
                and all(p.lang == "zh" for p in phonemes)):
            widened = _slice_text(source, toks,
                                  max(lo - expand_words, 0),
                                  min(hi + expand_words, len(toks)))
            text = widened or text
        out.setdefault(text)
    return list(out)


class RectifyRecord:
    """One stored correction with its pre-phonemized diff fragments."""

    def __init__(self, wrong: str, right: str, fragments: List[str]):
        self.wrong = wrong
        self.right = right
        self.fragments = fragments
        self.fragment_phonemes: Dict[str, List[Phoneme]] = {
            f: get_phoneme_seq(f) for f in fragments}

    def __repr__(self):
        return (f"RectifyRecord('{self.wrong}' => '{self.right}', "
                f"fragments={self.fragments})")


def _parse_blocks(content: str) -> List[Tuple[str, str]]:
    """``---``-separated blocks → (wrong, right) pairs. Within a block,
    comments (#) and blank lines are skipped; the first two surviving
    lines are the pair, extras are ignored."""
    pairs = []
    for block in content.split("---"):
        lines = [ln.strip() for ln in block.splitlines()]
        kept = [ln for ln in lines if ln and not ln.startswith("#")]
        if len(kept) >= 2:
            pairs.append((kept[0], kept[1]))
    return pairs


class RectificationRAG:
    """Retrieves past corrections relevant to the current transcript.

    File format: blocks separated by ``---``; first non-comment line is
    the wrong text, second the corrected text.
    """

    _HEADER = ("# 纠错历史文件\n# 格式：用 --- 分隔的多行内容\n"
               "# 每一段第一行是原始文本，第二行是修正文本\n")

    def __init__(self, rectify_file: str = "hot-rectify.txt",
                 threshold: float = 0.5):
        self.rectify_file = Path(rectify_file)
        self.threshold = threshold
        self.records: List[RectifyRecord] = []
        self._lock = threading.Lock()
        self.load_history()

    def load_history(self):
        from .manager import read_or_create_text
        content = read_or_create_text(self.rectify_file, self._HEADER)
        if content is None:
            # transient read error (e.g. atomic-save window): retain the
            # current records; a genuinely EMPTY file falls through and
            # clears them — emptying the file is how a user disables
            # corrections
            return
        t0 = time.time()
        loaded = [
            RectifyRecord(wrong, right,
                          extract_diff_fragments(wrong, right) or [wrong])
            for wrong, right in _parse_blocks(content)]
        with self._lock:
            self.records = loaded
        if loaded:
            logger.info("loaded %d rectification records in %.3fs",
                        len(loaded), time.time() - t0)

    @staticmethod
    def _fragment_scores(record: RectifyRecord,
                         input_info: List[tuple]) -> List[dict]:
        """Per-fragment fuzzy scores vs the input, best first. Score =
        1 − normalized edit distance of the fragment's phoneme tuple
        sequence against any substring of the input's."""
        scored = []
        for fragment, phonemes in record.fragment_phonemes.items():
            if not phonemes:
                continue
            frag_info = [p.info for p in phonemes]
            dist = fuzzy_substring_distance(frag_info, input_info)
            scored.append({"fragment": fragment,
                           "score": round(1.0 - dist / len(frag_info), 3),
                           "phonemes": len(frag_info)})
        return sorted(scored, key=lambda d: d["score"], reverse=True)

    def _matches(self, text: str) -> List[Tuple[RectifyRecord, List[dict]]]:
        """All records whose best fragment clears the threshold, sorted
        by that score descending."""
        phonemes = get_phoneme_seq(text) if text else []
        if not phonemes:
            return []
        input_info = [p.info for p in phonemes]
        with self._lock:
            records = list(self.records)
        hits = []
        for record in records:
            scored = self._fragment_scores(record, input_info)
            if scored and scored[0]["score"] >= self.threshold:
                hits.append((record, scored))
        hits.sort(key=lambda h: h[1][0]["score"], reverse=True)
        return hits

    def search(self, text: str, top_k: int = 5
               ) -> List[Tuple[str, str, float]]:
        return [(rec.wrong, rec.right, round(scored[0]["score"], 3))
                for rec, scored in self._matches(text)[:top_k]]

    def search_detailed(self, text: str, top_k: int = 5) -> List[dict]:
        return [{"wrong": rec.wrong, "right": rec.right,
                 "score": scored[0]["score"], "fragments": scored}
                for rec, scored in self._matches(text)[:top_k]]

    def format_prompt(self, text: str, top_k: int = 5,
                      prefix: str = "纠错历史：") -> str:
        entries = self.search(text, top_k=top_k)
        if not entries:
            return ""
        return "\n".join(
            [prefix] + [f"- {wrong} => {right}" for wrong, right, _ in
                        entries])
