# coding: utf-8
"""Phoneme-based hotword correction (the production corrector).

Behavioral equivalent of the reference PhonemeCorrector
(``fun_asr_gguf/hotword/hot_phoneme.py``): two-stage retrieval — FastRAG
coarse filter then boundary-constrained fuzzy search — classifying windows
into ``matchs`` (score ≥ threshold, replaced in place) and ``similars``
(score ≥ similar_threshold, deduped/sorted, top-k — these feed the LLM
prompt as hotword hints). Hotword swaps are thread-safe.
"""

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from . import logger
from .algo_calc import fuzzy_substring_search_constrained
from .algo_phoneme import Phoneme, get_phoneme_info
from .rag_fast import FastRAG

FAST_TOP_K = 100          # stage-1 candidate budget


class MatchResult(NamedTuple):
    start: int
    end: int
    score: float
    hotword: str


class CorrectionResult(NamedTuple):
    text: str
    matchs: List[Tuple[str, str, float]]    # (original, hotword, score)
    similars: List[Tuple[str, str, float]]


def _spans_clash(a: Tuple[int, int], b: Tuple[int, int]) -> bool:
    return a[0] < b[1] and b[0] < a[1]


class PhonemeCorrector:
    """Two-stage fuzzy hotword corrector."""

    def __init__(self, threshold: float = 0.7,
                 similar_threshold: Optional[float] = None):
        self.threshold = threshold
        self.similar_threshold = (threshold - 0.2 if similar_threshold
                                  is None else similar_threshold)
        self.max_diff = 2
        self.top_k_candidates = FAST_TOP_K
        self.hotwords: Dict[str, List[Phoneme]] = {}
        self.fast_rag = FastRAG(threshold=self._recall_floor)
        self._lock = threading.Lock()

    @property
    def _recall_floor(self) -> float:
        """Stage-1/DP search floor: a notch under the laxer of the two
        acceptance thresholds, so borderline windows survive to stage 2."""
        return min(self.threshold, self.similar_threshold) - 0.1

    def update_hotwords(self, hotword_text: str) -> int:
        """Replace the hotword set (thread-safe). Lines starting with '#'
        and blanks are ignored."""
        t0 = time.time()
        entries = (ln.strip() for ln in hotword_text.splitlines())
        fresh = {hw: ph for hw in entries
                 if hw and not hw.startswith("#")
                 and (ph := get_phoneme_info(hw))}
        rag = FastRAG(threshold=self._recall_floor)
        rag.add_hotwords(fresh)
        with self._lock:
            self.hotwords, self.fast_rag = fresh, rag
        logger.debug("PhonemeCorrector updated %d hotwords in %.3fs",
                     len(fresh), time.time() - t0)
        return len(fresh)

    def _windows(self, candidates, info):
        """Stage 2: boundary-constrained DP per stage-1 candidate,
        yielding (hotword, score, char_start, char_end)."""
        floor = self._recall_floor
        for hw, _coarse in candidates:
            hw_info = [p.info[:5] for p in self.hotwords[hw]]
            for score, lo, hi in fuzzy_substring_search_constrained(
                    hw_info, info, threshold=floor):
                yield hw, score, info[lo][5], info[hi - 1][6]

    def _classify(self, text, candidates, info):
        """Split DP windows into replacement matches and hint similars
        (best window per hotword, ordered by score then hotword length)."""
        matches: List[MatchResult] = []
        best_hint: Dict[str, Tuple[str, float]] = {}
        for hw, score, lo, hi in self._windows(candidates, info):
            if score >= self.threshold:
                matches.append(MatchResult(lo, hi, score, hw))
            if score >= self.similar_threshold:
                prev = best_hint.get(hw)
                if prev is None or score > prev[1]:
                    best_hint[hw] = (text[lo:hi], score)
        hints = sorted(
            ((origin, hw, score)
             for hw, (origin, score) in best_hint.items()),
            key=lambda h: (h[2], len(h[1])), reverse=True)
        return matches, hints

    def _apply(self, text: str, matches: List[MatchResult]):
        """Greedy overlap resolution (score, then span length) followed by
        right-to-left in-place edits."""
        taken: List[Tuple[int, int]] = []
        edits: List[MatchResult] = []
        for m in sorted(matches, reverse=True,
                        key=lambda m: (m.score, m.end - m.start)):
            span = (m.start, m.end)
            if any(_spans_clash(span, t) for t in taken):
                continue
            taken.append(span)
            if text[m.start:m.end] != m.hotword:
                edits.append(m)

        out = list(text)
        for m in sorted(edits, key=lambda m: m.start, reverse=True):
            out[m.start:m.end] = m.hotword
        return "".join(out), [(text[m.start:m.end], m.hotword, m.score)
                              for m in sorted(edits, key=lambda m: m.start,
                                              reverse=True)]

    def correct(self, text: str, k: int = 10) -> CorrectionResult:
        """Correct ``text`` in place and return top-k similar hotwords."""
        empty = CorrectionResult(text=text, matchs=[], similars=[])
        if not text or not self.hotwords:
            return empty
        phonemes = get_phoneme_info(text)
        if not phonemes:
            return empty
        info = [p.info for p in phonemes]
        with self._lock:
            candidates = self.fast_rag.search(phonemes,
                                              top_k=self.top_k_candidates)
            matches, hints = self._classify(text, candidates, info)
        new_text, replaced = self._apply(text, matches)
        return CorrectionResult(text=new_text, matchs=replaced,
                                similars=hints[:k])
