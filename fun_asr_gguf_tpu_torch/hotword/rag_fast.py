# coding: utf-8
"""Fast coarse hotword retrieval.

Behavioral port of the reference FastRAG (``fun_asr_gguf/hotword/
rag_fast.py``): phoneme strings are int-coded, hotwords are bucketed in an
inverted index on their first two phonemes (with similar-phoneme expansion
of the query), and candidates are scored by a unit-cost fuzzy substring
distance. The reference's numba @njit DP hot loop (``:36-77``) is replaced
by a **batched numpy DP**: all candidates are padded into one [C, L] code
matrix and every DP row is computed for all candidates at once, with the
in-row dependency resolved by a prefix min-scan — no JIT warm-up, same
results.
"""

from typing import Dict, List, Tuple

import numpy as np

from .algo_calc import SIMILAR_PHONEMES
from .algo_phoneme import Phoneme

# phoneme value → the union of its confusion sets (precomputed once from
# the SIMILAR_PHONEMES table; query-side expansion looks up here instead
# of walking every set per phoneme)
_SIMILAR_UNION: Dict[str, frozenset] = {}
for _s in SIMILAR_PHONEMES:
    for _v in _s:
        _SIMILAR_UNION[_v] = frozenset(
            _SIMILAR_UNION.get(_v, frozenset()) | set(_s))


class PhonemeEncoder:
    """str phoneme → dense int code (0 reserved for padding)."""

    def __init__(self):
        self._codes: Dict[str, int] = {}

    def encode(self, phoneme: str) -> int:
        # auto-assign codes in first-seen order, starting at 1
        return self._codes.setdefault(phoneme, len(self._codes) + 1)

    def code_of(self, phoneme: str):
        """Code for an already-seen phoneme, else None (query side must
        not grow the vocabulary)."""
        return self._codes.get(phoneme)

    def encode_sequence(self, phonemes: List[str]) -> np.ndarray:
        return np.fromiter((self.encode(p) for p in phonemes),
                           dtype=np.int32, count=len(phonemes))


class PhonemeIndex:
    """Inverted index on the first two phonemes of each hotword."""

    N_INDEX = 2                     # leading phonemes that key a hotword

    def __init__(self):
        self.encoder = PhonemeEncoder()
        self._buckets: Dict[int, List[Tuple[str, np.ndarray]]] = {}
        self.n_entries = 0

    def add(self, hotword: str, phonemes: List[Phoneme]):
        if not phonemes:
            return
        codes = self.encoder.encode_sequence([p.value for p in phonemes])
        entry = (hotword, codes)
        for code in set(codes[:self.N_INDEX].tolist()):
            self._buckets.setdefault(code, []).append(entry)
        self.n_entries += 1

    def _query_codes(self, input_phonemes: List[Phoneme]) -> set:
        """Index codes reachable from the input, zh phonemes expanded
        through their confusion sets (so 'zang' also pulls the 'zhang'
        bucket — the recall-side half of the fuzzy cost model)."""
        values = set()
        for p in input_phonemes:
            values.add(p.value)
            if p.lang == "zh":
                values |= _SIMILAR_UNION.get(p.value, frozenset())
        codes = (self.encoder.code_of(v) for v in values)
        return {c for c in codes if c is not None}

    def get_candidates(self, input_phonemes: List[Phoneme]
                       ) -> List[Tuple[str, np.ndarray]]:
        seen: Dict[str, np.ndarray] = {}
        for code in self._query_codes(input_phonemes):
            seen.update(self._buckets.get(code, ()))
        return list(seen.items())

    def encode_input(self, phonemes: List[Phoneme]) -> np.ndarray:
        return self.encoder.encode_sequence([p.value for p in phonemes])


def batched_fuzzy_distance(main_codes: np.ndarray,
                           subs: List[np.ndarray]) -> np.ndarray:
    """Unit-cost fuzzy substring distance of each sub inside main.

    dp[i][j] = min(dp[i-1][j]+1, dp[i][j-1]+1, dp[i-1][j-1]+(sub_i!=main_j));
    dp[0][j] = 0 (free start), answer = min_j dp[n][j].
    Prefers the native C++ kernel (native/dp_kernels.cc) when built;
    otherwise a candidate-batched numpy DP with a prefix min-scan for the
    in-row dependency. Returns [C] float32 distances.
    """
    from ..native import fuzzy_substring_distance_batch_native
    native = fuzzy_substring_distance_batch_native(main_codes, subs)
    if native is not None:
        return native
    c = len(subs)
    if c == 0:
        return np.zeros(0, np.float32)
    m = len(main_codes)
    lens = np.array([len(s) for s in subs], dtype=np.int32)
    if m == 0:
        return lens.astype(np.float32)
    n_max = int(lens.max())
    sub_mat = np.zeros((c, n_max), dtype=np.int32)
    for i, s in enumerate(subs):
        sub_mat[i, :len(s)] = s

    neq = (sub_mat[:, :, None] != main_codes[None, None, :]).astype(np.float32)

    j_idx = np.arange(1, m + 1, dtype=np.float32)
    prev = np.zeros((c, m + 1), dtype=np.float32)
    best = np.full(c, np.inf, dtype=np.float32)
    shifted = np.empty((c, m + 1), dtype=np.float32)
    for i in range(1, n_max + 1):
        cand = np.minimum(prev[:, 1:] + 1.0, prev[:, :-1] + neq[:, i - 1])
        shifted[:, 0] = float(i)
        shifted[:, 1:] = cand - j_idx
        scan = np.minimum.accumulate(shifted, axis=1)
        curr = np.empty_like(prev)
        curr[:, 0] = float(i)
        curr[:, 1:] = scan[:, 1:] + j_idx
        prev = curr
        finished = lens == i
        if finished.any():
            best[finished] = prev[finished].min(axis=1)
    return best


class FastRAG:
    """High-throughput coarse retriever (index + batched DP scoring)."""

    def __init__(self, threshold: float = 0.6):
        self.threshold = threshold
        self.index = PhonemeIndex()
        self.hotword_count = 0

    def add_hotwords(self, hotwords: Dict[str, List[Phoneme]]):
        for hw, phonemes in hotwords.items():
            if phonemes:
                self.index.add(hw, phonemes)
                self.hotword_count += 1

    def search(self, input_phonemes: List[Phoneme], top_k: int = 10
               ) -> List[Tuple[str, float]]:
        if not input_phonemes:
            return []
        input_codes = self.index.encode_input(input_phonemes)
        candidates = self.index.get_candidates(input_phonemes)
        results = self._score_candidates(input_codes, candidates)
        results.sort(key=lambda x: x[1], reverse=True)
        return results[:top_k]

    def _score_candidates(self, input_codes: np.ndarray,
                          candidates: List[Tuple[str, np.ndarray]]
                          ) -> List[Tuple[str, float]]:
        input_len = len(input_codes)
        kept = [(hw, codes) for hw, codes in candidates
                if len(codes) <= input_len + 3]        # length pre-filter
        if not kept:
            return []
        dists = batched_fuzzy_distance(input_codes,
                                       [codes for _, codes in kept])
        results = []
        for (hw, codes), dist in zip(kept, dists.tolist()):
            score = 1.0 - dist / len(codes)
            if score >= self.threshold:
                results.append((hw, round(score, 3)))
        return results

    def compute_score(self, input_phonemes, hotword_phonemes) -> float:
        """Exact score for one pair (re-ranking helper)."""
        input_codes = self.index.encode_input(input_phonemes)
        hw_codes = self.index.encode_input(hotword_phonemes)
        if len(hw_codes) == 0:
            return 0.0
        dist = float(batched_fuzzy_distance(input_codes, [hw_codes])[0])
        return max(0.0, 1.0 - dist / len(hw_codes))
