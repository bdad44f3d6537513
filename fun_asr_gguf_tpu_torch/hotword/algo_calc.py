# coding: utf-8
"""Phoneme fuzzy-distance scoring.

Behavioral port of the reference DP layer
(``fun_asr_gguf/hotword/algo_calc.py``): confusable-phoneme cost sets
(front/back nasals, flat/retroflex sibilants, l/n, f/h, ... at cost 0.5),
LCS-based English-token similarity, unconstrained fuzzy substring distance
(numpy-vectorized rows replacing the pure-python rolling arrays), and the
boundary-constrained search that returns every window scoring above
threshold — the production matcher (reference ``:401-498``).
"""

from typing import List, Tuple

import numpy as np

from .algo_phoneme import Phoneme

# confusable phoneme sets, fuzzy cost 0.5 (reference ``algo_calc.py:11-35``)
SIMILAR_PHONEMES = [
    {"an", "ang"}, {"en", "eng"}, {"in", "ing"},
    {"ian", "iang"}, {"uan", "uang"},
    {"z", "zh"}, {"c", "ch"}, {"s", "sh"},
    {"l", "n"},
    {"f", "h"},
    {"ai", "ei"}, {"o", "uo"}, {"e", "ie"},
    {"p", "t"}, {"p", "b"}, {"t", "d"}, {"k", "g"},
]

_SIMILAR_LOOKUP = {}
for _s in SIMILAR_PHONEMES:
    for _a in _s:
        _SIMILAR_LOOKUP.setdefault(_a, set()).update(_s - {_a})


def lcs_length(s1: str, s2: str) -> int:
    """Longest common subsequence length (rolling-row numpy-free)."""
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    n = len(s2)
    if n == 0:
        return 0
    prev = [0] * (n + 1)
    for c1 in s1:
        curr = [0] * (n + 1)
        for j, c2 in enumerate(s2, start=1):
            curr[j] = prev[j - 1] + 1 if c1 == c2 \
                else max(prev[j], curr[j - 1])
        prev = curr
    return prev[n]


def char_level_substring_score(main_text: str, pattern: str) -> float:
    """Best sliding-window LCS score of pattern inside main_text."""
    if not pattern or not main_text:
        return 0.0
    if pattern in main_text:
        return 1.0
    plen = len(pattern)
    best = 0.0
    for window in range(plen, min(len(main_text) + 1, int(plen * 1.5) + 1)):
        for start in range(len(main_text) - window + 1):
            score = lcs_length(main_text[start:start + window], pattern) / plen
            if score > best:
                best = score
    return best


def get_phoneme_cost(p1: Phoneme, p2: Phoneme) -> float:
    """0.0 exact / 0.5 confusable-zh / LCS-graded en / 1.0 mismatch."""
    if p1.lang != p2.lang:
        return 1.0
    if p1.value == p2.value:
        return 0.0
    if p1.lang == "zh":
        if p2.value in _SIMILAR_LOOKUP.get(p1.value, ()):
            return 0.5
    if p1.lang == "en":
        max_len = max(len(p1.value), len(p2.value))
        if max_len:
            return 1.0 - lcs_length(p1.value, p2.value) / max_len
    return 1.0


def _get_tuple_cost(t1: Tuple, t2: Tuple) -> float:
    """Cost on info tuples (value, lang, ws, we, is_tone, ...).

    Reference quirk preserved (``algo_calc.py:382-384``): any two distinct
    *tones* cost 0.5.
    """
    if t1[1] != t2[1]:
        return 1.0
    if t1[0] == t2[0]:
        return 0.0
    if t1[1] == "zh":
        if t1[4]:  # is_tone: differing tones are half-cost
            return 0.5
        if t2[0] in _SIMILAR_LOOKUP.get(t1[0], ()):
            return 0.5
    if t1[1] == "en":
        max_len = max(len(t1[0]), len(t2[0]))
        if max_len:
            return 1.0 - lcs_length(t1[0], t2[0]) / max_len
    return 1.0


def _cost_matrix(hw_info: List[Tuple], input_info: List[Tuple]) -> np.ndarray:
    """[n, m] pairwise tuple costs."""
    n, m = len(hw_info), len(input_info)
    cost = np.empty((n, m), dtype=np.float32)
    for i, h in enumerate(hw_info):
        row = cost[i]
        for j, t in enumerate(input_info):
            row[j] = _get_tuple_cost(h, t)
    return cost


def fuzzy_substring_distance(hw_info: List[Tuple],
                             input_info: List[Tuple]) -> float:
    """Min edit distance of hw as a substring of input (free start/end).

    Vectorized rows: the in-row "insertion" dependency is resolved with a
    min-accumulate prefix scan (curr[j] = min_k≤j cand[k] + (j−k)).
    """
    n, m = len(hw_info), len(input_info)
    if n == 0:
        return 0.0
    if m == 0:
        return float(n)
    cost = _cost_matrix(hw_info, input_info)
    j_idx = np.arange(1, m + 1, dtype=np.float32)
    prev = np.zeros(m + 1, dtype=np.float32)
    shifted = np.empty(m + 1, dtype=np.float32)
    for i in range(1, n + 1):
        # cand[j] = min(del, match); the left-insertion chain is
        # curr[j] = min_{k<=j}(cand_or_col0[k] + (j-k)) — a prefix min-scan
        # of cand[k]-k shifted back by +j.
        cand = np.minimum(prev[1:] + 1.0, prev[:-1] + cost[i - 1])
        shifted[0] = float(i)                   # dp[i][0]
        shifted[1:] = cand - j_idx
        scan = np.minimum.accumulate(shifted)
        prev = np.concatenate(([np.float32(i)], scan[1:] + j_idx))
    return float(prev.min())


def fuzzy_substring_score(hw_info: List[Tuple],
                          input_info: List[Tuple]) -> float:
    """Distance → similarity in [0, 1]."""
    n = len(hw_info)
    if n == 0:
        return 0.0
    score = 1.0 - fuzzy_substring_distance(hw_info, input_info) / n
    return max(0.0, min(1.0, score))


def fast_substring_score(hw_info: List[Tuple],
                         input_info: List[Tuple]) -> float:
    """Aligned position-wise similarity (no DP; reference ``:257-296``)."""
    n = len(hw_info)
    if n == 0:
        return 0.0
    diff = 0.0
    for h, t in zip(hw_info, input_info):
        if h[1] != t[1]:
            diff += 1.0
        elif h[0] != t[0]:
            if h[1] == "zh" and t[0] in _SIMILAR_LOOKUP.get(h[0], ()):
                diff += 0.5
            else:
                diff += 1.0
    return 1.0 - diff / n


def find_best_match(main_seq: List[Phoneme], sub_seq: List[Phoneme]
                    ) -> Tuple[float, int, int]:
    """Best fuzzy match constrained to start at a word boundary.

    Reference ``algo_calc.py:146-254``. Returns (score, start, end-exclusive)
    over ``main_seq`` indices.
    """
    n, m = len(sub_seq), len(main_seq)
    if n == 0 or m == 0:
        return 0.0, 0, 0

    valid_starts = {j for j in range(m) if main_seq[j].is_word_start}

    INF = float("inf")
    dp = [[0.0] * (m + 1) for _ in range(n + 1)]
    for j in range(m + 1):
        dp[0][j] = 0.0 if j in valid_starts else INF
    for i in range(1, n + 1):
        dp[i][0] = dp[i - 1][0] + 1.0

    costs = [[get_phoneme_cost(sub_seq[i], main_seq[j]) for j in range(m)]
             for i in range(n)]
    for i in range(1, n + 1):
        row, prev = dp[i], dp[i - 1]
        ci = costs[i - 1]
        for j in range(1, m + 1):
            row[j] = min(prev[j] + 1.0, row[j - 1] + 1.0,
                         prev[j - 1] + ci[j - 1])

    min_dist, end_pos, best_start = INF, 0, 0
    for j in range(1, m + 1):
        if dp[n][j] < min_dist:
            # trace back to find the start column
            ci_, cj = n, j
            while ci_ > 0:
                cost = costs[ci_ - 1][cj - 1] if cj > 0 else INF
                if cj > 0 and abs(dp[ci_][cj] - (dp[ci_ - 1][cj - 1] + cost)) < 1e-9:
                    ci_ -= 1
                    cj -= 1
                elif abs(dp[ci_][cj] - (dp[ci_ - 1][cj] + 1.0)) < 1e-9:
                    ci_ -= 1
                elif cj > 0 and abs(dp[ci_][cj] - (dp[ci_][cj - 1] + 1.0)) < 1e-9:
                    cj -= 1
                else:
                    ci_ -= 1
            if cj in valid_starts:
                min_dist, end_pos, best_start = dp[n][j], j, cj

    if min_dist == INF:
        return 0.0, 0, 0
    return 1.0 - min_dist / n, best_start, end_pos


def fuzzy_substring_search_constrained(
        hw_info: List[Tuple], input_info: List[Tuple],
        threshold: float = 0.6) -> List[Tuple[float, int, int]]:
    """All boundary-constrained fuzzy matches of hw inside input.

    Starts must fall on ``is_word_start``, ends on ``is_word_end``
    (reference ``algo_calc.py:401-498``). Returns [(score, start, end)]
    sorted by score descending, deduped per end position.
    """
    n, m = len(hw_info), len(input_info)
    if n == 0 or m == 0:
        return []

    INF = float("inf")
    cost = _cost_matrix(hw_info, input_info)

    dp = np.full((n + 1, m + 1), INF, dtype=np.float32)
    start_col = np.zeros((n + 1, m + 1), dtype=np.int32)
    dp[0][0] = 0.0
    for j in range(m):
        if j < m and input_info[j][2]:      # is_word_start
            dp[0][j] = 0.0
            start_col[0][j] = j

    for i in range(1, n + 1):
        prev_dp, prev_sc = dp[i - 1], start_col[i - 1]
        row_dp, row_sc = dp[i], start_col[i]
        ci = cost[i - 1]
        for j in range(1, m + 1):
            d_match = prev_dp[j - 1] + ci[j - 1]
            d_del = prev_dp[j] + 1.0
            d_ins = row_dp[j - 1] + 1.0
            if d_match <= d_del and d_match <= d_ins:
                row_dp[j] = d_match
                row_sc[j] = prev_sc[j - 1]
            elif d_del <= d_ins:
                row_dp[j] = d_del
                row_sc[j] = prev_sc[j]
            else:
                row_dp[j] = d_ins
                row_sc[j] = row_sc[j - 1]

    used_ends = {}
    for j in range(1, m + 1):
        if not input_info[j - 1][3]:        # must end on is_word_end
            continue
        dist = float(dp[n][j])
        if dist >= n * 0.8:
            continue
        score = 1.0 - dist / n
        if score >= threshold:
            entry = (score, int(start_col[n][j]), j)
            if j not in used_ends or score > used_ends[j][0]:
                used_ends[j] = entry
    return sorted(used_ends.values(), key=lambda x: x[0], reverse=True)
