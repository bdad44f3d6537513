"""CTC greedy decoding and character-level timestamp alignment.

Behavioral port of the reference's host-side CTC layer
(``fun_asr_gguf/nano_ctc.py``) with the DP vectorized:

* greedy decode collapses repeats and drops the blank (= max vocab id,
  since ``<blk>`` is the last token); frame time is
  ``max((idx·60ms − 240ms)/1000, 0)`` (``nano_ctc.py:67-69,99``);
* Needleman–Wunsch alignment of CTC chars to LLM text (match +1 /
  mismatch −1 / gap −1, ``nano_ctc.py:149-172``) is computed row-wise in
  numpy using a max-accumulate scan for the in-row "left" dependency —
  O(n·m) cells but vectorized inner loop (the reference's pure-python DP is
  the 118 ms line item in BASELINE.md);
* unanchored characters get linearly interpolated start times
  (``nano_ctc.py:189-230``), multi-char CTC tokens assume 80 ms per char.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .profiling import span


@dataclass
class Token:
    text: str
    start: float


FRAME_SHIFT_MS = 60
OFFSET_MS = -240
CHAR_DURATION = 0.08


def decode_ctc(indices_or_logits: np.ndarray, id2token: Dict[int, str]
               ) -> Tuple[str, List[Token], Dict[str, float]]:
    """Greedy CTC decode.

    Accepts either pre-argmaxed indices (1-D or [1, T], the fused-argmax
    fast path) or raw logits [T, V] (legacy path: cast to f32, argmax).
    Returns (text, tokens-with-start-times, micro-timings).
    """
    arr = np.asarray(indices_or_logits)
    t_cast = t_argmax = 0.0
    if arr.ndim == 1 or (arr.ndim == 2 and arr.shape[0] == 1):
        indices = arr.reshape(-1)
    else:
        with span("ctc.cast", timed=True) as s:
            logits_f32 = arr.astype(np.float32)
        t_cast = s.seconds
        with span("ctc.argmax", timed=True) as s:
            indices = np.argmax(logits_f32, axis=-1).reshape(-1)
        t_argmax = s.seconds

    with span("ctc.loop", timed=True) as s:
        blank_id = max(id2token.keys()) if id2token else 0

        results: List[Token] = []
        if indices.size:
            # vectorized collapse: segment starts where the id changes
            change = np.empty(indices.shape, dtype=bool)
            change[0] = True
            np.not_equal(indices[1:], indices[:-1], out=change[1:])
            starts = np.flatnonzero(change)
            ids = indices[starts]
            keep = ids != blank_id
            for token_id, start in zip(ids[keep].tolist(),
                                       starts[keep].tolist()):
                text = id2token.get(int(token_id), "")
                if not text:
                    continue
                t_start = max((start * FRAME_SHIFT_MS + OFFSET_MS) / 1000.0,
                              0.0)
                results.append(Token(text=text, start=t_start))

        full_text = "".join(r.text for r in results)
    return full_text, results, {"cast": t_cast, "argmax": t_argmax,
                                "loop": s.seconds}


def _nw_align(ctc_chars: List[str], llm_chars: List[str]
              ) -> List[Optional[int]]:
    """Needleman–Wunsch global alignment.

    Returns, for each llm char index, the aligned ctc char index or None.
    Scores: match +1, mismatch −1, gap −1; traceback prefers diag, then up
    (delete ctc), then left (gap in ctc) — the reference's tie-break order.
    """
    from .native import nw_align_native
    native = nw_align_native(ctc_chars, llm_chars)
    if native is not None:
        return native

    n, m = len(ctc_chars) + 1, len(llm_chars) + 1
    ctc_l = np.array([c.lower() for c in ctc_chars])
    llm_l = np.array([c.lower() for c in llm_chars])
    sub = np.where(ctc_l[:, None] == llm_l[None, :], 1.0, -1.0).astype(
        np.float32)                                   # [n-1, m-1]

    gap = -1.0
    score = np.empty((n, m), dtype=np.float32)
    trace = np.empty((n, m), dtype=np.int8)
    score[0, :] = np.arange(m, dtype=np.float32) * gap
    score[:, 0] = np.arange(n, dtype=np.float32) * gap
    trace[0, :] = 3
    trace[:, 0] = 2

    j_idx = np.arange(1, m, dtype=np.float32)
    for i in range(1, n):
        prev = score[i - 1]
        s_diag = prev[:-1] + sub[i - 1]               # [m-1]
        s_up = prev[1:] + gap
        cand = np.maximum(s_diag, s_up)
        # row[j] = max(cand[j], row[j-1] + gap): prefix-max scan
        aug = np.empty(m, dtype=np.float32)
        aug[0] = score[i, 0]                           # = i * gap
        aug[1:] = cand + j_idx
        acc = np.maximum.accumulate(aug)
        row = acc[1:] - j_idx
        score[i, 1:] = row
        tr = np.where(row == s_diag, 1,
                      np.where(row == s_up, 2, 3)).astype(np.int8)
        trace[i, 1:] = tr

    # traceback
    alignment: List[Optional[int]] = [None] * len(llm_chars)
    i, j = n - 1, m - 1
    while i > 0 or j > 0:
        if i > 0 and j > 0 and trace[i, j] == 1:
            alignment[j - 1] = i - 1
            i -= 1
            j -= 1
        elif i > 0 and (j == 0 or trace[i, j] == 2):
            i -= 1
        else:
            alignment[j - 1] = None
            j -= 1
    return alignment


def align_timestamps(ctc_results: List[Token], llm_text: str
                     ) -> List[Dict[str, float]]:
    """Char-level timestamps for the LLM text via NW alignment to CTC chars."""
    if not ctc_results or not llm_text:
        return []

    ctc_chars: List[Dict] = []
    for item in ctc_results:
        for i, char in enumerate(item.text):
            ctc_chars.append({"char": char,
                              "start": item.start + i * CHAR_DURATION})
    llm_chars = list(llm_text)

    alignment = _nw_align([c["char"] for c in ctc_chars], llm_chars)

    anchors = [(idx, ctc_chars[a]["start"])
               for idx, a in enumerate(alignment) if a is not None]

    def interpolated_start(target_idx: int) -> float:
        prev_a = next_a = None
        for a in anchors:
            if a[0] < target_idx:
                prev_a = a
            elif a[0] > target_idx:
                next_a = a
                break
        if prev_a and next_a:
            step = (next_a[1] - prev_a[1]) / (next_a[0] - prev_a[0])
            return prev_a[1] + (target_idx - prev_a[0]) * step
        if prev_a:
            return prev_a[1] + 0.05
        if next_a:
            return max(0.0, next_a[1] - 0.05)
        return 0.0

    final_chars = []
    for idx, char in enumerate(llm_chars):
        a = alignment[idx]
        start = ctc_chars[a]["start"] if a is not None \
            else interpolated_start(idx)
        final_chars.append({"char": char, "start": start})
    return final_chars
