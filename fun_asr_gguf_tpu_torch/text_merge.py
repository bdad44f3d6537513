"""Overlap merging for long-audio segment results.

Behavioral port of the reference merge algorithm
(``fun_asr_gguf/text_merge.py:14-114``): segment char/timestamp lists get
global offsets; the overlap window of the running buffer (global start ≥
offset − 1 s) is matched against the head of the new segment (start ≤
overlap + 1 s) with ``SequenceMatcher.find_longest_match``; a ≥ 2-char
anchor splices the two (truncate buffer at the anchor, append the new
segment from its anchor); otherwise a timestamp-based hard concat is used.
Consecutive duplicate punctuation is dropped at the end.
"""

import difflib
from typing import Any, Dict, List, Tuple

PUNCS = set("，。！？；,.!?; ")


def merge_step(full_segments: List[Dict[str, Any]],
               res: Dict[str, Any], offset: float, overlap_s: float,
               first: bool = False) -> List[Dict[str, Any]]:
    """Merge ONE segment result into the accumulated char/timestamp list.

    The incremental unit of :func:`merge_transcription_results` (same
    anchor-splice/hard-concat rules); callers that accumulate segments
    one at a time (streaming rollover) fold with this instead of
    re-merging the whole history each tick, keeping per-commit cost
    O(overlap window) rather than O(total segments). Finish with
    :func:`finalize_merge`."""
    curr_segments = res.get("segments") or []
    for seg in curr_segments:
        seg["_global_start"] = seg["start"] + offset

    if first:
        full_segments.extend({"char": s["char"],
                              "start": s["_global_start"]}
                             for s in curr_segments)
        return full_segments
    if not curr_segments:
        return full_segments

    buffer_overlap_segs = [s for s in full_segments
                           if s["start"] >= offset - 1.0]
    buffer_overlap_text = "".join(s["char"] for s in buffer_overlap_segs)
    curr_overlap_segs = [s for s in curr_segments
                         if s["start"] <= overlap_s + 1.0]
    curr_overlap_text = "".join(s["char"] for s in curr_overlap_segs)

    sm = difflib.SequenceMatcher(None, buffer_overlap_text,
                                 curr_overlap_text)
    match = sm.find_longest_match(0, len(buffer_overlap_text),
                                  0, len(curr_overlap_text))

    if match.size >= 2:
        # truncate the buffer at the anchor (search from the back for
        # the matching element)
        target_seg = buffer_overlap_segs[match.a]
        global_idx = -1
        for idx in range(len(full_segments) - 1, -1, -1):
            if (full_segments[idx]["start"] == target_seg["start"]
                    and full_segments[idx]["char"] == target_seg["char"]):
                global_idx = idx
                break
        if global_idx != -1:
            full_segments = full_segments[:global_idx]

        # append the new segment from its anchor char onward
        match_seg = curr_overlap_segs[match.b]
        match_idx_in_curr = -1
        for idx, s in enumerate(curr_segments):
            if s is match_seg:
                match_idx_in_curr = idx
                break
        to_add = (curr_segments[match_idx_in_curr:]
                  if match_idx_in_curr != -1 else curr_segments)
        full_segments.extend({"char": s["char"], "start": s["_global_start"]}
                             for s in to_add)
    else:
        # fallback: timestamp-based hard concat
        last_time = full_segments[-1]["start"] if full_segments else offset
        to_add = [s for s in curr_segments
                  if s["_global_start"] > last_time + 0.1]
        full_segments.extend({"char": s["char"], "start": s["_global_start"]}
                             for s in to_add)
    return full_segments


def finalize_merge(full_segments: List[Dict[str, Any]],
                   prev_char: str = ""
                   ) -> Tuple[str, List[Dict[str, Any]]]:
    """Punctuation dedup + text join over an accumulated segment list.

    ``prev_char`` carries the dedup state across a split fold (streaming
    keeps an already-finalized frozen head; passing its last emitted
    char makes finalize(head) ++ finalize(tail, head[-1]) equal
    finalize(head ++ tail))."""
    clean_segments: List[Dict[str, Any]] = []
    last = prev_char
    for s in full_segments:
        if last and s["char"] in PUNCS and last == s["char"]:
            continue
        clean_segments.append(s)
        last = s["char"]

    full_text = "".join(s["char"] for s in clean_segments)
    return full_text, clean_segments


def merge_transcription_results(
        results: List[Dict[str, Any]],
        segment_offsets: List[float],
        overlap_s: float) -> Tuple[str, List[Dict[str, Any]]]:
    if not results:
        return "", []

    if len(results) == 1:
        offset = segment_offsets[0]
        full_segments = [{"char": s["char"], "start": s["start"] + offset}
                         for s in (results[0].get("segments") or [])]
        return results[0]["text"], full_segments

    full_segments: List[Dict[str, Any]] = []
    for i, res in enumerate(results):
        full_segments = merge_step(full_segments, res, segment_offsets[i],
                                   overlap_s, first=(i == 0))
    return finalize_merge(full_segments)
