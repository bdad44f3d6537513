"""SRT subtitle export from char-level timestamps.

Behavioral port of the reference exporter (``fun_asr_gguf/srt_utils.py``):
sentences split on punctuation, end time = next char start (or +0.1 s),
trailing punctuation stripped. The SRT text itself is composed here rather
than via the ``srt`` pip package (not available in this environment).
"""

from typing import Any, Dict, List

SPLIT_PUNCS = set("，。！？；,.!?;")
STRIP_PUNCS = "，。！？；, .!?;"


def _fmt_time(seconds: float) -> str:
    if seconds < 0:
        seconds = 0.0
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"


def compose_srt(subtitles: List[Dict[str, Any]]) -> str:
    """subtitles: [{'start': s, 'end': s, 'content': str}] → SRT text."""
    blocks = []
    for i, sub in enumerate(subtitles, start=1):
        blocks.append(f"{i}\n{_fmt_time(sub['start'])} --> "
                      f"{_fmt_time(sub['end'])}\n{sub['content']}\n")
    return "\n".join(blocks)


def split_subtitles(segments: List[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
    """Char-level timestamps → sentence cues.

    segments: [{'char', 'start'}] → [{'start', 'end', 'content'}], split
    on sentence punctuation, end time = next char start (capped at
    +0.1 s), trailing punctuation stripped — the reference exporter's
    grouping, shared by the SRT/VTT composers and the server's
    whisper-style ``verbose_json`` segments."""
    if not segments:
        return []
    subtitles: List[Dict[str, Any]] = []
    current_chars: List[str] = []
    start_time = segments[0]["start"]

    for i, seg in enumerate(segments):
        char = seg["char"]
        time_s = seg["start"]
        current_chars.append(char)

        is_punc = char in SPLIT_PUNCS
        is_last = i == len(segments) - 1
        if is_punc or is_last:
            end_time = time_s + 0.1
            if not is_last and segments[i + 1]["start"] < end_time:
                end_time = segments[i + 1]["start"]
            content = "".join(current_chars).strip().rstrip(STRIP_PUNCS)
            if content:
                subtitles.append({"start": start_time, "end": end_time,
                                  "content": content})
            if not is_last:
                current_chars = []
                start_time = segments[i + 1]["start"]
    return subtitles


def compose_vtt(subtitles: List[Dict[str, Any]]) -> str:
    """subtitles → WebVTT text (same cues as SRT, '.' ms separator,
    no block numbers)."""
    blocks = ["WEBVTT\n"]
    for sub in subtitles:
        start = _fmt_time(sub["start"]).replace(",", ".")
        end = _fmt_time(sub["end"]).replace(",", ".")
        blocks.append(f"{start} --> {end}\n{sub['content']}\n")
    return "\n".join(blocks)


def generate_srt_file(segments: List[Dict[str, Any]], output_path: str,
                      max_chars_per_line: int = 30):
    """segments: [{'char', 'start'}] → write an .srt file; returns the path."""
    if not segments:
        return None
    with open(output_path, "w", encoding="utf-8") as f:
        f.write(compose_srt(split_subtitles(segments)))
    return output_path
