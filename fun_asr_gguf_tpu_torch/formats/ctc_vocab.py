"""CTC vocabulary (tokens.txt) loading and generation.

Load-side behavior matches the reference's ``load_ctc_tokens``
(``fun_asr_gguf/nano_ctc.py:12-36``): one token per line as
``<base64-or-text> <id>``; base64 payloads are pre-decoded once; a line with
a single field means the token text is a space. The blank id is the maximum
id (the SenseVoice vocab appends ``<blk>`` last,
``01-Export-Encoder-Adaptor-CTC.py:78``).

Generation-side (:func:`generate_sensevoice_vocab`) rebuilds the same vocab
layout from a tiktoken file: base tokens, then Whisper-style special labels,
50 reserved specials, 1500 timestamp tokens, and the trailing blank
(``01-Export…py:52-79``).
"""

import base64
import os
from typing import Dict, List


def load_ctc_tokens(filename: str) -> Dict[int, str]:
    """Load tokens.txt into an id->text dict with eager base64 decoding."""
    id2token: Dict[int, str] = {}
    if not os.path.exists(filename):
        return id2token
    with open(filename, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if len(parts) == 1:
                text, idx = " ", parts[0]
            else:
                text, idx = parts
            try:
                text = base64.b64decode(text).decode("utf-8")
            except Exception:
                pass  # keep the raw field for non-b64 tokens
            id2token[int(idx)] = text
    return id2token


_SPECIAL_LABELS = [
    "<|endoftext|>", "<|startoftranscript|>",
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue", "minnan", "wuyu", "dialect", "zh/en", "en/zh",
    "ASR", "AED", "SER", "Speech", "/Speech", "BGM", "/BGM", "Laughter",
    "/Laughter", "Applause", "/Applause",
    "HAPPY", "SAD", "ANGRY", "NEUTRAL",
    "translate", "transcribe", "startoflm", "startofprev", "nospeech",
    "notimestamps",
]


def generate_sensevoice_vocab(tiktoken_path: str) -> List[str]:
    """Rebuild the SenseVoice CTC vocab token list from a tiktoken file."""
    tokens: List[str] = []
    with open(tiktoken_path, "r", encoding="utf-8") as f:
        for line in f:
            if line.strip():
                tokens.append(line.split()[0])
    for label in _SPECIAL_LABELS:
        if not label.startswith("<|"):
            label = f"<|{label}|>"
        tokens.append(base64.b64encode(label.encode()).decode())
    for i in range(1, 51):
        tokens.append(base64.b64encode(f"<|SPECIAL_TOKEN_{i}|>".encode()).decode())
    for i in range(1500):
        tokens.append(base64.b64encode(f"<|{i * 0.02:.2f}|>".encode()).decode())
    tokens.append(base64.b64encode("<blk>".encode()).decode())
    return tokens


def write_tokens_file(tokens: List[str], path: str):
    with open(path, "w", encoding="utf-8") as f:
        for i, t in enumerate(tokens):
            f.write(f"{t} {i}\n")
