"""Hotword subsystem: phoneme-level fuzzy recall for CTC transcripts.

Re-implements the reference hotword stack (``fun_asr_gguf/hotword/``) with
no external dependencies: pypinyin is replaced by an embedded pinyin table
(:mod:`.pinyin`), numba's JIT DP by vectorized numpy (:mod:`.rag_fast`),
and watchdog by an mtime-polling watcher (:mod:`.manager`).
"""

import logging

logger = logging.getLogger("fun_asr_gguf_tpu_torch.hotword")

from .hot_phoneme import CorrectionResult, PhonemeCorrector  # noqa: E402,F401
from .hot_rule import RuleCorrector  # noqa: E402,F401
from .hot_rectification import RectificationRAG  # noqa: E402,F401
from .manager import HotwordManager, get_hotword_manager  # noqa: E402,F401

__all__ = [
    "PhonemeCorrector",
    "CorrectionResult",
    "RuleCorrector",
    "RectificationRAG",
    "HotwordManager",
    "get_hotword_manager",
    "logger",
]
