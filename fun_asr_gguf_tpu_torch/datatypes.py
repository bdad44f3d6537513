"""Typed results and configuration for the TPU ASR engine.

API-compatible with the reference dataclasses (reference
``fun_asr_gguf/nano_dataclass.py``), including the sherpa-onnx-style
``RecognitionStream``/``RecognitionResult`` pair, the per-stage ``Timings``
(with CTC micro-stats), and throughput ``Statistics``.

The engine config diverges from the reference where the backends diverge:
instead of ONNX/GGUF file paths it takes a single checkpoint directory (our
TPU checkpoint layout) plus JAX-specific knobs, while keeping every
behavioral parameter (n_predict, similar_threshold, max_hotwords,
sample_rate, ...) with the reference defaults
(``nano_dataclass.py:126-157``).
"""

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


# ==================== Recognition results ====================

@dataclass
class RecognitionResult:
    """Recognition result (sherpa-onnx compatible, ``nano_dataclass.py:15``)."""
    text: str = ""
    timestamps: List[float] = field(default_factory=list)
    tokens: List[str] = field(default_factory=list)


@dataclass
class RecognitionStream:
    """Recognition stream carrying audio + result (``nano_dataclass.py:30``)."""
    sample_rate: int = 16000
    audio_data: Optional[np.ndarray] = None
    _result: Optional[RecognitionResult] = field(default=None, init=False, repr=False)

    def accept_waveform(self, sample_rate: int, audio: np.ndarray):
        self.sample_rate = sample_rate
        self.audio_data = np.asarray(audio).astype(np.float32)

    @property
    def result(self) -> RecognitionResult:
        if self._result is None:
            self._result = RecognitionResult()
        return self._result

    def set_result(self, text: str, timestamps: List[float] = None,
                   tokens: List[str] = None):
        self._result = RecognitionResult(
            text=text, timestamps=timestamps or [], tokens=tokens or [])


@dataclass
class Timings:
    """Per-stage wall times in seconds (``nano_dataclass.py:73-101``)."""
    encode: float = 0.0
    load_audio: float = 0.0
    ctc: float = 0.0
    prepare: float = 0.0
    inject: float = 0.0
    llm_generate: float = 0.0
    align: float = 0.0
    total: float = 0.0

    # Detailed micro-stats
    ctc_infer: float = 0.0
    ctc_decode: float = 0.0
    ctc_cast: float = 0.0
    ctc_argmax: float = 0.0
    ctc_loop: float = 0.0
    hotword_verify: float = 0.0


@dataclass
class TranscriptionResult:
    """Complete transcription result (``nano_dataclass.py:105``)."""
    text: str = ""
    segments: List[Dict[str, Any]] = field(default_factory=list)
    ctc_text: str = ""
    hotwords: List[str] = field(default_factory=list)
    timings: Timings = field(default_factory=Timings)
    audio_seconds: float = 0.0     # decoded clip length (RTF denominator)


# ==================== Engine configuration ====================

@dataclass
class ASREngineConfig:
    """Engine configuration.

    Behavioral defaults follow the reference (``nano_dataclass.py:145-157``).
    Backend knobs are JAX/TPU-native: a checkpoint directory replaces the
    onnx/gguf path triple; ``compute_dtype`` selects bf16/fp32 compute;
    ``segment_pad_seconds`` is the static-shape padding window (the XLA
    analogue of the DML pad-to-60 s trick, ``nano_onnx.py:6-19``).
    """
    checkpoint_dir: str = ""
    tokens_path: Optional[str] = None       # CTC vocab (tokens.txt); default: <ckpt>/tokens.txt
    tokenizer_path: Optional[str] = None    # Qwen tokenizer.json; default: <ckpt>/tokenizer.json
    hotwords_path: Optional[str] = None
    rules_path: Optional[str] = None        # opt-in regex rule correction
                                            # ("pattern = replacement" file,
                                            # live-reloaded); the reference
                                            # ships RuleCorrector unwired
    rectify_path: Optional[str] = None      # opt-in correction-history RAG
                                            # ("wrong/right" blocks, ---
                                            # separated, live-reloaded);
                                            # retrieved entries join the LLM
                                            # context (reference ships
                                            # RectificationRAG unwired)
    enable_ctc: bool = True
    n_predict: int = 512
    similar_threshold: float = 0.6
    max_hotwords: int = 10
    sample_rate: int = 16000

    # TPU-native knobs
    compute_dtype: str = "bfloat16"          # encoder/LLM activation dtype
    segment_pad_seconds: float = 60.0        # static shape window for jit
    max_prompt_tokens: int = 512             # static prefill length bucket
    llm_weight_format: str = "auto"          # auto | bf16 | int8 | int4 | q8_0
    kv_cache_dtype: str = "bf16"             # bf16 | int8 (halves KV HBM
                                             # reads — the batched-decode
                                             # bottleneck past b~16)
    mesh_shape: Optional[Dict[str, int]] = None   # e.g. {"dp": 1, "tp": 4}
    prefill_buckets: tuple = (256, 512)
    fuse_projections: bool = True            # pack qkv / gate-up matmuls
    ctc_beam_size: int = 1                   # >1: prefix beam search for the
                                             # hotword-recall transcript
    ctc_beam_topk: int = 8                   # per-frame device candidates
    hotword_beam_bonus: float = 2.0          # shallow-fusion char bonus
    compilation_cache_dir: Optional[str] = None  # persist XLA compiles
                                             # across restarts (serving)
    int8_lm_head: bool = True                # per-channel int8 logits head
                                             # in bf16 mode (+6% decode)
    warmup_all_buckets: bool = False         # compile every prefill bucket
                                             # at init (serving: no first-
                                             # request compile stalls)
    warmup: bool = True                      # False: skip init-time compile
                                             # warmup entirely; programs
                                             # compile on first use (bench/
                                             # batch-only callers that never
                                             # touch the b=1 programs)
    speculative: bool = True                 # CTC-draft speculative decode
                                             # (distribution-preserving;
                                             # needs enable_ctc)
    spec_k: int = 8                          # drafted tokens per verify step
    spec_draft_len: int = 512                # static draft buffer (tokens)
    spec_min_accept: float = 1.35            # auto-off: abandon drafting
                                             # below this emitted-tokens-
                                             # per-verify-round rate (a
                                             # round costs ~1 decode step);
                                             # 0 disables the guardrail
    spec_accept_slope: float = 0.13          # batched decode: a verify
                                             # round costs ~(1 + slope*B)
                                             # plain steps (measured v5e,
                                             # experiments/spec_batch_
                                             # crossover.py), so the per-
                                             # row accept threshold scales
                                             # with batch size


# ==================== CTC ====================

@dataclass
class CTCResult:
    """CTC decode unit (``nano_dataclass.py:163``)."""
    text: str
    start: float
    end: float
    score: float = 1.0


# ==================== Statistics ====================

@dataclass
class Statistics:
    """Inference throughput statistics (``nano_dataclass.py:182-213``)."""
    audio_duration: float = 0.0
    n_input_tokens: int = 0
    n_prefix_tokens: int = 0
    n_audio_tokens: int = 0
    n_suffix_tokens: int = 0
    n_generated_tokens: int = 0
    tps_in: float = 0.0
    tps_out: float = 0.0

    def __str__(self) -> str:
        return (
            f"  音频长度: {self.audio_duration:6.2f}s\n"
            f"  Decoder输入: {self.tps_in:6.0f} tokens/s "
            f"(总: {self.n_input_tokens}, prefix:{self.n_prefix_tokens}, "
            f"audio:{self.n_audio_tokens}, suffix:{self.n_suffix_tokens})\n"
            f"  Decoder输出: {self.tps_out:6.0f} tokens/s (总: {self.n_generated_tokens})"
        )


@dataclass
class DecodeResult:
    """Full per-segment decode result (``nano_dataclass.py:217``)."""
    text: str = ""
    ctc_results: List = field(default_factory=list)
    aligned: List[Dict[str, Any]] = field(default_factory=list)
    audio_embd: Optional[np.ndarray] = None
    n_audio_tokens: int = 0       # LLM audio-token count (set even when
    #                               audio_embd stays on device)
    n_prefix: int = 0
    n_suffix: int = 0
    n_gen: int = 0
    timings: Timings = field(default_factory=Timings)
    hotwords: List[str] = field(default_factory=list)
    is_aborted: bool = False


@dataclass
class LLMDecodeResult:
    """LLM decode-loop result (``nano_dataclass.py:245``)."""
    text: str = ""
    n_gen: int = 0
    t_inject: float = 0.0
    t_gen: float = 0.0
    is_aborted: bool = False


__all__ = [
    "RecognitionResult",
    "RecognitionStream",
    "TranscriptionResult",
    "DecodeResult",
    "LLMDecodeResult",
    "ASREngineConfig",
    "Timings",
    "CTCResult",
    "Statistics",
]
