"""Public facade: FunASREngine / create_asr_engine.

Counterpart of ``fun_asr_gguf_tpu/engine.py`` with the same checkpoint
directory, call surface and defaults, at batch 1: ``llm_weight_format=
"auto"`` (per-channel int8 weights and head in bf16 compute, dense in
float32), ``bf16`` and ``int8`` explicitly, and ``q8_0`` with the fused
per-layer chain (kernel K4); ``kv_cache_dtype`` ``"bf16"`` or ``"int8"``
(kernel K2-i8); CTC-draft speculation (``speculative=True``, ``spec_k=8``,
with the ``spec_min_accept`` guardrail). Settings outside the ported
slices raise ``NotImplementedError`` naming the ROADMAP item that ports
them; none of them runs something else instead.

The engine runs on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); without a card it raises.
"""

from typing import Optional

import torch

from .core.model_manager import ModelManager
from .core.orchestrator import TranscriptionOrchestrator
from .datatypes import (ASREngineConfig, DecodeResult, RecognitionStream,
                        TranscriptionResult)


def _todo(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch engine yet "
        f"(ROADMAP.md, Queue 1: '{item}')")


class FunASREngine:
    """ASR inference engine on PyTorch (CUDA kernels on an NVIDIA GPU)."""

    def __init__(self,
                 checkpoint_dir: str,
                 tokens_path: Optional[str] = None,
                 tokenizer_path: Optional[str] = None,
                 hotwords_path: Optional[str] = None,
                 rules_path: Optional[str] = None,
                 rectify_path: Optional[str] = None,
                 enable_ctc: bool = True,
                 n_predict: int = 512,
                 similar_threshold: float = 0.6,
                 max_hotwords: int = 10,
                 compute_dtype: str = "bfloat16",
                 segment_pad_seconds: float = 60.0,
                 prefill_buckets=(256, 512),
                 llm_weight_format: str = "auto",
                 fuse_projections: bool = True,
                 ctc_beam_size: int = 1,
                 ctc_beam_topk: int = 8,
                 hotword_beam_bonus: float = 2.0,
                 compilation_cache_dir: Optional[str] = None,
                 int8_lm_head: bool = True,
                 warmup_all_buckets: bool = False,
                 warmup: bool = True,
                 speculative: bool = True,
                 spec_k: int = 8,
                 spec_draft_len: int = 512,
                 spec_min_accept: float = 1.35,
                 mesh_shape: Optional[dict] = None,
                 kv_cache_dtype: str = "bf16",
                 device: Optional[str] = None):
        """JAX's parameters, in JAX's order and with its defaults, then
        ``device``. ``compilation_cache_dir`` is accepted for the same call
        surface: PyTorch runs eagerly and the kernels are built once per
        source hash (``kernels/build.py``), so there is no XLA cache for it
        to feed. ``warmup_all_buckets`` warms every prefill bucket at init
        (the smallest only by default). ``ctc_beam_topk`` and
        ``hotword_beam_bonus`` are kept in the config for the beam search,
        which raises until it is ported (``ctc_beam_size > 1``)."""
        if llm_weight_format not in ("auto", "bf16", "int8", "int4",
                                     "q8_0"):
            raise ValueError(
                f"llm_weight_format must be auto|bf16|int8|int4|q8_0, got "
                f"{llm_weight_format!r}")
        if llm_weight_format == "int4":
            _todo("llm_weight_format='int4'", "Int4Weight")
        if kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be bf16|int8, got {kv_cache_dtype!r}")
        if mesh_shape:
            _todo("mesh_shape (multi-device serving)", "Multi-GPU and training")
        if ctc_beam_size > 1:
            _todo("ctc_beam_size > 1 (prefix beam search)",
                  "The device half of CTC beam search")
        if compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype must be bfloat16|float32, got "
                             f"{compute_dtype!r}")
        dev = torch.device(device or "cuda")
        if dev.type == "cuda" and compute_dtype != "bfloat16":
            _todo("compute_dtype='float32' on CUDA (the kernels take bf16 "
                  "activations)", "float32 compute on CUDA")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FunASREngine runs on a CUDA card and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        self.config = ASREngineConfig(
            checkpoint_dir=checkpoint_dir, tokens_path=tokens_path,
            tokenizer_path=tokenizer_path, hotwords_path=hotwords_path,
            rules_path=rules_path, rectify_path=rectify_path,
            enable_ctc=enable_ctc, n_predict=n_predict,
            similar_threshold=similar_threshold, max_hotwords=max_hotwords,
            compute_dtype=compute_dtype,
            segment_pad_seconds=segment_pad_seconds,
            prefill_buckets=tuple(prefill_buckets),
            llm_weight_format=llm_weight_format,
            fuse_projections=fuse_projections, ctc_beam_size=ctc_beam_size,
            ctc_beam_topk=ctc_beam_topk,
            hotword_beam_bonus=hotword_beam_bonus,
            compilation_cache_dir=compilation_cache_dir,
            int8_lm_head=int8_lm_head,
            warmup_all_buckets=warmup_all_buckets, warmup=warmup,
            speculative=speculative, spec_k=spec_k,
            spec_draft_len=spec_draft_len, spec_min_accept=spec_min_accept,
            kv_cache_dtype=kv_cache_dtype)
        self.device = dev
        self.models = ModelManager(self.config, dev)
        self.orchestrator = TranscriptionOrchestrator(self.models)
        self.sample_rate = self.config.sample_rate

    def initialize(self, verbose: bool = True) -> bool:
        return self.models.initialize(verbose=verbose)

    def transcribe(self, audio_path: str, language: Optional[str] = None,
                   context: Optional[str] = None, verbose: bool = True,
                   segment_size: float = 60.0, overlap: float = 2.0,
                   start_second: Optional[float] = None,
                   duration: Optional[float] = None, srt: bool = False,
                   temperature: float = 0.4, top_p: float = 1.0,
                   top_k: int = 50, on_stream=None, on_stream_reset=None,
                   preloaded_audio=None,
                   parallel_segments: bool = False) -> TranscriptionResult:
        """Transcribe one file (clips longer than ``segment_size + 2`` s
        run window by window). See the JAX facade for the arguments."""
        if parallel_segments:
            _todo("parallel_segments=True (batched long-audio decode)",
                  "Batched decode")
        return self.orchestrator.transcribe(
            audio_path=audio_path, language=language, context=context,
            verbose=verbose, segment_size=segment_size, overlap=overlap,
            start_second=start_second, duration=duration, srt=srt,
            temperature=temperature, top_p=top_p, top_k=top_k,
            on_stream=on_stream, on_stream_reset=on_stream_reset,
            preloaded_audio=preloaded_audio)

    def create_stream(self, hotwords: Optional[str] = None
                      ) -> RecognitionStream:
        """sherpa-onnx compatible stream creation."""
        return RecognitionStream(sample_rate=self.sample_rate)

    def decode_stream(self, stream: RecognitionStream,
                      language: Optional[str] = None,
                      context: Optional[str] = None, verbose: bool = True,
                      reporter=None, temperature: float = 0.3,
                      top_p: float = 1.0, top_k: int = 50) -> DecodeResult:
        """sherpa-onnx compatible stream decoding."""
        return self.orchestrator.decoder.decode_stream(
            stream, language, context, verbose, reporter,
            temperature=temperature, top_p=top_p, top_k=top_k)

    def decode_streams(self, *args, **kwargs):
        _todo("decode_streams (batched decode)", "Batched decode")

    def transcribe_batch(self, *args, **kwargs):
        _todo("transcribe_batch (batched decode)", "Batched decode")

    def create_streaming_session(self, *args, **kwargs):
        _todo("create_streaming_session (streaming)", "Streaming")

    def cleanup(self):
        self.models.cleanup()


def create_asr_engine(checkpoint_dir: str,
                      tokens_path: Optional[str] = None,
                      tokenizer_path: Optional[str] = None,
                      hotwords_path: Optional[str] = None,
                      enable_ctc: bool = True,
                      similar_threshold: float = 0.6,
                      max_hotwords: int = 10,
                      verbose: bool = True,
                      **kwargs) -> FunASREngine:
    """Create and initialize the engine (raises on failure); JAX's
    positional parameters, the rest (``device`` included) by keyword."""
    engine = FunASREngine(
        checkpoint_dir=checkpoint_dir, tokens_path=tokens_path,
        tokenizer_path=tokenizer_path, hotwords_path=hotwords_path,
        enable_ctc=enable_ctc, similar_threshold=similar_threshold,
        max_hotwords=max_hotwords, **kwargs)
    if not engine.initialize(verbose=verbose):
        raise RuntimeError("Failed to initialize ASR engine")
    return engine
