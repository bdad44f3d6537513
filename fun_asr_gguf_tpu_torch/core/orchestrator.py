"""High-level transcription orchestration.

Counterpart of ``fun_asr_gguf_tpu/core/orchestrator.py``: the short/long
split at ``segment_size + 2 s``; the long path's windows (size
``segment_size``, step ``segment_size - overlap``) decoded one after the
other by the same per-segment decoder (:136), timings accumulated, the
overlap merge, SRT export and the stats report. The batched
``parallel_segments`` mode is not ported yet.
"""

import os
from typing import Optional

from .. import profiling
from ..audio import load_audio
from ..datatypes import RecognitionStream, Statistics, TranscriptionResult
from ..display import DisplayReporter
from ..srt_utils import generate_srt_file
from ..text_merge import merge_transcription_results
from .decoder import StreamDecoder
from .model_manager import ModelManager

_TIMING_FIELDS = ("encode", "ctc", "prepare", "inject", "llm_generate",
                  "align", "ctc_infer", "ctc_decode", "hotword_verify",
                  "ctc_cast", "ctc_argmax", "ctc_loop")


class TranscriptionOrchestrator:
    """Drives full-file transcription."""

    def __init__(self, models: ModelManager):
        self.models = models
        self.decoder = StreamDecoder(models)

    def transcribe(self, audio_path: str, language: Optional[str] = None,
                   context: Optional[str] = None, verbose: bool = True,
                   segment_size: float = 60.0, overlap: float = 2.0,
                   start_second: Optional[float] = None,
                   duration: Optional[float] = None, srt: bool = False,
                   temperature: float = 0.3, top_p: float = 1.0,
                   top_k: int = 50, on_stream=None, on_stream_reset=None,
                   preloaded_audio=None) -> TranscriptionResult:
        result = TranscriptionResult()
        with profiling.request(), DisplayReporter(
                verbose=verbose, on_stream=on_stream,
                on_stream_reset=on_stream_reset) as reporter:
            try:
                line = "=" * 70
                reporter.print(f"\n{line}\n处理音频: "
                               f"{os.path.basename(audio_path)}\n{line}",
                               force=True)
                reporter.print("\n[1] 加载音频...")
                sr = self.models.config.sample_rate
                with profiling.span("load_audio", timed=True) as s:
                    audio = (preloaded_audio if preloaded_audio is not None
                             else load_audio(audio_path, sr,
                                             start_second=start_second,
                                             duration=duration))
                result.timings.load_audio = s.seconds
                audio_duration = len(audio) / sr
                result.audio_seconds = audio_duration
                reporter.print(f"    音频长度: {audio_duration:.2f}s")
                base_offset = start_second if start_second else 0.0

                kw = dict(temperature=temperature, top_p=top_p, top_k=top_k)
                with profiling.span("process", timed=True) as s:
                    if audio_duration <= segment_size + 2.0:
                        self._transcribe_short(audio, result, language,
                                               context, verbose, reporter,
                                               base_offset, **kw)
                    else:
                        self._transcribe_long(audio, result, language,
                                              context, segment_size, overlap,
                                              reporter, base_offset, **kw)
                result.timings.total = s.seconds
                self._print_stats(reporter, result)
                if srt and result.segments:
                    srt_path = os.path.splitext(audio_path)[0] + ".srt"
                    generate_srt_file(result.segments, srt_path)
                    reporter.print(f"✓ 字幕已导出至: "
                                   f"{os.path.basename(srt_path)}",
                                   force=True)
                if result.text:
                    reporter.print("\n" + "-" * 30 + " 完整转录文本 "
                                   + "-" * 30, force=True)
                    reporter.print(result.text, force=True)
                    reporter.print("-" * 74 + "\n", force=True)
                return result
            except Exception as e:
                reporter.print(f"\n✗ 转录失败: {e}", force=True)
                raise

    def _transcribe_short(self, audio, result, language, context, verbose,
                          reporter, base_offset, **kw):
        stream = RecognitionStream()
        stream.accept_waveform(self.models.config.sample_rate, audio)
        with profiling.span("segment", index=0):
            d_res = self.decoder.decode_stream(stream, language, context,
                                               verbose, reporter, **kw)
        for name in _TIMING_FIELDS:
            setattr(result.timings, name, getattr(d_res.timings, name))
        result.text = d_res.text
        result.segments = [{"char": s["char"], "start": s["start"] +
                            base_offset} for s in (d_res.aligned or [])]
        result.hotwords = d_res.hotwords
        if d_res.ctc_results:
            result.ctc_text = "".join(r.text for r in d_res.ctc_results)
        if verbose:
            n_audio = d_res.n_audio_tokens
            stats = Statistics(
                audio_duration=len(audio) / self.models.config.sample_rate,
                n_input_tokens=n_audio + d_res.n_prefix + d_res.n_suffix,
                n_prefix_tokens=d_res.n_prefix, n_audio_tokens=n_audio,
                n_suffix_tokens=d_res.n_suffix,
                n_generated_tokens=d_res.n_gen)
            if result.timings.inject > 0:
                stats.tps_in = stats.n_input_tokens / result.timings.inject
            if result.timings.llm_generate > 0:
                stats.tps_out = d_res.n_gen / result.timings.llm_generate
            reporter.print(f"\n[统计]\n{stats}")

    def _transcribe_long(self, audio, result, language, context,
                         segment_size, overlap, reporter, base_offset, **kw):
        reporter.print("    检测到长音频，开启分段识别模式...", force=True)
        reporter.skip_technical = True
        sr = self.models.config.sample_rate
        audio_duration = len(audio) / sr
        segments_info = []
        step = segment_size - overlap
        curr = 0.0
        while curr < audio_duration:
            end = min(curr + segment_size, audio_duration)
            segments_info.append((curr, end))
            if end >= audio_duration:
                break
            curr += step

        segment_results = []
        for idx, (s_s, e_s) in enumerate(segments_info):
            reporter.set_segment(idx + 1, len(segments_info))
            reporter.print(f"\n--- 处理分段 [{s_s:.1f}s - {e_s:.1f}s] ---",
                           force=True)
            stream = RecognitionStream()
            stream.accept_waveform(sr, audio[int(s_s * sr):int(e_s * sr)])
            with profiling.span("segment", index=idx):
                d_res = self.decoder.decode_stream(stream, language, context,
                                                   True, reporter, **kw)
            segment_results.append({
                "text": d_res.text, "segments": d_res.aligned,
                "duration": e_s - s_s, "hotwords": d_res.hotwords,
                "ctc_text": "".join(r.text for r in d_res.ctc_results)
                            if d_res.ctc_results else ""})
            for name in _TIMING_FIELDS:
                setattr(result.timings, name,
                        getattr(result.timings, name)
                        + getattr(d_res.timings, name))
        reporter.set_segment(0, 0)
        reporter.skip_technical = False

        offsets = [s[0] + base_offset for s in segments_info]
        result.text, result.segments = merge_transcription_results(
            segment_results, offsets, overlap)
        result.hotwords = list({h for r in segment_results
                                for h in r["hotwords"]})
        result.ctc_text = "".join(r["ctc_text"] for r in segment_results)

    def _print_stats(self, reporter, result):
        t = result.timings
        reporter.print("\n[转录耗时]")
        reporter.print(f"  - 音频编码： {t.encode*1000:5.0f}ms")
        reporter.print(f"  - CTC解码：  {t.ctc*1000:5.0f}ms "
                       f"(Infer: {t.ctc_infer*1000:.0f}ms, "
                       f"Dec: {t.ctc_decode*1000:.0f}ms, "
                       f"HW: {t.hotword_verify*1000:.0f}ms)")
        reporter.print(f"  - Prompt:    {t.prepare*1000:5.0f}ms")
        reporter.print(f"  - LLM读取：  {t.inject*1000:5.0f}ms")
        reporter.print(f"  - LLM生成：  {t.llm_generate*1000:5.0f}ms")
        reporter.print(f"  - 时间对齐： {t.align*1000:5.0f}ms")
        reporter.print(f"  - 推理总计： {t.total:5.2f}s\n")
