"""Per-segment pipeline: encode → CTC + hotwords → prompt → LLM → align.

Counterpart of ``fun_asr_gguf_tpu/core/decoder.py``: greedy CTC + hotword
recall (:class:`CTCDecoder`), whose transcript doubles as the speculative
draft; CTC-draft speculation with its probe chunk and acceptance guardrail,
then chunked on-device generation read once per chunk (:class:`LLMDecoder`,
:146-250); and the retry with +0.3 temperature on repetition aborts, up to
6 attempts (:class:`StreamDecoder`, :340-354).
"""

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ctc import align_timestamps, decode_ctc
from ..datatypes import (DecodeResult, LLMDecodeResult, RecognitionStream,
                         Timings)
from ..display import DisplayReporter
from ..formats.tokenizer import StreamTextDecoder
from ..models.speculative import spec_to_gen
from ..profiling import count, counters, span
from .model_manager import ModelManager

logger = logging.getLogger("fun_asr_gguf_tpu_torch.core")

ABORT_MARKER = "====解码有误，强制熔断===="


class CTCDecoder:
    """CTC inference (device argmax) + greedy collapse + hotword recall."""

    def __init__(self, models: ModelManager):
        self.models = models

    def decode(self, enc_output, enable_ctc: bool, max_hotwords: int
               ) -> Tuple[List, List[str], Optional[str], Dict[str, float]]:
        """Returns (ctc_results, hotwords, draft_text, t_stats)."""
        t_stats = {"infer": 0.0, "decode": 0.0, "hotword": 0.0}
        if not enable_ctc or not self.models.ctc_id2token:
            return [], [], None, t_stats
        with span("ctc.infer", timed=True) as s:
            indices = self.models.ctc_indices(enc_output)
        t_stats["infer"] = s.seconds

        with span("ctc.decode", timed=True) as s:
            ctc_text, ctc_results, ctc_details = decode_ctc(
                indices, self.models.ctc_id2token)
        t_stats["decode"] = s.seconds
        t_stats.update(ctc_details)

        hotwords: List[str] = []
        draft_text = ctc_text or None
        with span("ctc.hotword", timed=True) as s:
            corrector = self.models.corrector
            if corrector and corrector.hotwords and ctc_text:
                res = corrector.correct(ctc_text, k=max_hotwords)
                hotwords = list({hw for _, hw, _ in res.matchs}
                                | {hw for _, hw, _ in res.similars})
                if res.text:
                    draft_text = res.text
        t_stats["hotword"] = s.seconds
        return ctc_results, hotwords, draft_text, t_stats


class LLMDecoder:
    """Drives the chunked on-device generation."""

    def __init__(self, models: ModelManager):
        self.models = models

    def decode(self, full_embd: np.ndarray, n_predict: int,
               stream_output: bool = False,
               reporter: Optional[DisplayReporter] = None,
               temperature: float = 0.3, top_p: float = 1.0,
               top_k: int = 50,
               draft_text: Optional[str] = None) -> LLMDecodeResult:
        res = LLMDecodeResult()
        models = self.models
        sync = (torch.cuda.synchronize if models.device.type == "cuda"
                else (lambda *a: None))

        with span("llm.prefill", timed=True) as s:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
            state = models.prefill(full_embd, rng_seed=seed)
            count("host.syncs")
            sync(models.device)
        res.t_inject = s.seconds

        # CTC-draft speculation (distribution-preserving, see
        # models/speculative.py)
        draft_ids = None
        if models.config.speculative and draft_text:
            draft_ids = models.make_draft_ids(draft_text)
        if draft_ids is not None:
            state = models.spec_prepare(state)

        with span("llm.generate", timed=True) as s:
            self._generate(res, state, draft_ids, n_predict,
                           reporter if stream_output else None,
                           temperature, top_p, top_k)
        res.t_gen = s.seconds
        return res

    def _generate(self, res, state, draft_ids, n_predict, reporter,
                  temperature, top_p, top_k):
        """The chunks after the prefill: the speculative ones while
        ``draft_ids`` is set, then plain ones; fills ``res``."""
        models = self.models
        text_decoder = StreamTextDecoder(models.tokenizer, reporter)
        chunk_len = models._default_chunk_len()
        stop_set = set(models.stop_tokens) | {models.eos_token}
        generated = 0
        before = counters()

        def push_chunk(tokens, done) -> Tuple[int, bool]:
            """The one host sync of a chunk: its tokens and done flag.
            Returns (tokens emitted, done)."""
            with span("llm.push"):
                count("host.syncs")
                host = torch.cat([tokens[0], done[:1].to(torch.int64)]
                                 ).cpu().tolist()
                emitted = [t for t in host[:-1] if t >= 0]
                for tok in emitted:
                    if tok not in stop_set:
                        text_decoder.push(tok)
            return len(emitted), bool(host[-1])

        def spec_log(what):
            now = counters()
            tokens, rounds = (now.get(k, 0) - before.get(k, 0)
                              for k in ("spec.tokens", "spec.rounds"))
            logger.info("%s: %d tokens in %d verify rounds (%.2f a round)",
                        what, tokens, rounds, tokens / max(rounds, 1))

        done = False
        first_spec = True
        while generated < n_predict and draft_ids is not None:
            todo = min(chunk_len, n_predict - generated)
            if first_spec:
                # probe: the guardrail may bail after <= 16 emissions
                # instead of paying a full chunk of verify rounds
                todo = min(todo, 16)
                first_spec = False
            tokens = models.spec_generate(
                state, draft_ids, temperature=temperature, top_p=top_p,
                top_k=top_k, chunk_len=chunk_len, limit=todo)
            n_emitted, done = push_chunk(tokens, state.done)
            count("spec.tokens", n_emitted)
            generated += n_emitted
            if done or n_emitted == 0:
                done = True
                break
            # acceptance-rate guardrail: a verify round costs about one
            # decode step, so below spec_min_accept emitted tokens per
            # round drafting is slower than plain decode; a pending forbid
            # rides along into the plain chunk's first draw
            count("host.syncs")
            rounds = int(state.rounds[0].item())
            min_acc = models.config.spec_min_accept
            if rounds >= 8 and min_acc > 0 and generated / rounds < min_acc:
                count("spec.off")
                spec_log(f"speculation off (below {min_acc:.2f} a round)")
                state = spec_to_gen(state)
                draft_ids = None
        if draft_ids is not None:
            spec_log("speculation")

        while not done and generated < n_predict:
            todo = min(chunk_len, n_predict - generated)
            tokens = models.generate(state, temperature=temperature,
                                     top_p=top_p, top_k=top_k,
                                     chunk_len=chunk_len, limit=todo)
            generated += todo
            _, done = push_chunk(tokens, state.done)
        count("host.syncs", 2)
        res.is_aborted = bool(state.aborted[0].item())
        text_decoder.flush()
        res.text = text_decoder.generated_text
        res.n_gen = int(state.n_gen[0].item())


class StreamDecoder:
    """Full per-segment pipeline."""

    def __init__(self, models: ModelManager):
        self.models = models
        self.ctc_decoder = CTCDecoder(models)
        self.llm_decoder = LLMDecoder(models)

    def decode_stream(self, stream: RecognitionStream,
                      language: Optional[str] = None,
                      context: Optional[str] = None,
                      verbose: bool = True,
                      reporter: Optional[DisplayReporter] = None,
                      temperature: float = 0.3, top_p: float = 1.0,
                      top_k: int = 50) -> DecodeResult:
        timings = Timings()
        models = self.models
        if reporter:
            reporter.print("\n[2] 音频编码...")
        with span("encode", timed=True) as s:
            audio_embd, enc_output = models.encode_audio(stream.audio_data)
        timings.encode = s.seconds
        if reporter:
            reporter.print(f"    耗时: {timings.encode*1000:.2f}ms")

        if reporter:
            reporter.print("\n[3] CTC 解码...")
        with span("ctc", timed=True) as s:
            ctc_results, hotwords, draft_text, ctc_times = \
                self.ctc_decoder.decode(enc_output, models.config.enable_ctc,
                                        models.config.max_hotwords)
        timings.ctc = s.seconds
        timings.ctc_infer = ctc_times["infer"]
        timings.ctc_decode = ctc_times["decode"]
        timings.hotword_verify = ctc_times["hotword"]
        timings.ctc_cast = ctc_times.get("cast", 0.0)
        timings.ctc_argmax = ctc_times.get("argmax", 0.0)
        timings.ctc_loop = ctc_times.get("loop", 0.0)
        if verbose and ctc_results and reporter:
            reporter.print(f"    CTC: {''.join(r.text for r in ctc_results)}")
            if hotwords:
                reporter.print(f"    热词: {hotwords}")

        if reporter:
            reporter.print("\n[4] 准备 Prompt...")
        context = models.augment_context(context, draft_text)
        with span("prepare", timed=True) as s:
            p_embd, s_embd, n_p, n_s, p_text = \
                models.prompt_builder.build_prompt(hotwords, language,
                                                   context)
        timings.prepare = s.seconds
        if verbose and reporter:
            reporter.print("-" * 15 + " Prefix Prompt " + "-" * 15 + "\n"
                           + p_text + "\n" + "-" * 40)

        if reporter:
            reporter.print("\n[5] LLM 解码...")
            reporter.print("=" * 70)
        full_embd = np.concatenate(
            [p_embd, audio_embd.astype(np.float32), s_embd], axis=0)
        stream_output = verbose or (
            reporter is not None and getattr(reporter, "on_stream", None))
        llm_res = None
        for attempt in range(6):
            with span("llm.attempt", index=attempt) as s:
                llm_res = self.llm_decoder.decode(
                    full_embd, models.config.n_predict,
                    stream_output=bool(stream_output), reporter=reporter,
                    temperature=temperature, top_p=top_p, top_k=top_k,
                    draft_text=draft_text)
                s.note("aborted", llm_res.is_aborted)
            count("llm.attempts")
            count("llm.tokens", llm_res.n_gen)
            if not llm_res.is_aborted:
                break
            if attempt < 5:     # retried: the fuse threw this attempt away
                count("llm.aborted")
                count("llm.aborted_tokens", llm_res.n_gen)
            temperature += 0.3
            llm_res.text += ABORT_MARKER
            if reporter is not None and hasattr(reporter, "stream_reset"):
                reporter.stream_reset()
            if reporter is not None:
                reporter.print(f"\n\n[!] 触发重试 (Temp -> {temperature:.1f})\n")

        text = models.apply_rules(llm_res.text.strip())
        timings.inject = llm_res.t_inject
        timings.llm_generate = llm_res.t_gen
        if reporter:
            reporter.print("\n" + "=" * 70)
            reporter.print("\n[6] 时间戳对齐")

        aligned = None
        timestamps: List[float] = []
        tokens: List[str] = []
        with span("align", timed=True) as s:
            if ctc_results:
                aligned = align_timestamps(ctc_results, text)
                if aligned:
                    tokens = [seg["char"] for seg in aligned]
                    timestamps = [seg["start"] for seg in aligned]
        timings.align = s.seconds

        stream.set_result(text=text, timestamps=timestamps, tokens=tokens)
        return DecodeResult(
            text=text, ctc_results=ctc_results, aligned=aligned,
            audio_embd=audio_embd, n_audio_tokens=int(audio_embd.shape[0]),
            n_prefix=n_p, n_suffix=n_s, n_gen=llm_res.n_gen, timings=timings,
            hotwords=hotwords, is_aborted=llm_res.is_aborted)
