"""The port's spans and counters (``fun_asr_gguf_tpu_torch.profiling``), on
the CPU.

* Spans nest under their parent with the request's id and a segment's or
  attempt's index; self times add up to the request's span.
* With no tracer and no profiler, a step span is the shared off span: no
  clock read, no profiler range.
* Every ``Timings`` field a span feeds equals that span's duration.
* Under a CPU-activity ``torch.profiler`` an aten op launched inside a
  span lies inside the span's [start, end] moved onto the profiler's
  clock by ``clock_offset_ns()``, and the profile holds the span's
  ``asr.<name>`` range, which is no user annotation.
* On a tiny engine with speculation and the repetition fuse: the
  counters equal the verify rounds, steps and retries the engine ran, and
  ``host.syncs`` is the same with the tracer open and closed.
* The benchmark's ``idle_by_span`` puts each idle gap on the innermost
  span open at its middle; ``trace_kept`` pairs each kernel's calls in a
  trace with the launch counters.
* A span's seconds come from the monotonic clock, whatever the wall
  clock does.
* A ``--trace 1`` rehearsal of each cell prints its new metrics, and the
  trace probe's rehearsal reports what the line lacks.
"""

import argparse
import base64
import io
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fun_asr_gguf_tpu_torch import profiling

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def engine_inputs(tmp_path_factory):
    from fun_asr_gguf_tpu_torch.audio import write_wav
    from fun_asr_gguf_tpu_torch.models.config import HybridConfig
    from fun_asr_gguf_tpu_torch.models.loaders import write_random_checkpoint
    root = tmp_path_factory.mktemp("tracing_engine")
    ckpt = str(root / "model")
    cfg = write_random_checkpoint(ckpt, HybridConfig.tiny(), seed=0)
    with open(os.path.join(ckpt, "tokens.txt"), "w", encoding="utf-8") as f:
        for i in range(cfg.ctc.vocab_size):
            ch = chr(ord("一") + i) if i < cfg.ctc.vocab_size - 1 else "<blk>"
            f.write(f"{base64.b64encode(ch.encode()).decode()} {i}\n")
    wav = str(root / "a.wav")
    write_wav(wav, np.random.default_rng(0).normal(size=24000) * 0.05, 16000)
    return ckpt, wav


@pytest.fixture(scope="module")
def engine(engine_inputs):
    """A tiny CPU engine with speculation, a 48-token budget (past the
    fuse's window of 30) and its observed attempts, verify rounds and
    plain steps."""
    from fun_asr_gguf_tpu_torch import create_asr_engine
    from fun_asr_gguf_tpu_torch.hotword.manager import reset_hotword_manager
    ckpt, wav = engine_inputs
    reset_hotword_manager()
    eng = create_asr_engine(ckpt, verbose=False, compute_dtype="float32",
                            device="cpu", segment_pad_seconds=2.0,
                            n_predict=48, prefill_buckets=(64,))
    seen = {"rounds": 0, "steps": 0, "attempts": 0, "retried": 0,
            "aborted_tokens": 0}
    models, llm = eng.models, eng.orchestrator.decoder.llm_decoder
    spec, gen, decode = models.spec_generate, models.generate, llm.decode

    def spec_generate(state, *args, **kw):
        r0 = int(state.rounds[0])
        out = spec(state, *args, **kw)
        seen["rounds"] += int(state.rounds[0]) - r0
        return out

    def generate(state, *args, **kw):
        s0 = state.step
        out = gen(state, *args, **kw)
        seen["steps"] += state.step - s0
        return out

    attempts = []

    def llm_decode(*args, **kw):
        res = decode(*args, **kw)
        attempts.append(res)
        return res

    def transcribe(**kw):
        """One greedy transcription; the attempts it made."""
        attempts.clear()
        np.random.seed(0)
        res = eng.transcribe(wav, verbose=False, temperature=0.0, **kw)
        seen["attempts"] += len(attempts)
        seen["retried"] += len(attempts) - 1
        seen["aborted_tokens"] += sum(a.n_gen for a in attempts[:-1])
        return res

    models.spec_generate, models.generate = spec_generate, generate
    llm.decode = llm_decode
    yield eng, transcribe, seen
    eng.cleanup()
    reset_hotword_manager()


@pytest.fixture(scope="module")
def traced(engine):
    """One transcription under ``trace()``: (result, tracer)."""
    _, transcribe, _ = engine
    with profiling.trace() as tr:
        res = transcribe()
    return res, tr


def _by_name(tr, name):
    return [s for s in tr.spans if s.name == name]


def test_spans_nest_with_parent_request_and_index(traced):
    res, tr = traced
    (req,) = _by_name(tr, "request")
    assert req.parent is None and req.request is not None
    assert all(s.request == req.request for s in tr.spans)
    parents = {"load_audio": "request", "process": "request",
               "segment": "process", "encode": "segment", "ctc": "segment",
               "ctc.infer": "ctc", "ctc.decode": "ctc", "ctc.loop":
               "ctc.decode", "ctc.hotword": "ctc", "prepare": "segment",
               "llm.attempt": "segment", "llm.prefill": "llm.attempt",
               "llm.generate": "llm.attempt", "llm.push": "llm.generate",
               "decode.chunk": "llm.generate", "decode.step": "decode.chunk",
               "decode.wait": "decode.step", "decode.sample": "decode.step",
               "decode.forward": "decode.step", "spec.round": "llm.generate",
               "spec.sync": "spec.round", "spec.draft": "spec.round",
               "spec.forward": "spec.round", "spec.accept": "spec.round",
               "align": "segment"}
    names = {s.name for s in tr.spans}
    assert names == set(parents) | {"request"}, names ^ set(parents)
    for s in tr.spans:
        if s.name != "request":
            assert s.parent.name == parents[s.name], s
            assert s.parent.start <= s.start <= s.end <= s.parent.end, s
    assert [s.attrs for s in _by_name(tr, "segment")] == [{"index": 0}]
    atts = _by_name(tr, "llm.attempt")
    assert [s.attrs["index"] for s in atts] == list(range(len(atts)))
    assert [s.attrs["aborted"] for s in atts] == \
        [True] * (len(atts) - 1) + [False]
    total = sum(tr.self_times().values())
    assert total == pytest.approx(req.seconds, rel=1e-9, abs=1e-9)


def test_step_span_off_takes_no_clock_and_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called while nothing records")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(profiling, "time", argparse.Namespace(
        time_ns=refuse, perf_counter_ns=refuse))
    assert not profiling._tracers
    assert not profiling._autograd_profiler._is_profiler_enabled
    for name in ("decode.step", "decode.wait", "spec.round"):
        s = profiling.span(name)
        assert s is profiling._OFF
        with s as inner:
            inner.note("index", 1)
    assert not profiling._stack


def test_timings_fields_equal_their_spans(traced):
    res, tr = traced
    last = {}
    for s in tr.spans:
        last[s.name] = s
    fields = {"load_audio": "load_audio", "total": "process",
              "encode": "encode", "ctc": "ctc", "ctc_infer": "ctc.infer",
              "ctc_decode": "ctc.decode", "ctc_loop": "ctc.loop",
              "hotword_verify": "ctc.hotword", "prepare": "prepare",
              "inject": "llm.prefill", "llm_generate": "llm.generate",
              "align": "align"}
    for field, name in fields.items():
        assert getattr(res.timings, field) == last[name].seconds, field
    assert res.timings.ctc_cast == res.timings.ctc_argmax == 0.0


def test_aten_op_lies_inside_its_span_on_the_profiler_clock():
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("decode.forward") as s:
            time.sleep(0.002)
            x @ x
            time.sleep(0.002)
        # a profiler stopped while a span is open leaves it sound
        inner = profiling.span("decode.step")
        inner.__enter__()
    prof_events = prof.profiler.kineto_results.events()
    inner.__exit__(None, None, None)
    assert not profiling._stack and s.recorded
    mm = [e for e in prof_events if e.name() == "aten::mm"]
    assert len(mm) == 1
    # spans run on the monotonic clock; the offset puts them on the
    # profiler's
    off = profiling.clock_offset_ns()
    assert s.start + off <= mm[0].start_ns()
    assert mm[0].start_ns() + mm[0].duration_ns() <= s.end + off
    ranges = {e.name(): e for e in prof_events if e.name().startswith("asr.")}
    assert set(ranges) == {"asr.decode.forward", "asr.decode.step"}
    # not a user annotation: a profile of the card would mirror those onto
    # the device's timeline as events spanning their kernels
    assert not any(e.is_user_annotation() for e in ranges.values())


def test_counters_match_the_engine_and_the_tracer_adds_no_sync(engine):
    _, transcribe, seen = engine
    deltas = []
    for tracing in (False, True, False):
        before = dict(seen)
        c0 = profiling.counters()
        if tracing:
            with profiling.trace():
                transcribe()
        else:
            transcribe()
        c = {k: v - c0.get(k, 0) for k, v in profiling.counters().items()}
        did = {k: seen[k] - before[k] for k in seen}
        assert c["requests"] == 1
        assert c["spec.rounds"] == did["rounds"] > 0
        assert c["decode.steps"] == did["steps"] > 0
        assert c["llm.attempts"] == did["attempts"]
        assert c.get("llm.aborted", 0) == did["retried"] > 0
        assert c.get("llm.aborted_tokens", 0) == did["aborted_tokens"]
        assert c["spec.off"] == did["attempts"]     # the guardrail, each time
        assert c["host.syncs"] > c["decode.steps"] + c["spec.rounds"]
        deltas.append(c)
    assert deltas[0] == deltas[1] == deltas[2]
    rec = profiling.recent_requests()[-1]
    assert rec.counters == deltas[-1] and rec.spans == {}


class _Event:
    def __init__(self, start, end, device=True):
        self.s, self.e, self.dev = start, end, device

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.dev else DeviceType.CPU

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s


def test_idle_by_span_takes_the_innermost_open_span():
    from bench_torch.program_trace import idle_by_span

    kernels = [(0, 10), (30, 40), (45, 50), (90, 100), (200, 210)]
    prof = argparse.Namespace(profiler=argparse.Namespace(
        kineto_results=argparse.Namespace(events=lambda: [
            _Event(s, e) for s, e in kernels] + [_Event(0, 300, False)])))

    def sp(name, start, end):
        s = profiling.Span(name, {})
        s.start, s.end = start, end
        return s

    tracer = profiling.Tracer()
    tracer.offset_ns = 1000     # the spans' clock, 1 us behind the profile's
    tracer.spans = [sp("request", -1000, -850), sp("decode.step", -995, -940),
                    sp("decode.wait", -964, -950),
                    sp("decode.forward", -948, -942)]
    got = dict(idle_by_span(prof, tracer))
    # gaps 10-30 (mid 20: the step), 40-45 (42.5: the wait), 50-90 (70:
    # the request), 100-200 (150: none open; the request ends at 150)
    assert got == pytest.approx({"decode.step": 20e-9, "decode.wait": 5e-9,
                                 "request": 40e-9,
                                 "(no program span)": 100e-9})


def test_trace_kept_pairs_trace_calls_with_launch_counters():
    from bench_torch.program_trace import trace_kept
    kernels = {"void q8_layer_fused_kernel<0, false>(Args)": [0.1, 56],
               "void q8_layer_fused_kernel<1, false>(Args)": [0.1, 4],
               "void flash_decode_kernel<bf16, 1>(Args)": [0.1, 59],
               "elementwise": [0.2, 900]}
    launched = {"quant_matmul.fused_launches": 60, "flash_decode.launches": 60,
                "flash_attention.launches": 0}
    assert trace_kept(kernels, launched) == {"K2": [59, 60], "K4": [60, 60]}


@pytest.mark.parametrize("cell, names", [
    ("nano-q8_0.clip60", ["step_host_ms", "step_wait_ms", "aborted_pct",
                          "host_syncs_per_token", "decode_graph_pct"]),
    ("nano-int8.short", ["round_host_ms", "spec_tokens_per_round"])])
def test_traced_rehearsal_prints_the_new_metrics(monkeypatch, cell, names):
    from bench_torch import harness
    load = harness.load_cell

    def shorter(root, name):
        bench, c, cfg, mix, limits = load(root, name)
        # fewer tokens a request, so the rehearsal stays short
        return bench, c, cfg, dict(mix, tokens_per_audio_second=1.0), limits

    monkeypatch.setattr(harness, "load_cell", shorter)
    monkeypatch.setattr(harness, "PROFILE_S", 0.0)
    monkeypatch.setattr(harness, "HOST_PROFILE_S", 0.0)
    out = io.StringIO()
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 23, seconds=0.1,
                              trace=1, t_start=time.perf_counter())
    harness.run(args, torch.device("cpu"), model=harness.TINY, out=out)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    for name in names:
        assert line["metrics"][name]["value"] >= 0, name


def test_span_seconds_keep_the_monotonic_clock_when_the_wall_clock_steps(
        monkeypatch):
    ticks = iter([1_000, 3_000])
    monkeypatch.setattr(profiling, "time", argparse.Namespace(
        perf_counter_ns=lambda: next(ticks),
        time_ns=lambda: -10 ** 12))     # stepped back, mid-span
    with profiling.span("encode", timed=True) as s:
        pass
    assert s.seconds == pytest.approx(2e-6)


@pytest.mark.parametrize("mode", ["spans", "tracer"])
def test_trace_probe_rehearsal_reports_what_the_line_lacks(
        monkeypatch, capsys, mode):
    from bench_torch import devtrace, harness
    from bench_torch.tools import trace_probe
    load = harness.load_cell

    def shorter(root, name):
        bench, c, cfg, mix, limits = load(root, name)
        return bench, c, cfg, dict(mix, tokens_per_audio_second=1.0), limits

    monkeypatch.setattr(harness, "load_cell", shorter)
    monkeypatch.setattr(harness, "PROFILE_S", 0.0)
    monkeypatch.setattr(harness, "HOST_PROFILE_S", 0.0)
    lines, run = io.StringIO(), harness.run
    monkeypatch.setattr(harness, "run",
                        lambda *a, **kw: run(*a, out=lines, **kw))
    made = devtrace.device_profile, devtrace.host_profile
    rc = trace_probe.main([
        "--mode", mode, "--workload", "nano-q8_0.clip60",
        "--seed", str(2 ** 31 + 29), "--seconds", "0.1",
        "--trace", "1" if mode == "spans" else "0", "--rehearse"])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines.getvalue().strip().splitlines()[-1])
    extra = json.loads(out[-1][len("EXTRA "):])
    # one sampled request: no greedy token to compare, so not "correct"
    assert rc == 0 and line["attempted"] == 1 and line["failed"] == 0
    assert (devtrace.device_profile, devtrace.host_profile) == made
    if mode == "spans":
        # the CPU rehearsal records no device event and launches no kernel
        assert extra["idle_by_span"] == [] and extra["trace_kept"] == {}
        assert extra["profiled_requests"] >= 1
        assert extra["self_times"]["decode.forward"] > 0
        assert extra["host_profile"]["asr_ranges"]["asr.request"] == 1
    else:
        assert extra["step_host_ms"] > 0 and extra["round_host_ms"] > 0
        assert 0 <= extra["step_wait_ms"] < extra["step_host_ms"]
