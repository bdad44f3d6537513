"""What the program's spans show that the benchmark's line does not carry
yet: the device's idle time by program span, the trace's kernel calls
beside the launch counters, the spans' clock against the device's, and
what tracing and a step's instrumentation cost.

    python3 bench_torch/tools/trace_probe.py --mode spans \\
        --workload nano-q8_0.clip60 --seed 7 --seconds 45 --trace 1
    python3 bench_torch/tools/trace_probe.py --mode tracer \\
        --workload nano-int8.short --seed 7 --seconds 45 --trace 0
    python3 bench_torch/tools/trace_probe.py --mode cost

``spans``: one run of the cell as ``bench_torch/run.py`` makes it (the
arguments after ``--mode`` are run.py's), its traced parts as the harness
has them, with a ``profiling.trace()`` open and the launch counters taken
over the device-profiled requests. After the run's line it prints
``EXTRA {json}``: ``idle_by_span``, ``trace_kept``, ``clock`` (the share
of the device's busy time inside ``request`` spans), ``self_times`` of
the profiled requests' spans, and ``host_profile`` (the host-and-device
profile's device busy time, its ``asr.*`` ranges and its idle gaps).

``tracer``: one run of the cell inside one ``profiling.trace()``, the cost
of tracing at ``--trace 0``; EXTRA holds the step's and the round's host
and wait times from the tracer's spans, on a host no profiler slows.

``cost``: ns a plain decode step's instrumentation takes (its 5 spans and
3 counter adds) with tracing off, under a tracer and under a device-only
profile.

``--rehearse`` (run.py's) runs ``spans`` and ``tracer`` on the CPU at the
tiny model's shapes, where no device event is recorded.
"""

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _spans(run_cell, extra):
    """Run the cell with the harness's two profiles hooked; fill
    ``extra``."""
    from torch.autograd import DeviceType
    from bench_torch import devtrace, harness, program_trace
    from fun_asr_gguf_tpu_torch import profiling

    kept = {}
    made = {"device": devtrace.device_profile, "host": devtrace.host_profile}

    def hooked(key):
        def profile(on_card=True):
            prof = made[key](on_card)
            start, stop = prof.start, prof.stop

            def started():
                if key == "device":
                    kept["before"] = harness.counters()
                    kept["trace"] = profiling.trace()
                    kept["tracer"] = kept["trace"].__enter__()
                t = time.perf_counter()
                start()
                extra[key + "_profile_start_s"] = time.perf_counter() - t

            def stopped():
                stop()
                if key == "device":
                    kept["trace"].__exit__(None, None, None)
                    before = kept["before"]
                    kept["launched"] = {k: v - before.get(k, 0) for k, v in
                                        harness.counters().items()}
                kept[key] = prof

            prof.start, prof.stop = started, stopped
            return prof
        return profile

    devtrace.device_profile, devtrace.host_profile = \
        hooked("device"), hooked("host")
    try:
        rc = run_cell()
    finally:
        devtrace.device_profile, devtrace.host_profile = \
            made["device"], made["host"]
    if "device" not in kept:
        raise SystemExit("--mode spans takes a --trace 1 run")
    prof, tracer = kept["device"], kept["tracer"]
    summary = devtrace.device_summary(prof)
    extra["idle_by_span"] = program_trace.idle_by_span(prof, tracer)
    extra["trace_kept"] = program_trace.trace_kept(summary["kernels"],
                                                   kept["launched"])
    busy = devtrace._union([(e.start_ns(), e.start_ns() + e.duration_ns())
                            for e in devtrace._events(prof)
                            if e.device_type() == DeviceType.CUDA])
    off = tracer.offset_ns
    reqs = devtrace._union([(s.start + off, s.end + off)
                            for s in tracer.spans if s.name == "request"])
    inside = sum(max(0, min(b1, r1) - max(b0, r0))
                 for b0, b1 in busy for r0, r1 in reqs)
    total = sum(e - s for s, e in busy)
    extra["clock"] = {
        "busy_s": total * 1e-9,
        "busy_inside_requests": inside / total if total else None,
        "first_kernel_after_request_ms": (busy[0][0] - reqs[0][0]) * 1e-6
        if busy and reqs else None}
    extra["profiled_requests"] = sum(s.name == "request"
                                     for s in tracer.spans)
    extra["self_times"] = dict(sorted(tracer.self_times().items(),
                                      key=lambda kv: -kv[1]))
    host = kept["host"]
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in devtrace._events(host)
           if e.device_type() == DeviceType.CUDA]
    asr = collections.Counter(e.name() for e in devtrace._events(host)
                              if e.name().startswith("asr."))
    extra["host_profile"] = {
        "device_busy_s": sum(e - s for s, e in devtrace._union(dev)) * 1e-9,
        "device_span_s": (max(e for _, e in dev) - min(s for s, _ in dev))
        * 1e-9 if dev else None,
        "asr_ranges": dict(asr.most_common(12)),
        "idle_gaps": devtrace.idle_gaps_by_host(host)}
    return rc


def _tracer(run_cell, extra):
    from bench_torch import program_trace
    from fun_asr_gguf_tpu_torch import profiling

    with profiling.trace() as tr:
        rc = run_cell()
    spans = collections.defaultdict(lambda: [0, 0.0])
    for s in tr.spans:
        spans[s.name][0] += 1
        spans[s.name][1] += s.seconds
    extra["spans"] = len(tr.spans)
    extra["step_host_ms"] = program_trace.host_ms(
        spans, "decode.step", "decode.wait", "decode.forward")
    extra["round_host_ms"] = program_trace.host_ms(
        spans, "spec.round", "spec.sync", "spec.forward")
    if spans.get("decode.forward"):
        extra["step_wait_ms"] = spans.get("decode.wait", [0, 0.0])[1] \
            * 1e3 / spans["decode.forward"][0]
    return rc


def _cost(extra):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fun_asr_gguf_tpu_torch import profiling
    span, count = profiling.span, profiling.count

    def step():
        with span("decode.step"):
            with span("decode.wait"):
                count("host.syncs")
            count("decode.steps")
            with span("decode.sample"):
                pass
            with span("decode.forward"):
                pass

    def ns(f, n):
        best = None
        for _ in range(5):
            t = time.perf_counter_ns()
            for _ in range(n):
                f()
            d = (time.perf_counter_ns() - t) / n
            best = d if best is None else min(best, d)
        return best

    extra["bare_ns"] = ns(lambda: None, 100000)
    extra["off_ns"] = ns(step, 100000)
    with profiling.trace():
        extra["tracer_ns"] = ns(step, 20000)
    acts = [ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU]
    with profile(activities=acts):
        extra["device_profile_ns"] = ns(step, 20000)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", choices=("spans", "tracer", "cost"),
                   required=True)
    args, rest = p.parse_known_args(argv)
    from bench_torch import run

    extra = {"mode": args.mode}
    if args.mode == "cost":
        rc = _cost(extra)
    else:
        rc = (_spans if args.mode == "spans" else _tracer)(
            lambda: run.main(rest), extra)
    print("EXTRA " + json.dumps(extra), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
