"""What the program records of itself, read for the benchmark.

``fun_asr_gguf_tpu_torch.profiling`` keeps, for each of the program's last
requests (``recent_requests()``, interim until the harness takes
``counters()`` and ``trace()`` around its window), its ``request`` span
on ``time.perf_counter_ns()``, the harness's clock, the increments of its
counters (always on) and the time of the spans recorded in it by name.
Spans are recorded while a ``torch.profiler`` records, so the requests a
traced run serves under the device-only profile, after the window, carry
their spans, timed on a host that the profile slows; the window's
requests carry counters only.

A checkout whose program lacks the module gives nothing: every function
here returns None, and the readers built on them report nothing.

``idle_by_span`` and ``trace_kept`` take a finished device profile and
what was open or counted over it: the device's idle time by the
innermost program span open at each gap's middle, and each kernel's
calls in the trace beside the program's own launch counts. The
harness's traced parts do not call them yet: they need the profile
before it is dropped and a ``profiling.trace()`` open over it, which
``bench_torch/tools/trace_probe.py --mode spans`` adds around them.
"""

import bisect
import collections
import heapq

from torch.autograd import DeviceType

from .devtrace import _events, _union


def _profiling():
    try:
        from fun_asr_gguf_tpu_torch import profiling
    except ImportError:
        return None
    return profiling


def _recent(ctx):
    """The program's recent requests, or None."""
    prof = _profiling()
    if prof is None or not ctx["records"]:
        return None
    return prof.recent_requests()


def window_counters(ctx):
    """The program's counters summed over the window's requests (those
    whose middle lies in the window, on the harness's ``perf_counter``
    seconds), or None."""
    recent = _recent(ctx)
    if recent is None:
        return None
    t0 = ctx["records"][0]["start"] * 1e9
    t1 = ctx["records"][-1]["end"] * 1e9
    total = collections.Counter()
    for r in recent:
        if t0 <= (r.start + r.end) / 2 <= t1:
            total.update(r.counters)
    return dict(total) if total else None


def profiled_spans(ctx):
    """{span name: [spans, seconds]} summed over the requests served under
    the device-only profile of a traced run (the first
    ``ctx["trace"]["requests"]`` after the window), or None."""
    recent = _recent(ctx)
    if recent is None or not ctx.get("trace"):
        return None
    t1 = ctx["records"][-1]["end"] * 1e9
    after = [r for r in recent if r.start > t1]
    total = collections.defaultdict(lambda: [0, 0.0])
    for r in after[:ctx["trace"]["requests"]]:
        for name, (n, secs) in r.spans.items():
            total[name][0] += n
            total[name][1] += secs
    return dict(total) if total else None


def host_ms(spans, whole, wait, per):
    """Mean ms of ``whole`` less its ``wait`` child, over the ``per`` spans
    (the steps or rounds that ran), or None."""
    if not spans or whole not in spans or not spans.get(per, [0])[0]:
        return None
    waited = spans.get(wait, [0, 0.0])[1]
    return (spans[whole][1] - waited) * 1e3 / spans[per][0]


def idle_by_span(prof, tracer):
    """The device's idle gaps inside a finished profile, each put down to
    the innermost span of ``tracer`` (a ``profiling.Tracer`` open over the
    profile; its ``offset_ns`` puts the spans on the profile's clock) open
    at its middle, summed by name: [[name, s]], most first,
    ``(no program span)`` included."""
    dev = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in _events(prof) if ev.device_type() == DeviceType.CUDA]
    busy = _union(dev)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    off = tracer.offset_ns
    opened = sorted((s.start + off, s.end + off, s.name)
                    for s in tracer.spans)
    starts = [s[0] for s in opened]
    by_name = collections.defaultdict(float)
    active, i = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) / 2
        j = bisect.bisect_right(starts, mid)
        for s, e, name in opened[i:j]:
            heapq.heappush(active, (-s, e, name))
        i = max(i, j)
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        by_name[active[0][2] if active else "(no program span)"] += \
            (g1 - g0) * 1e-9
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])]


# each kernel of the port's counters: the name its trace events carry, and
# the launch counters (``harness.counters()`` keys) that count its calls
KERNELS = {
    "K1": ("q8_matvec_kernel", ("quant_matmul.launches",
                                "quant_matmul.q8dot_launches")),
    "K1-gemm": ("q8_gemm_kernel", ("quant_matmul.gemm_launches",)),
    "K2": ("flash_decode_kernel", ("flash_decode.launches",
                                   "flash_decode.launches_i8")),
    "K3": ("flash_attention_kernel", ("flash_attention.launches",)),
    "K4": ("q8_layer_fused_kernel", ("quant_matmul.fused_launches",
                                     "quant_matmul.head_fused_launches",
                                     "quant_matmul.q8i_launches")),
}


def trace_kept(kernels, launched):
    """{kernel: [calls in the device trace, launches counted]} of each
    kernel either side saw; ``kernels`` is ``devtrace.device_summary``'s,
    ``launched`` the launch counters' increments over the same work."""
    out = {}
    for k, (name, keys) in KERNELS.items():
        calls = sum(v[1] for n, v in kernels.items() if name in n)
        counted = sum(launched.get(key, 0) for key in keys)
        if calls or counted:
            out[k] = [calls, counted]
    return out
