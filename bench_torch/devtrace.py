"""Device busy time, kernel times and idle gaps from ``torch.profiler``.

The raw kineto events are read as they are (``kineto_results.events()``),
which stays fast over the hundreds of thousands of kernels an eager
request launches. Busy time is the length of the union of the device
intervals (kernels, copies, sets); a kernel's time is the sum of its
intervals.
"""

import bisect
import collections
import heapq

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def device_profile(on_card=True):
    """A profiler of device activity only: the host's eager dispatch keeps
    its speed, so the idle share is the program's. (Without a card, the
    CPU rehearsal, it records host activity, and no device event.)"""
    return profile(activities=[ProfilerActivity.CUDA if on_card
                               else ProfilerActivity.CPU])


def host_profile(on_card=True):
    acts = [ProfilerActivity.CPU]
    return profile(activities=acts + [ProfilerActivity.CUDA] if on_card
                   else acts)


def _events(prof):
    return prof.profiler.kineto_results.events()


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_summary(prof):
    """{"busy_s", "events", "kernels": {name: [seconds, calls]}} of the
    device events of a finished profile."""
    spans, kernels = [], collections.defaultdict(lambda: [0.0, 0])
    for ev in _events(prof):
        if ev.device_type() != DeviceType.CUDA:
            continue
        s, d = ev.start_ns(), ev.duration_ns()
        spans.append((s, s + d))
        k = kernels[ev.name()]
        k[0] += d * 1e-9
        k[1] += 1
    busy = sum(e - s for s, e in _union(spans)) * 1e-9
    return {"busy_s": busy, "events": len(spans), "kernels": dict(kernels)}


def top_device_ops(kernels, n=10, width=120):
    """The ``n`` device operations that took most time: [[name, s]]."""
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:n]
    return [[name[:width], secs] for name, (secs, _) in rows]


def idle_gaps_by_host(prof, n=10, width=120):
    """The device's idle gaps inside the profiled span, each put on the
    innermost host operation that was running at its middle, summed by
    name: the ``n`` largest as [[name, s]]."""
    dev, host = [], []
    for ev in _events(prof):
        s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            dev.append((s, e))
        elif e > s:
            host.append((s, e, ev.name()))
    busy = _union(dev)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    host.sort()
    starts = [h[0] for h in host]
    by_name = collections.defaultdict(float)
    active, i = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        j = bisect.bisect_right(starts, mid)
        for s, e, name in host[i:j]:
            heapq.heappush(active, (-s, e, name))
        i = max(i, j)
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        name = active[0][2] if active else "(no host operation)"
        by_name[name[:width]] += (g1 - g0) * 1e-9
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:n]]
