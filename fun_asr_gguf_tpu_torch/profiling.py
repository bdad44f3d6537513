"""Spans and counters of the program, on the clock of ``torch.profiler``.

    from fun_asr_gguf_tpu_torch import profiling

    with profiling.trace() as tr:
        engine.transcribe("a.wav")
    tr.spans            # [Span]: name, start / end (ns), parent, request
    tr.self_times()     # {name: seconds not covered by the span's children}
    tr.offset_ns        # + start / end: the profiler's clock
    profiling.counters()  # {name: count since the process started}

A span is a named stretch of host time: ``request`` (one ``transcribe``
call) down to ``decode.step`` (one step of the plain decode loop). It
records its start and end on ``time.perf_counter_ns()``, a monotonic
clock, so a step of the wall clock cannot bend a stage's time; its
parent span; the id of the request it belongs to; and its attributes (a
segment's or an LLM attempt's ``index``, an attempt's ``aborted``).
``torch.profiler``'s events (kineto's ``start_ns()``) read the wall
clock in ns: :func:`clock_offset_ns` added to a span's start and end puts
it on that clock, and a :class:`Tracer` keeps the offset of its opening.

A span is recorded while a :func:`trace` is open or a ``torch.profiler``
records; then it also enters a profiler range named ``asr.<name>``,
which names the program's stages in any profile that records host
activity. The range is a function-scope ``RecordFunction`` (torch's
``_RecordFunctionFast``), not a ``record_function`` user annotation: a
profile that also records the card mirrors every user annotation onto
the device's timeline as an event spanning its kernels, which would
read as device time. Otherwise a span costs one flag check, no clock
read and no allocation, except a ``timed`` span: the stage spans that
``Timings`` fields read always take their two clock reads, and the field
is set from the span's ``seconds``.

Counters are always on: :func:`count` adds to a host integer, only where
the program already holds the value on the host, so no counter adds a
device sync. Take differences of :func:`counters` around a window.

:func:`recent_requests` is interim: it keeps, for each of the last
requests, its span, its counters' increments and the time of the spans
recorded in it, so that a benchmark can recover its window's counters
and its profiled requests' spans afterwards. It goes once the benchmark
takes :func:`counters` and :func:`trace` around its window itself.

The state is the process's, as the kernels' launch counters are; spans
and counters assume the engine is driven from one thread.
"""

import collections
import contextlib
import itertools
import time
from typing import Dict, List, NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

RECENT_REQUESTS = 1024

_counts: Dict[str, int] = {}
_tracers: List["Tracer"] = []
_stack: List["Span"] = []
_ids = itertools.count()
_request: Optional["_Request"] = None
_recent = collections.deque(maxlen=RECENT_REQUESTS)


class Span:
    """One span; ``start`` and ``end`` in ns on ``time.perf_counter_ns()``."""

    __slots__ = ("name", "attrs", "start", "end", "parent", "request",
                 "recorded", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.start = self.end = 0
        self.parent: Optional[Span] = None
        self.request: Optional[int] = None
        self.recorded = False
        self._range = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def note(self, key: str, value) -> None:
        """Set the attribute ``key``."""
        self.attrs[key] = value

    def __enter__(self):
        # torch's own flag for "a profiler is recording"
        profiler_on = _autograd_profiler._is_profiler_enabled
        if _tracers or profiler_on:
            self.recorded = True
            self.parent = _stack[-1] if _stack else None
            _stack.append(self)
            if profiler_on:
                self._range = _RecordFunctionFast("asr." + self.name)
                self._range.__enter__()
        if _request is not None:
            self.request = _request.id
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self.recorded:
            if self._range is not None:
                self._range.__exit__(None, None, None)
                self._range = None
            if _stack and _stack[-1] is self:
                _stack.pop()
            elif self in _stack:
                _stack.remove(self)
            for tracer in _tracers:
                tracer.spans.append(self)
            if _request is not None:
                _request.add(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, {self.seconds * 1e3:.3f} ms, "
                f"request={self.request}, attrs={self.attrs})")


class _Off:
    """The span of a stretch nobody records."""

    __slots__ = ()

    def note(self, key: str, value) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, index: Optional[int] = None, timed: bool = False):
    """A context manager recording the stretch it encloses as ``name``.

    ``index`` numbers a segment or an attempt; ``timed`` spans always take
    their clock reads (a ``Timings`` field reads their ``seconds``)."""
    if timed or _tracers or _autograd_profiler._is_profiler_enabled:
        return Span(name, {} if index is None else {"index": index})
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (a host integer)."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    return dict(_counts)


def clock_offset_ns() -> int:
    """What puts a span's ``start`` or ``end`` on ``torch.profiler``'s
    clock (the wall clock's ns) when added to it."""
    return time.time_ns() - time.perf_counter_ns()


class Tracer:
    """The spans that ended while it was open, in the order they ended,
    and :func:`clock_offset_ns` as it read when the tracer opened."""

    def __init__(self):
        self.spans: List[Span] = []
        self.offset_ns = clock_offset_ns()

    def self_times(self) -> Dict[str, float]:
        """Seconds by span name, each span's duration less the part its
        recorded children cover."""
        covered = collections.defaultdict(int)
        for s in self.spans:
            if s.parent is not None:
                covered[id(s.parent)] += s.end - s.start
        out: Dict[str, float] = collections.defaultdict(float)
        for s in self.spans:
            out[s.name] += (s.end - s.start - covered[id(s)]) * 1e-9
        return dict(out)


@contextlib.contextmanager
def trace():
    """Record every span while open; yields the :class:`Tracer`."""
    tracer = Tracer()
    _tracers.append(tracer)
    try:
        yield tracer
    finally:
        _tracers.remove(tracer)


class RequestRecord(NamedTuple):
    """One finished request (interim, see the module's doc): its id, its
    ``request`` span's start and end (ns on ``time.perf_counter_ns()``),
    the counters' increments during it, and {span name: [spans,
    seconds]} of the spans recorded in it (empty when none was)."""
    id: int
    start: int
    end: int
    counters: Dict[str, int]
    spans: Dict[str, list]


class _Request:
    def __init__(self):
        self.id = next(_ids)
        self.before = counters()
        self.spans: Dict[str, list] = {}

    def add(self, s: Span):
        row = self.spans.setdefault(s.name, [0, 0.0])
        row[0] += 1
        row[1] += s.seconds


@contextlib.contextmanager
def request():
    """The span of one ``transcribe`` call: a new request id for the spans
    inside it, the ``requests`` counter, and a :class:`RequestRecord` in
    :func:`recent_requests` once it ends."""
    global _request
    outer, req = _request, _Request()
    _request = req
    count("requests")
    s = span("request", timed=True)
    try:
        with s:
            yield s
    finally:
        _request = outer
        after = counters()
        _recent.append(RequestRecord(
            req.id, s.start, s.end,
            {k: v - req.before.get(k, 0) for k, v in after.items()
             if v != req.before.get(k, 0)}, req.spans))


def recent_requests() -> List[RequestRecord]:
    """The last :data:`RECENT_REQUESTS` requests, oldest first. Interim:
    it goes once the benchmark reads :func:`counters` and :func:`trace`
    around its window."""
    return list(_recent)
