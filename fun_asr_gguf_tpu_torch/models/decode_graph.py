"""CUDA graphs of the decode loop: the plain decode step
(:func:`.generate.step_graph`) and the verify round
(:func:`.speculative.round_graph`), captured, owned and handed back the
same way.

On a card, :func:`.generate.generate_chunk` does not enqueue each decode
step's ~900 launches from Python, nor :func:`.speculative.run_rounds`
each round's: each replays a CUDA graph (:class:`Graph`) of its
iteration, whatever kernels the route runs (K4 / K4c + K2 + K1, K7 + K6,
K5, or the int8 and dense products). The CPU runs the same iterations
eagerly. A graph reads and writes buffers of its own, made outside the
graphs' memory pool, and the KV cache of its layout:

- at a chunk's start, :meth:`Graph.begin` makes the state the owner of
  the cache and copies in the state's fields that the forward reads and
  the chunk's values;
- each iteration the loop writes the iteration's inputs into the
  buffers (the plain step's token, slot and position; the round's
  uniforms) and calls the graph once: a capture the first time, a replay
  after;
- at the chunk's end, :meth:`Graph.end` hands the state copies of what
  the graph keeps (the plain step's logits; the round's carry).

So no state field is a graph's buffer between chunks. A forward returns
the buffers it makes (the plain step's logits, in the pool: the next
replay overwrites them, and the sampler reads them before then, on the
same stream), or nothing where it writes its buffers in place (the
round).

The decode graph and the verify graphs of one cache layout (batch,
capacity, dtypes; int8, head-major) share one static cache and one memory
pool (:class:`SharedCache`). A state's first chunk through a graph of the
layout copies the state's cache in (one device copy a tensor) and points
``state.kv`` at it: the state owns the shared cache from then on, and a
state that no longer points at it has given it up (``spec_to_gen`` hands
it on so). A second state that enters a graph of the layout first hands
the owner, while it lives and holds the cache, a copy of it, so two live
states never share a cache.

Capture runs the forward once eagerly on a side stream, which fills the
kernels' plan tables, ticket buffers and workspaces, then captures it on
that stream. A forward that writes its buffers in place has then run:
its eager run is the call. One that returns its output is replayed at
once, so that the output is the graph's. The kernels' Python wrappers
count their launches while they are captured, though nothing runs: those
increments are taken back and added again on every replay, so the launch
counters count what ran on the card. Counters ``<kind>.graph_captures``
and ``<kind>.graph_replays`` (``decode``, ``spec``).
"""

import collections
import functools
import types
import weakref

import torch

from .. import profiling
from ..ops.quant_matmul import fused_head_on
from .qwen3 import KVCache, QuantKV

LIMIT = 4          # graphs an engine keeps, the least recently used dropped


def _tensors(kv: KVCache):
    for half in kv:
        yield from (half if isinstance(half, QuantKV) else (half,))


def _empty_like(kv: KVCache) -> KVCache:
    return KVCache(*(QuantKV(*(torch.empty_like(t) for t in half))
                     if isinstance(half, QuantKV) else torch.empty_like(half)
                     for half in kv))


def _copy(dst: KVCache, src: KVCache) -> KVCache:
    for d, s in zip(_tensors(dst), _tensors(src)):
        d.copy_(s)
    return dst


def _launch_counts():
    """{(module, name): value} of the kernels' launch counters."""
    from ..ops import flash_attention, flash_decode, quant_matmul
    return {(mod, name): value
            for mod in (flash_attention, flash_decode, quant_matmul)
            for name, value in vars(mod).items()
            if "launches" in name and type(value) is int}


def counts():
    """Every counter, the launch counters and :mod:`..profiling`'s."""
    return _launch_counts(), profiling.counters()


def take_back(before):
    """Undo the counters' increments since ``before`` (a :func:`counts`);
    returns them, for :func:`add`."""
    launches, named = before
    up = ({k: v - launches.get(k, 0) for k, v in _launch_counts().items()
           if v != launches.get(k, 0)},
          {k: v - named.get(k, 0) for k, v in profiling.counters().items()
           if v != named.get(k, 0)})
    add(up, -1)
    return up


def add(increments, times: int = 1):
    """Add ``times`` the :func:`take_back` ``increments``."""
    for (mod, name), n in increments[0].items():
        setattr(mod, name, getattr(mod, name) + times * n)
    for name, n in increments[1].items():
        profiling.count(name, times * n)


def capture(forward, device, pool=None):
    """Run ``forward()`` once on a side stream of ``device``, then capture
    it there into a CUDA graph, in the memory ``pool`` (a
    ``torch.cuda.graph_pool_handle()``; None: a pool of its own). Returns
    (replay, the graph's output, the counters' increments of one call,
    what must outlive the graph)."""
    from ..kernels import build
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        forward()
        # the split-KV kernels' tickets on this stream, which the graph's
        # launches keep pointing at
        tickets = build.tickets(device, 1)
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = counts()
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        out = forward()
    return graph.replay, out, take_back(before), tickets


class SharedCache:
    """The static cache of one cache layout, which the layout's decode graph
    and verify graphs all read and write, their memory pool, and the state
    that owns the cache (the module's doc)."""

    def __init__(self, kv: KVCache):
        self.kv = _empty_like(kv)
        self.pool = (torch.cuda.graph_pool_handle()
                     if next(_tensors(self.kv)).is_cuda else None)
        self._owner = None          # weakref to the state owning self.kv

    def adopt(self, state):
        """Make ``state`` the owner of the cache. Raises where ``state``
        already points at the cache that another live state holds."""
        owner = self._owner() if self._owner is not None else None
        if owner is state:
            return
        if owner is not None and owner.kv is self.kv:
            if state.kv is self.kv:
                raise ValueError("this state holds the graphs' cache, "
                                 "which another live state owns")
            owner.kv = _copy(_empty_like(self.kv), self.kv)
        if state.kv is not self.kv:
            state.kv = _copy(self.kv, state.kv)
        self._owner = weakref.ref(state)


def put(bufs, values):
    """Write ``values`` ({name: a tensor or a number}) into the buffers of
    those names in ``bufs``."""
    for name, value in values.items():
        if isinstance(value, torch.Tensor):
            getattr(bufs, name).copy_(value)
        else:
            getattr(bufs, name).fill_(value)


class Graph:
    """One captured iteration of the decode loop (the module's doc):
    ``forward(bufs)`` over buffers made outside the pool: ``bufs.kv``, the
    shared cache; one like each of ``state``'s fields of ``reads``, which
    :meth:`begin` copies in; and ``bufs`` ({name: tensor}, the
    iteration's inputs and the chunk's values). :meth:`end` hands back the
    buffers of ``keeps``; ``kind`` names the counters."""

    def __init__(self, shared: SharedCache, kind: str, forward, state,
                 bufs, reads, keeps):
        self.shared, self.kind = shared, kind
        self.reads, self.keeps = reads, keeps
        self.bufs = types.SimpleNamespace(
            kv=shared.kv, **bufs,
            **{n: torch.empty_like(getattr(state, n)) for n in reads})
        self.forward = functools.partial(forward, self.bufs)
        self.ran = False            # whether the chunk called the graph
        self._replay = self._increments = self._keep = None

    def begin(self, state, **values):
        """A chunk's start: ``state`` takes the shared cache; its fields of
        ``reads`` and the chunk's ``values`` (:func:`put`) go into the
        buffers."""
        self.shared.adopt(state)
        put(self.bufs, {n: getattr(state, n) for n in self.reads})
        put(self.bufs, values)
        self.ran = False

    def __call__(self):
        """One iteration: the capture the first time, a replay after."""
        self.ran = True
        if self._replay is None:
            self._replay, out, self._increments, self._keep = capture(
                self.forward, next(_tensors(self.bufs.kv)).device,
                self.shared.pool)
            profiling.count(f"{self.kind}.graph_captures")
            if out is None:
                return
            vars(self.bufs).update(out)
        self._replay()
        add(self._increments)
        profiling.count(f"{self.kind}.graph_replays")

    def end(self, state):
        """A chunk's end: ``state`` gets copies of the buffers of
        ``keeps``, where the chunk called the graph."""
        if self.ran:
            for n in self.keeps:
                setattr(state, n, getattr(self.bufs, n).clone())


class DecodeGraphs:
    """An engine's CUDA graphs: at most :data:`LIMIT`, by key (the
    module's doc), the least recently used dropped first. The graphs of
    one cache layout share a :class:`SharedCache` while any of them is
    kept. A dropped graph's owner keeps its cache, and its next chunk
    captures anew."""

    def __init__(self):
        self._graphs = collections.OrderedDict()
        self._shared = weakref.WeakValueDictionary()

    def graph(self, params, cfg, state, key, make) -> Graph:
        """The graph of ``state``'s cache layout and of ``key`` (what else
        fixes the graph: a hashable), made by ``make(shared)`` when there
        is none. :func:`.generate.step_graph` and
        :func:`.speculative.round_graph` call it with a kind's ``key`` and
        ``make``."""
        layout = (id(params), id(cfg), fused_head_on(),
                  tuple((tuple(t.shape), t.dtype)
                        for t in _tensors(state.kv)))
        graph = self._graphs.pop(layout + (key,), None)
        if graph is None:
            shared = self._shared.get(layout)
            if shared is None:
                shared = self._shared[layout] = SharedCache(state.kv)
            graph = make(shared)
            while len(self._graphs) >= LIMIT:
                self._graphs.popitem(last=False)
        self._graphs[layout + (key,)] = graph
        return graph
