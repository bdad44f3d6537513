"""CUDA graphs of the plain decode step, and the machinery the verify
round's graphs (:mod:`.speculative`) share with them.

On a card, :func:`.generate.generate_chunk` does not enqueue each decode
step's ~900 launches from Python: it replays a CUDA graph of
``embed_tokens`` + ``qwen3_decode_step``, captured once per params, cfg,
cache layout (batch, capacity, dtypes; int8, head-major) and
``FUNASR_Q8_FUSED_HEAD`` route, whatever kernels that route runs (K4 / K4c
+ K2 + K1, K7 + K6, K5, or the int8 and dense products). The sampling
around it stays eager. The CPU runs the same step eagerly.

A graph reads and writes buffers of its own, fixed at capture:

- its inputs, the fed-back token [B], the slot [1], the rope position [B]
  and ``valid_from`` [B]. Each step writes the first three in three small
  launches, from the sampled token and the host's step counter, with no
  sync, and ``valid_from`` when another state steps through the graph;
- its KV cache, of the state's layout, which the layout's decode graph
  and verify graphs share (:class:`SharedCache`) with one memory pool. A
  state's first step or round through a graph of the layout copies the
  state's cache in (one device copy a tensor) and points ``state.kv`` at
  it: the state owns the shared cache from then on, and a state that no
  longer points at it has given it up (``spec_to_gen`` hands it on so). A
  second state that steps through a graph of the layout first hands the
  owner, while it lives and holds the cache, copies of the cache and of
  its logits, so two live states never share a cache;
- its logits: ``state.logits`` is the graph's output, which the next
  replay overwrites; the sampler reads it before then, on the same stream.

The graphs of a layout allocate in one pool: what a state holds across
replays is a buffer made outside the pool or a decode graph's logits,
which a dispossessed owner gets a copy of before another graph replays,
so a graph may reuse what another left in the pool.

Capture runs the step once eagerly on a side stream, which fills the
kernels' plan tables, ticket buffers and workspaces, then captures it on
that stream. The kernels' Python wrappers count their launches while
they are captured, though nothing runs: those increments are taken back
and added again on every replay, so the launch counters count what ran on
the card. Counters ``decode.graph_captures`` and ``decode.graph_replays``.
"""

import collections
import weakref

import torch

from .. import profiling
from ..ops.quant_matmul import fused_head_on
from .qwen3 import KVCache, QuantKV, embed_tokens, qwen3_decode_step

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
        self.outputs = []           # graph outputs a state's logits may be
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
            if any(owner.logits is out for out in self.outputs):
                owner.logits = owner.logits.clone()
        if state.kv is not self.kv:
            state.kv = _copy(self.kv, state.kv)
        self._owner = weakref.ref(state)


class DecodeGraph:
    """One captured decode step and its buffers (the module's doc)."""

    def __init__(self, params, cfg, shared: SharedCache, state):
        b = state.logits.shape[0]
        dev = state.logits.device
        self.params, self.cfg, self.shared = params, cfg, shared
        self.token, self.position, self.valid_from = (
            torch.zeros(b, dtype=torch.int64, device=dev) for _ in range(3))
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.logits = None
        self._replay = self._increments = self._keep = None
        self._fed = None            # weakref to the state of valid_from

    @property
    def kv(self) -> KVCache:
        return self.shared.kv

    def forward(self):
        """The captured step on the graph's buffers → logits [B, vocab]."""
        return qwen3_decode_step(
            self.params, self.kv, embed_tokens(self.params, self.token),
            self.slot, self.position, self.valid_from, self.cfg)[0]

    def step(self, state, token):
        """Feed ``token`` [B] back and advance ``state`` by one step."""
        self.shared.adopt(state)
        if self._fed is None or self._fed() is not state:
            self.valid_from.copy_(state.valid_from)
            self._fed = weakref.ref(state)
        self.token.copy_(token)
        self.slot.fill_(state.prompt_slots + state.step)
        torch.add(state.prompt_len, state.step, out=self.position)
        if self._replay is None:
            self._replay, self.logits, self._increments, self._keep = \
                capture(self.forward, self.slot.device, self.shared.pool)
            self.shared.outputs.append(self.logits)
            profiling.count("decode.graph_captures")
        self._replay()
        add(self._increments)
        profiling.count("decode.graph_replays")
        state.logits = self.logits


class DecodeGraphs:
    """An engine's CUDA graphs: at most :data:`LIMIT`, by key (the
    module's doc), the least recently used dropped first. The graphs of
    one cache layout share a :class:`SharedCache` while any of them is
    kept. A dropped graph's owner keeps its cache and logits, and its
    next step captures anew."""

    def __init__(self):
        self._graphs = collections.OrderedDict()
        self._shared = weakref.WeakValueDictionary()

    def graph(self, params, cfg, state, kind, make):
        """The graph of ``state``'s cache layout and of ``kind`` (what
        else fixes the graph: a hashable), made by ``make(shared)`` when
        there is none."""
        layout = (id(params), id(cfg), fused_head_on(),
                  tuple((tuple(t.shape), t.dtype)
                        for t in _tensors(state.kv)))
        graph = self._graphs.pop(layout + (kind,), None)
        if graph is None:
            shared = self._shared.get(layout)
            if shared is None:
                shared = self._shared[layout] = SharedCache(state.kv)
            graph = make(shared)
            while len(self._graphs) >= LIMIT:
                self._graphs.popitem(last=False)
        self._graphs[layout + (kind,)] = graph
        return graph

    def step(self, params, state, token, cfg):
        """One decode step of ``state`` (on the card) through its graph."""
        self.graph(params, cfg, state, "decode", lambda shared: DecodeGraph(
            params, cfg, shared, state)).step(state, token)
