"""The decode step with its slot and position on the device, and the CUDA
graphs of the decode loop (``fun_asr_gguf_tpu_torch.models.decode_graph``:
the plain step's and the verify round's), on the CPU.

* The step with a device slot gives bit for bit the logits and cache of
  the int-slot step it replaced (kept here as the reference), over 8
  steps, on dense bf16, per-channel int8, fused q8_0 (K4), int8-dot (q8i)
  and all-layers (K5) params, over bf16 and int8 caches.
* ``generate_chunk`` returns the same tokens and leaves the same ``done``,
  ``aborted``, ``ring`` and cache as with that reference step, greedy and
  sampled; on the CPU it captures nothing.
* Through :class:`DecodeGraphs`, with the capture replaced by eager calls
  on the graph's buffers (the CPU has no CUDA graphs), each test over both
  kinds, the plain step (``decode``) and the verify round (``verify``):
  chunks equal eager chunks, greedy and sampled through one graph (the
  graphed steps of ``run_steps`` equal ``generate_chunk``'s, tokens,
  logits, carry, cache and generator); the state owns the graph's cache, and no other field of it is a
  graph's buffer after a chunk; a second live state keeps its own cache;
  a state holding a cache that another live state owns is refused; the
  least recently used graph goes beyond the limit; the counters'
  increments of a capture are taken back and added per replay; a second
  request captures nothing; ``spec_to_gen`` hands its cache over, to the
  decode graph of the layout with no copy where the rounds ran through its
  verify graph; the two graphs of a layout share one cache and pool.
* The engine sizes its cache in whole blocks of output slots, so
  requests whose ``n_predict`` differ within a block share one graph.

The card tests (``tests/test_torch_cuda.py``) hold real replays to eager
steps and rounds.
"""

import dataclasses
import functools
import gc
import types

import numpy as np
import pytest
import torch

from fun_asr_gguf_tpu_torch import profiling
from fun_asr_gguf_tpu_torch.formats.quant_np import q8_0_quantize
from fun_asr_gguf_tpu_torch.models import decode_graph as dg
from fun_asr_gguf_tpu_torch.models import generate as tg
from fun_asr_gguf_tpu_torch.models import qwen3 as tq
from fun_asr_gguf_tpu_torch.models import speculative as tsp
from fun_asr_gguf_tpu_torch.models.common import rms_norm
from fun_asr_gguf_tpu_torch.models.config import Qwen3Config
from fun_asr_gguf_tpu_torch.ops import flash_decode as tfd
from fun_asr_gguf_tpu_torch.ops import quant_matmul as tqm

CFG = Qwen3Config.tiny(vocab_size=512)
P = 12                      # prompt bucket
STEPS = 8
ROUTES = ["bf16", "int8", "q8_0", "q8i", "mega"]
CASES = [(r, c) for r in ROUTES for c in ("bf16", "int8")]
STOPS = (7,)
CHUNK = 64
SPEC_ROOM = P + CHUNK + 9 + 16      # a chunk, a round's rows and more
KINDS = ["decode", "verify"]


def _params(route, seed=0):
    """Port params of ``route`` at ``CFG``, made with numpy alone."""
    rng = np.random.default_rng(seed)
    cfg = CFG
    n, h, hd, f = cfg.n_layers, cfg.hidden, cfg.head_dim, cfg.ffn_dim
    nq = (cfg.q_heads + 2 * cfg.kv_heads) * hd

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    def norm(*shape):
        return t(1 + rng.normal(size=shape) * 0.1)
    common = {"embed": t(rng.normal(size=(cfg.vocab_size, h)) * 0.1),
              "final_ln": norm(h)}
    norms = {"input_ln": norm(n, h), "post_ln": norm(n, h),
             "q_norm": norm(n, hd), "k_norm": norm(n, hd)}
    if route in ("bf16", "int8"):
        def w(k, m):
            return t(rng.normal(size=(n, k, m)) * 0.05)
        params = dict(common, layers=dict(
            norms, qkv_w=w(h, nq), o_w=w(cfg.q_heads * hd, h),
            gate_up_w=w(h, 2 * f), down_w=w(f, h)))
        if route == "int8":
            params = tq.quantize_lm_head_per_channel(
                tq.quantize_qwen3_params_int8(params), cfg)
        return params

    def q8(rows, k):
        q, d = zip(*(q8_0_quantize((rng.normal(size=(rows, k)) * 0.05
                                    ).astype(np.float32)) for _ in range(n)))
        return tqm.Q8Weight(torch.from_numpy(np.stack(q)),
                            torch.from_numpy(np.stack(d).astype(np.float32)))
    params = tq.quantize_lm_head(dict(common, layers=dict(
        norms, qkv_w=q8(nq, h), o_w=q8(h, cfg.q_heads * hd),
        gate_up_w=q8(2 * f, h), down_w=q8(h, f))), cfg)
    if route == "q8i":
        return tq.fuse_qwen3_params_q8i(params)
    params = tq.fuse_qwen3_params_q8(params)
    if route == "mega":
        params = tq.fuse_qwen3_params_q8_mega(params, cfg)
        assert "q8_mega" in params
    return params


_PARAMS = {}


def params_of(route):
    if route not in _PARAMS:
        _PARAMS[route] = _params(route)
    return _PARAMS[route]


def _batch(route):
    return 1 if route == "mega" else 2      # K5 decodes one row


def _state(params, route, cache, seed=1, max_len=P + 24, b=None):
    """A prefilled GenState: left-padded prompts of P and P - 3 tokens."""
    b = b or _batch(route)
    rng = np.random.default_rng(seed)
    emb = torch.from_numpy(rng.normal(size=(b, P, CFG.hidden)).astype(
        np.float32) * 0.1).to(torch.bfloat16)
    mask = torch.ones(b, P)
    mask[1:, :3] = 0
    gen = torch.Generator().manual_seed(seed)
    return tg.prefill_init(params, emb, mask, gen, CFG, max_len=max_len,
                           kv_int8=cache == "int8")


def _clone(state):
    """An independent copy of a GenState (cache, tensors, generator)."""
    def kv(c):
        return dg._copy(dg._empty_like(c), c)
    out = dataclasses.replace(
        state, kv=kv(state.kv), logits=state.logits.clone(),
        ring=state.ring.clone(), n_gen=state.n_gen.clone(),
        done=state.done.clone(), aborted=state.aborted.clone(),
        generator=torch.Generator())
    out.generator.set_state(state.generator.get_state())
    return out


def _tensors(kv):
    return list(dg._tensors(kv))


def _same_cache(a, b):
    return all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


def parent_step(params, kv, token_embed, slot: int, position, valid_from,
                cfg):
    """The step as it was before the slot moved to the device: an int
    slot, a slice write, the K5 bias and write from that int."""
    if "q8_mega" in params and token_embed.shape[0] == 1 and kv.head_major:
        layers = params["layers"]
        x0 = token_embed.to(torch.float32)
        nhb0 = rms_norm(x0, layers["input_ln"][0], cfg.rms_eps).to(
            torch.bfloat16)
        cos, sin = tq.rope_cos_sin(position, cfg.head_dim, cfg.rope_theta,
                                   torch.float32)
        j = torch.arange(kv.max_len)
        bias = torch.where((j >= valid_from[0]) & (j < slot), 0.0,
                           tq.NEG_INF).to(torch.float32)[None]
        logits, k_new, v_new = tqm.q8_decode_all_fused(
            x0, nhb0, layers["post_ln"], params["norms_next"],
            layers["q_norm"], layers["k_norm"], cos, sin, bias, kv.k, kv.v,
            layers["qkv_w"], layers["o_w"], layers["gate_up_w"],
            layers["down_w"], params["lm_head_q"], cfg.rms_eps)
        kv.k[:, :, slot] = k_new.to(kv.k.dtype)
        kv.v[:, :, slot] = v_new.to(kv.v.dtype)
        return logits[:, :cfg.vocab_size], kv
    x = token_embed[:, None, :]
    cos, sin = tq._rope(position[:, None], cfg, x.dtype)
    logits = tq._layer_stack(params, kv, x, cos, sin,
                             tq.decode_bias(kv, slot, valid_from),
                             (slice(None), slice(slot, slot + 1)), cfg)
    return logits[:, 0], kv


def _tokens(state, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(state.logits.shape[0],)))


FIELDS = ("logits", "forbid", "prompt_len", "valid_from", "slot_next",
          "pos_next", "ring", "n_gen", "done", "aborted", "last_tok",
          "cursor", "rounds")


def _spec(params, route, cache="bf16", seed=1, max_len=SPEC_ROOM, b=None):
    return tsp.spec_init(_state(params, route, cache, seed=seed,
                                max_len=max_len, b=b))


def _spec_clone(state):
    """An independent copy of a SpecState (cache, tensors, generator)."""
    out = dataclasses.replace(
        state, kv=dg._copy(dg._empty_like(state.kv), state.kv),
        generator=torch.Generator(),
        **{n: getattr(state, n).clone() for n in FIELDS})
    out.generator.set_state(state.generator.get_state())
    return out


def _assert_same(got, ref, what=""):
    for n in FIELDS:
        assert torch.equal(getattr(got, n), getattr(ref, n)), (n, what)
    assert _same_cache(got.kv, ref.kv), what
    assert torch.equal(got.generator.get_state(),
                       ref.generator.get_state()), what


_DRAFTS = {}


def _draft(kind, b=2, length=48):
    """``matches``: the greedy ids of the dense route's first row, which a
    run meets again (pending tokens found in it, drafts accepted); ``none``:
    all -1."""
    if kind == "none":
        return torch.full((b, length), -1, dtype=torch.int64)
    if b not in _DRAFTS:
        params = params_of("bf16")
        st = _state(params, "bf16", "bf16", max_len=P + 40, b=b)
        ids = tg.generate_chunk(params, st, CFG, 0.0, 1.0, 50, chunk_len=32,
                                stop_tokens=())
        buf = torch.full((b, length), -1, dtype=torch.int64)
        buf[:, :32] = ids[:1]
        _DRAFTS[b] = buf
    return _DRAFTS[b]


def _chunk(params, state, draft, temperature, spec_k, limit, graphs=None,
           top_k=50, chunk_len=CHUNK):
    """A chunk of rounds: eager, or through ``graphs`` as a card runs it."""
    graph = None if graphs is None else tsp.round_graph(
        graphs, params, CFG, state, draft, top_k, spec_k, chunk_len, STOPS)
    return tsp.run_rounds(params, state, draft, CFG, temperature, 1.0, top_k,
                          spec_k, chunk_len, STOPS, limit, graph)


def _steps(params, state, temperature, limit, graphs=None):
    """A chunk of decode steps: ``generate_chunk`` (eager on the CPU), or
    its steps through ``graphs`` as a card runs them."""
    if graphs is None:
        return tg.generate_chunk(params, state, CFG, temperature, 1.0, 50,
                                 STEP_CHUNK, STOPS, limit)
    graph = tg.step_graph(graphs, params, CFG, state)
    return tg.run_steps(params, state, CFG, temperature, 1.0, 50,
                        STEP_CHUNK, STOPS, limit, graph)


# ---------------------------------------------------------------------------
# one chunk of either kind
# ---------------------------------------------------------------------------

# a kind's chunks: temperature, limit
CHUNKS = {"decode": ((0.0, 3), (0.4, 3), (0.0, 3)),
          "verify": ((0.0, 6), (0.4, 9), (0.0, 16))}
STEP_CHUNK = 4


def _kind_state(kind, route, cache="bf16", seed=1, room=0, b=None):
    """A prefilled state of ``kind``: a GenState, or its SpecState."""
    if kind == "decode":
        return _state(params_of(route), route, cache, seed=seed,
                      max_len=P + 24 + room, b=b)
    return _spec(params_of(route), route, cache, seed=seed,
                 max_len=SPEC_ROOM + room, b=b)


def _kind_clone(kind, state):
    return _clone(state) if kind == "decode" else _spec_clone(state)


def _kind_chunk(kind, route, state, i, graphs=None):
    """Chunk ``i`` of ``state``, eager or through ``graphs``, at the
    temperature and limit of ``CHUNKS[kind][i % 3]``: decode steps, or
    verify rounds (``spec_k`` 4, a draft with matches). Returns its
    tokens."""
    params = params_of(route)
    temperature, limit = CHUNKS[kind][i % 3]
    if kind == "decode":
        return _steps(params, state, temperature, limit, graphs)
    return _chunk(params, state, _draft("matches", state.logits.shape[0]),
                  temperature, 4, limit, graphs)


def _kind_same(kind, got, ref, what=""):
    if kind == "verify":
        return _assert_same(got, ref, what)
    for name in ("logits", "forbid", "ring", "n_gen", "done", "aborted"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), \
            (name, what)
    assert got.step == ref.step and _same_cache(got.kv, ref.kv), what
    assert torch.equal(got.generator.get_state(),
                       ref.generator.get_state()), what


def _kind_count(kind, name):
    return _count(f"{'decode' if kind == 'decode' else 'spec'}.{name}")


def _count(name):
    return profiling.counters().get(name, 0)


@pytest.fixture(autouse=True)
def own_counters(monkeypatch):
    """The counters are the process's: each test here counts on copies,
    put back when it ends, so no other test sees what these counted."""
    monkeypatch.setattr(profiling, "_counts", dict(profiling._counts))
    for mod, name in dg.counts()[0]:
        monkeypatch.setattr(mod, name, getattr(mod, name))


def eager_capture_of(forward, device, pool=None, increments=({}, {}),
                     pools=None):
    """``decode_graph.capture`` as eager calls: the first runs now, each
    replay runs ``forward`` again, into the same output tensors where it
    returns some (a verify round returns none: it writes its buffers).
    Appends ``pool`` to ``pools``."""
    if pools is not None:
        pools.append(pool)
    out = forward()
    if out is None:
        return forward, None, increments, None
    out = {k: v.clone() for k, v in out.items()}

    def replay():
        for k, v in forward().items():
            out[k].copy_(v)
    return replay, out, increments, None


@pytest.fixture
def eager_capture(monkeypatch):
    """``decode_graph.capture`` replaced by :func:`eager_capture_of`;
    returns the memory pools the captures were given, in order."""
    pools = []
    monkeypatch.setattr(dg, "capture", functools.partial(eager_capture_of,
                                                         pools=pools))
    return pools


@pytest.mark.parametrize("route,cache", CASES)
def test_device_slot_step_is_the_int_slot_step(route, cache):
    params = params_of(route)
    ref = _state(params, route, cache)
    got = _clone(ref)
    assert ref.kv.head_major is (route == "mega" and cache == "bf16")
    for i in range(STEPS):
        emb = tq.embed_tokens(params, _tokens(ref, i))
        slot = P + i
        want, _ = parent_step(params, ref.kv, emb, slot, ref.prompt_len + i,
                              ref.valid_from, CFG)
        logits, kv = tq.qwen3_decode_step(
            params, got.kv, emb, torch.tensor([slot]), got.prompt_len + i,
            got.valid_from, CFG)
        assert kv is got.kv
        assert torch.equal(logits, want), i
        assert _same_cache(got.kv, ref.kv), i


@pytest.mark.parametrize("temperature", [0.0, 0.4])
@pytest.mark.parametrize("route", ROUTES)
def test_generate_chunk_is_unchanged(monkeypatch, route, temperature):
    params = params_of(route)
    ref = _state(params, route, "bf16", max_len=P + 48)
    got = _clone(ref)
    graphs = dg.DecodeGraphs()
    captures = _count("decode.graph_captures")
    toks = tg.generate_chunk(params, got, CFG, temperature, 1.0, 50,
                             chunk_len=40, stop_tokens=(7,), graphs=graphs)
    assert _count("decode.graph_captures") == captures and not graphs._graphs
    monkeypatch.setattr(tg, "qwen3_decode_step", parent_step)
    want = tg.generate_chunk(params, ref, CFG, temperature, 1.0, 50,
                             chunk_len=40, stop_tokens=(7,))
    assert torch.equal(toks, want)
    for name in ("done", "aborted", "ring", "n_gen", "logits"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert got.step == ref.step and _same_cache(got.kv, ref.kv)


GRAPH_CASES = ([("decode", r, c) for r, c in CASES]
               + [("verify", r, c) for r in ("int8", "q8_0", "q8i")
                  for c in ("bf16", "int8")])


def _graphed(kind, route, state, i, graphs):
    """:func:`_kind_chunk` through ``graphs``: (what it emitted, the calls
    of the graph: steps or rounds)."""
    calls = "decode.steps" if kind == "decode" else "spec.rounds"
    before = _count(calls)
    out = _kind_chunk(kind, route, state, i, graphs)
    return out, _count(calls) - before


@pytest.mark.parametrize("kind,route,cache", GRAPH_CASES)
def test_graph_chunks_are_eager_chunks(eager_capture, kind, route, cache):
    """Three chunks of one state through one graph (greedy, sampled,
    greedy), each equal to the eager chunk; the state owns the
    shared cache; one capture, and a replay a call but the verify
    capture's own round."""
    ref = _kind_state(kind, route, cache)
    got = _kind_clone(kind, ref)
    graphs = dg.DecodeGraphs()
    captures, replays = (_kind_count(kind, f"graph_{n}")
                         for n in ("captures", "replays"))
    calls = 0
    for i in range(3):
        want = _kind_chunk(kind, route, ref, i)
        toks, n = _graphed(kind, route, got, i, graphs)
        calls += n
        assert torch.equal(toks, want), i
        _kind_same(kind, got, ref, i)
    (graph,) = graphs._graphs.values()
    assert got.kv is graph.shared.kv
    assert _kind_count(kind, "graph_captures") == captures + 1
    assert _kind_count(kind, "graph_replays") == \
        replays + calls - (kind == "verify")


@pytest.mark.parametrize("kind", KINDS)
def test_no_state_field_is_a_graph_buffer_after_a_chunk(eager_capture,
                                                        kind):
    """After a chunk the state holds the shared cache and copies of what
    the graph keeps: another state's chunk through the same graph leaves
    every other field of it as it was."""
    graphs = dg.DecodeGraphs()
    a, b = (_kind_state(kind, "q8_0", seed=s) for s in (1, 2))
    _kind_chunk(kind, "q8_0", a, 0, graphs)
    (graph,) = graphs._graphs.values()
    assert a.kv is graph.shared.kv
    held = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)
            if isinstance(getattr(a, f.name), torch.Tensor)}
    kept = {n: t.clone() for n, t in held.items()}
    bufs = [t for t in vars(graph.bufs).values()
            if isinstance(t, torch.Tensor)]
    for name, t in held.items():
        assert all(t.untyped_storage().data_ptr()
                   != u.untyped_storage().data_ptr() for u in bufs), name
    _kind_chunk(kind, "q8_0", b, 1, graphs)
    assert b.kv is graph.shared.kv and a.kv is not b.kv
    for name, t in held.items():
        assert torch.equal(t, kept[name]), name


@pytest.mark.parametrize("kind", KINDS)
def test_second_live_state_keeps_its_own_cache(eager_capture, kind):
    """Two live states of one shape take turns through one graph: each
    stays equal to its own eager chunks, and the one not in turn holds a
    cache of its own."""
    refs = [_kind_state(kind, "q8_0", seed=s) for s in (1, 2)]
    states = [_kind_clone(kind, r) for r in refs]
    graphs = dg.DecodeGraphs()
    for turn, k in enumerate([0, 1, 0, 1]):
        want = _kind_chunk(kind, "q8_0", refs[k], turn)
        toks = _kind_chunk(kind, "q8_0", states[k], turn, graphs)
        assert torch.equal(toks, want), turn
        for s, r in zip(states, refs):
            _kind_same(kind, s, r, turn)
        (graph,) = graphs._graphs.values()
        assert states[k].kv is graph.shared.kv
        assert states[1 - k].kv is not states[k].kv
    assert len(graphs._graphs) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_state_holding_another_live_owners_cache_is_refused(eager_capture,
                                                            kind):
    """A state that shares its owner's cache is refused while the owner
    lives, before anything of either changes; once the owner is gone it
    goes on as the owner would have."""
    a = _kind_state(kind, "int8", "int8")
    graphs = dg.DecodeGraphs()
    _kind_chunk(kind, "int8", a, 0, graphs)
    twin = dataclasses.replace(a)           # shares a's (the graph's) cache
    with pytest.raises(ValueError, match="another live state"):
        _kind_chunk(kind, "int8", twin, 1, graphs)
    ref = _kind_clone(kind, a)
    del a
    gc.collect()
    toks = _kind_chunk(kind, "int8", twin, 1, graphs)   # the owner is gone
    assert torch.equal(toks, _kind_chunk(kind, "int8", ref, 1))
    _kind_same(kind, twin, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_least_recently_used_graph_goes_beyond_the_limit(monkeypatch,
                                                         eager_capture,
                                                         kind):
    monkeypatch.setattr(dg, "LIMIT", 2)
    states = [_kind_state(kind, "bf16", room=k) for k in range(3)]
    refs = [_kind_clone(kind, s) for s in states]
    graphs = dg.DecodeGraphs()
    captures = _kind_count(kind, "graph_captures")
    for i, k in enumerate([0, 1, 0, 2, 1, 0]):
        want = _kind_chunk(kind, "bf16", refs[k], i)
        toks = _kind_chunk(kind, "bf16", states[k], i, graphs)
        assert torch.equal(toks, want), i
        _kind_same(kind, states[k], refs[k], i)
        assert len(graphs._graphs) <= 2
    # 0, 1, (0 kept), 2 drops 1, 1 drops 0, 0 drops 2
    assert _kind_count(kind, "graph_captures") == captures + 5


@pytest.mark.parametrize("kind", KINDS)
def test_capture_increments_are_taken_back_and_added_per_replay(
        monkeypatch, kind):
    """``take_back`` undoes the counters' increments and returns them,
    ``add`` adds them again; a graph adds what its capture counted once a
    replay (a plain step's capture is followed by a replay, a verify
    capture's own round counts as it ran)."""
    before = dg.counts()
    tfd.launches += 3
    tfd.launches_i8 += 1
    profiling.count("test.graph", 2)
    up = dg.take_back(before)
    assert up == ({(tfd, "launches"): 3, (tfd, "launches_i8"): 1},
                  {"test.graph": 2})
    assert dg.counts()[0] == before[0]
    assert _count("test.graph") == before[1].get("test.graph", 0)
    dg.add(up)
    dg.add(up)
    assert tfd.launches == before[0][(tfd, "launches")] + 6
    assert tfd.launches_i8 == before[0][(tfd, "launches_i8")] + 2
    assert _count("test.graph") == before[1].get("test.graph", 0) + 4

    monkeypatch.setattr(dg, "capture", functools.partial(
        eager_capture_of, increments=({(tfd, "launches"): 3},
                                      {"test.graph": 2})))
    state = _kind_state(kind, "bf16")
    launches, named = tfd.launches, _count("test.graph")
    replays = _kind_count(kind, "graph_replays")
    _, calls = _graphed(kind, "bf16", state, 0, dg.DecodeGraphs())
    replayed = _kind_count(kind, "graph_replays") - replays
    assert replayed == calls - (kind == "verify") > 0
    assert tfd.launches == launches + 3 * replayed
    assert _count("test.graph") == named + 2 * replayed


@pytest.mark.parametrize("kind", KINDS)
def test_second_request_captures_nothing(eager_capture, kind):
    graphs = dg.DecodeGraphs()
    for req in range(2):
        state = _kind_state(kind, "q8_0", seed=1 + req)
        captures, replays = (_kind_count(kind, f"graph_{n}")
                             for n in ("captures", "replays"))
        _, calls = _graphed(kind, "q8_0", state, 1, graphs)
        captured = _kind_count(kind, "graph_captures") - captures
        assert captured == (1 if req == 0 else 0)
        assert _kind_count(kind, "graph_replays") - replays == \
            calls - (captured if kind == "verify" else 0)


@pytest.mark.parametrize("temperature", [0.0, 0.4])
@pytest.mark.parametrize("kind", KINDS)
def test_spec_to_gen_hands_its_cache_over(eager_capture, kind, temperature):
    """Rounds, ``spec_to_gen``, then chunks of decode steps through the
    layout's decode graph, each equal to eager steps. The rounds run
    eagerly (``decode``: the decode graph takes the converted state's
    cache by a copy) or through the layout's verify graph (``verify``: the
    plain carry holds the shared cache from the rounds on, with no
    copy)."""
    params = params_of("q8_0")
    spec = _spec(params, "q8_0", b=1)
    graphs = dg.DecodeGraphs()
    _chunk(params, spec, _draft("matches", b=1), temperature, 4, 6,
           graphs if kind == "verify" else None)
    kv = spec.kv
    got = tsp.spec_to_gen(spec)
    assert spec.kv is None and got.kv is kv and got.step > 0
    ref = _clone(got)
    for i in range(3):
        want = _kind_chunk("decode", "q8_0", ref, i)
        assert torch.equal(_kind_chunk("decode", "q8_0", got, i, graphs),
                           want), i
        _kind_same("decode", got, ref, i)
    graph = graphs._graphs[next(reversed(graphs._graphs))]
    assert got.kv is graph.shared.kv
    assert (got.kv is kv) is (kind == "verify")
    assert len(graphs._graphs) == (2 if kind == "verify" else 1)


def test_plain_and_verify_graphs_of_a_layout_share_cache_and_pool(
        eager_capture):
    """A verify chunk, ``spec_to_gen``, a decode chunk: the layout's two
    graphs read and write one cache and capture into one memory pool."""
    params = params_of("q8_0")
    spec = _spec(params, "q8_0", b=1)
    graphs = dg.DecodeGraphs()
    draft = _draft("matches", b=1)
    verify = tsp.round_graph(graphs, params, CFG, spec, draft, 50, 4, CHUNK,
                             STOPS)
    verify.shared.pool = pool = object()
    tsp.run_rounds(params, spec, draft, CFG, 0.4, 1.0, 50, 4, CHUNK, STOPS,
                   6, verify)
    gen = tsp.spec_to_gen(spec)
    _kind_chunk("decode", "q8_0", gen, 0, graphs)
    assert list(graphs._graphs.values())[0] is verify
    decode = list(graphs._graphs.values())[1]
    assert decode.shared is verify.shared
    assert decode.bufs.kv is verify.bufs.kv is verify.shared.kv is gen.kv
    assert eager_capture == [pool, pool]


def test_engine_cache_holds_whole_blocks_of_output_slots():
    from fun_asr_gguf_tpu_torch.core.model_manager import (KV_BLOCK,
                                                           ModelManager)
    from fun_asr_gguf_tpu_torch.datatypes import ASREngineConfig
    lens = {}
    for n_predict in (19, 80, 252, 256, 257):
        m = ModelManager(ASREngineConfig(n_predict=n_predict,
                                         prefill_buckets=(16,)),
                         torch.device("cpu"))
        m.hybrid_cfg = types.SimpleNamespace(llm=CFG)
        m.llm_params = params_of("bf16")
        state = m.prefill(np.zeros((10, CFG.hidden), np.float32), 0)
        lens[n_predict] = state.kv.max_len
    headroom = ASREngineConfig().spec_k + 1
    assert lens[19] == lens[80] == lens[252] == lens[256] == \
        16 + KV_BLOCK + headroom
    assert lens[257] == 16 + 2 * KV_BLOCK + headroom
