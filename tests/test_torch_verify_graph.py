"""The verify round with its draws and scalars on the device, and the CUDA
graph that replays it (``fun_asr_gguf_tpu_torch.models.speculative``), on
the CPU.

* The round, fed uniforms drawn beforehand and ``limit``, temperature and
  ``top_p`` as device scalars, gives bit for bit the tokens, carry (logits,
  forbid, cursor, ring, n_gen, done, aborted, slots, ...), cache and
  generator state of the round it replaced (kept here as the reference):
  greedy and at T = 0.3, 0.4 and 0.7, ``spec_k`` 0 and 8, ``limit`` 1, 16
  and 64, left-padded rows, a draft with matches and an all -1 draft; and
  on dense bf16, per-channel int8, fused q8_0 (K4) and int8-dot (q8i)
  params over bf16 and int8 caches.
* :func:`sample_drawn` with device scalars draws what ``sample_residual``
  draws from the same generator.
* Through :class:`DecodeGraphs`, with the capture replaced by eager calls
  (the CPU has no CUDA graphs): rounds equal eager rounds, greedy and
  sampled through one graph; a second request captures nothing; the
  counters' increments of a capture are added per replay; ``spec_to_gen``
  leaves the decode graph of the layout the shared cache, with no copy; a
  second live state keeps its own cache; a state holding the cache that
  another live state owns is refused; the least recently used graph goes
  beyond the limit.

The card tests (``tests/test_torch_cuda.py``) hold real replays to eager
rounds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fun_asr_gguf_tpu_torch import profiling
from fun_asr_gguf_tpu_torch.models import decode_graph as dg
from fun_asr_gguf_tpu_torch.models import generate as tg
from fun_asr_gguf_tpu_torch.models import qwen3 as tq
from fun_asr_gguf_tpu_torch.models import speculative as tsp
from fun_asr_gguf_tpu_torch.ops import flash_decode as tfd
from fun_asr_gguf_tpu_torch.ops import sampling as tsamp

from test_torch_decode_graph import (CFG, P, _clone, _same_cache, _state,
                                     eager_capture, eager_step, own_counters,
                                     params_of)

STOPS = (7,)
CHUNK = 64
SPEC_ROOM = P + CHUNK + 9 + 16      # a chunk, a round's rows and more


def _count(name):
    return profiling.counters().get(name, 0)


# ---------------------------------------------------------------------------
# the round as it was: a generator inside, Python numbers baked in
# ---------------------------------------------------------------------------

def _parent_top_candidates(logits, top_p, top_k):
    v = logits.shape[-1]
    k = min(top_k, v) if top_k > 0 else v
    vals, idx = torch.topk(logits, k, dim=-1)
    p1 = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(p1, dim=-1)
    keep = (cum - p1) < top_p
    keep[..., 0] = True
    return (torch.where(keep, vals, torch.full_like(vals, tsamp.NEG_INF)),
            idx, keep)


def parent_warped(logits, temperature, top_p, top_k):
    logits = logits.to(torch.float32)
    masked, idx, keep = _parent_top_candidates(logits, top_p, top_k)
    probs = torch.softmax(masked / max(temperature, 1e-6), dim=-1)
    return torch.where(keep, probs, torch.zeros_like(probs)), idx


def parent_sample_residual(logits, generator, temperature, top_p, top_k=50,
                           forbid=None):
    logits = logits.to(torch.float32)
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    masked, idx, _ = _parent_top_candidates(logits, top_p, top_k)
    if forbid is not None:
        masked = torch.where(idx == forbid[:, None],
                             torch.full_like(masked, tsamp.NEG_INF), masked)
    t = max(temperature, 1e-6)
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    choice = torch.argmax(masked / t + gumbel, dim=-1)
    return torch.gather(idx, 1, choice[:, None])[:, 0]


def parent_chunk(params, state, draft_ids, cfg, temperature, top_p, top_k=50,
                 spec_k=8, chunk_len=64, stop_tokens=STOPS, limit=None):
    """``spec_generate_chunk`` before the round took its draws and scalars
    from outside."""
    b = state.logits.shape[0]
    dev = state.logits.device
    greedy = temperature <= 0
    limit = chunk_len if limit is None else min(limit, chunk_len)
    buf = torch.full((b, chunk_len + 1), -1, dtype=torch.int64, device=dev)
    sink = chunk_len
    stops = torch.tensor(stop_tokens, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    lanes = torch.arange(spec_k + 1, device=dev)
    t_next = torch.zeros(b, dtype=torch.int64, device=dev)
    draft_ids = draft_ids.to(device=dev, dtype=torch.int64)
    while True:
        active = ~state.done & (t_next < limit)
        if not bool(active.any()):
            break
        pending = parent_sample_residual(state.logits, state.generator,
                                         temperature, top_p, top_k,
                                         state.forbid)
        pend_stop = torch.isin(pending, stops)
        d_tok, d_valid, start, _ = tsp._lookup_draft(
            draft_ids, state.last_tok, pending, state.cursor, spec_k)
        d_valid &= (active & ~pend_stop)[:, None]
        d_valid &= torch.cumprod(
            (~torch.isin(d_tok, stops)).to(torch.int64), dim=1).bool()
        d_valid &= (t_next[:, None] + lanes[None, 1:]) < limit
        tok_seq = torch.cat([pending[:, None], d_tok], dim=1)
        emb = tq.embed_tokens(params, tok_seq)
        logits_v, state.kv = tq.qwen3_verify_step(
            params, state.kv, emb, state.slot_next,
            state.pos_next[:, None] + lanes[None, :], state.valid_from, cfg)
        score = logits_v[:, :spec_k, :]
        if greedy:
            acc = torch.argmax(score, dim=-1) == d_tok
        else:
            probs, idx = parent_warped(score, temperature, top_p, top_k)
            p_d = torch.where(idx == d_tok[:, :, None], probs,
                              torch.zeros_like(probs)).sum(dim=-1)
            u = torch.rand(p_d.shape, generator=state.generator, device=dev)
            acc = u < p_d
        acc &= d_valid
        a = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)
        if spec_k == 0:
            forbid = torch.where(active, -1, state.forbid)
        else:
            rej_i = a.clamp(0, spec_k - 1)[:, None]
            rej_was_valid = torch.gather(d_valid, 1, rej_i)[:, 0] & \
                (a < spec_k) & (not greedy)
            forbid = torch.where(
                active, torch.where(
                    rej_was_valid, torch.gather(d_tok, 1, rej_i)[:, 0], -1),
                state.forbid)
        state.logits = torch.where(active[:, None], logits_v[rows, a],
                                   state.logits)
        state.forbid = forbid
        n_emit = torch.where(active, 1 + a, 0)
        emit = active[:, None] & (lanes[None, :] < n_emit[:, None])
        cols = torch.where(emit, t_next[:, None] + lanes[None, :], sink)
        buf[rows[:, None], cols] = tok_seq
        buf[:, sink] = -1
        fused = torch.zeros(b, dtype=torch.bool, device=dev)
        for i in range(spec_k + 1):
            tok = tok_seq[:, i]
            counted = emit[:, i] & ~torch.isin(tok, stops)
            pos = state.n_gen % tg.RING
            state.ring[rows, pos] = torch.where(counted, tok,
                                                state.ring[rows, pos])
            state.n_gen = state.n_gen + counted.to(torch.int64)
            fused |= counted & (state.n_gen > tg.RING) & \
                (tg._distinct_count(state.ring) <= tg.FUSE_DISTINCT)
        state.done = state.done | (active & pend_stop) | fused
        state.aborted = state.aborted | fused
        state.slot_next = state.slot_next + n_emit
        state.pos_next = state.pos_next + n_emit
        t_next = t_next + n_emit
        last = torch.gather(tok_seq, 1,
                            (n_emit - 1).clamp(0, spec_k)[:, None])
        state.last_tok = torch.where(active, last[:, 0], state.last_tok)
        state.cursor = torch.where(active, start + a, state.cursor)
        state.rounds = state.rounds + active.to(torch.int64)
    return buf[:, :chunk_len]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

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
    graph = None if graphs is None else tsp.verify_graph(
        graphs, params, state, draft, CFG, top_k, spec_k, chunk_len, STOPS)
    return tsp.run_rounds(params, state, draft, CFG, temperature, 1.0, top_k,
                          spec_k, chunk_len, STOPS, limit, graph)


# ---------------------------------------------------------------------------
# the round against the parent's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["matches", "none"])
@pytest.mark.parametrize("limit", [1, 16, 64])
@pytest.mark.parametrize("spec_k", [0, 8])
@pytest.mark.parametrize("temperature", [0.0, 0.3, 0.4, 0.7])
def test_round_is_the_parent_round(temperature, spec_k, limit, draft):
    params = params_of("bf16")
    ref = _spec(params, "bf16")
    got = _spec_clone(ref)
    assert int(ref.valid_from[1]) == 3           # a left-padded row
    d = _draft(draft)
    want = parent_chunk(params, ref, d, CFG, temperature, 1.0,
                        spec_k=spec_k, chunk_len=CHUNK, limit=limit)
    toks = tsp.spec_generate_chunk(params, got, d, CFG, temperature, 1.0, 50,
                                   spec_k=spec_k, chunk_len=CHUNK,
                                   stop_tokens=STOPS, limit=limit)
    assert torch.equal(toks, want)
    assert int(got.rounds.max()) >= 1
    _assert_same(got, ref)


@pytest.mark.parametrize("temperature", [0.0, 0.4])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("route", ["bf16", "int8", "q8_0", "q8i"])
def test_round_is_the_parent_round_on_every_route(route, cache, temperature):
    params = params_of(route)
    ref = _spec(params, route, cache)
    got = _spec_clone(ref)
    d = _draft("matches")
    for limit in (5, 16):                       # two chunks
        want = parent_chunk(params, ref, d, CFG, temperature, 1.0,
                            spec_k=4, chunk_len=16, limit=limit)
        toks = tsp.spec_generate_chunk(params, got, d, CFG, temperature,
                                       1.0, 50, spec_k=4, chunk_len=16,
                                       stop_tokens=STOPS, limit=limit)
        assert torch.equal(toks, want), limit
        _assert_same(got, ref, limit)


@pytest.mark.parametrize("top_p", [0.9, 1.0])
@pytest.mark.parametrize("temperature", [0.3, 0.4, 0.7, 1.0])
def test_sample_drawn_with_device_scalars_is_sample_residual(temperature,
                                                             top_p):
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        size=(5, 300)).astype(np.float32) * 3.0)
    forbid = torch.tensor([-1, 4, 17, -1, 250])
    for seed in range(3):
        want = tsamp.sample_residual(
            logits, torch.Generator().manual_seed(seed), temperature, top_p,
            40, forbid)
        u = torch.rand((5, tsamp.candidates(300, 40)),
                       generator=torch.Generator().manual_seed(seed))
        got = tsamp.sample_drawn(logits, u, torch.tensor(temperature),
                                 torch.tensor(top_p), 40, forbid)
        assert torch.equal(got, want), seed
    probs, idx = tsamp.warped_candidates(logits, temperature, top_p, 40)
    p2, i2 = tsamp.warped_candidates(logits, torch.tensor(temperature),
                                     torch.tensor(top_p), 40)
    assert torch.equal(probs, p2) and torch.equal(idx, i2)


# ---------------------------------------------------------------------------
# the graph's bookkeeping, with the capture replaced by eager calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("route", ["int8", "q8_0", "q8i"])
def test_graph_rounds_are_eager_rounds(eager_capture, route, cache):
    """Greedy, then sampled, then greedy chunks of one state through one
    graph: each equal to the eager rounds."""
    params = params_of(route)
    ref = _spec(params, route, cache)
    got = _spec_clone(ref)
    graphs = dg.DecodeGraphs()
    rounds, captures, replays = (_count(f"spec.{n}") for n in (
        "rounds", "graph_captures", "graph_replays"))
    for temperature, limit in ((0.0, 6), (0.4, 9), (0.0, 16)):
        want = _chunk(params, ref, _draft("matches"), temperature, 4, limit)
        toks = _chunk(params, got, _draft("matches"), temperature, 4, limit,
                      graphs)
        assert torch.equal(toks, want), temperature
        _assert_same(got, ref, temperature)
    (graph,) = graphs._graphs.values()
    assert got.kv is graph.shared.kv
    ran = (_count("spec.rounds") - rounds) // 2
    assert _count("spec.graph_captures") == captures + 1
    assert _count("spec.graph_replays") == replays + ran - 1


def test_second_request_captures_nothing(eager_capture):
    params = params_of("q8_0")
    graphs = dg.DecodeGraphs()
    for req in range(2):
        state = _spec(params, "q8_0", seed=1 + req)
        before = profiling.counters()
        _chunk(params, state, _draft("none"), 0.4, 8, 16, graphs)
        now = profiling.counters()
        grew = {k: now.get(k, 0) - before.get(k, 0) for k in (
            "spec.rounds", "spec.graph_replays", "spec.graph_captures")}
        assert grew["spec.rounds"] == 16
        assert grew["spec.graph_captures"] == (1 if req == 0 else 0)
        assert grew["spec.graph_replays"] == (15 if req == 0 else 16)


def test_capture_increments_are_added_per_replay(monkeypatch):
    """What the capture counted of one round is taken back there and added
    at every replay; the capture's own eager round counts as it ran."""
    def capture(forward, device, pool=None):
        forward()
        return forward, None, ({(tfd, "launches"): 3},
                               {"test.verify_graph": 2}), None
    monkeypatch.setattr(tsp, "capture", capture)
    params = params_of("bf16")
    state = _spec(params, "bf16")
    graphs = dg.DecodeGraphs()
    launches = tfd.launches
    _chunk(params, state, _draft("none"), 0.0, 4, 10, graphs)
    assert int(state.rounds[0]) == 10
    assert tfd.launches == launches + 3 * 9
    assert _count("test.verify_graph") == 2 * 9


@pytest.mark.parametrize("temperature", [0.0, 0.4])
def test_spec_to_gen_leaves_the_decode_graph_its_cache(eager_capture,
                                                       temperature):
    """Rounds through the layout's verify graph, ``spec_to_gen``, then
    decode steps through its decode graph: the plain carry holds the
    shared cache from the rounds on, with no copy, and each step equals
    an eager step."""
    params = params_of("q8_0")
    spec = _spec(params, "q8_0", b=1)
    graphs = dg.DecodeGraphs()
    _chunk(params, spec, _draft("matches", b=1), temperature, 4, 6, graphs)
    (vgraph,) = graphs._graphs.values()
    shared = vgraph.shared
    got = tsp.spec_to_gen(spec)
    assert spec.kv is None and got.kv is shared.kv and got.step > 0
    ref = _clone(got)
    for i in range(8):
        tok = torch.tensor([3 + i])
        eager_step(params, ref, tok)
        graphs.step(params, got, tok, CFG)
        got.step += 1
        assert got.kv is shared.kv, i
        assert torch.equal(got.logits, ref.logits), i
        assert _same_cache(got.kv, ref.kv), i
    assert len(graphs._graphs) == 2


def test_second_live_state_keeps_its_own_cache(eager_capture):
    params = params_of("q8_0")
    refs = [_spec(params, "q8_0", seed=s) for s in (1, 2)]
    states = [_spec_clone(r) for r in refs]
    graphs = dg.DecodeGraphs()
    for turn, k in enumerate([0, 1, 0, 1]):
        temperature = (0.0, 0.4)[k]
        want = _chunk(params, refs[k], _draft("matches"), temperature, 4, 5)
        toks = _chunk(params, states[k], _draft("matches"), temperature, 4,
                      5, graphs)
        assert torch.equal(toks, want), turn
        for s, r in zip(states, refs):
            _assert_same(s, r, turn)
        assert states[1 - k].kv is not states[k].kv
    assert len(graphs._graphs) == 1


def test_state_holding_another_live_owners_cache_is_refused(eager_capture):
    params = params_of("int8")
    a = _spec(params, "int8")
    graphs = dg.DecodeGraphs()
    _chunk(params, a, _draft("none"), 0.0, 4, 2, graphs)
    twin = dataclasses.replace(a)           # shares a's (the graphs') cache
    with pytest.raises(ValueError, match="another live state"):
        _chunk(params, twin, _draft("none"), 0.0, 4, 2, graphs)


def test_least_recently_used_graph_goes_beyond_the_limit(monkeypatch,
                                                         eager_capture):
    monkeypatch.setattr(dg, "LIMIT", 2)
    params = params_of("bf16")
    states = [_spec(params, "bf16", max_len=SPEC_ROOM + k) for k in range(3)]
    refs = [_spec_clone(s) for s in states]
    graphs = dg.DecodeGraphs()
    captures = _count("spec.graph_captures")
    for i, k in enumerate([0, 1, 0, 2, 1, 0]):
        want = _chunk(params, refs[k], _draft("none"), 0.4, 4, 2)
        toks = _chunk(params, states[k], _draft("none"), 0.4, 4, 2, graphs)
        assert torch.equal(toks, want), i
        _assert_same(states[k], refs[k], i)
        assert len(graphs._graphs) <= 2
    # 0, 1, (0 kept), 2 drops 1, 1 drops 0, 0 drops 2
    assert _count("spec.graph_captures") == captures + 5
