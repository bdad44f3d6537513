"""CTC-draft speculative decoding (``fun_asr_gguf_tpu/models/speculative.py``).

The CTC head's transcript predicts the LLM's output, and a verify pass over
``spec_k + 1`` tokens (:func:`.qwen3.qwen3_verify_step`) streams the same
weight bytes as one decode step. Each round draws the pending token (what
the plain loop would draw now), proposes the ``spec_k`` draft tokens that
follow it in the tokenized CTC text (prompt-lookup: bigram, then unigram,
the match nearest a monotone cursor; :func:`_lookup_draft` :137), verifies
all of them in one pass and emits the pending token plus the accepted
prefix.

Acceptance is distribution-preserving (Leviathan et al., with a
deterministic draft): at temperature 0 a draft token is accepted while it
equals the argmax, so the output is the plain greedy loop's token for
token; at T > 0 draft ``d`` is accepted with probability p(d) under the
top-k → top-p → temperature distribution, and on rejection ``d`` is
excluded from the next draw (the residual distribution). Stop ids, the
repetition fuse (checked per emitted token), the ``limit`` budget and the
``rounds`` counter behave as in JAX.

JAX's ``lax.while_loop`` over rounds (:258-262) becomes a host loop over
verify rounds on device tensors with a ``torch.Generator``: the loop test
reads one flag per round on the host (a device sync per round), which at
batch 1 is the accepted count's only trip to the host. The host draws the
round's uniforms from the generator before the round (the pending draw's
[B, top_k], then acceptance's [B, spec_k]; a greedy round draws nothing),
and the temperature, ``top_p`` and ``limit`` are device scalars, so the
round itself (:func:`_round`) reads no value on the host.

On a card the round is one replay of a CUDA graph (:class:`VerifyGraph`),
kept by the engine's :class:`.decode_graph.DecodeGraphs` beside the decode
graph of the same cache layout, whose cache and memory pool it shares; it
is keyed by what fixes its shapes (``spec_k``, ``top_k``, ``chunk_len``,
the draft's length, the stop ids). Greedy and sampled rounds are one graph:
the round takes the argmax where the temperature is <= 0, on the device.
The graph copies the state's carry into buffers of its own at a chunk's
start and hands copies back at its end. The CPU runs the same round
eagerly. Each round is a ``spec.round`` span (``..profiling``) of
``spec.sync`` (that read) and ``spec.forward``: on the CPU the verify
pass, beside ``spec.draft`` and ``spec.accept``; on the card the replay,
which holds all three.
Counters ``spec.rounds``, ``spec.graph_captures`` and
``spec.graph_replays``.
"""

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from ..ops.sampling import candidates, sample_drawn, warped_candidates
from ..profiling import count, span
from .decode_graph import DecodeGraphs, add, capture
from .generate import (FUSE_DISTINCT, RING, GenState, _distinct_count)
from .qwen3 import KVCache, embed_tokens, qwen3_verify_step

NEG_BIG = 2 ** 30


@dataclass
class SpecState:
    """Speculative carry (persists across chunks)."""
    kv: KVCache
    logits: torch.Tensor       # [B, V] f32 — next-token logits
    forbid: torch.Tensor       # [B] int64 — rejected draft id to exclude (-1)
    prompt_len: torch.Tensor   # [B] int64
    valid_from: torch.Tensor   # [B] int64
    slot_next: torch.Tensor    # [B] int64 — next free KV slot
    pos_next: torch.Tensor     # [B] int64 — rope position of the next token
    generator: torch.Generator
    ring: torch.Tensor         # [B, RING] int64
    n_gen: torch.Tensor        # [B] int64 — counted (non-stop) tokens
    done: torch.Tensor         # [B] bool
    aborted: torch.Tensor      # [B] bool
    last_tok: torch.Tensor     # [B] int64 — last emitted token (-1 at start)
    cursor: torch.Tensor       # [B] int64 — draft cursor (match tie-break)
    rounds: torch.Tensor       # [B] int64 — verify rounds run
    prompt_slots: int          # P


def spec_init(state: GenState) -> SpecState:
    """A :func:`.generate.prefill_init` state → the speculative carry."""
    b = state.logits.shape[0]
    dev = state.logits.device
    return SpecState(
        kv=state.kv, logits=state.logits, forbid=state.forbid,
        prompt_len=state.prompt_len, valid_from=state.valid_from,
        slot_next=torch.full((b,), state.prompt_slots + state.step,
                             dtype=torch.int64, device=dev),
        pos_next=state.prompt_len + state.step, generator=state.generator,
        ring=state.ring, n_gen=state.n_gen, done=state.done,
        aborted=state.aborted,
        last_tok=torch.full((b,), -1, dtype=torch.int64, device=dev),
        cursor=torch.zeros(b, dtype=torch.int64, device=dev),
        rounds=torch.zeros(b, dtype=torch.int64, device=dev),
        prompt_slots=state.prompt_slots)


def spec_to_gen(state: SpecState) -> GenState:
    """The speculative carry → the plain-decode carry (the acceptance
    guardrail's switch). GenState keeps one host step counter, so every
    row must sit at the same slot (true at batch 1). A pending ``forbid``
    rides along: the plain chunk's first draw consumes it. The cache
    moves: ``state.kv`` becomes None, so the plain carry is its one
    holder (:class:`.decode_graph.SharedCache`)."""
    count("host.syncs")
    slot = state.slot_next.tolist()
    if any(s != slot[0] for s in slot):
        raise ValueError(f"spec_to_gen requires uniform row slots (got "
                         f"{slot})")
    kv, state.kv = state.kv, None
    return GenState(
        kv=kv, logits=state.logits, prompt_len=state.prompt_len,
        valid_from=state.valid_from, step=slot[0] - state.prompt_slots,
        generator=state.generator, ring=state.ring, n_gen=state.n_gen,
        done=state.done, aborted=state.aborted,
        prompt_slots=state.prompt_slots, forbid=state.forbid)


def _lookup_draft(draft, last_tok, pending, cursor, spec_k: int):
    """Prompt-lookup proposal: the continuation of (last_tok, pending) in
    ``draft [B, D]`` (-1 padded). Returns (d_tok [B, K] safe ids, d_valid
    [B, K] cumulative validity, start [B], has [B]). The bigram match is
    preferred, then the unigram; among matches the one nearest ``cursor``
    wins (first index on ties). With no match the monotone continuation
    ``draft[cursor + 1:]`` is proposed: the verify lanes are paid for
    either way."""
    b, d = draft.shape
    dev = draft.device
    idx = torch.arange(d - 1, device=dev)[None, :]
    m2 = ((draft[:, :-1] == last_tok[:, None])
          & (draft[:, 1:] == pending[:, None]) & (draft[:, :-1] >= 0))
    has2 = m2.any(dim=1)
    score2 = torch.where(m2, -(idx - cursor[:, None]).abs(),
                         torch.full_like(idx, -NEG_BIG))
    best2 = torch.argmax(score2, dim=1) + 2

    idx1 = torch.arange(d, device=dev)[None, :]
    m1 = (draft == pending[:, None]) & (draft >= 0)
    has1 = m1.any(dim=1)
    score1 = torch.where(m1, -(idx1 - cursor[:, None]).abs(),
                         torch.full_like(idx1, -NEG_BIG))
    best1 = torch.argmax(score1, dim=1) + 1

    start = torch.where(has2, best2, torch.where(has1, best1, cursor + 1))
    cols = start[:, None] + torch.arange(spec_k, device=dev)[None, :]
    gathered = torch.gather(draft, 1, cols.clamp(0, d - 1))
    valid = (cols < d) & (cols >= 0) & (gathered >= 0)
    d_valid = torch.cumprod(valid.to(torch.int64), dim=1).bool()
    d_tok = torch.where(d_valid, gathered, torch.zeros_like(gathered))
    return d_tok, d_valid, start, has2 | has1


def _round(params, st: SpecState, draft, t_next, buf, u_pend, u_acc, limit,
           temperature, top_p, top_k: int, spec_k: int, stops, cfg,
           phase=span) -> torch.Tensor:
    """One verify round of every row of ``st``: pending draw, draft,
    verify pass, acceptance, emission, ring and fuse, advance. Rebinds
    ``st``'s fields, writes ``st.kv``, ``st.ring`` and ``buf`` [B,
    chunk_len + 1] in place, and returns the new ``t_next`` (tokens
    emitted in the chunk). ``u_pend`` [B, candidates] and ``u_acc`` [B,
    spec_k] are the round's uniforms; ``limit``, ``temperature`` and
    ``top_p`` are device scalars (rows are greedy where the temperature is
    <= 0). Reads nothing on the host, so a CUDA graph can capture it;
    ``phase`` names its three parts (a span each on the eager path)."""
    b = st.logits.shape[0]
    dev = st.logits.device
    sink = buf.shape[1] - 1                 # column for non-emitted lanes
    rows = torch.arange(b, device=dev)
    lanes = torch.arange(spec_k + 1, device=dev)
    greedy = temperature <= 0
    active = ~st.done & (t_next < limit)
    with phase("spec.draft"):
        # 1. pending: the token the plain loop would draw now (from the
        #    residual distribution after a rejected draft)
        pending = torch.where(
            greedy, torch.argmax(st.logits.to(torch.float32), dim=-1),
            sample_drawn(st.logits, u_pend, temperature, top_p, top_k,
                         st.forbid))
        pend_stop = torch.isin(pending, stops)

        # 2. draft proposal; no speculation past a stop, for paused rows
        #    or past the budget; a stop id inside the draft ends it
        d_tok, d_valid, start, _ = _lookup_draft(
            draft, st.last_tok, pending, st.cursor, spec_k)
        d_valid &= (active & ~pend_stop)[:, None]
        d_valid &= torch.cumprod(
            (~torch.isin(d_tok, stops)).to(torch.int64), dim=1).bool()
        d_valid &= (t_next[:, None] + lanes[None, 1:]) < limit

    with phase("spec.forward"):
        # 3. one verify pass over [pending, d_1 .. d_K]
        tok_seq = torch.cat([pending[:, None], d_tok], dim=1)
        emb = embed_tokens(params, tok_seq)
        logits_v, st.kv = qwen3_verify_step(
            params, st.kv, emb, st.slot_next,
            st.pos_next[:, None] + lanes[None, :], st.valid_from, cfg)

    with phase("spec.accept"):
        # 4. acceptance of each drafted token, then the accepted prefix
        score = logits_v[:, :spec_k, :]
        probs, idx = warped_candidates(score, temperature, top_p, top_k)
        p_d = torch.where(idx == d_tok[:, :, None], probs,
                          torch.zeros_like(probs)).sum(dim=-1)
        acc = torch.where(greedy, torch.argmax(score, dim=-1) == d_tok,
                          u_acc < p_d)
        acc &= d_valid
        a = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)

        # a probabilistic rejection excludes that id from the next draw;
        # validity and budget rejections resample unconstrained
        if spec_k == 0:
            forbid = torch.where(active, -1, st.forbid)
        else:
            rej_i = a.clamp(0, spec_k - 1)[:, None]
            rej_was_valid = torch.gather(d_valid, 1, rej_i)[:, 0] & \
                (a < spec_k) & ~greedy
            forbid = torch.where(
                active, torch.where(
                    rej_was_valid, torch.gather(d_tok, 1, rej_i)[:, 0], -1),
                st.forbid)

        # 5. next logits: after the last consumed token (lane a)
        st.logits = torch.where(active[:, None], logits_v[rows, a],
                                st.logits)
        st.forbid = forbid

        # 6. emit pending + accepted drafts
        n_emit = torch.where(active, 1 + a, 0)
        emit = active[:, None] & (lanes[None, :] < n_emit[:, None])
        cols = torch.where(emit, t_next[:, None] + lanes[None, :], sink)
        buf[rows[:, None], cols] = tok_seq
        buf[:, sink] = -1

        # 7. ring, counters and the fuse, per emitted token
        fused = torch.zeros(b, dtype=torch.bool, device=dev)
        for i in range(spec_k + 1):
            tok = tok_seq[:, i]
            counted = emit[:, i] & ~torch.isin(tok, stops)
            pos = st.n_gen % RING
            st.ring[rows, pos] = torch.where(counted, tok,
                                             st.ring[rows, pos])
            st.n_gen = st.n_gen + counted.to(torch.int64)
            fused |= counted & (st.n_gen > RING) & \
                (_distinct_count(st.ring) <= FUSE_DISTINCT)
        st.done = st.done | (active & pend_stop) | fused
        st.aborted = st.aborted | fused

        # 8. advance (pending and accepted drafts all entered the cache)
        st.slot_next = st.slot_next + n_emit
        st.pos_next = st.pos_next + n_emit
        last = torch.gather(tok_seq, 1,
                            (n_emit - 1).clamp(0, spec_k)[:, None])
        st.last_tok = torch.where(active, last[:, 0], st.last_tok)
        st.cursor = torch.where(active, start + a, st.cursor)
        st.rounds = st.rounds + active.to(torch.int64)
    return t_next + n_emit


# the carry a round reads and writes; valid_from it only reads
CARRY = ("logits", "forbid", "slot_next", "pos_next", "ring", "n_gen",
         "done", "aborted", "last_tok", "cursor", "rounds")


class VerifyGraph:
    """One captured verify round and its buffers (the module's doc): the
    carry, the draft, ``t_next``, the token buffer, the round's uniforms
    and the device scalars, all made outside the graphs' pool, and the
    cache of its :class:`.decode_graph.SharedCache`. Its first round runs
    eagerly and is captured (:func:`.decode_graph.capture`); every later
    round is a replay."""

    def __init__(self, params, cfg, shared, state, draft_len: int,
                 top_k: int, spec_k: int, chunk_len: int, stop_tokens):
        b, vocab = state.logits.shape
        dev = state.logits.device
        self.params, self.cfg, self.shared = params, cfg, shared
        self.top_k, self.spec_k = top_k, spec_k
        self.carry = dataclasses.replace(
            state, kv=shared.kv, valid_from=torch.empty_like(
                state.valid_from),
            **{n: torch.empty_like(getattr(state, n)) for n in CARRY})
        self.draft = torch.empty((b, draft_len), dtype=torch.int64,
                                 device=dev)
        self.t_next = torch.zeros(b, dtype=torch.int64, device=dev)
        self.buf = torch.empty((b, chunk_len + 1), dtype=torch.int64,
                               device=dev)
        self.limit = torch.zeros((), dtype=torch.int64, device=dev)
        self.temperature, self.top_p = (
            torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(2))
        self.u_pend = torch.zeros((b, candidates(vocab, top_k)),
                                  device=dev)
        self.u_acc = torch.zeros((b, spec_k), device=dev)
        self.stops = torch.tensor(stop_tokens, dtype=torch.int64,
                                  device=dev)
        self._replay = self._increments = self._keep = None

    def begin(self, state, draft_ids, limit: int, temperature: float,
              top_p: float):
        """A chunk's start: ``state`` takes the shared cache, its carry,
        the draft and the chunk's scalars go into the graph's buffers."""
        self.shared.adopt(state)
        for n in CARRY + ("valid_from",):
            getattr(self.carry, n).copy_(getattr(state, n))
        self.draft.copy_(draft_ids)
        self.t_next.zero_()
        self.buf.fill_(-1)
        self.limit.fill_(limit)
        self.temperature.fill_(temperature)
        self.top_p.fill_(top_p)

    def forward(self):
        """The captured round on the graph's buffers."""
        st = dataclasses.replace(self.carry)
        t_next = _round(self.params, st, self.draft, self.t_next, self.buf,
                        self.u_pend, self.u_acc, self.limit,
                        self.temperature, self.top_p, self.top_k,
                        self.spec_k, self.stops, self.cfg,
                        phase=contextlib.nullcontext)
        self.t_next.copy_(t_next)
        for n in CARRY:
            if getattr(st, n) is not getattr(self.carry, n):
                getattr(self.carry, n).copy_(getattr(st, n))

    def round(self):
        """One round: the capture's eager run, or a replay."""
        if self._replay is None:
            self._replay, _, self._increments, self._keep = capture(
                self.forward, self.t_next.device, self.shared.pool)
            count("spec.graph_captures")
            return
        self._replay()
        add(self._increments)
        count("spec.graph_replays")

    def end(self, state):
        """A chunk's end: ``state`` gets copies of the carry."""
        for n in CARRY:
            setattr(state, n, getattr(self.carry, n).clone())


def spec_generate_chunk(params, state: SpecState, draft_ids, cfg,
                        temperature: float, top_p: float, top_k: int = 50,
                        spec_k: int = 8, chunk_len: int = 64,
                        stop_tokens: Tuple[int, ...] = (151643, 151645),
                        limit: int = None,
                        graphs: DecodeGraphs = None) -> torch.Tensor:
    """Emit up to ``min(limit, chunk_len)`` tokens per row with CTC-draft
    speculation; ``state`` advances in place. Returns the emitted ids
    [B, chunk_len] in order, -1 elsewhere. A round emits 1 to 1 + spec_k
    tokens per row; acceptance is cut at the budget, so ``limit`` stays an
    exact cap. The cache needs ``spec_k + 1`` slots of headroom beyond
    prompt + n_predict: each round writes K + 1 rows from the row's next
    free slot. On a card the rounds replay a graph of ``graphs`` (an
    engine's, so that its requests capture once; a new one otherwise)."""
    graph = None
    if state.logits.device.type == "cuda":
        graph = verify_graph(DecodeGraphs() if graphs is None else graphs,
                             params, state, draft_ids, cfg, top_k, spec_k,
                             chunk_len, stop_tokens)
    return run_rounds(params, state, draft_ids, cfg, temperature, top_p,
                      top_k, spec_k, chunk_len, stop_tokens, limit, graph)


def verify_graph(graphs: DecodeGraphs, params, state: SpecState, draft_ids,
                 cfg, top_k: int, spec_k: int, chunk_len: int,
                 stop_tokens) -> VerifyGraph:
    """The verify graph of ``graphs`` for ``state``'s cache layout and the
    round's shapes, made (not yet captured) where there is none."""
    key = ("verify", draft_ids.shape[1], top_k, spec_k, chunk_len,
           tuple(stop_tokens))
    return graphs.graph(params, cfg, state, key, lambda shared: VerifyGraph(
        params, cfg, shared, state, draft_ids.shape[1], top_k, spec_k,
        chunk_len, stop_tokens))


def run_rounds(params, state: SpecState, draft_ids, cfg, temperature: float,
               top_p: float, top_k: int, spec_k: int, chunk_len: int,
               stop_tokens: Tuple[int, ...], limit: int = None,
               graph: VerifyGraph = None) -> torch.Tensor:
    """:func:`spec_generate_chunk`'s rounds through ``graph``, or eagerly
    where it is None (the CPU's path; on a card, the reference the graph
    is held to)."""
    b = state.logits.shape[0]
    dev = state.logits.device
    greedy = temperature <= 0
    limit = chunk_len if limit is None else min(limit, chunk_len)
    gen = state.generator
    if graph is None:
        carry, t_next = state, torch.zeros(b, dtype=torch.int64, device=dev)
        buf = torch.full((b, chunk_len + 1), -1, dtype=torch.int64,
                         device=dev)
        draft = draft_ids.to(device=dev, dtype=torch.int64)
        stops = torch.tensor(stop_tokens, dtype=torch.int64, device=dev)
        scalars = [torch.tensor(v, dtype=dtype, device=dev) for v, dtype in (
            (limit, torch.int64), (temperature, torch.float32),
            (top_p, torch.float32))]
        u_pend = torch.zeros((b, candidates(state.logits.shape[-1], top_k)),
                             device=dev)
        u_acc = torch.zeros((b, spec_k), device=dev)
    else:
        graph.begin(state, draft_ids, limit, temperature, top_p)
        carry, buf, u_pend, u_acc = (graph.carry, graph.buf, graph.u_pend,
                                     graph.u_acc)

    while True:
        with span("spec.round"):
            with span("spec.sync"):
                if graph is not None:
                    t_next = graph.t_next
                active = ~carry.done & (t_next < limit)
                count("host.syncs")
                go = bool(active.any())     # the round's one host sync
            if not go:
                break
            count("spec.rounds")
            if not greedy:
                u_pend.uniform_(generator=gen)
                u_acc.uniform_(generator=gen)
            if graph is None:
                t_next = _round(params, state, draft, t_next, buf, u_pend,
                                u_acc, *scalars, top_k, spec_k, stops, cfg)
            else:
                with span("spec.forward"):
                    graph.round()
    if graph is None:
        return buf[:, :chunk_len]
    graph.end(state)
    return buf[:, :chunk_len].clone()
