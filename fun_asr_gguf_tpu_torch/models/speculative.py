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

On a card the round is one replay of a CUDA graph (:func:`round_graph`,
:mod:`.decode_graph`), kept by the engine's
:class:`.decode_graph.DecodeGraphs` beside the decode graph of the same
cache layout, whose cache and memory pool it shares; it is keyed by what
fixes its shapes (``spec_k``, ``top_k``, ``chunk_len``, the draft's
length, the stop ids). Greedy and sampled rounds are one graph: the round
takes the argmax where the temperature is <= 0, on the device. The graph
copies the state's carry into buffers of its own at a chunk's start and
hands copies back at its end. The CPU runs the same round eagerly. Each
round is a ``spec.round`` span (``..profiling``) of ``spec.sync`` (that
read) and ``spec.forward``: on the CPU the verify pass, beside
``spec.draft`` and ``spec.accept``; on the card the replay, which holds
all three.
Counters ``spec.rounds``, ``spec.graph_captures`` and
``spec.graph_replays``.
"""

import contextlib
import functools
import types
from dataclasses import dataclass
from typing import Tuple

import torch

from ..ops.sampling import candidates, sample_drawn, warped_candidates
from ..profiling import count, span
from .decode_graph import DecodeGraphs, Graph, put
from .generate import GenState, count_token
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


def _round(params, st: SpecState, io, top_k: int, spec_k: int, cfg,
           phase=span) -> torch.Tensor:
    """One verify round of every row of ``st``: pending draw, draft,
    verify pass, acceptance, emission, ring and fuse, advance. Rebinds
    ``st``'s fields, writes ``st.kv``, ``st.ring`` and ``io.buf`` [B,
    chunk_len + 1] in place, and returns the new ``t_next`` (tokens
    emitted in the chunk). ``io`` holds :func:`_round_buffers`: ``u_pend``
    [B, candidates] and ``u_acc`` [B, spec_k] are the round's uniforms;
    ``limit``, ``temperature`` and ``top_p`` are device scalars (rows are
    greedy where the temperature is <= 0). Reads nothing on the host, so a
    CUDA graph can capture it; ``phase`` names its three parts (a span
    each on the eager path)."""
    b = st.logits.shape[0]
    dev = st.logits.device
    t_next, stops, temperature = io.t_next, io.stops, io.temperature
    sink = io.buf.shape[1] - 1              # column for non-emitted lanes
    rows = torch.arange(b, device=dev)
    lanes = torch.arange(spec_k + 1, device=dev)
    greedy = temperature <= 0
    active = ~st.done & (t_next < io.limit)
    with phase("spec.draft"):
        # 1. pending: the token the plain loop would draw now (from the
        #    residual distribution after a rejected draft)
        pending = torch.where(
            greedy, torch.argmax(st.logits.to(torch.float32), dim=-1),
            sample_drawn(st.logits, io.u_pend, temperature, io.top_p, top_k,
                         st.forbid))
        pend_stop = torch.isin(pending, stops)

        # 2. draft proposal; no speculation past a stop, for paused rows
        #    or past the budget; a stop id inside the draft ends it
        d_tok, d_valid, start, _ = _lookup_draft(
            io.draft, st.last_tok, pending, st.cursor, spec_k)
        d_valid &= (active & ~pend_stop)[:, None]
        d_valid &= torch.cumprod(
            (~torch.isin(d_tok, stops)).to(torch.int64), dim=1).bool()
        d_valid &= (t_next[:, None] + lanes[None, 1:]) < io.limit

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
        probs, idx = warped_candidates(score, temperature, io.top_p, top_k)
        p_d = torch.where(idx == d_tok[:, :, None], probs,
                          torch.zeros_like(probs)).sum(dim=-1)
        acc = torch.where(greedy, torch.argmax(score, dim=-1) == d_tok,
                          io.u_acc < p_d)
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
        io.buf[rows[:, None], cols] = tok_seq
        io.buf[:, sink] = -1

        # 7. ring, counters and the fuse, per emitted token
        fused = torch.zeros(b, dtype=torch.bool, device=dev)
        for i in range(spec_k + 1):
            tok = tok_seq[:, i]
            fused |= count_token(st, rows, tok,
                                 emit[:, i] & ~torch.isin(tok, stops))
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


def _round_buffers(state: SpecState, draft_len: int, top_k: int,
                   spec_k: int, chunk_len: int, stop_tokens):
    """What a round reads and writes beside the carry, on ``state``'s
    device: the draft, ``t_next``, the token buffer (a sink column last),
    the device scalars, the uniforms and the stop ids."""
    b, vocab = state.logits.shape
    dev = state.logits.device
    i64, f32 = ({"dtype": dtype, "device": dev}
                for dtype in (torch.int64, torch.float32))
    return {"draft": torch.empty((b, draft_len), **i64),
            "t_next": torch.empty(b, **i64),
            "buf": torch.empty((b, chunk_len + 1), **i64),
            "limit": torch.empty((), **i64),
            "temperature": torch.empty((), **f32),
            "top_p": torch.empty((), **f32),
            "u_pend": torch.zeros((b, candidates(vocab, top_k)), device=dev),
            "u_acc": torch.zeros((b, spec_k), device=dev),
            "stops": torch.tensor(stop_tokens, **i64)}


def _graph_round(params, cfg, top_k: int, spec_k: int, bufs):
    """The captured round on a graph's buffers, which it writes."""
    st = types.SimpleNamespace(**vars(bufs))
    t_next = _round(params, st, bufs, top_k, spec_k, cfg,
                    phase=contextlib.nullcontext)
    bufs.t_next.copy_(t_next)
    for n in CARRY:
        if getattr(st, n) is not getattr(bufs, n):
            getattr(bufs, n).copy_(getattr(st, n))


def round_graph(graphs: DecodeGraphs, params, cfg, state: SpecState,
                draft_ids, top_k: int, spec_k: int, chunk_len: int,
                stop_tokens) -> Graph:
    """The verify round's graph of ``state``'s batch and the round's
    shapes in ``graphs`` (:meth:`.decode_graph.DecodeGraphs.graph`). It
    reads the carry, ``valid_from`` and the chunk's values (copied in at a
    chunk's start) and the uniforms (drawn each round), and keeps the
    carry."""
    args = (draft_ids.shape[1], top_k, spec_k, chunk_len, tuple(stop_tokens))

    def make(shared):
        return Graph(shared, "spec", functools.partial(
            _graph_round, params, cfg, top_k, spec_k), state,
            _round_buffers(state, *args), reads=CARRY + ("valid_from",),
            keeps=CARRY)
    return graphs.graph(params, cfg, state, ("verify",) + args, make)


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
        graph = round_graph(DecodeGraphs() if graphs is None else graphs,
                            params, cfg, state, draft_ids, top_k, spec_k,
                            chunk_len, stop_tokens)
    return run_rounds(params, state, draft_ids, cfg, temperature, top_p,
                      top_k, spec_k, chunk_len, stop_tokens, limit, graph)


def run_rounds(params, state: SpecState, draft_ids, cfg, temperature: float,
               top_p: float, top_k: int, spec_k: int, chunk_len: int,
               stop_tokens: Tuple[int, ...], limit: int = None,
               graph: Graph = None) -> torch.Tensor:
    """:func:`spec_generate_chunk`'s rounds through ``graph`` (of
    :func:`round_graph`), or eagerly where it is None (the CPU's path; on
    a card, the reference the graph is held to)."""
    greedy = temperature <= 0
    limit = chunk_len if limit is None else min(limit, chunk_len)
    gen = state.generator
    values = {"draft": draft_ids, "t_next": 0, "buf": -1, "limit": limit,
              "temperature": temperature, "top_p": top_p}
    if graph is None:
        carry, io = state, types.SimpleNamespace(**_round_buffers(
            state, draft_ids.shape[1], top_k, spec_k, chunk_len,
            stop_tokens))
        put(io, values)
    else:
        graph.begin(state, **values)
        carry = io = graph.bufs

    while True:
        with span("spec.round"):
            with span("spec.sync"):
                active = ~carry.done & (io.t_next < limit)
                count("host.syncs")
                go = bool(active.any())     # the round's one host sync
            if not go:
                break
            count("spec.rounds")
            if not greedy:
                io.u_pend.uniform_(generator=gen)
                io.u_acc.uniform_(generator=gen)
            if graph is None:
                io.t_next = _round(params, state, io, top_k, spec_k, cfg)
            else:
                with span("spec.forward"):
                    graph()
    if graph is None:
        return io.buf[:, :chunk_len]
    graph.end(state)
    return io.buf[:, :chunk_len].clone()
