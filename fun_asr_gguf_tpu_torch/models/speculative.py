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
batch 1 is the accepted count's only trip to the host. Each round is a
``spec.round`` span (``..profiling``) of ``spec.sync`` (that read),
``spec.draft``, ``spec.forward`` (the verify pass) and ``spec.accept``.
"""

from dataclasses import dataclass
from typing import Tuple

import torch

from ..ops.sampling import sample_residual, warped_candidates
from ..profiling import count, span
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
    rides along: the plain chunk's first draw consumes it."""
    count("host.syncs")
    slot = state.slot_next.tolist()
    if any(s != slot[0] for s in slot):
        raise ValueError(f"spec_to_gen requires uniform row slots (got "
                         f"{slot})")
    return GenState(
        kv=state.kv, logits=state.logits, prompt_len=state.prompt_len,
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


def spec_generate_chunk(params, state: SpecState, draft_ids, cfg,
                        temperature: float, top_p: float, top_k: int = 50,
                        spec_k: int = 8, chunk_len: int = 64,
                        stop_tokens: Tuple[int, ...] = (151643, 151645),
                        limit: int = None) -> torch.Tensor:
    """Emit up to ``min(limit, chunk_len)`` tokens per row with CTC-draft
    speculation; ``state`` advances in place. Returns the emitted ids
    [B, chunk_len] in order, -1 elsewhere. A round emits 1 to 1 + spec_k
    tokens per row; acceptance is cut at the budget, so ``limit`` stays an
    exact cap. The cache needs ``spec_k + 1`` slots of headroom beyond
    prompt + n_predict: each round writes K + 1 rows from the row's next
    free slot."""
    b = state.logits.shape[0]
    dev = state.logits.device
    greedy = temperature <= 0
    limit = chunk_len if limit is None else min(limit, chunk_len)
    buf = torch.full((b, chunk_len + 1), -1, dtype=torch.int64, device=dev)
    sink = chunk_len                        # column for non-emitted lanes
    stops = torch.tensor(stop_tokens, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    lanes = torch.arange(spec_k + 1, device=dev)
    t_next = torch.zeros(b, dtype=torch.int64, device=dev)
    draft_ids = draft_ids.to(device=dev, dtype=torch.int64)

    while True:
        with span("spec.round"):
            with span("spec.sync"):
                active = ~state.done & (t_next < limit)
                count("host.syncs")
                go = bool(active.any())     # the round's one host sync
            if not go:
                break
            count("spec.rounds")
            with span("spec.draft"):
                # 1. pending: the token the plain loop would draw now (from
                #    the residual distribution after a rejected draft)
                pending = sample_residual(state.logits, state.generator,
                                          temperature, top_p, top_k,
                                          state.forbid)
                pend_stop = torch.isin(pending, stops)

                # 2. draft proposal; no speculation past a stop, for paused
                #    rows or past the budget; a stop id inside the draft
                #    ends it
                d_tok, d_valid, start, _ = _lookup_draft(
                    draft_ids, state.last_tok, pending, state.cursor, spec_k)
                d_valid &= (active & ~pend_stop)[:, None]
                d_valid &= torch.cumprod(
                    (~torch.isin(d_tok, stops)).to(torch.int64), dim=1).bool()
                d_valid &= (t_next[:, None] + lanes[None, 1:]) < limit

            with span("spec.forward"):
                # 3. one verify pass over [pending, d_1 .. d_K]
                tok_seq = torch.cat([pending[:, None], d_tok], dim=1)
                emb = embed_tokens(params, tok_seq)
                logits_v, state.kv = qwen3_verify_step(
                    params, state.kv, emb, state.slot_next,
                    state.pos_next[:, None] + lanes[None, :],
                    state.valid_from, cfg)

            with span("spec.accept"):
                # 4. acceptance of each drafted token, then the accepted
                #    prefix
                score = logits_v[:, :spec_k, :]
                if greedy:
                    acc = torch.argmax(score, dim=-1) == d_tok
                else:
                    probs, idx = warped_candidates(score, temperature, top_p,
                                                   top_k)
                    p_d = torch.where(idx == d_tok[:, :, None], probs,
                                      torch.zeros_like(probs)).sum(dim=-1)
                    u = torch.rand(p_d.shape, generator=state.generator,
                                   device=dev)
                    acc = u < p_d
                acc &= d_valid
                a = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)

                # a probabilistic rejection excludes that id from the next
                # draw; validity and budget rejections resample
                # unconstrained
                if spec_k == 0:
                    forbid = torch.where(active, -1, state.forbid)
                else:
                    rej_i = a.clamp(0, spec_k - 1)[:, None]
                    rej_was_valid = torch.gather(d_valid, 1, rej_i)[:, 0] & \
                        (a < spec_k) & (not greedy)
                    forbid = torch.where(
                        active, torch.where(
                            rej_was_valid,
                            torch.gather(d_tok, 1, rej_i)[:, 0], -1),
                        state.forbid)

                # 5. next logits: after the last consumed token (lane a)
                state.logits = torch.where(active[:, None], logits_v[rows, a],
                                           state.logits)
                state.forbid = forbid

                # 6. emit pending + accepted drafts
                n_emit = torch.where(active, 1 + a, 0)
                emit = active[:, None] & (lanes[None, :] < n_emit[:, None])
                cols = torch.where(emit, t_next[:, None] + lanes[None, :],
                                   sink)
                buf[rows[:, None], cols] = tok_seq
                buf[:, sink] = -1

                # 7. ring, counters and the fuse, per emitted token
                fused = torch.zeros(b, dtype=torch.bool, device=dev)
                for i in range(spec_k + 1):
                    tok = tok_seq[:, i]
                    counted = emit[:, i] & ~torch.isin(tok, stops)
                    pos = state.n_gen % RING
                    state.ring[rows, pos] = torch.where(counted, tok,
                                                        state.ring[rows, pos])
                    state.n_gen = state.n_gen + counted.to(torch.int64)
                    fused |= counted & (state.n_gen > RING) & \
                        (_distinct_count(state.ring) <= FUSE_DISTINCT)
                state.done = state.done | (active & pend_stop) | fused
                state.aborted = state.aborted | fused

                # 8. advance (pending and accepted drafts all entered the
                #    cache)
                state.slot_next = state.slot_next + n_emit
                state.pos_next = state.pos_next + n_emit
                t_next = t_next + n_emit
                last = torch.gather(tok_seq, 1,
                                    (n_emit - 1).clamp(0, spec_k)[:, None])
                state.last_tok = torch.where(active, last[:, 0],
                                             state.last_tok)
                state.cursor = torch.where(active, start + a, state.cursor)
                state.rounds = state.rounds + active.to(torch.int64)
    return buf[:, :chunk_len]
