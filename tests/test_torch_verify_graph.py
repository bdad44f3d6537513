"""The verify round with its draws and scalars on the device
(``fun_asr_gguf_tpu_torch.models.speculative``), on the CPU.

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

The round's CUDA graph is tested with the plain step's, over both kinds,
in ``tests/test_torch_decode_graph.py``; the card tests
(``tests/test_torch_cuda.py``) hold real replays to eager rounds and to
this file's reference.
"""

import numpy as np
import pytest
import torch

from fun_asr_gguf_tpu_torch.models import generate as tg
from fun_asr_gguf_tpu_torch.models import qwen3 as tq
from fun_asr_gguf_tpu_torch.models import speculative as tsp
from fun_asr_gguf_tpu_torch.ops import sampling as tsamp

from test_torch_decode_graph import (CFG, CHUNK, STOPS, _assert_same,
                                     _draft, _spec, _spec_clone,
                                     own_counters, params_of)


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
