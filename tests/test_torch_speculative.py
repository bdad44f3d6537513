"""Port CTC-draft speculation against the JAX package and against the
port's own plain loop, on the CPU.

* ``_lookup_draft`` gives JAX's ids on random drafts (-1 padding, bigram
  preferred, unigram fallback, no match, the cursor tie-break).
* Greedy speculation emits exactly the plain greedy ids for a perfect, a
  partial, a garbage and an empty draft, across chunk boundaries and to an
  exact ``n_predict`` budget, on the packed and on the fused tree; and
  exactly JAX's ``spec_generate_chunk`` ids on the same weights.
* Sampled speculation preserves the distribution: the accept / residual
  mechanism against the warped distribution, and the emitted tokens of
  thousands of batch rows against the plain sampler's.
* A pending ``forbid`` is consumed by the plain chunk's first draw only;
  ``spec_to_gen`` mid-stream keeps the greedy transcript; the engine's
  guardrail and all four ``speculative`` × ``fuse_projections`` settings
  keep the greedy ids.
"""

import base64
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fun_asr_gguf_tpu.models import generate as jgen
from fun_asr_gguf_tpu.models import qwen3 as jq
from fun_asr_gguf_tpu.models import speculative as jspec
from fun_asr_gguf_tpu.models.config import Qwen3Config
from fun_asr_gguf_tpu_torch.models import generate as tgen
from fun_asr_gguf_tpu_torch.models import qwen3 as tq
from fun_asr_gguf_tpu_torch.models import speculative as tspec
from fun_asr_gguf_tpu_torch.models.weights import to_torch
from fun_asr_gguf_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(2)

CFG = Qwen3Config.tiny(vocab_size=97)
STOPS = (96,)
P = 6


def _np(x):
    return jax.tree_util.tree_map(np.array, jax.device_get(x))


@pytest.fixture(scope="module")
def weights():
    base = jq.init_qwen3_params(jax.random.PRNGKey(0), CFG)
    jp = jq.pack_qwen3_params(jq.quantize_lm_head(
        jq.quantize_qwen3_params(base, mode="pallas"), CFG, mode="pallas"))
    tp = to_torch(_np(jp))
    return jp, {"packed": tp, "fused": tq.fuse_qwen3_params_q8(tp)}


def _prompt(b=1):
    rng = np.random.default_rng(2)
    emb = (rng.normal(size=(1, P, CFG.hidden)) * 0.05).astype(np.float32)
    return np.repeat(emb, b, axis=0), np.ones((b, P), np.float32)


def _state(params, b=1, seed=3, extra=64):
    emb, mask = _prompt(b)
    return tgen.prefill_init(params, torch.from_numpy(emb),
                             torch.from_numpy(mask),
                             torch.Generator().manual_seed(seed), CFG,
                             max_len=P + extra)


def _ids(row):
    return [int(t) for t in row.tolist() if t >= 0]


def _greedy(params, n):
    st = _state(params)
    return _ids(tgen.generate_chunk(params, st, CFG, 0.0, 1.0, 50,
                                    chunk_len=n, stop_tokens=STOPS)[0])


def _draft(ids, d=48):
    buf = torch.full((1, d), -1, dtype=torch.int64)
    buf[0, :min(len(ids), d)] = torch.tensor(ids[:d], dtype=torch.int64)
    return buf


def _spec(params, draft, n, chunk=None, spec_k=4, temperature=0.0):
    st = tspec.spec_init(_state(params))
    chunk = chunk or n
    out = []
    while len(out) < n:
        got = _ids(tspec.spec_generate_chunk(
            params, st, draft, CFG, temperature, 1.0, 50, spec_k=spec_k,
            chunk_len=chunk, stop_tokens=STOPS,
            limit=min(chunk, n - len(out)))[0])
        out.extend(got)
        if bool(st.done[0]) or not got:
            break
    return st, out


# ---------------------------------------------------------------------------
# draft lookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_lookup_draft_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b, d, k = 6, 24, 5
    draft = rng.integers(0, 6, size=(b, d))          # a small vocab: ties
    for i in range(b):
        draft[i, rng.integers(d // 2, d + 1):] = -1  # -1 padded tails
        draft[i, rng.integers(0, d)] = -1            # a hole
    last = rng.integers(-1, 6, size=b)
    pending = rng.integers(0, 8, size=b)             # 6, 7: no match
    cursor = rng.integers(0, d, size=b)
    want = jspec._lookup_draft(*(jnp.asarray(a, jnp.int32) for a in
                                 (draft, last, pending, cursor)), k)
    got = tspec._lookup_draft(*(torch.from_numpy(a).long() for a in
                                (draft, last, pending, cursor)), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_lookup_draft_cases():
    draft = _draft([10, 20, 30, 40, 10, 20, 50, 60])
    one = lambda v: torch.tensor([v])                    # noqa: E731
    # bigram (10, 20): cursor 0 takes the first match, cursor 4 the second
    d_tok, d_valid, _, has = tspec._lookup_draft(draft, one(10), one(20),
                                                 one(0), 4)
    assert bool(has[0]) and d_tok[0].tolist() == [30, 40, 10, 20]
    assert d_valid[0].all()
    d_tok, d_valid, _, _ = tspec._lookup_draft(draft, one(10), one(20),
                                               one(4), 4)
    assert d_tok[0, :2].tolist() == [50, 60]
    assert d_valid[0].tolist() == [True, True, False, False]
    # unigram fallback; no match proposes draft[cursor + 1:]
    draft = _draft([7, 8, 9])
    d_tok, d_valid, _, has = tspec._lookup_draft(draft, one(-1), one(8),
                                                 one(0), 2)
    assert bool(has[0]) and d_tok[0].tolist() == [9, 0]
    assert d_valid[0].tolist() == [True, False]
    d_tok, d_valid, start, has = tspec._lookup_draft(draft, one(-1), one(55),
                                                     one(0), 2)
    assert not bool(has[0]) and int(start[0]) == 1
    assert d_tok[0].tolist() == [8, 9] and d_valid[0].all()


# ---------------------------------------------------------------------------
# greedy: the plain loop's ids, JAX's ids
# ---------------------------------------------------------------------------

def _make_draft(kind, ref):
    return {"perfect": lambda: ref,
            "partial": lambda: ref[:10] + [3, 1, 4, 1, 5] + ref[10:18],
            "garbage": lambda: [5, 5, 5, 11, 13, 17, 19, 23],
            "empty": lambda: []}[kind]()


@pytest.mark.parametrize("tree", ["packed", "fused"])
@pytest.mark.parametrize("kind", ["perfect", "partial", "garbage", "empty"])
def test_greedy_speculation_equals_plain_greedy(weights, tree, kind):
    params = weights[1][tree]
    ref = _greedy(params, 24)
    st, out = _spec(params, _draft(_make_draft(kind, ref)), 24)
    assert out == ref
    if kind == "perfect":       # drafting really happened
        assert int(st.rounds[0]) < len(out)


@pytest.mark.parametrize("tree", ["packed", "fused"])
def test_greedy_speculation_keeps_chunks_and_budget(weights, tree):
    params = weights[1][tree]
    ref = _greedy(params, 24)
    assert _spec(params, _draft(ref), 24, chunk=7)[1] == ref
    assert _spec(params, _draft(ref), 9)[1] == ref[:9]
    # KV slots consumed = tokens emitted (rejected rows never count)
    st, out = _spec(params, _draft(ref), 9)
    assert int(st.slot_next[0]) - P == len(out) == 9


def test_greedy_speculation_ids_equal_jax(weights):
    jp, tps = weights
    emb, mask = _prompt()

    def jstate():
        return jgen.prefill_init(jp, jnp.asarray(emb), jnp.asarray(mask),
                                 jax.random.PRNGKey(0), CFG, max_len=P + 64)

    _, jtok = jgen.generate_chunk(jp, jstate(), CFG, jnp.asarray(0.0),
                                  jnp.asarray(1.0), 50, chunk_len=24,
                                  stop_tokens=STOPS, greedy=True)
    ref = _ids(np.asarray(jtok)[0])
    for kind in ("perfect", "partial", "garbage"):
        draft = _make_draft(kind, ref)
        buf = np.full((1, 48), -1, np.int32)
        buf[0, :len(draft)] = draft
        _, jtok = jspec.spec_generate_chunk(
            jp, jspec.spec_init(jstate()), jnp.asarray(buf), CFG,
            jnp.asarray(0.0), jnp.asarray(1.0), 50, spec_k=4, chunk_len=24,
            stop_tokens=STOPS, greedy=True)
        want = _ids(np.asarray(jtok)[0])
        for params in tps.values():
            assert _spec(params, _draft(draft), 24)[1] == want == ref


# ---------------------------------------------------------------------------
# sampled: the distribution is preserved
# ---------------------------------------------------------------------------

def test_sample_residual_without_forbid_is_sample_token():
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, CFG.vocab_size)).astype(np.float32) * 2.0)
    for seed in range(5):
        a = tsamp.sample_token(logits, torch.Generator().manual_seed(seed),
                               0.7, 0.9, 17)
        b = tsamp.sample_residual(logits,
                                  torch.Generator().manual_seed(seed), 0.7,
                                  0.9, 17, torch.full((3,), -1))
        assert torch.equal(a, b)


def test_accept_or_residual_draw_is_the_warped_distribution():
    """Accept draft d with probability p(d), else draw with d excluded:
    the emitted token follows the warped distribution exactly."""
    v, n, draft = 8, 40000, 1
    logits = torch.log(torch.tensor(
        [.30, .22, .15, .12, .09, .06, .04, .02]))[None, :]
    probs, idx = tsamp.warped_candidates(logits, 0.9, 0.97, 6)
    p_full = torch.zeros(v).index_add_(0, idx[0], probs[0])
    gen = torch.Generator().manual_seed(0)
    accept = torch.rand(n, generator=gen) < p_full[draft]
    resid = tsamp.sample_residual(logits.expand(n, v), gen, 0.9, 0.97, 6,
                                  torch.full((n,), draft))
    out = torch.where(accept, draft, resid)
    emp = torch.bincount(out, minlength=v).double() / n
    np.testing.assert_allclose(emp.numpy(), p_full.numpy(), atol=0.012)


def test_sampled_speculation_matches_the_plain_sampler(weights):
    """Thousands of identical batch rows: the first three emitted tokens
    of sampled speculation follow the plain sampler's distribution."""
    params = weights[1]["fused"]
    b, n, temp, top_k = 3000, 3, 1.0, 4
    ref = _greedy(params, 8)
    plain = tgen.generate_chunk(params, _state(params, b=b, seed=1), CFG,
                                temp, 1.0, top_k, chunk_len=n,
                                stop_tokens=())
    draft = _draft(ref).expand(b, -1)
    st = tspec.spec_init(_state(params, b=b, seed=2))
    spec = tspec.spec_generate_chunk(params, st, draft, CFG, temp, 1.0,
                                     top_k, spec_k=2, chunk_len=n,
                                     stop_tokens=())
    assert int(st.rounds.sum()) < b * n          # drafts were accepted
    assert (spec >= 0).all() and (plain >= 0).all()
    for i in range(n):
        pa = torch.bincount(plain[:, i], minlength=CFG.vocab_size) / b
        sp = torch.bincount(spec[:, i], minlength=CFG.vocab_size) / b
        # two independent samples of 3000: 4 sigma of a difference <= 0.052
        assert (pa - sp).abs().max() < 0.052, i


def test_forbid_is_consumed_by_the_first_draw_only(weights):
    params = weights[1]["packed"]
    b = 400
    st = _state(params, b=b)
    top2 = torch.topk(st.logits, 2, dim=-1).indices
    st.forbid = top2[:, 0].clone()
    toks = tgen.generate_chunk(params, st, CFG, 1.0, 1.0, 2, chunk_len=2)
    assert (toks[:, 0] == top2[:, 1]).all()      # top-2 minus the forbidden
    assert (st.forbid == -1).all()


# ---------------------------------------------------------------------------
# the guardrail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", ["packed", "fused"])
def test_spec_to_gen_mid_stream_keeps_greedy_ids(weights, tree):
    params = weights[1][tree]
    ref = _greedy(params, 24)
    st = tspec.spec_init(_state(params))
    got = _ids(tspec.spec_generate_chunk(
        params, st, _draft([5, 7, 11, 13, 17, 19, 23, 29]), CFG, 0.0, 1.0,
        50, spec_k=4, chunk_len=8, stop_tokens=STOPS)[0])
    assert int(st.rounds[0]) >= 1
    gst = tspec.spec_to_gen(st)
    assert gst.step == len(got)
    while len(got) < 24 and not bool(gst.done[0]):
        got += _ids(tgen.generate_chunk(params, gst, CFG, 0.0, 1.0, 50,
                                        chunk_len=8, stop_tokens=STOPS,
                                        limit=min(8, 24 - len(got)))[0])
    assert got == ref[:len(got)] and len(got) >= 23


@pytest.fixture(scope="module")
def engine_inputs(tmp_path_factory):
    from fun_asr_gguf_tpu_torch.audio import write_wav
    from fun_asr_gguf_tpu_torch.models.config import HybridConfig
    from fun_asr_gguf_tpu_torch.models.loaders import write_random_checkpoint
    root = tmp_path_factory.mktemp("spec_engine")
    ckpt = str(root / "model")
    cfg = write_random_checkpoint(ckpt, HybridConfig.tiny(), seed=0)
    with open(os.path.join(ckpt, "tokens.txt"), "w", encoding="utf-8") as f:
        for i in range(cfg.ctc.vocab_size):
            ch = chr(ord("一") + i) if i < cfg.ctc.vocab_size - 1 else "<blk>"
            f.write(f"{base64.b64encode(ch.encode()).decode()} {i}\n")
    wav = str(root / "a.wav")
    write_wav(wav, np.random.default_rng(0).normal(size=24000) * 0.05, 16000)
    return ckpt, wav, str(root / "hot.txt")


def _engine_ids(engine_inputs, monkeypatch, **kwargs):
    """Greedy transcription of the q8_0 engine (unless ``kwargs`` name
    another format) → (generated ids, verify rounds)."""
    from fun_asr_gguf_tpu_torch import create_asr_engine
    from fun_asr_gguf_tpu_torch.core import decoder as tdec
    from fun_asr_gguf_tpu_torch.formats.tokenizer import StreamTextDecoder
    from fun_asr_gguf_tpu_torch.hotword.manager import reset_hotword_manager
    ckpt, wav, hot = engine_inputs
    ids = []

    class Recorder(StreamTextDecoder):
        def push(self, tok):
            ids.append(tok)
            return super().push(tok)

    monkeypatch.setattr(tdec, "StreamTextDecoder", Recorder)
    reset_hotword_manager()
    eng = create_asr_engine(ckpt, verbose=False, compute_dtype="float32",
                            device="cpu", segment_pad_seconds=2.0,
                            n_predict=24, prefill_buckets=(64,),
                            hotwords_path=hot,
                            **{"llm_weight_format": "q8_0", **kwargs})
    rounds = [0]
    inner = eng.models.spec_generate

    def counting(state, *args, **kw):       # verify rounds of the decode
        r0 = int(state.rounds[0])
        out = inner(state, *args, **kw)
        rounds[0] += int(state.rounds[0]) - r0
        return out

    eng.models.spec_generate = counting
    try:
        res = eng.transcribe(wav, verbose=False, temperature=0.0)
        assert res.ctc_text and isinstance(res.text, str)
        return ids, rounds[0]
    finally:
        eng.cleanup()
        reset_hotword_manager()


def test_engine_guardrail_keeps_the_greedy_transcript(engine_inputs,
                                                      monkeypatch):
    plain, _ = _engine_ids(engine_inputs, monkeypatch, speculative=False)
    forced, rounds = _engine_ids(engine_inputs, monkeypatch,
                                 spec_min_accept=99.0)
    assert forced == plain and len(plain) > 8
    assert rounds >= 8                  # the probe ran, then the switch


@pytest.mark.parametrize("fuse", [True, False])
def test_engine_speculation_settings_keep_greedy_ids(engine_inputs,
                                                     monkeypatch, fuse):
    plain, rounds = _engine_ids(engine_inputs, monkeypatch,
                                speculative=False, fuse_projections=fuse)
    assert rounds == 0
    spec, rounds = _engine_ids(engine_inputs, monkeypatch, spec_min_accept=0,
                               fuse_projections=fuse)
    assert spec == plain and rounds > 0


# ---------------------------------------------------------------------------
# the plain chunk stops once every row is done, as JAX's while_loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [0, 1, 2])
def test_plain_chunk_stops_at_the_step_its_row_stops(weights, k,
                                                     monkeypatch):
    """A row that draws a stop id at step t: the chunk runs t + 1 decode
    steps (the stop id is fed back, then the loop ends), as JAX's
    ``generate_chunk``, whose ``state.step`` says the same. t is the k-th
    step of a greedy run whose id did not occur before it."""
    jp, tps = weights
    tp = tps["packed"]
    ids = _greedy(tp, 12)
    t = [i for i in range(len(ids)) if ids[i] not in ids[:i]][2 * k]
    stop = ids[t]
    calls = [0]
    step = tgen.qwen3_decode_step

    def counted(*args, **kwargs):
        calls[0] += 1
        return step(*args, **kwargs)
    monkeypatch.setattr(tgen, "qwen3_decode_step", counted)
    st = _state(tp)
    buf = tgen.generate_chunk(tp, st, CFG, 0.0, 1.0, 50, chunk_len=16,
                              stop_tokens=(stop,))
    assert calls[0] == st.step == t + 1
    assert buf[0, :t + 1].tolist() == ids[:t + 1]
    assert (buf[0, t + 1:] == -1).all() and bool(st.done[0])
    emb, mask = _prompt()
    jst, jtok = jgen.generate_chunk(
        jp, jgen.prefill_init(jp, jnp.asarray(emb), jnp.asarray(mask),
                              jax.random.PRNGKey(0), CFG, max_len=P + 64),
        CFG, jnp.asarray(0.0), jnp.asarray(1.0), 50, chunk_len=16,
        stop_tokens=(stop,), greedy=True)
    assert int(jst.step) == t + 1
    assert _ids(np.asarray(jtok)[0]) == _ids(buf[0])
    # a chunk that starts with every row done runs no step
    calls[0] = 0
    tgen.generate_chunk(tp, st, CFG, 0.0, 1.0, 50, chunk_len=16,
                        stop_tokens=(stop,))
    assert calls[0] == 0 and st.step == t + 1
