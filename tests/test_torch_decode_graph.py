"""The decode step with its slot and position on the device, and the CUDA
graphs that replay it (``fun_asr_gguf_tpu_torch.models.decode_graph``),
on the CPU.

* The step with a device slot gives bit for bit the logits and cache of
  the int-slot step it replaced (kept here as the reference), over 8
  steps, on dense bf16, per-channel int8, fused q8_0 (K4), int8-dot (q8i)
  and all-layers (K5) params, over bf16 and int8 caches.
* ``generate_chunk`` returns the same tokens and leaves the same ``done``,
  ``aborted``, ``ring`` and cache as with that reference step, greedy and
  sampled; on the CPU it captures nothing.
* Through :class:`DecodeGraphs`, with the capture replaced by eager calls
  on the graph's buffers (the CPU has no CUDA graphs): steps equal eager
  steps; the state owns the graph's cache; a second live state of the
  same shape hands the first its own copies; a state holding a cache that
  another live state owns is refused; a state converted by
  ``spec_to_gen`` after verify rounds hands its cache over; the least
  recently used graph goes beyond the limit; the counters' increments of
  a capture are taken back and added per replay.
* The engine sizes its cache in whole blocks of output slots, so
  requests whose ``n_predict`` differ within a block share one graph.

The card tests (``tests/test_torch_cuda.py``) hold real replays to eager
steps.
"""

import dataclasses
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


def eager_step(params, state, token):
    """One step of ``state`` as ``generate_chunk`` runs it on the CPU."""
    state.logits, state.kv = tq.qwen3_decode_step(
        params, state.kv, tq.embed_tokens(params, token),
        state.prompt_slots + state.step, state.prompt_len + state.step,
        state.valid_from, CFG)
    state.step += 1


def _tokens(state, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(state.logits.shape[0],)))


@pytest.fixture(autouse=True)
def own_counters(monkeypatch):
    """The counters are the process's: each test here counts on copies,
    put back when it ends, so no other test sees what these counted."""
    monkeypatch.setattr(profiling, "_counts", dict(profiling._counts))
    for mod, name in dg.counts()[0]:
        monkeypatch.setattr(mod, name, getattr(mod, name))


def eager_capture_of(forward, device, pool=None):
    """``decode_graph.capture`` as eager calls: the first runs now, each
    replay runs ``forward`` again, into the same output tensor where it
    returns one (a verify round returns none: it writes its buffers)."""
    out = forward()
    if out is None:
        return forward, None, ({}, {}), None
    out = out.clone()
    return (lambda: out.copy_(forward())), out, ({}, {}), None


@pytest.fixture
def eager_capture(monkeypatch):
    """``decode_graph.capture`` replaced by :func:`eager_capture_of`, in
    both modules that capture."""
    monkeypatch.setattr(dg, "capture", eager_capture_of)
    monkeypatch.setattr(tsp, "capture", eager_capture_of)


def _graph_count(name):
    return profiling.counters().get(f"decode.graph_{name}", 0)


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
    captures = _graph_count("captures")
    toks = tg.generate_chunk(params, got, CFG, temperature, 1.0, 50,
                             chunk_len=40, stop_tokens=(7,), graphs=graphs)
    assert _graph_count("captures") == captures and not graphs._graphs
    monkeypatch.setattr(tg, "qwen3_decode_step", parent_step)
    want = tg.generate_chunk(params, ref, CFG, temperature, 1.0, 50,
                             chunk_len=40, stop_tokens=(7,))
    assert torch.equal(toks, want)
    for name in ("done", "aborted", "ring", "n_gen", "logits"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert got.step == ref.step and _same_cache(got.kv, ref.kv)


@pytest.mark.parametrize("route,cache", CASES)
def test_graph_steps_are_eager_steps(eager_capture, route, cache):
    params = params_of(route)
    ref = _state(params, route, cache)
    got = _clone(ref)
    graphs = dg.DecodeGraphs()
    captures, replays = _graph_count("captures"), _graph_count("replays")
    for i in range(STEPS):
        tok = _tokens(ref, i)
        eager_step(params, ref, tok)
        graphs.step(params, got, tok, CFG)
        got.step += 1
        assert torch.equal(got.logits, ref.logits), i
        assert _same_cache(got.kv, ref.kv), i
    (graph,) = graphs._graphs.values()
    assert got.kv is graph.kv and got.logits is graph.logits
    assert _graph_count("captures") == captures + 1
    assert _graph_count("replays") == replays + STEPS


def test_second_live_state_gets_its_own_cache(eager_capture):
    params = params_of("q8_0")
    refs = [_state(params, "q8_0", "bf16", seed=s) for s in (1, 2)]
    a, b = (_clone(r) for r in refs)
    graphs = dg.DecodeGraphs()
    for turn, (state, ref) in enumerate([(a, refs[0]), (b, refs[1]),
                                         (a, refs[0]), (b, refs[1])]):
        for i in range(3):
            tok = _tokens(ref, 10 * turn + i)
            eager_step(params, ref, tok)
            graphs.step(params, state, tok, CFG)
            state.step += 1
        other = b if state is a else a
        graph = graphs._graphs[next(iter(graphs._graphs))]
        assert state.kv is graph.kv and other.kv is not graph.kv
        for s, r in ((a, refs[0]), (b, refs[1])):
            if s.step:
                assert torch.equal(s.logits, r.logits), turn
                assert _same_cache(s.kv, r.kv), turn
    assert len(graphs._graphs) == 1


def test_state_holding_another_live_owners_cache_is_refused(eager_capture):
    params = params_of("int8")
    a = _state(params, "int8", "int8")
    graphs = dg.DecodeGraphs()
    graphs.step(params, a, _tokens(a, 0), CFG)
    a.step += 1
    twin = dataclasses.replace(a)           # shares a's (the graph's) cache
    with pytest.raises(ValueError, match="another live state"):
        graphs.step(params, twin, _tokens(a, 1), CFG)
    ref = _clone(a)
    del a
    gc.collect()
    graphs.step(params, twin, _tokens(ref, 1), CFG)   # the owner is gone
    eager_step(params, ref, _tokens(ref, 1))
    assert torch.equal(twin.logits, ref.logits)


@pytest.mark.parametrize("temperature", [0.0, 0.4])
def test_spec_to_gen_hands_its_cache_over(eager_capture, temperature):
    params = params_of("q8_0")
    spec = tsp.spec_init(_state(params, "q8_0", "bf16", max_len=P + 40,
                                b=1))
    draft = torch.tensor([[5, 9, 5, 9, 3, 8, 1, 2, 4, 6, 7, 11]])
    tsp.spec_generate_chunk(params, spec, draft, CFG, temperature, 1.0, 50,
                            spec_k=4, chunk_len=12, stop_tokens=(7,),
                            limit=6)
    got = tsp.spec_to_gen(spec)
    ref = _clone(got)
    graphs = dg.DecodeGraphs()
    assert got.step > 0
    for i in range(STEPS):
        tok = _tokens(ref, i)
        eager_step(params, ref, tok)
        graphs.step(params, got, tok, CFG)
        got.step += 1
        assert torch.equal(got.logits, ref.logits), i
        assert _same_cache(got.kv, ref.kv), i


def test_least_recently_used_graph_goes_beyond_the_limit(monkeypatch,
                                                         eager_capture):
    monkeypatch.setattr(dg, "LIMIT", 2)
    params = params_of("bf16")
    states = [_state(params, "bf16", "bf16", max_len=P + 16 + k)
              for k in range(3)]
    refs = [_clone(s) for s in states]
    graphs = dg.DecodeGraphs()
    captures = _graph_count("captures")
    for i, k in enumerate([0, 1, 0, 2, 1, 0]):
        tok = _tokens(refs[k], i)
        eager_step(params, refs[k], tok)
        graphs.step(params, states[k], tok, CFG)
        states[k].step += 1
        assert torch.equal(states[k].logits, refs[k].logits), i
        assert _same_cache(states[k].kv, refs[k].kv), i
        assert len(graphs._graphs) <= 2
    # 0, 1, (0 kept), 2 drops 1, 1 drops 0, 0 drops 2
    assert _graph_count("captures") == captures + 5


def test_capture_increments_are_taken_back_and_added_per_replay():
    before = dg.counts()
    tfd.launches += 3
    tfd.launches_i8 += 1
    profiling.count("test.decode_graph", 2)
    up = dg.take_back(before)
    assert up == ({(tfd, "launches"): 3, (tfd, "launches_i8"): 1},
                  {"test.decode_graph": 2})
    assert dg.counts()[0] == before[0]
    assert profiling.counters().get("test.decode_graph", 0) == \
        before[1].get("test.decode_graph", 0)
    dg.add(up)
    dg.add(up)
    assert tfd.launches == before[0][(tfd, "launches")] + 6
    assert tfd.launches_i8 == before[0][(tfd, "launches_i8")] + 2
    assert profiling.counters()["test.decode_graph"] == \
        before[1].get("test.decode_graph", 0) + 4


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
