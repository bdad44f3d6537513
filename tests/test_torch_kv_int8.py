"""Port int8 KV cache and K2-i8 against the JAX package, on the CPU.

* ``_kv_quantize`` gives JAX's int8 values and scales bit for bit, in bf16
  and in float32.
* K2-i8's plain version (``flash_decode_attention`` with ``k_scale`` /
  ``v_scale`` on CPU tensors) against JAX's ``_attend_cache`` QuantKV
  branch and JAX's Pallas int8 branch in interpret mode, on the same
  quantized cache: T = 1 and T = 9, GQA 2, masked slots, b in {1, 3}
  (rtol / atol 0.03 in bf16, as ``tests/test_flash_decode.py``; cosine
  > 0.99999 against ``_attend_cache`` in float32).
* Greedy speculation over an int8 cache emits the plain loop's ids and
  JAX's; a verify round and sequential decode steps write the same int8
  rows.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fun_asr_gguf_tpu.models import generate as jgen
from fun_asr_gguf_tpu.models import qwen3 as jq
from fun_asr_gguf_tpu.models import speculative as jspec
from fun_asr_gguf_tpu.models.config import Qwen3Config
from fun_asr_gguf_tpu.ops.flash_decode import \
    flash_decode_attention as jax_flash_decode
from fun_asr_gguf_tpu_torch.models import generate as tgen
from fun_asr_gguf_tpu_torch.models import qwen3 as tq
from fun_asr_gguf_tpu_torch.models import speculative as tspec
from fun_asr_gguf_tpu_torch.models.weights import to_torch
from fun_asr_gguf_tpu_torch.ops import flash_decode as tfd

torch.set_num_threads(2)

COS = 0.99999


def _np(x):
    return jax.tree_util.tree_map(np.array, jax.device_get(x))


def _t(a, dtype=None):
    """numpy (ml_dtypes bf16 included) → tensor, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ---------------------------------------------------------------------------
# _kv_quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_equals_jax(dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(2, 9, 3, 32))
         * rng.uniform(0.01, 5.0, size=(2, 9, 3, 1))).astype(np.float32)
    a[0, 2, 1] = 0.0                      # an all-zero head row: scale 0
    a[1, 4, 0, :4] = [127.0, -127.0, 63.5, 0.5]
    ja = jnp.asarray(a, jdt)
    jqv, js = jq._kv_quantize(ja)
    tqv, ts = tq._kv_quantize(_t(_np(ja)))
    assert tqv.dtype == torch.int8 and ts.dtype == tdt
    np.testing.assert_array_equal(tqv.numpy(), _np(jqv))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  _np(js).astype(np.float32))


# ---------------------------------------------------------------------------
# K2-i8: the plain version against JAX
# ---------------------------------------------------------------------------

ACFG = Qwen3Config(hidden=128, n_layers=1, q_heads=4, kv_heads=2,
                   head_dim=128, ffn_dim=256, vocab_size=64)


def _cache_inputs(b, t, s, seed, jdt):
    """q [B,T,qh,hd] (unscaled), a quantized cache layer and a [B,T,S]
    bias: row b sees slots [lo_b, hi_b - T + i] from query row i (the
    verify mask), everything else is masked."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, 4, 128)).astype(np.float32)

    def raw():
        return (rng.normal(size=(b, s, 2, 128))
                * rng.uniform(0.2, 3.0, size=(b, s, 2, 1))).astype(np.float32)
    k, v = raw(), raw()
    lo = rng.integers(0, s // 4, size=(b,))
    hi = rng.integers(s // 2, s + 1, size=(b,))
    j = np.arange(s)[None, None, :]
    i = np.arange(t)[None, :, None]
    vis = (j >= lo[:, None, None]) & (j < hi[:, None, None] - t + 1 + i)
    bias = np.where(vis, 0.0, -1e30).astype(np.float32)
    kq, ks = jq._kv_quantize(jnp.asarray(k, jdt))
    vq, vs = jq._kv_quantize(jnp.asarray(v, jdt))
    return jnp.asarray(q, jdt), bias, kq, ks, vq, vs


def _port_i8(q, bias, kq, ks, vq, vs):
    qs = (q.astype(jnp.float32) * 128 ** -0.5).astype(q.dtype)
    return tfd.flash_decode_attention(_t(_np(qs)), _t(_np(kq)),
                                      _t(_np(vq)), _t(bias), _t(_np(ks)),
                                      _t(_np(vs)))


CASES = [(1, 1, 64), (3, 1, 96), (1, 9, 64), (3, 9, 128)]


@pytest.mark.parametrize("b,t,s", CASES)
def test_k2_i8_plain_matches_attend_cache_and_pallas_bf16(b, t, s):
    q, bias, kq, ks, vq, vs = _cache_inputs(b, t, s, b * 10 + t, jnp.bfloat16)
    ref = jq._attend_cache(q, jq.QuantKV(kq[None], ks[None]),
                           jq.QuantKV(vq[None], vs[None]), 0,
                           jnp.asarray(bias)[:, None], ACFG)
    qs = (q.astype(jnp.float32) * 128 ** -0.5).astype(q.dtype)
    pallas = jax_flash_decode(qs, kq, vq, jnp.asarray(bias), ks, vs,
                              interpret=True)
    out = _port_i8(q, bias, kq, ks, vq, vs)
    assert out.shape == (b, 4, t, 128) and out.dtype == torch.bfloat16
    for want in (ref, pallas):
        np.testing.assert_allclose(out.float().numpy(),
                                   _np(want).astype(np.float32),
                                   rtol=0.03, atol=0.03)


@pytest.mark.parametrize("b,t,s", CASES)
def test_k2_i8_plain_matches_attend_cache_float32(b, t, s):
    q, bias, kq, ks, vq, vs = _cache_inputs(b, t, s, b * 10 + t + 1,
                                            jnp.float32)
    ref = jq._attend_cache(q, jq.QuantKV(kq[None], ks[None]),
                           jq.QuantKV(vq[None], vs[None]), 0,
                           jnp.asarray(bias)[:, None], ACFG)
    out = _port_i8(q, bias, kq, ks, vq, vs)
    assert out.dtype == torch.float32
    assert _cosine(out.numpy(), _np(ref)) > COS


def test_k2_i8_plain_counts_no_launch():
    q, bias, kq, ks, vq, vs = _cache_inputs(1, 1, 32, 7, jnp.bfloat16)
    before = (tfd.launches, tfd.launches_i8)
    _port_i8(q, bias, kq, ks, vq, vs)
    assert (tfd.launches, tfd.launches_i8) == before


# ---------------------------------------------------------------------------
# greedy speculation over an int8 cache
# ---------------------------------------------------------------------------

SCFG = Qwen3Config.tiny(vocab_size=97)
STOPS = (96,)
SP = 6


@functools.lru_cache(maxsize=None)
def spec_weights():
    base = jq.init_qwen3_params(jax.random.PRNGKey(0), SCFG)
    jp = jq.quantize_qwen3_params_int8(jq.pack_qwen3_params(
        jq.quantize_lm_head_per_channel(base, SCFG)))
    return jp, to_torch(_np(jp))


def _spec_prompt():
    rng = np.random.default_rng(2)
    emb = (rng.normal(size=(1, SP, SCFG.hidden)) * 0.05).astype(np.float32)
    return emb, np.ones((1, SP), np.float32)


def _ids(row):
    return [int(t) for t in row.tolist() if t >= 0]


def _state(params):
    emb, mask = _spec_prompt()
    return tgen.prefill_init(params, torch.from_numpy(emb),
                             torch.from_numpy(mask), torch.Generator(), SCFG,
                             max_len=SP + 64, kv_int8=True)


def test_greedy_speculation_on_int8_cache_equals_plain_and_jax():
    jp, tp = spec_weights()
    emb, mask = _spec_prompt()

    def jstate():
        return jgen.prefill_init(jp, jnp.asarray(emb), jnp.asarray(mask),
                                 jax.random.PRNGKey(0), SCFG, max_len=SP + 64,
                                 kv_int8=True)

    st = _state(tp)
    assert isinstance(st.kv.k, tq.QuantKV)
    plain = _ids(tgen.generate_chunk(tp, st, SCFG, 0.0, 1.0, 50,
                                     chunk_len=24, stop_tokens=STOPS)[0])
    _, jtok = jgen.generate_chunk(jp, jstate(), SCFG, jnp.asarray(0.0),
                                  jnp.asarray(1.0), 50, chunk_len=24,
                                  stop_tokens=STOPS, greedy=True)
    assert plain == _ids(np.asarray(jtok)[0]) and len(plain) > 8
    for draft in (plain, plain[:10] + [3, 1, 4, 1, 5] + plain[10:18],
                  [5, 5, 5, 11, 13, 17, 19, 23]):
        buf = np.full((1, 48), -1, np.int64)
        buf[0, :len(draft)] = draft
        _, jtok = jspec.spec_generate_chunk(
            jp, jspec.spec_init(jstate()), jnp.asarray(buf, jnp.int32), SCFG,
            jnp.asarray(0.0), jnp.asarray(1.0), 50, spec_k=8, chunk_len=24,
            stop_tokens=STOPS, greedy=True)
        sst = tspec.spec_init(_state(tp))
        got = _ids(tspec.spec_generate_chunk(
            tp, sst, torch.from_numpy(buf), SCFG, 0.0, 1.0, 50, spec_k=8,
            chunk_len=24, stop_tokens=STOPS)[0])
        assert got == _ids(np.asarray(jtok)[0]) == plain
        if draft is plain:                # drafting really happened
            assert int(sst.rounds[0]) < len(got)


# ---------------------------------------------------------------------------
# verify rounds and decode steps write the same int8 rows
# ---------------------------------------------------------------------------

def test_int8_cache_verify_equals_sequential_decode_steps():
    """Quantization is per entry, so the rows one verify round writes and
    those of as many decode steps differ only by the f32 sums' order: the
    same logits, int8 values at most one step apart."""
    _, tp = spec_weights()
    base = _state(tp).kv

    def clone(kv):
        return tq.KVCache(*(tq.QuantKV(h.q.clone(), h.s.clone())
                            for h in kv))
    t = 5
    toks = torch.from_numpy((np.random.default_rng(5).normal(
        size=(1, t, SCFG.hidden)) * 0.1).astype(np.float32))
    vf, pos0 = torch.tensor([0]), torch.tensor([SP])
    seq_kv, seq = clone(base), []
    for i in range(t):
        lg, _ = tq.qwen3_decode_step(tp, seq_kv, toks[:, i], SP + i,
                                     pos0 + i, vf, SCFG)
        seq.append(lg)
    ver_kv = clone(base)
    got, _ = tq.qwen3_verify_step(tp, ver_kv, toks, torch.tensor([SP]),
                                  pos0[:, None] + torch.arange(t)[None, :],
                                  vf, SCFG)
    np.testing.assert_allclose(got.numpy(), torch.stack(seq, 1).numpy(),
                               rtol=2e-4, atol=2e-4)
    for a, b in zip(ver_kv, seq_kv):
        assert (a.q[:, :, :SP + t].int()
                - b.q[:, :, :SP + t].int()).abs().max() <= 1
        np.testing.assert_allclose(a.s.numpy(), b.s.numpy(), rtol=1e-5)
