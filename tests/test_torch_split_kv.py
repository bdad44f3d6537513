"""The split-KV attention the port's kernels run (K2, K2-i8, K5's
attention, the P12 probe), and the P5 probe, on the CPU.

* ``flash_decode.split_kv_plain`` — the chunked combine of
  ``csrc/split_kv.cuh`` written on tensors — against JAX's
  ``flash_decode_attention`` (Pallas, ``interpret=True``) on the same seeded
  numpy inputs: T = 1 and 9, bf16 and int8 caches, 1, 2 and 7 chunks with
  an uneven last chunk, and visible slots in one chunk only (rtol / atol
  0.03 in bf16, as ``tests/test_flash_decode.py``); in float32 against
  ``_attend_cache`` (cosine > 0.99999).
* The same function started from the current token against P12's
  reference on P12's inputs, and no caller hands K2 a row with no visible
  slot (the one case where the combine and the exact softmax differ).
* The P5 probe's plain versions against numpy.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fun_asr_gguf_tpu.models import qwen3 as jq
from fun_asr_gguf_tpu.models.config import Qwen3Config
from fun_asr_gguf_tpu.ops.flash_decode import \
    flash_decode_attention as jax_flash_decode
from fun_asr_gguf_tpu_torch.models import generate as tgen
from fun_asr_gguf_tpu_torch.models import qwen3 as tq
from fun_asr_gguf_tpu_torch.models.weights import to_torch
from fun_asr_gguf_tpu_torch.ops import flash_decode as tfd
from fun_asr_gguf_tpu_torch.probes import q8_bw_probe as p5
from fun_asr_gguf_tpu_torch.probes import q8_mega_probes as p12

torch.set_num_threads(2)

QH, KH, HD = 4, 2, 128
ACFG = Qwen3Config(hidden=128, n_layers=1, q_heads=QH, kv_heads=KH,
                   head_dim=HD, ffn_dim=256, vocab_size=64)
S = 200                 # 7 chunks of 29 slots: the last one has 26


def _np(x):
    return jax.tree_util.tree_map(np.array, jax.device_get(x))


def _t(a):
    """numpy (ml_dtypes bf16 included) → tensor, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _inputs(b, t, seed, jdt, window=None):
    """Pre-scaled q [B,T,qh,hd], a cache layer (k, v; int8 values and
    scales too) and the verify mask [B,T,S]: row b sees slots [lo_b,
    hi_b - T + i] from query row i, or only ``window`` when given."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, t, QH, HD)) * HD ** -0.5).astype(np.float32)

    def raw():
        return (rng.normal(size=(b, S, KH, HD))
                * rng.uniform(0.2, 3.0, size=(b, S, KH, 1))).astype(np.float32)
    k, v = raw(), raw()
    j = np.arange(S)[None, None, :]
    if window is None:
        lo = rng.integers(0, S // 4, size=(b,))[:, None, None]
        hi = rng.integers(S // 2, S + 1, size=(b,))[:, None, None]
        vis = (j >= lo) & (j < hi - t + 1 + np.arange(t)[None, :, None])
    else:
        vis = (j >= window[0]) & (j < window[1] + np.arange(t)[None, :, None])
    bias = np.where(vis, 0.0, -1e30).astype(np.float32)
    jq_, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    return jq_, jk, jv, bias


def _chunk(n):
    return -(-S // n)


@pytest.mark.parametrize("n_chunks", [1, 2, 7])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("t", [1, 9])
def test_split_kv_plain_matches_jax_pallas(t, cache, n_chunks):
    q, k, v, bias = _inputs(2, t, seed=10 * t + n_chunks, jdt=jnp.bfloat16)
    if cache == "int8":
        (kq, ks), (vq, vs) = jq._kv_quantize(k), jq._kv_quantize(v)
        want = jax_flash_decode(q, kq, vq, jnp.asarray(bias), ks, vs,
                                interpret=True)
        args = [_t(_np(a)) for a in (q, kq, vq)] + [_t(bias)]
        scales = dict(k_scale=_t(_np(ks)), v_scale=_t(_np(vs)))
    else:
        want = jax_flash_decode(q, k, v, jnp.asarray(bias), interpret=True)
        args = [_t(_np(a)) for a in (q, k, v)] + [_t(bias)]
        scales = {}
    got = tfd.split_kv_plain(*args, _chunk(n_chunks), **scales)
    assert got.shape == (2, QH, t, HD) and got.dtype == torch.bfloat16
    # bf16 output; the probabilities are rounded at another point
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want).astype(np.float32),
                               rtol=0.03, atol=0.03)
    exact = tfd.flash_decode_plain(*args, scales.get("k_scale"),
                                   scales.get("v_scale"))
    np.testing.assert_allclose(got.float().numpy(), exact.float().numpy(),
                               rtol=0.03, atol=0.03)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("t", [1, 9])
def test_split_kv_plain_with_visible_slots_in_one_chunk_only(t, cache):
    """7 chunks of 29 slots; the rows see slots [60, 70 + i): chunk 2."""
    q, k, v, bias = _inputs(1, t, seed=3 + t, jdt=jnp.bfloat16,
                            window=(60, 70))
    if cache == "int8":
        (kq, ks), (vq, vs) = jq._kv_quantize(k), jq._kv_quantize(v)
        want = jax_flash_decode(q, kq, vq, jnp.asarray(bias), ks, vs,
                                interpret=True)
        got = tfd.split_kv_plain(*(_t(_np(a)) for a in (q, kq, vq)),
                                 _t(bias), _chunk(7), _t(_np(ks)),
                                 _t(_np(vs)))
    else:
        want = jax_flash_decode(q, k, v, jnp.asarray(bias), interpret=True)
        got = tfd.split_kv_plain(*(_t(_np(a)) for a in (q, k, v)), _t(bias),
                                 _chunk(7))
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want).astype(np.float32),
                               rtol=0.03, atol=0.03)


@pytest.mark.parametrize("n_chunks", [1, 2, 7])
@pytest.mark.parametrize("t", [1, 9])
def test_split_kv_plain_float32_matches_attend_cache(t, n_chunks):
    q, k, v, bias = _inputs(2, t, seed=50 + t + n_chunks, jdt=jnp.float32)
    # _attend_cache scales q itself: hand it the unscaled rows
    ref = jq._attend_cache(q * HD ** 0.5, k[None], v[None], 0,
                           jnp.asarray(bias)[:, None], ACFG)
    got = tfd.split_kv_plain(*(_t(_np(a)) for a in (q, k, v)), _t(bias),
                             _chunk(n_chunks))
    assert got.dtype == torch.float32
    assert _cosine(got.numpy(), _np(ref)) > 0.99999


def test_split_kv_plain_reads_nothing_for_a_batch_row_without_visible_slots():
    """No tile of batch row 0 is visible to any of its query rows: every
    tile is skipped and the row gives 0 (the exact softmax would give the
    mean of V); batch row 1 is unaffected."""
    q, k, v, bias = _inputs(2, 2, seed=9, jdt=jnp.bfloat16)
    bias[0] = -1e30
    args = [_t(_np(a)) for a in (q, k, v)] + [_t(bias)]
    got = tfd.split_kv_plain(*args, 32)
    assert (got[0] == 0).all()
    np.testing.assert_allclose(got[1].float().numpy(),
                               tfd.flash_decode_plain(*args)[1].float().numpy(),
                               rtol=0.03, atol=0.03)


@pytest.mark.parametrize("n_chunks", list(p12.CHUNK_COUNTS))
def test_split_kv_current_token_start_matches_p12_reference(n_chunks):
    """P12's inputs (rounded to bf16) through the stage with the current
    token first, at every chunk count the probe times, against P12's
    reference in torch and in numpy (P12's own loop, f32)."""
    args = p12.p12_inputs()
    ref = p12.p12_plain(*args)
    q, k, v, kc, vc, bias = (a.float().numpy() for a in args)
    want = np.zeros((p12.QH, p12.D), np.float32)
    for h in range(p12.KH):
        kh = np.concatenate([k[h][:p12.SLOT], kc[h][None]])
        vh = np.concatenate([v[h][:p12.SLOT], vc[h][None]])
        for j in range(2):
            s = kh @ q[2 * h + j] * p12.D ** -0.5
            p = np.exp(s - s.max())
            want[2 * h + j] = (p / p.sum()) @ vh
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-4, atol=1e-5)
    before = p12.launches
    got = p12.p12_stage(*args, -(-p12.S // n_chunks))
    assert got.shape == (p12.QH, p12.D) and got.dtype == torch.float32
    assert p12.launches == before
    # bf16 probabilities in the mix
    assert p12.rel_err(got, ref) < p12.TOL


def test_no_caller_hands_k2_a_row_without_a_visible_slot(monkeypatch):
    """The decode and verify steps write the current rows into the cache
    before they attend, so every query row K2 sees has a visible slot —
    the case where the split combine (0) and the exact softmax (the mean
    of V) would differ never arises. Checked on prefill + generate +
    verify of a tiny decoder, left-padded prompt."""
    cfg = Qwen3Config.tiny(vocab_size=97)
    params = to_torch(_np(jq.pack_qwen3_params(
        jq.init_qwen3_params(jax.random.PRNGKey(0), cfg))))
    seen = []
    attend = tq.flash_decode_attention

    def checked(q, k, v, bias, *scales):
        seen.append(bool((bias > -1e29).any(-1).all()))
        return attend(q, k, v, bias, *scales)
    monkeypatch.setattr(tq, "flash_decode_attention", checked)
    rng = np.random.default_rng(0)
    emb = torch.from_numpy((rng.normal(size=(1, 8, cfg.hidden)) * 0.1
                            ).astype(np.float32))
    mask = torch.ones(1, 8)
    mask[:, :3] = 0
    for kv_int8 in (False, True):
        st = tgen.prefill_init(params, emb, mask, torch.Generator(), cfg,
                               max_len=40, kv_int8=kv_int8)
        tgen.generate_chunk(params, st, cfg, 0.0, 1.0, 50, chunk_len=3,
                            stop_tokens=(96,))
        toks = torch.from_numpy((rng.normal(size=(1, 5, cfg.hidden)) * 0.1
                                 ).astype(np.float32))
        slot = st.prompt_slots + st.step
        tq.qwen3_verify_step(params, st.kv, toks, torch.tensor([slot]),
                             st.prompt_len[:, None] + st.step
                             + torch.arange(5)[None], st.valid_from, cfg)
    assert len(seen) >= 2 * 4 * cfg.n_layers and all(seen)


# ---------------------------------------------------------------------------
# P5: the plain versions against numpy
# ---------------------------------------------------------------------------

SMALL = (("o", 64, 1024), ("gate_up", 96, 512), ("down", 64, 1536),
         ("qkv", 80, 512))


def _weights():
    return p5.make_weights("cpu", layers=2, shapes=SMALL, seed=3)


def test_p5a_stream_sum_plain_matches_numpy():
    ws = _weights()
    got_i, got_f = p5.stream_sum(ws)
    assert got_i == sum(int(w.q.numpy().astype(np.int64).sum()) for w in ws)
    want_f = sum(float(w.d.numpy().astype(np.float64).sum()) for w in ws)
    assert abs(got_f - want_f) <= 1e-9 * abs(want_f)
    assert p5.n_bytes(ws) == sum(2 * n * k * 1.125 for _, n, k in SMALL)


def _gemv_numpy(ws, x):
    bf = ml_dtypes.bfloat16
    xb = x.float().numpy()[0]
    out = []
    for l in range(2):
        row = []
        for w in ws:
            q = w.q[l].numpy().astype(np.float32)
            d = np.repeat(w.d[l].float().numpy(), 32, axis=1)
            deq = (q * d).astype(bf).astype(np.float64)
            row.append(deq @ xb[:q.shape[1]].astype(np.float64))
        out.append(np.concatenate(row))
    return np.stack(out)


@pytest.mark.parametrize("scales", ["f32", "f16"])
def test_p5_gemv_plain_matches_numpy(scales):
    """(b) with f32 block scales, (c) with the same scales in f16 (every
    scale is f16-representable, so both give the same product)."""
    ws = _weights()
    if scales == "f16":
        ws = [p5.Q8Weight(w.q, w.d.half()) for w in ws]
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 1536)).astype(np.float32)).to(torch.bfloat16)
    got = p5.gemv(ws, x)
    assert got.shape == (2, sum(n for _, n, _ in SMALL))
    want = _gemv_numpy(ws, x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
