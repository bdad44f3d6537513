"""Port kernels' plain versions against the JAX package's, on the CPU.

K1 (q8_0 dequant-matmul), K2 (decode attention) and K3 (masked encoder
attention) of ``fun_asr_gguf_tpu_torch.ops`` take their plain PyTorch
version on CPU tensors; each is held against the JAX reference path
(``use_pallas=False`` / the XLA attention) and against the Pallas kernel
in interpret mode, on the same numpy inputs made from a seed. Plus the
sampler's candidate distribution and greedy draw.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fun_asr_gguf_tpu.models.config import Qwen3Config
from fun_asr_gguf_tpu.models.qwen3 import _attend_cache
from fun_asr_gguf_tpu.ops import sampling as jax_sampling
from fun_asr_gguf_tpu.ops.flash_attention import \
    attention_with_mask as jax_attention_with_mask
from fun_asr_gguf_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from fun_asr_gguf_tpu.ops.flash_decode import \
    flash_decode_attention as jax_flash_decode
from fun_asr_gguf_tpu.ops.quant_matmul import (block_unpermute, quant_matmul,
                                               quantize_weight)
from fun_asr_gguf_tpu_torch.models.weights import q8_from_jax
from fun_asr_gguf_tpu_torch.ops import flash_attention as tfa
from fun_asr_gguf_tpu_torch.ops import flash_decode as tfd
from fun_asr_gguf_tpu_torch.ops import quant_matmul as tqm
from fun_asr_gguf_tpu_torch.ops import sampling as tsp

torch.set_num_threads(2)


def _np(x):
    return np.array(jax.device_get(x))


def _qt(rng, k, n):
    w = jnp.asarray(rng.normal(size=(k, n)) * 0.05, jnp.float32)
    return jax.tree_util.tree_map(np.asarray, quantize_weight(w))


# --------------------------------------------------------------------- K1

@pytest.mark.parametrize("m", [1, 7, 64])
def test_q8_matmul_plain_matches_jax_reference(m):
    # same bf16 products (q*d rounded once, x rounded to bf16), f32 sums in
    # another order: agreement to f32 rounding of the sums
    rng = np.random.default_rng(m)
    qt = _qt(rng, 128, 256)
    x = rng.normal(size=(m, 128)).astype(np.float32)
    ref = _np(quant_matmul(jnp.asarray(x), qt, use_pallas=False))
    out = tqm.q8_matmul(torch.from_numpy(x), q8_from_jax(qt))
    assert out.dtype == torch.float32 and out.shape == (m, 256)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [1, 7, 64])
def test_q8_matmul_plain_matches_pallas_interpret(m):
    # the Pallas body rounds d to bf16 BEFORE the multiply (a second
    # rounding the port does not copy): weights differ by <= 1 bf16 ulp
    rng = np.random.default_rng(10 + m)
    qt = _qt(rng, 128, 256)
    x = rng.normal(size=(m, 128)).astype(np.float32)
    ref = _np(quant_matmul(jnp.asarray(x), qt, tile_n=256, use_pallas=True,
                           interpret=True))
    out = tqm.q8_matmul(torch.from_numpy(x), q8_from_jax(qt)).numpy()
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()


# the decode-sized rows the port's kernel serves (m = 2..16: a verify
# round is 9), at Qwen3-0.6B's widest k (2048: o; 3072: down) and n not a
# multiple of 32 (the kernel's ring tiles)
DECODE_SIZED = [(2, 2048, 200), (9, 2048, 200), (8, 3072, 72),
                (16, 3072, 72)]


@pytest.mark.parametrize("m,k,n", DECODE_SIZED)
def test_q8_matmul_plain_matches_jax_reference_at_decode_sized_rows(m, k, n):
    # as test_q8_matmul_plain_matches_jax_reference
    rng = np.random.default_rng(m + k + n)
    qt = _qt(rng, k, n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    ref = _np(quant_matmul(jnp.asarray(x), qt, use_pallas=False))
    out = tqm.q8_matmul(torch.from_numpy(x), q8_from_jax(qt))
    assert out.dtype == torch.float32 and out.shape == (m, n)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,n", DECODE_SIZED)
def test_q8_matmul_plain_matches_pallas_interpret_at_decode_sized_rows(m, k,
                                                                       n):
    # as test_q8_matmul_plain_matches_pallas_interpret (one tile of n rows)
    rng = np.random.default_rng(20 + m + k + n)
    qt = _qt(rng, k, n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    ref = _np(quant_matmul(jnp.asarray(x), qt, tile_n=n, use_pallas=True,
                           interpret=True))
    out = tqm.q8_matmul(torch.from_numpy(x), q8_from_jax(qt)).numpy()
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()


def test_q8_weight_is_the_natural_order_of_the_jax_bytes():
    rng = np.random.default_rng(1)
    qt = _qt(rng, 96, 64)
    w = q8_from_jax(qt)
    np.testing.assert_array_equal(w.q.numpy(), _np(block_unpermute(qt.q)))
    np.testing.assert_array_equal(w.d.numpy(), qt.d)


def test_matmul_any_flattens_leading_dims():
    rng = np.random.default_rng(2)
    qt = _qt(rng, 64, 32)
    x = torch.from_numpy(rng.normal(size=(2, 3, 64)).astype(np.float32))
    out = tqm.matmul_any(x, q8_from_jax(qt))
    flat = tqm.q8_matmul(x.reshape(6, 64), q8_from_jax(qt))
    assert torch.equal(out.reshape(6, 32), flat)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    w = q8_from_jax(_qt(rng, 64, 32))
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    before = tqm.launches
    assert torch.equal(tqm.q8_matmul(x, w), tqm.q8_matmul_plain(x, w))
    assert tqm.launches == before


# --------------------------------------------------------------------- K2

CFG = Qwen3Config(hidden=64, n_layers=1, q_heads=4, kv_heads=2, head_dim=128,
                  ffn_dim=128, vocab_size=64)


def _decode_inputs(b, t, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, CFG.q_heads, CFG.head_dim)).astype(np.float32)
    k = rng.normal(size=(b, s, CFG.kv_heads, CFG.head_dim)).astype(np.float32)
    v = rng.normal(size=(b, s, CFG.kv_heads, CFG.head_dim)).astype(np.float32)
    lo = rng.integers(0, s // 4, size=(b,))
    hi = rng.integers(s // 2, s + 1, size=(b,))
    j = np.arange(s)[None, :]
    vis = (j >= lo[:, None]) & (j < hi[:, None])
    bias = np.broadcast_to(np.where(vis, 0.0, -1e30)[:, None, :],
                           (b, t, s)).astype(np.float32).copy()
    return q, k, v, bias


@pytest.mark.parametrize("b,t,s", [(1, 1, 64), (2, 1, 96), (1, 3, 64)])
def test_flash_decode_plain_matches_attend_cache(b, t, s):
    # f32 throughout on both sides: only the q pre-scaling order differs
    q, k, v, bias = _decode_inputs(b, t, s, seed=b * 10 + t)
    ref = _np(_attend_cache(jnp.asarray(q), jnp.asarray(k)[None],
                            jnp.asarray(v)[None], 0,
                            jnp.asarray(bias)[:, None], CFG))
    qs = torch.from_numpy(q) * CFG.head_dim ** -0.5
    out = tfd.flash_decode_attention(qs, torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.from_numpy(bias))
    assert out.shape == (b, CFG.q_heads, t, CFG.head_dim)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,t,s", [(1, 1, 64), (1, 2, 128)])
def test_flash_decode_plain_matches_pallas_interpret(b, t, s):
    # bf16 cache on both sides; the Pallas kernel mixes UNnormalised bf16
    # probabilities and divides after, the port normalises first (the
    # _attend_cache order): outputs agree to a few bf16 ulps
    q, k, v, bias = _decode_inputs(b, t, s, seed=7 + s)
    qs = (q * CFG.head_dim ** -0.5).astype(np.float32)
    bf = jnp.bfloat16
    ref = _np(jax_flash_decode(jnp.asarray(qs, bf), jnp.asarray(k, bf),
                               jnp.asarray(v, bf), jnp.asarray(bias),
                               interpret=True)).astype(np.float32)
    tb = torch.bfloat16
    out = tfd.flash_decode_attention(
        torch.from_numpy(qs).to(tb), torch.from_numpy(k).to(tb),
        torch.from_numpy(v).to(tb), torch.from_numpy(bias))
    assert out.dtype == tb
    np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2, rtol=0)


# --------------------------------------------------------------------- K3

def _attn_inputs(bh, t, d, valid, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(bh, t, d)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(bh, t, d)) * 0.3).astype(np.float32)
    v = rng.normal(size=(bh, t, d)).astype(np.float32)
    mask = (np.arange(t)[None, :] < valid).astype(np.float32)
    return q, k, v, np.repeat(mask, bh, axis=0)


@pytest.mark.parametrize("t,valid", [(37, 30), (100, 100), (256, 200)])
def test_flash_attention_plain_matches_jax(t, valid):
    q, k, v, mask = _attn_inputs(4, t, 16, valid, seed=t)
    bias = (mask - 1.0) * 1e4
    ref = _np(jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(bias),
                                  use_pallas=False))
    out = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,valid", [(37, 30), (300, 290)])
def test_attention_with_mask_matches_pallas_interpret(t, valid):
    # ragged T: the JAX wrapper pads to 256 for the Pallas kernel, the port
    # masks the edge instead; f32 operands, so agreement is to f32 sums
    q, k, v, mask = _attn_inputs(2, t, 16, valid, seed=100 + t)
    shape = (1, 2, t, 16)
    ref = _np(jax_attention_with_mask(
        *(jnp.asarray(a.reshape(shape)) for a in (q, k, v)),
        jnp.asarray(mask[:1]), use_pallas=True, interpret=True))
    out = tfa.attention_with_mask(
        *(torch.from_numpy(a.reshape(shape)) for a in (q, k, v)),
        torch.from_numpy(mask[:1]))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- sampling

@pytest.mark.parametrize("temperature,top_p,top_k", [(0.4, 1.0, 50),
                                                      (0.7, 0.9, 20),
                                                      (1.3, 0.5, 0)])
def test_warped_candidates_match_jax(temperature, top_p, top_k):
    rng = np.random.default_rng(int(temperature * 10))
    logits = (rng.normal(size=(2, 300)) * 3).astype(np.float32)
    ref_p, ref_i = jax_sampling.warped_candidates(
        jnp.asarray(logits), temperature, top_p, top_k)
    p, i = tsp.warped_candidates(torch.from_numpy(logits), temperature,
                                 top_p, top_k)
    np.testing.assert_array_equal(i.numpy(), _np(ref_i))
    np.testing.assert_allclose(p.numpy(), _np(ref_p), rtol=1e-5, atol=1e-6)


def test_greedy_sample_token_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 1000)).astype(np.float32)
    ref = _np(jax_sampling.sample_token(jnp.asarray(logits),
                                        jax.random.PRNGKey(0), 0.0, 1.0,
                                        greedy=True))
    gen = torch.Generator().manual_seed(0)
    out = tsp.sample_token(torch.from_numpy(logits), gen, 0.0, 1.0)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sampled_tokens_stay_in_the_warped_support():
    rng = np.random.default_rng(6)
    logits = torch.from_numpy((rng.normal(size=(4, 500)) * 2).astype(
        np.float32))
    probs, idx = tsp.warped_candidates(logits, 0.8, 0.7, 30)
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        tok = tsp.sample_token(logits, gen, 0.8, 0.7, 30)
        for r in range(4):
            pos = (idx[r] == tok[r]).nonzero()
            assert pos.numel() == 1 and probs[r, pos[0, 0]] > 0


# ------------------------------------------------ K1's prefill output type

@pytest.mark.parametrize("m", [17, 48])
@pytest.mark.parametrize("cls", [tqm.Q8Weight, tqm.Q8DotWeight])
def test_matmul_any_bf16_rows_are_the_f32_product_cast(m, cls):
    # the decoder's projections ask for their compute dtype: above 16 rows
    # the card's GEMM writes bf16 itself, from the f32 sums; the plain
    # version casts its f32 product, so both compute one function
    rng = np.random.default_rng(m)
    w = cls(*q8_from_jax(_qt(rng, 96, 40)))
    x = torch.from_numpy(rng.normal(size=(2, m // 2 + m % 2, 96)).astype(
        np.float32)).bfloat16()
    f32 = tqm.matmul_any(x, w)
    bf16 = tqm.matmul_any(x, w, torch.bfloat16)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert bf16.shape == f32.shape == (*x.shape[:-1], 40)
    assert torch.equal(bf16, f32.to(torch.bfloat16))
