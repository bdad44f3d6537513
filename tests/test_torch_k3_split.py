"""K3's key split and combine, in plain PyTorch, against the JAX package.

The CUDA kernel (``csrc/flash_attention.cu``) splits the 64-key tiles of
each query tile into contiguous chunks, one block each, keeps each chunk's
online-softmax statistics (m, l, o) in f32 with P rounded to bf16 for
P.V, and combines the chunks in rank order.
``ops.flash_attention.flash_attention_split_plain`` is that arithmetic;
here it is held against JAX's ``flash_attention`` (the XLA reference,
``use_pallas=False``, and the Pallas kernel in interpret mode, whose
64-key loop is the one-chunk case) on the same numpy inputs, at ragged T,
masked tails and chunks past the last key. Plus the chunk rule and the
strided ``attention_with_mask`` (SANM's views of a packed projection).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fun_asr_gguf_tpu.ops.flash_attention import \
    attention_with_mask as jax_attention_with_mask
from fun_asr_gguf_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from fun_asr_gguf_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)


def _inputs(bh, t, d, valid, seed):
    """bf16-exact q (pre-scaled), k, v and the [BH, T] key bias."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()
    q = bf16(rng.normal(size=(bh, t, d)) * d ** -0.5)
    k = bf16(rng.normal(size=(bh, t, d)))
    v = bf16(rng.normal(size=(bh, t, d)))
    mask = (np.arange(t)[None, :] < valid).astype(np.float32)
    bias = np.repeat((mask - 1.0) * 1e4, bh, axis=0).astype(np.float32)
    return q, k, v, bias


def _split(q, k, v, bias, chunks):
    return tfa.flash_attention_split_plain(
        *(torch.from_numpy(a) for a in (q, k, v, bias)), chunks).numpy()


@pytest.mark.parametrize("t", [1, 17, 63, 64, 65, 200, 257])
@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
def test_split_plain_matches_jax_reference(t, chunks):
    # the XLA reference takes P in f32, the split model in bf16 for P.V
    # (as the kernel and the Pallas body do): agreement to bf16 rounding
    # of the probabilities, a few 1e-3 of |v| ~ 1
    q, k, v, bias = _inputs(3, t, 32, max(1, t - 5), seed=t + 10 * chunks)
    ref = np.asarray(jax_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)), use_pallas=False))
    np.testing.assert_allclose(_split(q, k, v, bias, chunks), ref,
                               rtol=0, atol=1e-2)


@pytest.mark.parametrize("t", [64, 128, 256])
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_split_plain_matches_pallas_interpret(t, chunks):
    # bf16 operands through the Pallas kernel's own 64-key online loop
    # (interpret mode): one chunk is its tile order, more chunks reorder
    # only the f32 statistics
    q, k, v, bias = _inputs(2, t, 64, t - 3, seed=t + chunks)
    ref = np.asarray(jax_flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(bias), block_q=64, block_k=64, use_pallas=True,
        interpret=True).astype(jnp.float32))
    out = tfa.flash_attention_split_plain(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        torch.from_numpy(bias), chunks).float().numpy()
    # both round the output to bf16: a bf16 ulp of |out| <= ~1
    np.testing.assert_allclose(out, ref, rtol=0, atol=1.6e-2)


@pytest.mark.parametrize("t,chunks", [(65, 4), (130, 8), (1, 2)])
def test_chunks_past_the_last_key_weigh_nothing(t, chunks):
    # 65 keys are 2 tiles: chunks 2 and 3 of 4 hold no key (l = 0, o = 0);
    # the result is the two-chunk combine's, bit for bit
    q, k, v, bias = _inputs(2, t, 16, t, seed=t)
    tiles = -(-t // tfa.TILE)
    np.testing.assert_array_equal(_split(q, k, v, bias, chunks),
                                  _split(q, k, v, bias, min(chunks, tiles)))


def test_a_fully_masked_chunk_keeps_its_weight_finite():
    # the keys of the second chunk are all masked: its m is ~ -1e4 below
    # the first's, e^(m_c - M) underflows to 0, nothing is NaN
    q, k, v, bias = _inputs(2, 128, 16, 64, seed=5)
    out = _split(q, k, v, bias, 2)
    ref = np.asarray(jax_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)), use_pallas=False))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2)


@pytest.mark.parametrize("bh,t,sms,want", [
    (4, 1001, 132, 2),     # the 60 s clip's encoder: 64 blocks of 8 tiles
    (4, 257, 132, 4),
    (4, 63, 132, 1),       # one key tile
    (1, 1, 132, 1),
    (4, 130, 132, 2),      # three key tiles: at most two chunks of them
    (64, 1001, 132, 1),    # a batch fills the card without a split
])
def test_attention_chunks(bh, t, sms, want):
    got = tfa.attention_chunks(bh, t, sms)
    assert got == want
    tiles = -(-t // tfa.TILE)
    assert got & (got - 1) == 0 and 1 <= got <= min(tfa.MAX_CHUNKS, tiles)
    assert got == 1 or bh * -(-t // tfa.ROWS) * got <= sms


@pytest.mark.parametrize("t,valid", [(37, 30), (257, 250)])
def test_strided_attention_with_mask_matches_jax(t, valid):
    # SANM's heads: views of one packed [B, T, 3 H D] projection (k and v
    # never copied), q scaled; the port's entry against JAX's
    b, h, d = 2, 4, 16
    rng = np.random.default_rng(t)
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * h * d)).astype(
        np.float32))
    qv, kv, vv = qkv.split(h * d, dim=-1)

    def heads(x):
        return x.reshape(b, t, h, d).transpose(1, 2)
    qh, kh, vh = heads(qv) * d ** -0.5, heads(kv), heads(vv)
    assert not kh.is_contiguous() and kh.data_ptr() != qkv.data_ptr()
    mask = torch.from_numpy(
        (np.arange(t)[None, :] < np.array([[valid], [t]])).astype(np.float32))
    ref = np.asarray(jax_attention_with_mask(
        *(jnp.asarray(a.contiguous().numpy()) for a in (qh, kh, vh)),
        jnp.asarray(mask.numpy()), use_pallas=False))
    out = tfa.attention_with_mask(qh, kh, vh, mask)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
