"""Port Qwen3 q8_0 decoder against the JAX package, on the CPU.

A tiny Qwen3 (2 layers, head_dim 16, GQA 4/2) with JAX-initialised
weights quantized to q8_0 by the JAX package (``quantize_qwen3_params``,
``quantize_lm_head``, ``pack_qwen3_params``), converted to the port with
``models.weights``. Float32 compute on both sides; the projections run the
same bf16-product q8_0 contract. Compared: the q8_0 head bytes (exactly),
prefill logits and KV (cosine > 0.99999), and teacher-forced decode steps
fed the JAX greedy ids, so near-ties of random weights cannot flake.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fun_asr_gguf_tpu.models import generate as jax_gen
from fun_asr_gguf_tpu.models import qwen3 as jq
from fun_asr_gguf_tpu.models.config import Qwen3Config
from fun_asr_gguf_tpu.ops.quant_matmul import block_unpermute
from fun_asr_gguf_tpu_torch.models import generate as tgen
from fun_asr_gguf_tpu_torch.models import qwen3 as tq
from fun_asr_gguf_tpu_torch.models.weights import to_torch

torch.set_num_threads(2)

COS = 0.99999
CFG = Qwen3Config.tiny(vocab_size=512)
P, PROMPT, MAX_LEN = 16, 11, 32        # bucket, valid prompt, KV capacity


def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _np(x):
    return jax.tree_util.tree_map(np.array, jax.device_get(x))


@pytest.fixture(scope="module")
def params():
    base = jq.init_qwen3_params(jax.random.PRNGKey(0), CFG)
    jp = jq.pack_qwen3_params(jq.quantize_lm_head(
        jq.quantize_qwen3_params(base, mode="pallas"), CFG, mode="pallas"))
    return jp, to_torch(_np(jp))


@pytest.fixture(scope="module")
def prompt():
    rng = np.random.default_rng(0)
    emb = np.zeros((1, P, CFG.hidden), np.float32)
    emb[0, P - PROMPT:] = rng.normal(size=(PROMPT, CFG.hidden)) * 0.5
    mask = np.zeros((1, P), np.float32)
    mask[0, P - PROMPT:] = 1.0
    return emb, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_head_bytes_equal_jax(dtype):
    """The head is quantized from the embedding AS LOADED in the compute
    dtype, vocab padded to 1024: same bytes as the JAX quantizer."""
    base = jq.init_qwen3_params(jax.random.PRNGKey(1), CFG)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jp = jq.quantize_lm_head({**base, "embed": base["embed"].astype(jdt)},
                             CFG, mode="pallas")
    tp = tq.quantize_lm_head({"embed": torch.from_numpy(
        np.array(base["embed"])).to(tdt)}, CFG)
    ref = jp["lm_head_q"]
    assert tuple(tp["lm_head_q"].q.shape) == (1024, CFG.hidden)
    np.testing.assert_array_equal(tp["lm_head_q"].q.numpy(),
                                  _np(block_unpermute(ref.q)))
    np.testing.assert_array_equal(tp["lm_head_q"].d.numpy(), _np(ref.d))


def test_pack_matches_jax_layout(params):
    jp, tp = params
    for key in ("qkv_w", "gate_up_w", "o_w", "down_w"):
        np.testing.assert_array_equal(tp["layers"][key].q.numpy(),
                                      _np(block_unpermute(jp["layers"][key].q)))


@pytest.mark.parametrize("positions", [np.array([0, 1, 7]),
                                       np.array([[3], [40]])])
def test_rope_matches_jax(positions):
    rng = np.random.default_rng(2)
    cos, sin = jq.rope_cos_sin(jnp.asarray(positions), 16, 1e4, jnp.float32)
    tcos, tsin = tq.rope_cos_sin(torch.from_numpy(positions), 16, 1e4,
                                 torch.float32)
    np.testing.assert_allclose(tcos.numpy(), _np(cos), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tsin.numpy(), _np(sin), rtol=1e-5, atol=1e-5)
    x = rng.normal(size=(*positions.shape, 2, 16)).astype(np.float32)
    ref = jq.apply_rope(jnp.asarray(x), cos[..., None, :], sin[..., None, :])
    out = tq.apply_rope(torch.from_numpy(x), tcos[..., None, :],
                        tsin[..., None, :])
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


def test_prefill_and_teacher_forced_decode_match_jax(params, prompt):
    jp, tp = params
    emb, mask = prompt
    jlog, jkv = jq.qwen3_prefill(jp, jnp.asarray(emb), jnp.asarray(mask), CFG,
                                 kv_max_len=MAX_LEN)
    tlog, tkv = tq.qwen3_prefill(tp, torch.from_numpy(emb),
                                 torch.from_numpy(mask), CFG,
                                 kv_max_len=MAX_LEN)
    assert tlog.shape == (1, CFG.vocab_size)
    assert cosine(tlog.numpy(), _np(jlog)) > COS
    for got, want in ((tkv.k, jkv.k), (tkv.v, jkv.v)):
        want = _np(want)
        assert got.shape == want.shape
        assert cosine(got[:, :, P - PROMPT:P].numpy(),
                      want[:, :, P - PROMPT:P]) > COS

    step = jax.jit(jq.qwen3_decode_step, static_argnames=("cfg",))
    valid_from = np.array([P - PROMPT], np.int32)
    jlast = _np(jlog)
    for t in range(4):
        tok = int(np.argmax(jlast[0]))            # JAX greedy id, fed to both
        slot, pos = P + t, np.array([PROMPT + t], np.int32)
        jlg, jkv = step(jp, jkv, jp["embed"][jnp.asarray([tok])], slot,
                        jnp.asarray(pos), jnp.asarray(valid_from), cfg=CFG)
        tlg, tkv = tq.qwen3_decode_step(
            tp, tkv, tq.embed_tokens(tp, torch.tensor([tok])), slot,
            torch.from_numpy(pos).long(), torch.from_numpy(valid_from).long(),
            CFG)
        jlast = _np(jlg)
        assert cosine(tlg.numpy(), jlast) > COS, f"decode step {t}"
        assert cosine(tkv.k[:, 0, slot].numpy(), _np(jkv.k)[:, 0, slot]) > COS


def _zero_head(p, zeros):
    """Same decoder with a zero final norm: every logit is exactly 0, so
    the greedy id is exactly 0 on both sides (first index wins ties)."""
    return {**p, "final_ln": zeros}


def test_generate_chunk_fuse_and_stops_match_jax(params, prompt):
    jp, tp = params
    emb, mask = prompt
    jpz = _zero_head(jp, jnp.zeros_like(jp["final_ln"]))
    tpz = _zero_head(tp, torch.zeros_like(tp["final_ln"]))
    n = 40
    # token 0 repeats: the fuse (last 30 counted ids, <= 3 distinct) fires
    # on the 31st counted token and aborts the row
    js = jax_gen.prefill_init(jpz, jnp.asarray(emb), jnp.asarray(mask),
                              jax.random.PRNGKey(0), CFG, max_len=P + n)
    js, jtok = jax_gen.generate_chunk(jpz, js, CFG, jnp.float32(0.0),
                                      jnp.float32(1.0), chunk_len=n,
                                      greedy=True)
    ts = tgen.prefill_init(tpz, torch.from_numpy(emb),
                           torch.from_numpy(mask), torch.Generator(), CFG,
                           max_len=P + n)
    ttok = tgen.generate_chunk(tpz, ts, CFG, 0.0, 1.0, chunk_len=n)
    jtok = _np(jtok)
    assert (jtok[0, :31] == 0).all() and (jtok[0, 31:] == -1).all()
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    assert bool(ts.aborted[0]) and bool(_np(js.aborted)[0])
    assert int(ts.n_gen[0]) == int(_np(js.n_gen)[0]) == 31

    # a stop id ends the row at once and is not counted
    ts = tgen.prefill_init(tpz, torch.from_numpy(emb),
                           torch.from_numpy(mask), torch.Generator(), CFG,
                           max_len=P + 8)
    ttok = tgen.generate_chunk(tpz, ts, CFG, 0.0, 1.0, chunk_len=8,
                               stop_tokens=(0,))
    assert ttok[0].tolist() == [0] + [-1] * 7
    assert bool(ts.done[0]) and not bool(ts.aborted[0])
    assert int(ts.n_gen[0]) == 0


def test_generate_chunk_respects_limit(params, prompt):
    _, tp = params
    emb, mask = prompt
    ts = tgen.prefill_init(tp, torch.from_numpy(emb), torch.from_numpy(mask),
                           torch.Generator().manual_seed(0), CFG,
                           max_len=P + 8)
    tok = tgen.generate_chunk(tp, ts, CFG, 0.7, 0.9, chunk_len=8, limit=3)
    assert ts.step == 3 and (tok[0, 3:] == -1).all()
    assert ((tok[0, :3] >= 0) & (tok[0, :3] < CFG.vocab_size)).all()


@pytest.mark.parametrize("dtype,cos", [("float32", COS), ("bfloat16", 0.999)])
def test_prefill_above_16_rows_matches_jax(params, dtype, cos):
    # a 48-row bucket: every q8_0 projection takes K1's prefill product
    # (the GEMM on the card, above 16 rows); in bf16 compute the port asks
    # it for bf16 rows (matmul_any's out_dtype), JAX casts its f32 product
    jp, tp = params
    rng = np.random.default_rng(48)
    p2, valid = 48, 37
    emb = np.zeros((1, p2, CFG.hidden), np.float32)
    emb[0, p2 - valid:] = rng.normal(size=(valid, CFG.hidden)) * 0.5
    mask = np.zeros((1, p2), np.float32)
    mask[0, p2 - valid:] = 1.0
    jlog, jkv = jq.qwen3_prefill(jp, jnp.asarray(emb, dtype),
                                 jnp.asarray(mask), CFG, kv_max_len=64)
    tlog, tkv = tq.qwen3_prefill(tp, torch.from_numpy(emb).to(
        getattr(torch, dtype)), torch.from_numpy(mask), CFG, kv_max_len=64)
    assert tlog.shape == (1, CFG.vocab_size)
    assert cosine(tlog.float().numpy(), _np(jlog).astype(np.float32)) > cos
    for got, want in ((tkv.k, jkv.k), (tkv.v, jkv.v)):
        assert cosine(got[:, :, p2 - valid:p2].float().numpy(),
                      _np(want)[:, :, p2 - valid:p2].astype(np.float32)) > cos
