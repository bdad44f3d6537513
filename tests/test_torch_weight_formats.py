"""Port weight formats (per-channel int8, bf16, q8_0) and the int8 KV cache
in the decoder and the engine, against the JAX package, on the CPU.

* ``quantize_qwen3_params_int8`` and ``quantize_lm_head_per_channel`` give
  JAX's int8 bytes and scales bit for bit on the same tree, in bf16 and in
  float32; the dense GGUF load gives exactly JAX's
  ``load_checkpoint(..., llm_keep_quantized=False)`` weights, and the int8
  quantizer on it JAX's bytes.
* Prefill logits, one decode step and one 9-row verify step against JAX's
  own steps on the same tree (carried across by ``models.weights``), with
  the JAX cache carried across too: int8 weights + int8 head, bf16
  weights, and the int8 KV cache under int8, bf16 and fused q8_0 weights
  (K4's plain version). Cosine > 0.99999 in float32.
* The engine on the CPU: the JAX facade's defaults resolve as JAX's do
  (float32 → dense, bf16 → int8 + the int8 head); ``int8`` and
  ``kv_cache_dtype="int8"`` transcribe; the CTC text equals JAX's engine's;
  greedy text with an int8 cache equals the bf16-cache engine's.
"""

import base64
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fun_asr_gguf_tpu.models import qwen3 as jq
from fun_asr_gguf_tpu.models.config import HybridConfig, Qwen3Config
from fun_asr_gguf_tpu.models.loaders import (create_random_checkpoint,
                                             load_checkpoint)
from fun_asr_gguf_tpu_torch.models import loaders as tload
from fun_asr_gguf_tpu_torch.models import qwen3 as tq
from fun_asr_gguf_tpu_torch.models.weights import (kv_from_jax,
                                                   q8_fused_from_jax,
                                                   to_torch)
from fun_asr_gguf_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(2)

COS = 0.99999
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return jax.tree_util.tree_map(np.array, jax.device_get(x))


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


CFG = Qwen3Config(n_layers=3, hidden=128, q_heads=4, kv_heads=2, head_dim=32,
                  ffn_dim=256, vocab_size=512, rope_theta=1e6, rms_eps=1e-6,
                  tie_embeddings=True)
P, MAX_LEN = 16, 32
PACKED = ("qkv_w", "o_w", "gate_up_w", "down_w")


def _assert_int8_equal(got, want):
    """A port Int8Weight against a JAX one, bit for bit."""
    assert isinstance(got, tqm.Int8Weight)
    assert got.w8.dtype == torch.int8 and got.scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.w8.numpy(), _np(want.w8))
    np.testing.assert_array_equal(got.scale.float().numpy(),
                                  _f32(_np(want.scale)))


# ---------------------------------------------------------------------------
# quantizers and the dense load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_weights_equal_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    base = jq.init_qwen3_params(jax.random.PRNGKey(1), CFG, dtype=jdt)
    want = jq.quantize_qwen3_params_int8(jq.pack_qwen3_params(base))
    tp = to_torch(_np(base), dtype=tdt)
    got = tq.quantize_qwen3_params_int8(tq.pack_qwen3_params(tp))
    # packing concatenates output channels: quantize∘pack == pack∘quantize
    other = tq.pack_qwen3_params(tq.quantize_qwen3_params_int8(tp))
    for key in PACKED:
        _assert_int8_equal(got["layers"][key], want["layers"][key])
        assert torch.equal(other["layers"][key].w8, got["layers"][key].w8)
        assert tuple(got["layers"][key].scale.shape[-2:]) == \
            (1, got["layers"][key].w8.shape[-1])
    assert got["layers"]["input_ln"].dtype == tdt


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_head_equals_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    base = jq.init_qwen3_params(jax.random.PRNGKey(2), CFG, dtype=jdt)
    jw, js = jq.quantize_lm_head_per_channel(base, CFG)["lm_head_i8"]
    tp = tq.quantize_lm_head_per_channel(to_torch(_np(base), dtype=tdt), CFG)
    w, s = tp["lm_head_i8"]
    assert w.shape == (CFG.hidden, CFG.vocab_size) and w.dtype == torch.int8
    assert s.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), _np(jw))
    np.testing.assert_array_equal(s.numpy(), _np(js))
    assert "lm_head_q" not in tp and "embed" in tp


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("formats") / "model")
    create_random_checkpoint(ckpt, HybridConfig.tiny(), seed=0)
    return ckpt


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_gguf_load_equals_jax(jax_ckpt, dtype):
    jdt, tdt = DTYPES[dtype]
    *_, jllm, jembed = load_checkpoint(jax_ckpt, dtype=jdt, llm_dtype=jdt,
                                       llm_keep_quantized=False)
    *_, tllm, embed = tload.load_checkpoint(jax_ckpt, dtype=tdt,
                                            llm_keep_quantized=False)
    want = to_torch(_np(jllm), dtype=tdt)
    assert set(tllm) == set(want) and set(tllm["layers"]) == \
        set(want["layers"])
    for key, w in want["layers"].items():
        got = tllm["layers"][key]
        assert got.dtype == w.dtype == tdt and torch.equal(got, w), key
    for key in ("embed", "final_ln"):
        assert torch.equal(tllm[key], want[key]), key
    np.testing.assert_array_equal(embed, jembed)
    # the int8 quantizer sees the same dtype-rounded values as JAX's
    jint8 = jq.quantize_qwen3_params_int8(jq.pack_qwen3_params(jllm))
    tint8 = tq.quantize_qwen3_params_int8(tq.pack_qwen3_params(tllm))
    for key in PACKED:
        _assert_int8_equal(tint8["layers"][key], jint8["layers"][key])


# ---------------------------------------------------------------------------
# decoder steps: int8 / bf16 / q8_0 weights, bf16 / int8 cache
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def step_trees(fmt):
    """(JAX tree, port tree) in float32 compute for a weight format:
    ``int8`` (per-channel int8 layers and head), ``bf16`` (dense) or
    ``q8_0`` (the fused tree, carried across from JAX's)."""
    base = jq.init_qwen3_params(jax.random.PRNGKey(0), CFG)
    if fmt == "int8":
        jp = jq.quantize_qwen3_params_int8(jq.pack_qwen3_params(
            jq.quantize_lm_head_per_channel(base, CFG)))
        return jp, to_torch(_np(jp))
    if fmt == "bf16":
        jp = jq.pack_qwen3_params(base)
        return jp, to_torch(_np(jp))
    jp = jq.fuse_qwen3_params_q8(jq.pack_qwen3_params(jq.quantize_lm_head(
        jq.quantize_qwen3_params(base, mode="pallas"), CFG, mode="pallas")))
    return jp, q8_fused_from_jax(_np(jp))


def _prompt():
    rng = np.random.default_rng(1)
    emb = (rng.normal(size=(2, P, CFG.hidden)) * 0.1).astype(np.float32)
    mask = np.ones((2, P), np.float32)
    mask[1, :5] = 0.0                     # a left-padded row
    emb[1, :5] = 0.0
    return emb, mask


def _dequant(half):
    """A port cache half (QuantKV or tensor) → f32 numpy values."""
    if isinstance(half, tq.QuantKV):
        return (half.q.float() * half.s.float()).numpy()
    return half.float().numpy()


def _jax_dequant(half):
    if isinstance(half, jq.QuantKV):
        return _f32(_np(half.q)) * _f32(_np(half.s))
    return _f32(_np(half))


SETTINGS = [("int8", False), ("bf16", False), ("int8", True), ("bf16", True),
            ("q8_0", True)]


def _jax_prefill(jp, kv8):
    emb, mask = _prompt()
    return jq.qwen3_prefill(jp, jnp.asarray(emb), jnp.asarray(mask), CFG,
                            kv_max_len=MAX_LEN, kv_int8=kv8)


@pytest.mark.parametrize("fmt,kv8", SETTINGS)
def test_prefill_matches_jax(fmt, kv8, monkeypatch):
    monkeypatch.delenv("FUNASR_UNROLL_DECODE", raising=False)
    jp, tp = step_trees(fmt)
    emb, mask = _prompt()
    want, jkv = _jax_prefill(jp, kv8)
    got, tkv = tq.qwen3_prefill(tp, torch.from_numpy(emb),
                                torch.from_numpy(mask), CFG,
                                kv_max_len=MAX_LEN, kv_int8=kv8)
    assert got.shape == (2, CFG.vocab_size) and tkv.max_len == MAX_LEN
    assert isinstance(tkv.k, tq.QuantKV) == kv8
    assert _cosine(got.numpy(), _np(want)) > COS
    for t_half, j_half in ((tkv.k, jkv.k), (tkv.v, jkv.v)):
        assert _cosine(_dequant(t_half), _jax_dequant(j_half)) > COS
    if kv8:
        assert tkv.k.q.data_ptr() != tkv.v.q.data_ptr()
        # per-entry rounding of f32 values summed in another order: at
        # most one int8 step apart
        diff = np.abs(tkv.k.q.numpy().astype(np.int32)
                      - _np(jkv.k.q).astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99


@pytest.mark.parametrize("fmt,kv8", SETTINGS)
def test_decode_step_matches_jax(fmt, kv8, monkeypatch):
    monkeypatch.delenv("FUNASR_UNROLL_DECODE", raising=False)
    jp, tp = step_trees(fmt)
    _, jkv = _jax_prefill(jp, kv8)
    tkv = kv_from_jax(_np(jkv))
    tok = (np.random.default_rng(2).normal(size=(2, CFG.hidden))
           * 0.1).astype(np.float32)
    valid_from = np.array([0, 5])
    want, jkv2 = jq.qwen3_decode_step(
        jp, jkv, jnp.asarray(tok), jnp.asarray(P, jnp.int32),
        jnp.asarray([P, P - 5], jnp.int32),
        jnp.asarray(valid_from, jnp.int32), CFG)
    got, tkv2 = tq.qwen3_decode_step(
        tp, tkv, torch.from_numpy(tok), P, torch.tensor([P, P - 5]),
        torch.from_numpy(valid_from), CFG)
    assert _cosine(got.numpy(), _np(want)) > COS
    for t_half, j_half in ((tkv2.k, jkv2.k), (tkv2.v, jkv2.v)):
        assert _cosine(_dequant(t_half)[:, :, P],
                       _jax_dequant(j_half)[:, :, P]) > COS


@pytest.mark.parametrize("fmt,kv8", SETTINGS)
def test_verify_step_matches_jax(fmt, kv8, monkeypatch):
    monkeypatch.delenv("FUNASR_UNROLL_DECODE", raising=False)
    jp, tp = step_trees(fmt)
    _, jkv = _jax_prefill(jp, kv8)
    tkv = kv_from_jax(_np(jkv))
    t = 9
    toks = (np.random.default_rng(3).normal(size=(2, t, CFG.hidden))
            * 0.1).astype(np.float32)
    slots = np.array([P, P])
    pos = np.array([P, P - 5])[:, None] + np.arange(t)[None, :]
    valid_from = np.array([0, 5])
    want, jkv2 = jq.qwen3_verify_step(
        jp, jkv, jnp.asarray(toks), jnp.asarray(slots, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(valid_from, jnp.int32), CFG)
    got, tkv2 = tq.qwen3_verify_step(
        tp, tkv, torch.from_numpy(toks), torch.from_numpy(slots),
        torch.from_numpy(pos), torch.from_numpy(valid_from), CFG)
    assert got.shape == (2, t, CFG.vocab_size)
    assert _cosine(got.numpy(), _np(want)) > COS
    for t_half, j_half in ((tkv2.k, jkv2.k), (tkv2.v, jkv2.v)):
        assert _cosine(_dequant(t_half)[:, :, P:P + t],
                       _jax_dequant(j_half)[:, :, P:P + t]) > COS


def test_int8_weights_never_reach_k1():
    _, tp = step_trees("int8")
    emb, mask = _prompt()
    before = (tqm.launches, tqm.fused_launches)
    logits, _ = tq.qwen3_prefill(tp, torch.from_numpy(emb),
                                 torch.from_numpy(mask), CFG)
    assert (tqm.launches, tqm.fused_launches) == before
    lp = tq._layer_params(tp["layers"], 1)
    assert isinstance(lp["qkv_w"], tqm.Int8Weight)
    assert lp["qkv_w"].w8.data_ptr() == \
        tp["layers"]["qkv_w"].w8[1].data_ptr()
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(verbose=False, segment_pad_seconds=2.0, n_predict=8,
                 prefill_buckets=(64,), warmup=False)


@pytest.fixture(scope="module")
def engine_inputs(jax_ckpt, tmp_path_factory):
    from fun_asr_gguf_tpu_torch.audio import write_wav
    cfg = HybridConfig.tiny()
    lines = []
    for i in range(cfg.ctc.vocab_size):
        ch = chr(ord("一") + i) if i < cfg.ctc.vocab_size - 1 else "<blk>"
        lines.append(f"{base64.b64encode(ch.encode()).decode()} {i}")
    with open(os.path.join(jax_ckpt, "tokens.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    root = tmp_path_factory.mktemp("formats_wav")
    wav = str(root / "a.wav")
    write_wav(wav, np.random.default_rng(33).normal(size=16000) * 0.05, 16000)
    return jax_ckpt, wav, str(root / "hot.txt")


def _transcribe(engine_inputs, **kwargs):
    """Greedy transcription with the port engine on the CPU → (result,
    the engine's decoder params, its prefill's cache)."""
    from fun_asr_gguf_tpu_torch import create_asr_engine
    from fun_asr_gguf_tpu_torch.hotword.manager import reset_hotword_manager
    ckpt, wav, hot = engine_inputs
    reset_hotword_manager()
    eng = create_asr_engine(ckpt, device="cpu", hotwords_path=hot,
                            **{**ENGINE_KW, **kwargs})
    try:
        res = eng.transcribe(wav, verbose=False, temperature=0.0)
        assert isinstance(res.text, str) and res.ctc_text
        m = eng.models
        kv = m.prefill(np.zeros((4, m.hybrid_cfg.llm.hidden), np.float32),
                       rng_seed=0).kv
        return res, m.llm_params, kv
    finally:
        eng.cleanup()
        reset_hotword_manager()


def test_engine_defaults_float32_are_dense_and_ctc_matches_jax(
        engine_inputs):
    from fun_asr_gguf_tpu import create_asr_engine as jax_engine
    from fun_asr_gguf_tpu.hotword.manager import reset_hotword_manager
    ckpt, wav, hot = engine_inputs
    res, params, _ = _transcribe(engine_inputs, compute_dtype="float32")
    assert isinstance(params["layers"]["qkv_w"], torch.Tensor)
    assert params["layers"]["qkv_w"].dtype == torch.float32
    assert not {"lm_head_q", "lm_head_i8", "q8_fused"} & set(params)
    reset_hotword_manager()
    jeng = jax_engine(checkpoint_dir=ckpt, compute_dtype="float32",
                      hotwords_path=hot, **ENGINE_KW)
    try:
        ref = jeng.transcribe(wav, verbose=False, temperature=0.0)
    finally:
        jeng.cleanup()
        reset_hotword_manager()
    assert res.ctc_text == ref.ctc_text


def test_engine_defaults_bfloat16_are_int8_with_the_int8_head(engine_inputs):
    res, params, kv = _transcribe(engine_inputs)
    assert isinstance(params["layers"]["qkv_w"], tqm.Int8Weight)
    assert kv.k.dtype == torch.bfloat16
    assert "lm_head_i8" in params and "q8_fused" not in params
    assert res.timings.llm_generate > 0


@pytest.mark.parametrize("kwargs", [
    dict(llm_weight_format="int8"), dict(llm_weight_format="bf16"),
    dict(llm_weight_format="q8_0")])
def test_int8_cache_engine_keeps_the_greedy_text(engine_inputs, kwargs):
    """kv_cache_dtype='int8' perturbs the logits by about 1/254 of each
    head's absmax; on this checkpoint greedy output is unchanged (JAX's
    ``tests/test_engine_e2e.py`` holds its engine to the same)."""
    ref, params, kv = _transcribe(engine_inputs, compute_dtype="float32",
                                  **kwargs)
    want_type = {"int8": tqm.Int8Weight, "bf16": torch.Tensor,
                 "q8_0": tqm.Q8Weight}[kwargs["llm_weight_format"]]
    assert isinstance(params["layers"]["qkv_w"], want_type)
    got, _, kv8 = _transcribe(engine_inputs, compute_dtype="float32",
                              kv_cache_dtype="int8", **kwargs)
    assert isinstance(kv8.k, tq.QuantKV) and not isinstance(kv.k, tq.QuantKV)
    assert got.text == ref.text and got.ctc_text == ref.ctc_text
    assert len(ref.text) > 0
