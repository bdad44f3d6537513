"""Port K4 (the fused per-layer q8_0 chain) and the fused decode / verify
steps against the JAX package, on the CPU.

* The K4 plain version against JAX's three forms of the chain, at m = 1
  (decode) and m = 9 (verify, spec_k = 8), with and without the next-layer
  qkv stage: the jnp reference (``use_pallas=False``), the grid=(1,) Pallas
  bodies in interpret mode at tiny widths, and the staged Pallas kernel in
  interpret mode at widths ``_mega_stage_plan`` admits. JAX takes
  block-permuted activations and ``permute_out_channels`` weights (its perm
  space); its residual output is compared after ``block_unpermute``.
* ``q8_fused_from_jax`` carries a JAX fused tree across byte for byte.
* The port's fused decode and verify steps against JAX's default unrolled
  megacall-v2 branch on the fused tree (cosine > 0.99999 in float32), the
  port's fused against its unfused path, and verify against T sequential
  decode steps (logits and cache).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fun_asr_gguf_tpu.models import qwen3 as jq
from fun_asr_gguf_tpu.models.config import Qwen3Config
from fun_asr_gguf_tpu.ops import quant_matmul as jqm
from fun_asr_gguf_tpu_torch.models import qwen3 as tq
from fun_asr_gguf_tpu_torch.models.weights import (q8_from_jax,
                                                   q8_fused_from_jax,
                                                   to_torch,
                                                   unpermute_out_channels)
from fun_asr_gguf_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(2)

EPS = 1e-6
COS = 0.99999
# (m, qd, h, ffn, nq): tiny widths run the grid=(1,) Pallas bodies; the
# wide ones admit a staged plan
TINY = (128, 64, 96, 160)
WIDE = (512, 256, 512, 768)


def _np(x):
    return jax.tree_util.tree_map(np.array, jax.device_get(x))


def _chain_inputs(m, dims, seed):
    qd, h, ffn, nq = dims
    rng = np.random.default_rng(seed)

    def w(k, n):
        return (rng.normal(size=(k, n)) * 0.05).astype(np.float32)

    t = {"merged": (rng.normal(size=(m, qd)) * 0.3).astype(np.float32),
         "resid": (rng.normal(size=(m, h)) * 0.3).astype(np.float32),
         "post_w": (1.0 + rng.normal(size=(h,)) * 0.1).astype(np.float32),
         "in_w": (1.0 + rng.normal(size=(h,)) * 0.1).astype(np.float32),
         "o": w(qd, h), "gu": w(h, 2 * ffn), "dn": w(ffn, h),
         "qkv": w(h, nq)}
    jw = {"o": jqm.permute_out_channels(jqm.quantize_weight(t["o"])),
          "gu": jqm.permute_out_channels(jqm.quantize_weight(t["gu"]),
                                         halves=2),
          "dn": jqm.permute_out_channels(jqm.quantize_weight(t["dn"])),
          "qkv": jqm.quantize_weight(t["qkv"])}
    halves = {"o": 1, "gu": 2, "dn": 1}
    tw = {k: q8_from_jax(unpermute_out_channels(_np(v), halves[k])
                         if k in halves else _np(v))
          for k, v in jw.items()}
    jargs = [jqm.block_permute(jnp.asarray(t[k]))
             for k in ("merged", "resid", "post_w", "in_w")]
    targs = [torch.from_numpy(t[k])
             for k in ("merged", "resid", "post_w", "in_w")]
    return jargs, jw, targs, tw


def _port(targs, tw, with_qkv):
    xm, resid, pw, nw = targs
    if with_qkv:
        return tqm.q8_mlp_qkv_fused(xm, resid, pw, nw, tw["o"], tw["gu"],
                                    tw["dn"], tw["qkv"], EPS)
    return tqm.q8_mlp_fused(xm, resid, pw, tw["o"], tw["gu"], tw["dn"], EPS),


def _jax(jargs, jw, with_qkv, **kw):
    xm, resid, pw, nw = jargs
    if with_qkv:
        return jqm.q8_mlp_qkv_fused(xm, resid, pw, nw, jw["o"], jw["gu"],
                                    jw["dn"], jw["qkv"], EPS, **kw)
    return jqm.q8_mlp_fused(xm, resid, pw, jw["o"], jw["gu"], jw["dn"], EPS,
                            **kw),


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _check(got, want, tol):
    """got: the port's (out natural, [qkv]); want: JAX's (out perm space,
    [qkv natural])."""
    assert len(got) == len(want)
    assert _rel(got[0].numpy(), _np(jqm.block_unpermute(want[0]))) < tol
    if len(got) == 2:
        assert _rel(got[1].numpy(), _np(want[1])) < tol


# the same rounding points as the jnp reference, f32 sums in another order
# (measured <= 1.9e-7 here); an isolated bf16 flip of a normed or gated
# element, which another summation order can cause, moves a result by ~1e-4
TOL_REF = 1e-3
# the Pallas bodies also round d to bf16 before the multiply: a second
# rounding of every weight (measured <= 6.1e-3)
TOL_PALLAS = 1e-2


@pytest.mark.parametrize("with_qkv", [True, False])
@pytest.mark.parametrize("m", [1, 9])
def test_k4_plain_matches_jax_reference(m, with_qkv):
    jargs, jw, targs, tw = _chain_inputs(m, TINY, seed=m)
    _check(_port(targs, tw, with_qkv), _jax(jargs, jw, with_qkv,
                                            use_pallas=False), TOL_REF)


@pytest.mark.parametrize("with_qkv", [True, False])
@pytest.mark.parametrize("m", [1, 9])
def test_k4_plain_matches_pallas_body_interpret(m, with_qkv):
    jargs, jw, targs, tw = _chain_inputs(m, TINY, seed=10 + m)
    _check(_port(targs, tw, with_qkv),
           _jax(jargs, jw, with_qkv, use_pallas=True, interpret=True),
           TOL_PALLAS)


@pytest.mark.parametrize("with_qkv", [True, False])
@pytest.mark.parametrize("m", [1, 9])
def test_k4_plain_matches_staged_kernel_interpret(m, with_qkv, monkeypatch):
    # a small stage target so the plan admits these widths with and
    # without the qkv stage (the kernel then runs the explicit plan below)
    monkeypatch.setenv("FUNASR_Q8_STAGE_TARGET", "65536")
    jargs, jw, targs, tw = _chain_inputs(m, WIDE, seed=20 + m)
    qd, h, ffn, nq = WIDE
    plan = (2, 4, 2, 3) if with_qkv else (2, 4, 2, 0)
    assert jqm._mega_stage_plan(m, qd, h, 2 * ffn, ffn,
                                nq if with_qkv else 0) is not None

    def stk(w):
        return jqm.QuantTensor(q=w.q[None], d=w.d[None])

    xm, resid, pw, nw = jargs
    got = jqm._q8_mega_staged_call(
        xm.astype(jnp.bfloat16), resid, pw.reshape(1, h),
        nw.reshape(1, h) if with_qkv else None,
        stk(jw["o"]), 0, stk(jw["gu"]), 0, stk(jw["dn"]), 0,
        stk(jw["qkv"]) if with_qkv else None, 0 if with_qkv else None,
        EPS, plan, True)
    _check(_port(targs, tw, with_qkv), got if with_qkv else (got,),
           TOL_PALLAS)


# ---------------------------------------------------------------------------
# the fused decoder
# ---------------------------------------------------------------------------

CFG = Qwen3Config(n_layers=3, hidden=128, q_heads=4, kv_heads=2, head_dim=32,
                  ffn_dim=256, vocab_size=512, rope_theta=1e6, rms_eps=1e-6,
                  tie_embeddings=True)
P, MAX_LEN = 16, 32


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@functools.lru_cache(maxsize=None)
def _trees(name):
    """(name, jax dtype, torch dtype, JAX packed, JAX fused, port packed,
    port fused carried across from JAX's fused tree)."""
    jdt, tdt = ((jnp.float32, torch.float32) if name == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    base = jq.init_qwen3_params(jax.random.PRNGKey(0), CFG, dtype=jdt)
    qp = jq.pack_qwen3_params(jq.quantize_lm_head(
        jq.quantize_qwen3_params(base, mode="pallas"), CFG, mode="pallas"))
    fp = jq.fuse_qwen3_params_q8(qp)
    tp = to_torch(_np(qp), dtype=tdt)
    tfp = q8_fused_from_jax(_np(fp), dtype=tdt)
    return name, jdt, tdt, qp, fp, tp, tfp


@pytest.fixture(params=["float32", "bfloat16"])
def trees(request):
    return _trees(request.param)


def test_fused_tree_converts_byte_for_byte(trees):
    _, _, _, _, _, tp, tfp = trees
    own = tq.fuse_qwen3_params_q8(tp)
    assert set(own) == set(tfp) and "q8_fused" in own
    assert set(own["layers"]) == set(tfp["layers"])
    for key, w in own["layers"].items():
        got = tfp["layers"][key]
        if isinstance(w, tqm.Q8Weight):
            assert torch.equal(got.q, w.q) and torch.equal(got.d, w.d), key
        else:
            assert got.dtype == w.dtype and torch.equal(got, w), key
    for key in ("embed", "final_ln"):
        assert torch.equal(tfp[key], own[key])
    assert torch.equal(tfp["lm_head_q"].q, own["lm_head_q"].q)
    # the fuse moves no byte: the fused tree shares the packed tensors
    assert own["layers"]["o_w"].q is tp["layers"]["o_w"].q


def _prefill(trees):
    name, jdt, tdt, qp, fp, tp, tfp = trees
    rng = np.random.default_rng(1)
    emb = (rng.normal(size=(2, P, CFG.hidden)) * 0.1).astype(np.float32)
    mask = np.ones((2, P), np.float32)
    mask[1, :5] = 0.0                  # a left-padded row
    emb[1, :5] = 0.0
    _, jkv = jq.qwen3_prefill(qp, jnp.asarray(emb, jdt), jnp.asarray(mask),
                              CFG, kv_max_len=MAX_LEN)
    _, tkv = tq.qwen3_prefill(tp, torch.from_numpy(emb).to(tdt),
                              torch.from_numpy(mask), CFG, kv_max_len=MAX_LEN)
    valid_from = np.array([0, 5], np.int64)
    return jkv, tkv, valid_from


def _clone(kv):
    return tq.KVCache(k=kv.k.clone(), v=kv.v.clone())


# float32: ROADMAP's per-stage criterion (measured >= 0.9999979 against
# JAX); bfloat16: the residual stream and qkv are rounded to bf16 after
# every layer on both sides, after f32 sums taken in another order
# (measured >= 0.999958)
COS_BY_DTYPE = {"float32": COS, "bfloat16": 0.9999}


def test_fused_decode_step_matches_jax_fused_tree(trees, monkeypatch):
    monkeypatch.delenv("FUNASR_UNROLL_DECODE", raising=False)
    name, jdt, tdt, qp, fp, tp, tfp = trees
    jkv, tkv, valid_from = _prefill(trees)
    rng = np.random.default_rng(2)
    tok = (rng.normal(size=(2, CFG.hidden)) * 0.1).astype(np.float32)
    want, jkv2 = jq.qwen3_decode_step(
        fp, jkv, jnp.asarray(tok, jdt), jnp.asarray(P, jnp.int32),
        jnp.asarray([P, P - 5], jnp.int32),
        jnp.asarray(valid_from, jnp.int32), CFG)
    got, tkv2 = tq.qwen3_decode_step(
        tfp, _clone(tkv), torch.from_numpy(tok).to(tdt), P,
        torch.tensor([P, P - 5]), torch.from_numpy(valid_from), CFG)
    assert got.shape == (2, CFG.vocab_size) and got.dtype == torch.float32
    assert _cosine(got.numpy(), _np(want)) > COS_BY_DTYPE[name]
    assert _cosine(tkv2.k[:, :, P].float().numpy(),
                   _np(jkv2.k)[:, :, P].astype(np.float32)) > \
        COS_BY_DTYPE[name]


@pytest.mark.parametrize("t", [4, 9])
def test_fused_verify_step_matches_jax_fused_tree(trees, t, monkeypatch):
    monkeypatch.delenv("FUNASR_UNROLL_DECODE", raising=False)
    name, jdt, tdt, qp, fp, tp, tfp = trees
    jkv, tkv, valid_from = _prefill(trees)
    rng = np.random.default_rng(3)
    toks = (rng.normal(size=(2, t, CFG.hidden)) * 0.1).astype(np.float32)
    slots = np.array([P, P], np.int64)
    pos = np.array([P, P - 5])[:, None] + np.arange(t)[None, :]
    want, jkv2 = jq.qwen3_verify_step(
        fp, jkv, jnp.asarray(toks, jdt), jnp.asarray(slots, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(valid_from, jnp.int32), CFG)
    got, tkv2 = tq.qwen3_verify_step(
        tfp, _clone(tkv), torch.from_numpy(toks).to(tdt),
        torch.from_numpy(slots), torch.from_numpy(pos),
        torch.from_numpy(valid_from), CFG)
    assert got.shape == (2, t, CFG.vocab_size)
    assert _cosine(got.numpy(), _np(want)) > COS_BY_DTYPE[name]
    assert _cosine(tkv2.v[:, :, P:P + t].float().numpy(),
                   _np(jkv2.v)[:, :, P:P + t].astype(np.float32)) > \
        COS_BY_DTYPE[name]


def test_port_fused_matches_port_unfused(trees):
    name, jdt, tdt, qp, fp, tp, tfp = trees
    _, tkv, valid_from = _prefill(trees)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(
        (rng.normal(size=(2, 9, CFG.hidden)) * 0.1).astype(np.float32)).to(tdt)
    slots = torch.tensor([P, P])
    pos = torch.tensor([P, P - 5])[:, None] + torch.arange(9)[None, :]
    vf = torch.from_numpy(valid_from)
    outs = [tq.qwen3_verify_step(p, _clone(tkv), toks, slots, pos, vf,
                                 CFG)[0] for p in (tp, tfp)]
    outs += [tq.qwen3_decode_step(p, _clone(tkv), toks[:, 0], P, pos[:, 0],
                                  vf, CFG)[0] for p in (tp, tfp)]
    assert _cosine(outs[0].numpy(), outs[1].numpy()) > COS_BY_DTYPE[name]
    assert _cosine(outs[2].numpy(), outs[3].numpy()) > COS_BY_DTYPE[name]


@pytest.mark.parametrize("fused", [False, True])
def test_verify_equals_sequential_decode_steps(fused):
    trees = _trees("float32")
    _, _, _, _, _, tp, tfp = trees
    params = tfp if fused else tp
    _, tkv, valid_from = _prefill(trees)
    vf = torch.from_numpy(valid_from)
    rng = np.random.default_rng(5)
    t = 5
    toks = torch.from_numpy(
        (rng.normal(size=(2, t, CFG.hidden)) * 0.1).astype(np.float32))
    pos0 = torch.tensor([P, P - 5])
    seq_kv, seq = _clone(tkv), []
    for i in range(t):
        lg, _ = tq.qwen3_decode_step(params, seq_kv, toks[:, i], P + i,
                                     pos0 + i, vf, CFG)
        seq.append(lg)
    ver_kv = _clone(tkv)
    got, _ = tq.qwen3_verify_step(params, ver_kv, toks, torch.tensor([P, P]),
                                  pos0[:, None] + torch.arange(t)[None, :],
                                  vf, CFG)
    np.testing.assert_allclose(got.numpy(), torch.stack(seq, 1).numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ver_kv.k[:, :, :P + t].numpy(),
                               seq_kv.k[:, :, :P + t].numpy(),
                               rtol=2e-4, atol=2e-4)
