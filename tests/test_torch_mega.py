"""Port K5 (the all-layers q8_0 decode kernel) and K4c (the last layer's
chain with the final norm and the head) against the JAX package, on the
CPU.

* K5: at JAX's own mini config (hidden 256, 2 layers, GQA 4/2, head_dim
  128, ffn 512, vocab 2048, S = 256; ``tests/test_q8_mega.py``), where JAX's
  fuse marks the params, the plain version against JAX's
  ``q8_decode_all_fused`` in interpret mode on the same inputs, at JAX's
  tolerances; the port's mega decode step, ``prefill_init`` and greedy ids
  against JAX's mega path; ``fuse_qwen3_params_q8_mega``'s choices against
  JAX's.
* K4c: the plain version against JAX's ``q8_layer_head_fused`` reference
  and its staged Pallas kernel (interpret mode, a 12 x 128-row head); the
  fused decode and verify steps under ``FUNASR_Q8_FUSED_HEAD=1`` against
  JAX's fused tree (which always takes the fused head on the CPU).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fun_asr_gguf_tpu.models import generate as jg
from fun_asr_gguf_tpu.models import qwen3 as jq
from fun_asr_gguf_tpu.models.config import Qwen3Config
from fun_asr_gguf_tpu.ops import quant_matmul as jqm
from fun_asr_gguf_tpu_torch.models import generate as tg
from fun_asr_gguf_tpu_torch.models import qwen3 as tq
from fun_asr_gguf_tpu_torch.models.weights import (block_unpermute,
                                                   kv_from_jax, q8_from_jax,
                                                   q8_fused_from_jax,
                                                   q8_mega_from_jax,
                                                   unpermute_out_channels)
from fun_asr_gguf_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(2)

MINI = Qwen3Config(hidden=256, n_layers=2, q_heads=4, kv_heads=2,
                   head_dim=128, ffn_dim=512, vocab_size=2048,
                   rope_theta=1e4)
S_LEN = 256


def _np(x):
    return jax.tree_util.tree_map(np.array, jax.device_get(x))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@functools.lru_cache(maxsize=None)
def _mini():
    """(JAX fused tree, JAX mega tree, port fused tree, port mega tree),
    built as ``tests/test_q8_mega.py`` builds them."""
    params = jq.init_qwen3_params(jax.random.PRNGKey(0), MINI)
    qp = jq.fuse_qwen3_params_q8(jq.pack_qwen3_params(
        jq.quantize_qwen3_params(params, mode="pallas")))
    qp = jq.quantize_lm_head(qp, MINI, mode="pallas")
    mega = jq.fuse_qwen3_params_q8_mega(qp, MINI)
    assert "q8_mega" in mega
    return qp, mega, q8_fused_from_jax(_np(qp)), q8_mega_from_jax(_np(mega))


# (p, pad, seed): the prompts of test_q8_mega.py's two kernel tests
PROMPTS = [(6, 0, 1), (8, 3, 2)]


@functools.lru_cache(maxsize=None)
def _prefilled(p, pad, seed):
    """JAX's prefill of a p-slot prompt (the first ``pad`` slots padding)
    into an S_LEN cache, head-major and as it is, and the next token's
    embedding row."""
    qp = _mini()[0]
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, MINI.vocab_size, size=p - pad)
    embeds = jnp.concatenate([
        jnp.zeros((1, pad, MINI.hidden), jnp.float32),
        qp["embed"][jnp.asarray(ids)][None].astype(jnp.float32)], axis=1)
    mask = jnp.concatenate([jnp.zeros((1, pad)), jnp.ones((1, p - pad))],
                           axis=1).astype(jnp.float32)
    logits, kv = jq.qwen3_prefill(qp, embeds, mask, MINI, kv_max_len=S_LEN)
    tok = int(jnp.argmax(logits[0]))
    emb = qp["embed"][jnp.asarray([tok])].astype(jnp.float32)
    hm = jq.KVCache(k=jnp.transpose(kv.k[:, 0], (0, 2, 1, 3)),
                    v=jnp.transpose(kv.v[:, 0], (0, 2, 1, 3)))
    return hm, emb, kv


def _k5_inputs(hm, emb, slot, position, valid_from):
    """K5's inputs for JAX (perm space, as ``test_q8_mega._mega_inputs``
    builds them) and for the port (natural order, the same values)."""
    _, mega, _, tmp = _mini()
    layers = mega["layers"]
    x0 = jqm.block_permute(emb.astype(jnp.float32))
    var = jnp.mean(x0 * x0, axis=-1, keepdims=True)
    nhb0 = ((x0 * jax.lax.rsqrt(var + MINI.rms_eps))
            * layers["input_ln"][0][None]).astype(jnp.bfloat16)
    cos, sin = jq.rope_cos_sin(jnp.asarray([position], jnp.int32),
                               MINI.head_dim, MINI.rope_theta, jnp.float32)
    j = jnp.arange(S_LEN)
    bias = jnp.where((j >= valid_from) & (j < slot), 0.0, -1e30
                     ).astype(jnp.float32)[None]
    jins = dict(x0_perm=x0, nhb0=nhb0, post_lns=layers["post_ln"],
                norms_next=mega["norms_next"], q_norms=layers["q_norm"],
                k_norms=layers["k_norm"], cos=cos, sin=sin, bias_row=bias,
                kv_k=hm.k, kv_v=hm.v, qkv_w=layers["qkv_w"],
                o_w=layers["o_w"], gu_w=layers["gate_up_w"],
                down_w=layers["down_w"], head_w=mega["lm_head_q"],
                eps=MINI.rms_eps)
    tl = tmp["layers"]
    tkv = kv_from_jax(_np(hm))
    tins = (_t(block_unpermute(_np(x0))),
            _t(block_unpermute(_np(nhb0.astype(jnp.float32))),
               torch.bfloat16),
            tl["post_ln"], tmp["norms_next"], tl["q_norm"], tl["k_norm"],
            _t(_np(cos)), _t(_np(sin)), _t(_np(bias)), tkv.k, tkv.v,
            tl["qkv_w"], tl["o_w"], tl["gate_up_w"], tl["down_w"],
            tmp["lm_head_q"], MINI.rms_eps)
    return jins, tins


def _check_k5(got, want, v_tol=2e-2):
    """JAX's own tolerances (``test_q8_mega.py:100-117``)."""
    logits, k_new, v_new = (np.asarray(a, np.float32) for a in got)
    wl = np.asarray(want[0], np.float32)
    np.testing.assert_allclose(logits, wl, rtol=2e-2, atol=2e-2)
    assert int(logits.argmax()) == int(wl.argmax())
    assert _cosine(k_new, want[1]) > 0.99995
    np.testing.assert_allclose(k_new, want[1], rtol=0.1, atol=0.1)
    np.testing.assert_allclose(v_new, want[2], rtol=v_tol, atol=v_tol)


@pytest.mark.parametrize("p,pad,seed", PROMPTS)
def test_k5_plain_matches_jax_kernel_interpret(p, pad, seed):
    """Against JAX's K5, and against the step JAX's own test holds its K5
    to (the reference decode step on the same params, its cache row at the
    slot), at JAX's tolerances. JAX's K5 also rounds every q8_0 scale to
    bf16 before the multiply (the port does not, as in K1 / K4): that
    second rounding alone moves JAX's K5 from its reference by up to 0.026
    in v_new on these prompts, against the port's 0.017, so v_new is held
    to JAX's K5 at 3e-2 and to the reference at JAX's 2e-2."""
    qp = _mini()[0]
    hm, emb, kv = _prefilled(p, pad, seed)
    jins, tins = _k5_inputs(hm, emb, slot=p, position=p - pad,
                            valid_from=pad)
    got = [g.numpy() for g in tqm.q8_decode_all_fused(*tins)]
    assert got[0].shape == (1, 2048) and got[1].shape == (2, 2, 128)
    want = jqm.q8_decode_all_fused(**jins, interpret=True)
    assert want is not None
    _check_k5(got, [_np(w) for w in want], v_tol=3e-2)
    ref, ref_kv = jq.qwen3_decode_step(
        qp, kv, emb, jnp.asarray(p, jnp.int32),
        jnp.asarray([p - pad], jnp.int32), jnp.asarray([pad], jnp.int32),
        MINI)
    _check_k5([got[0][:, :MINI.vocab_size], got[1], got[2]],
              [_np(ref), _np(ref_kv.k)[:, 0, p], _np(ref_kv.v)[:, 0, p]])


@pytest.mark.parametrize("chunk", [32, 100])
@pytest.mark.parametrize("p,pad,seed", PROMPTS)
def test_k5_split_kv_plain_matches_jax_kernel_interpret(p, pad, seed, chunk):
    """K5's plain version with the kernel's split-KV attention (chunks of
    ``chunk`` slots merged in order, the current token's f32 term first)
    against JAX's K5 and its reference step, at the tolerances above."""
    qp = _mini()[0]
    hm, emb, kv = _prefilled(p, pad, seed)
    jins, tins = _k5_inputs(hm, emb, slot=p, position=p - pad,
                            valid_from=pad)
    got = [g.numpy() for g in tqm.q8_decode_all_fused_plain(*tins,
                                                            chunk=chunk)]
    want = jqm.q8_decode_all_fused(**jins, interpret=True)
    _check_k5(got, [_np(w) for w in want], v_tol=3e-2)
    ref, ref_kv = jq.qwen3_decode_step(
        qp, kv, emb, jnp.asarray(p, jnp.int32),
        jnp.asarray([p - pad], jnp.int32), jnp.asarray([pad], jnp.int32),
        MINI)
    _check_k5([got[0][:, :MINI.vocab_size], got[1], got[2]],
              [_np(ref), _np(ref_kv.k)[:, 0, p], _np(ref_kv.v)[:, 0, p]])
    # against the exact-softmax plain version: only the bf16 rounding
    # point of the probabilities moves (measured >= 0.999989 here), held
    # to the cosine the card test holds K5 to
    exact = tqm.q8_decode_all_fused_plain(*tins)
    assert _cosine(got[0], exact[0].numpy()) > 0.9999


def test_mega_decode_step_matches_jax_mega_step():
    _, mega, _, tmp = _mini()
    p, pad, seed = PROMPTS[1]
    hm, emb, _ = _prefilled(p, pad, seed)
    want, jkv = jq.qwen3_decode_step(
        mega, hm, emb, jnp.asarray(p, jnp.int32),
        jnp.asarray([p - pad], jnp.int32), jnp.asarray([pad], jnp.int32),
        MINI)
    tkv = kv_from_jax(_np(hm))
    before = tkv.k.clone()
    got, tkv2 = tq.qwen3_decode_step(
        tmp, tkv, _t(_np(emb)), p, torch.tensor([p - pad]),
        torch.tensor([pad]), MINI)
    assert tkv2 is tkv and got.shape == (1, MINI.vocab_size)
    wk, wv = _np(jkv.k), _np(jkv.v)
    _check_k5([got.numpy(), tkv.k[:, :, p].numpy(), tkv.v[:, :, p].numpy()],
              [_np(want), wk[:, :, p], wv[:, :, p]])
    # the step writes slot p and nothing else
    others = torch.ones(S_LEN, dtype=torch.bool)
    others[p] = False
    assert torch.equal(tkv.k[:, :, others], before[:, :, others])


def test_mega_prefill_init_builds_jax_head_major_cache():
    _, mega, _, tmp = _mini()
    p = 8
    rng = np.random.default_rng(3)
    emb = np.asarray(_mini()[0]["embed"])[rng.integers(0, 2048, size=p)]
    emb = emb[None].astype(np.float32)
    mask = np.ones((1, p), np.float32)
    want = jg.prefill_init(mega, jnp.asarray(emb), jnp.asarray(mask),
                           jax.random.PRNGKey(5), MINI, max_len=p + 12)
    got = tg.prefill_init(tmp, torch.from_numpy(emb), torch.from_numpy(mask),
                          torch.Generator().manual_seed(5), MINI,
                          max_len=p + 12)
    shape = (MINI.n_layers, MINI.kv_heads, 256, MINI.head_dim)
    assert tuple(got.kv.k.shape) == shape == np.shape(want.kv.k)
    assert got.kv.head_major and got.kv.max_len == 256
    assert got.kv.k.is_contiguous() and got.kv.v.is_contiguous()
    # f32 sums in another order before the bf16 rounding of a product's
    # activations: an isolated flip moves an entry by ~4e-3 of its size
    for g, w in ((got.kv.k, want.kv.k), (got.kv.v, want.kv.v),
                 (got.logits, want.logits)):
        assert _cosine(g.numpy(), _np(w)) > 0.99999
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-2, atol=1e-2)
    assert not got.kv.k[:, :, p:].any()


def test_mega_greedy_ids_match_fused_and_jax_mega():
    """Two 6-step greedy chunks (``test_q8_mega.py:151-184``)."""
    qp, mega, tfp, tmp = _mini()
    p = 8
    rng = np.random.default_rng(3)
    emb = np.asarray(qp["embed"])[rng.integers(0, 2048, size=p)][None]
    emb = emb.astype(np.float32)
    mask = np.ones((1, p), np.float32)

    def run_jax(params):
        st = jg.prefill_init(params, jnp.asarray(emb), jnp.asarray(mask),
                             jax.random.PRNGKey(5), MINI, max_len=p + 12)
        ids = []
        for _ in range(2):
            st, toks = jg.generate_chunk(params, st, MINI, jnp.asarray(0.0),
                                         jnp.asarray(1.0), 50, chunk_len=6,
                                         stop_tokens=(), fuse_enabled=False,
                                         greedy=True)
            ids += [int(t) for t in np.asarray(toks)[0]]
        return ids

    def run_port(params):
        st = tg.prefill_init(params, torch.from_numpy(emb),
                             torch.from_numpy(mask),
                             torch.Generator().manual_seed(5), MINI,
                             max_len=p + 12)
        return [int(t) for _ in range(2) for t in tg.generate_chunk(
            params, st, MINI, 0.0, 1.0, 50, chunk_len=6, stop_tokens=())[0]]

    port_mega = run_port(tmp)
    assert port_mega == run_port(tfp)
    assert port_mega == run_jax(mega)


# arch conditions under which JAX's fuse leaves the params unchanged
DECLINED = [dict(kv_heads=4), dict(q_heads=8), dict(sliding_pattern=6,
                                                    sliding_window=64),
            dict(rope_dim=64), dict(rope_factors_short=(1.0,) * 32),
            dict(rope_attn_factor=0.5), dict(rope_global_scale=2.0),
            dict(residual_scale=0.5)]


@pytest.mark.parametrize("change", DECLINED,
                         ids=lambda c: ",".join(sorted(c)))
def test_fuse_mega_declines_where_jax_declines(change):
    qp, _, tfp, _ = _mini()
    cfg = dataclasses.replace(MINI, **change)
    assert jq.fuse_qwen3_params_q8_mega(qp, cfg) is qp
    assert tq.fuse_qwen3_params_q8_mega(tfp, cfg) is tfp


def test_fuse_mega_needs_the_fused_tree_and_q8_head():
    qp, _, tfp, tmp = _mini()
    unfused = {k: v for k, v in tfp.items() if k != "q8_fused"}
    assert tq.fuse_qwen3_params_q8_mega(unfused, MINI) is unfused
    headless = {k: v for k, v in tfp.items() if k != "lm_head_q"}
    assert tq.fuse_qwen3_params_q8_mega(headless, MINI) is headless
    own = tq.fuse_qwen3_params_q8_mega(tfp, MINI)
    assert set(own) == set(tmp)
    assert torch.equal(own["norms_next"], tmp["norms_next"])
    assert own["layers"]["o_w"].q is tfp["layers"]["o_w"].q   # no copy


def _port_q8_tree(cfg, seed):
    """A packed, fused q8_0 port tree of ``cfg`` made with numpy alone."""
    from fun_asr_gguf_tpu_torch.formats.quant_np import q8_0_quantize
    rng = np.random.default_rng(seed)
    h, hd, n = cfg.hidden, cfg.head_dim, cfg.n_layers
    nq = (cfg.q_heads + 2 * cfg.kv_heads) * hd

    def q8(rows, k):
        q, d = zip(*(q8_0_quantize((rng.normal(size=(rows, k)) * 0.05
                                    ).astype(np.float32)) for _ in range(n)))
        return tqm.Q8Weight(torch.from_numpy(np.stack(q)),
                            torch.from_numpy(np.stack(d).astype(np.float32)))

    def norm(*shape):
        return torch.from_numpy((1 + rng.normal(size=shape) * 0.1).astype(
            np.float32))
    params = {"embed": torch.from_numpy((rng.normal(size=(
        cfg.vocab_size, h)) * 0.1).astype(np.float32)),
        "final_ln": norm(h),
        "layers": {"input_ln": norm(n, h), "post_ln": norm(n, h),
                   "q_norm": norm(n, hd), "k_norm": norm(n, hd),
                   "qkv_w": q8(nq, h), "o_w": q8(h, cfg.q_heads * hd),
                   "gate_up_w": q8(2 * cfg.ffn_dim, h),
                   "down_w": q8(h, cfg.ffn_dim)}}
    return tq.fuse_qwen3_params_q8(tq.quantize_lm_head(params, cfg))


def test_fuse_mega_marks_tiny_shapes_jax_declines():
    """A stated difference: JAX's TPU stage plan declines Qwen3Config.tiny()
    (``_mega_stage_plan`` :1077), which the port does not port; the port
    marks it, and its plain path decodes it like the fused path."""
    cfg = Qwen3Config.tiny(vocab_size=512)
    tfp = _port_q8_tree(cfg, seed=4)
    # JAX's choice reads the arch from cfg and the widths from the tree
    jtree = {"q8_fused": np.zeros((0,), np.int8),
             "lm_head_q": jqm.QuantTensor(q=tfp["lm_head_q"].q.numpy(),
                                          d=tfp["lm_head_q"].d.numpy()),
             "layers": {k: (jqm.QuantTensor(q=w.q.numpy(), d=w.d.numpy())
                            if isinstance(w, tqm.Q8Weight) else w.numpy())
                        for k, w in tfp["layers"].items()}}
    assert jq.fuse_qwen3_params_q8_mega(jtree, cfg) is jtree
    tmp = tq.fuse_qwen3_params_q8_mega(tfp, cfg)
    assert "q8_mega" in tmp
    rng = np.random.default_rng(4)
    emb = torch.from_numpy(rng.normal(size=(1, 10, cfg.hidden)).astype(
        np.float32) * 0.1)
    mask = torch.ones(1, 10)
    tok = torch.from_numpy(rng.normal(size=(1, cfg.hidden)).astype(
        np.float32) * 0.1)
    outs = []
    for params in (tfp, tmp):
        st = tg.prefill_init(params, emb, mask, torch.Generator(), cfg,
                             max_len=16)
        outs.append(tq.qwen3_decode_step(params, st.kv, tok, 10,
                                         torch.tensor([10]),
                                         torch.tensor([0]), cfg)[0])
    assert _cosine(outs[0].numpy(), outs[1].numpy()) > 0.9999


def test_verify_step_refuses_a_head_major_cache():
    _, _, _, tmp = _mini()
    kv = tq.KVCache(k=torch.zeros(2, 2, 256, 128), v=torch.zeros(2, 2, 256,
                                                                 128))
    with pytest.raises(ValueError, match="head-major"):
        tq.qwen3_verify_step(tmp, kv, torch.zeros(1, 3, 256),
                             torch.tensor([4]),
                             torch.arange(3)[None] + 4, torch.tensor([0]),
                             MINI)


# ---------------------------------------------------------------------------
# K4c: the fused head
# ---------------------------------------------------------------------------

EPS = 1e-6
QD, H, FFN = 512, 256, 512          # widths the staged plan admits
NV = 12 * 128                       # a head of 12 chunks of 128 rows


def _head_inputs(m, seed):
    rng = np.random.default_rng(seed)

    def w(k, n):
        return (rng.normal(size=(k, n)) * 0.05).astype(np.float32)

    t = {"merged": (rng.normal(size=(m, QD)) * 0.3).astype(np.float32),
         "resid": (rng.normal(size=(m, H)) * 0.3).astype(np.float32),
         "post_w": (1.0 + rng.normal(size=(H,)) * 0.1).astype(np.float32),
         "fin_w": (1.0 + rng.normal(size=(H,)) * 0.1).astype(np.float32)}
    jw = {"o": jqm.permute_out_channels(jqm.quantize_weight(w(QD, H))),
          "gu": jqm.permute_out_channels(jqm.quantize_weight(w(H, 2 * FFN)),
                                         halves=2),
          "dn": jqm.permute_out_channels(jqm.quantize_weight(w(FFN, H))),
          "head": jqm.quantize_weight(w(H, NV))}
    halves = {"o": 1, "gu": 2, "dn": 1}
    tw = [q8_from_jax(unpermute_out_channels(_np(jw[k]), halves[k])
                      if k in halves else _np(jw[k]))
          for k in ("o", "gu", "dn", "head")]
    jargs = [jqm.block_permute(jnp.asarray(t[k]))
             for k in ("merged", "resid", "post_w", "fin_w")]
    targs = [torch.from_numpy(t[k])
             for k in ("merged", "resid", "post_w", "fin_w")]
    return jargs, [jw[k] for k in ("o", "gu", "dn", "head")], targs, tw


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("m", [1, 9])
def test_k4c_plain_matches_jax_reference_and_staged_kernel(m):
    jargs, jw, targs, tw = _head_inputs(m, seed=30 + m)
    out, logits = tqm.q8_layer_head_fused_plain(*targs, *tw, EPS)
    assert out.shape == (m, H) and logits.shape == (m, NV)
    r_out, r_log = jqm.q8_layer_head_fused(*jargs, *jw, EPS,
                                           use_pallas=False)
    # the same rounding points as the jnp reference (test_torch_fused's
    # TOL_REF)
    assert _rel(out.numpy(), _np(jqm.block_unpermute(r_out))) < 1e-3
    assert _rel(logits.numpy(), _np(r_log)) < 1e-3

    def stk(w):
        return jqm.QuantTensor(q=w.q[None], d=w.d[None])

    xm, resid, pw, fw = jargs
    g_out, g_log = jqm._q8_mega_staged_call(
        xm.astype(jnp.bfloat16), resid, pw.reshape(1, H), fw.reshape(1, H),
        stk(jw[0]), 0, stk(jw[1]), 0, stk(jw[2]), 0, stk(jw[3]), 0, EPS,
        (2, 4, 2, 12), True)
    # the Pallas body also rounds d to bf16 (test_torch_fused's TOL_PALLAS)
    assert _rel(out.numpy(), _np(jqm.block_unpermute(g_out))) < 1e-2
    assert _rel(logits.numpy(), _np(g_log)) < 1e-2


def test_k4c_follows_the_knob(monkeypatch):
    jargs, jw, targs, tw = _head_inputs(1, seed=40)
    monkeypatch.delenv("FUNASR_Q8_FUSED_HEAD", raising=False)
    assert tqm.q8_layer_head_fused(*targs, *tw, EPS) is None
    monkeypatch.setenv("FUNASR_Q8_FUSED_HEAD", "0")
    assert tqm.q8_layer_head_fused(*targs, *tw, EPS) is None
    monkeypatch.setenv("FUNASR_Q8_FUSED_HEAD", "1")
    got = tqm.q8_layer_head_fused(*targs, *tw, EPS)
    want = tqm.q8_layer_head_fused_plain(*targs, *tw, EPS)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


class _Spy:
    """Counts the port decoder's K4c calls and what they returned."""

    def __init__(self, monkeypatch):
        self.results = []
        inner = tq.q8_layer_head_fused

        def spy(*args):
            self.results.append(inner(*args))
            return self.results[-1]
        monkeypatch.setattr(tq, "q8_layer_head_fused", spy)


@pytest.mark.parametrize("t", [1, 9])
def test_fused_head_steps_match_jax_fused_tree(t, monkeypatch):
    """t = 1: the decode step; t = 9: the verify step (spec_k = 8); on the
    fused (not mega) mini tree, with a left-padded prompt."""
    monkeypatch.delenv("FUNASR_UNROLL_DECODE", raising=False)
    monkeypatch.setenv("FUNASR_Q8_FUSED_HEAD", "1")
    spy = _Spy(monkeypatch)
    qp, _, tfp, _ = _mini()
    p, pad, seed = PROMPTS[1]
    _, _, jkv = _prefilled(p, pad, seed)
    rng = np.random.default_rng(3)
    toks = (rng.normal(size=(1, t, MINI.hidden)) * 0.1).astype(np.float32)
    pos = p - pad + np.arange(t)[None, :]
    tkv = kv_from_jax(_np(jkv))
    if t == 1:
        want, _ = jq.qwen3_decode_step(
            qp, jkv, jnp.asarray(toks[:, 0]), jnp.asarray(p, jnp.int32),
            jnp.asarray(pos[:, 0], jnp.int32), jnp.asarray([pad], jnp.int32),
            MINI)
        got, _ = tq.qwen3_decode_step(tfp, tkv, torch.from_numpy(toks[:, 0]),
                                      p, torch.from_numpy(pos[:, 0]),
                                      torch.tensor([pad]), MINI)
    else:
        want, _ = jq.qwen3_verify_step(
            qp, jkv, jnp.asarray(toks), jnp.asarray([p], jnp.int32),
            jnp.asarray(pos, jnp.int32), jnp.asarray([pad], jnp.int32), MINI)
        got, _ = tq.qwen3_verify_step(
            tfp, tkv, torch.from_numpy(toks), torch.tensor([p]),
            torch.from_numpy(pos), torch.tensor([pad]), MINI)
    assert len(spy.results) == 1 and spy.results[0] is not None
    assert got.shape == np.shape(want)
    assert _cosine(got.numpy(), _np(want)) > 0.99999
    assert np.array_equal(got.numpy().argmax(-1), _np(want).argmax(-1))


def test_fused_head_off_leaves_the_fused_step_unchanged(monkeypatch):
    _, _, tfp, _ = _mini()
    p, pad, seed = PROMPTS[1]
    _, _, jkv = _prefilled(p, pad, seed)
    rng = np.random.default_rng(6)
    tok = torch.from_numpy((rng.normal(size=(1, MINI.hidden)) * 0.1).astype(
        np.float32))
    args = (p, torch.tensor([p - pad]), torch.tensor([pad]), MINI)
    monkeypatch.delenv("FUNASR_Q8_FUSED_HEAD", raising=False)
    unset, _ = tq.qwen3_decode_step(tfp, kv_from_jax(_np(jkv)), tok, *args)
    monkeypatch.setenv("FUNASR_Q8_FUSED_HEAD", "0")
    spy = _Spy(monkeypatch)
    off, _ = tq.qwen3_decode_step(tfp, kv_from_jax(_np(jkv)), tok, *args)
    assert spy.results == [None]
    assert torch.equal(off, unset)
    monkeypatch.setenv("FUNASR_Q8_FUSED_HEAD", "1")
    on, _ = tq.qwen3_decode_step(tfp, kv_from_jax(_np(jkv)), tok, *args)
    assert _cosine(on.numpy(), off.numpy()) > 0.99999
