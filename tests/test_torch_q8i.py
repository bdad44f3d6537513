"""Port K6 / K7 (the int8-dot q8_0 product and layer chain) and the q8i
decode against the JAX package, on the CPU.

* ``quantize_act_q8``: the same int8 values and scales, bit for bit, with
  all-zero blocks and exact .5 ties.
* K6: the plain version against JAX's ``_q8dot_ref`` and its Pallas kernel
  in interpret mode; ``matmul_any``'s two branches against JAX's.
* K7: the plain version against JAX's ``_q8i_layer_ref`` and both of its
  Pallas kernels (with and without the next-layer qkv) in interpret mode;
  the decoder's entry (the attention rows quantized inside K7) against
  JAX's ``quantize_act_q8`` followed by its ``q8i_layer_fused``.
* The q8i tree carried across (``weights.q8i_from_jax``): prefill, decode
  and 9-row verify steps against JAX's q8i tree, on the plain and on the
  int8 cache; greedy ids against JAX's q8i path; greedy speculation
  against the plain loop; the fuse's refusals and relabelling; and the
  fault of ``to_torch`` on that tree (it un-permutes natural-k weights).

The config is JAX's own q8i wiring test's (``tests/test_q8_fused.py:328``).
"""

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
from fun_asr_gguf_tpu_torch.models import speculative as tspec
from fun_asr_gguf_tpu_torch.models.weights import (block_unpermute,
                                                   kv_from_jax, q8i_from_jax,
                                                   to_torch)
from fun_asr_gguf_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(2)

CFG = Qwen3Config(n_layers=2, hidden=128, q_heads=4, kv_heads=2,
                  head_dim=32, ffn_dim=256, vocab_size=512, rope_theta=1e6,
                  rms_eps=1e-6, tie_embeddings=True)
EPS = 1e-6


def _np(x):
    return jax.tree_util.tree_map(np.array, jax.device_get(x))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _qtn(rng, k, n):
    """A natural-k q8_0 weight [n, k] from a dense [k, n]: JAX's
    ``QuantTensorN`` and the port's ``Q8DotWeight`` of the same bytes."""
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    qtn = jqm.to_natural(jqm.quantize_weight(jnp.asarray(w)))
    return qtn, tqm.Q8DotWeight(*(torch.from_numpy(a) for a in _np(qtn)))


# ---------------------------------------------------------------------------
# activation quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_q8_is_bit_identical_to_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(5, 128)) * 0.7).astype(np.float32)
    x[1, 32:64] = 0.0                           # an all-zero block
    # amax 127: d = 1, inv = 1, so x * inv is an exact .5 tie
    x[2, :32] = 0.0
    x[2, :8] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5, -126.5, 1.5]
    # amax 63.5: d = 0.5, inv = 2: 1.25 -> 2.5, -0.75 -> -1.5
    x[3, 64:96] = 0.25
    x[3, 64:68] = [63.5, 1.25, -0.75, -63.5]
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    wq, wd = _np(jqm.quantize_act_q8(jx))
    gq, gd = tqm.quantize_act_q8(tx)
    assert gq.dtype == torch.int8 and gd.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), wq)
    np.testing.assert_array_equal(gd.numpy().view(np.int32),
                                  wd.view(np.int32))
    if dtype == "float32":
        assert gq[2, :8].tolist() == [127, 3, -4, 1, -1, 127, -127, 2]
        assert gq[3, 64:68].tolist() == [127, 3, -2, -127]
        assert not gq[1, 32:64].any() and gd[1, 1] == 0


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 128, 256), (3, 96, 160),
                                   (9, 256, 384), (16, 64, 128),
                                   # the decode-sized kernel's row classes
                                   # at Qwen3-0.6B's widest k, n not a
                                   # multiple of 32
                                   (2, 2048, 200), (9, 2048, 200),
                                   (8, 3072, 72), (16, 3072, 72)])
def test_k6_plain_matches_jax_reference_and_kernel(m, k, n):
    """The same integer partials; the scales and the block sum in f32, in
    another order: relative 1e-5 of max|ref|."""
    rng = np.random.default_rng(m + k + n)
    qtn, tw = _qtn(rng, k, n)
    x = (rng.normal(size=(m, k)) * 0.4).astype(np.float32)
    got = tqm.q8dot_matmul(torch.from_numpy(x), tw)
    assert got.shape == (m, n) and got.dtype == torch.float32
    ref = jqm.q8dot_matmul(jnp.asarray(x), qtn, use_pallas=False)
    pal = jqm.q8dot_matmul(jnp.asarray(x), qtn, use_pallas=True,
                           interpret=True)
    assert _rel(got.numpy(), _np(ref)) <= 1e-5
    assert _rel(got.numpy(), _np(pal)) <= 1e-5


@pytest.mark.parametrize("m", [1, 16, 17, 40])
def test_matmul_any_q8dot_branches_match_jax(m):
    """Up to 16 rows the int8-dot product, above them the dequant product
    bf16(x) . bf16(q * d) (JAX ``matmul_any`` :1704-1724), on a layer of a
    stacked weight."""
    rng = np.random.default_rng(50 + m)
    qtn, tw = _qtn(rng, 128, 192)
    stack = jqm.QuantTensorN(q=jnp.stack([qtn.q, qtn.q[::-1]]),
                             d=jnp.stack([qtn.d, qtn.d[::-1]]))
    tstack = tqm.Q8DotWeight(*(torch.from_numpy(a) for a in _np(stack)))
    x = (rng.normal(size=(m, 128)) * 0.4).astype(np.float32)
    want = jqm.matmul_any(jnp.asarray(x), jqm.IndexedQuant(stack, 1),
                          use_pallas=False)
    view = tqm.layer(tstack, 1)
    assert isinstance(view, tqm.Q8DotWeight)
    got = tqm.matmul_any(torch.from_numpy(x), view)
    assert _rel(got.numpy(), _np(want)) <= 1e-5
    if m > tqm.Q8DOT_MAX_ROWS:
        assert torch.equal(got, tqm.q8_matmul_plain(torch.from_numpy(x),
                                                    tqm.Q8Weight(*view)))
    else:
        assert torch.equal(got, tqm.q8dot_matmul_plain(torch.from_numpy(x),
                                                       view))


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

QD, H, FFN, NQ = 256, 128, 256, 384


def _chain_inputs(m, seed):
    """One K7 call's inputs in JAX's column layout, for both packages."""
    rng = np.random.default_rng(seed)
    attn = (rng.normal(size=(m, QD)) * 0.3).astype(np.float32)
    aq, as_ = jqm.quantize_act_q8(jnp.asarray(attn))
    vecs = [aq.T, as_.T,
            jnp.asarray((rng.normal(size=(H, m)) * 0.5).astype(np.float32)),
            jnp.asarray((1 + rng.normal(size=(H,)) * 0.1).astype(np.float32)),
            jnp.asarray((1 + rng.normal(size=(H,)) * 0.1).astype(np.float32))]
    ws = [_qtn(rng, k, n) for k, n in ((QD, H), (H, 2 * FFN), (FFN, H),
                                       (H, NQ))]
    return (vecs, [w for w, _ in ws],
            [torch.from_numpy(a) for a in _np(vecs)], [w for _, w in ws])


@pytest.mark.parametrize("with_qkv", [True, False])
@pytest.mark.parametrize("m", [1, 3, 9])
def test_k7_plain_matches_jax_reference_and_kernels(m, with_qkv):
    """Every product the int8-dot contract, every intermediate f32: the
    same integer partials, f32 sums in another order (relative 1e-4)."""
    jv, jw, tv, tw = _chain_inputs(m, seed=10 + m)
    if not with_qkv:
        jv[4], jw[3], tv[4], tw[3] = None, None, None, None
    got = tqm.q8i_layer_fused(*tv, *tw, EPS, with_qkv=with_qkv)
    assert got[0].shape == (H, m) and got[0].dtype == torch.float32
    assert (got[1] is None) == (not with_qkv)
    for use_pallas in (False, True):
        want = jqm.q8i_layer_fused(*jv, *jw, EPS, with_qkv=with_qkv,
                                   use_pallas=use_pallas,
                                   interpret=use_pallas)
        assert _rel(got[0].numpy(), _np(want[0])) <= 1e-4
        if with_qkv:
            assert got[1].shape == (NQ, m)
            assert _rel(got[1].numpy(), _np(want[1])) <= 1e-4


def test_k7_plain_takes_row_views_as_columns():
    """The decode hands K7 transposed views of row-major tensors; the
    plain version reads them as JAX's columns."""
    _, _, tv, tw = _chain_inputs(3, seed=21)
    views = [a.t().contiguous().t() for a in tv[:3]] + tv[3:]
    for g, w in zip(tqm.q8i_layer_fused(*views, *tw, EPS),
                    tqm.q8i_layer_fused(*tv, *tw, EPS)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("with_qkv", [True, False])
@pytest.mark.parametrize("m", [1, 2, 9, 16])
def test_k7_folded_entry_matches_jax_quantize_then_chain(m, with_qkv):
    """The decoder's entry takes the attention rows unquantized and the
    residual as f32 rows: its quantization is JAX's ``quantize_act_q8`` bit
    for bit, and its outputs JAX's ``q8i_layer_fused`` on those q8_0 rows
    (jnp reference and Pallas kernel in interpret mode) within the file's
    relative 1e-4."""
    rng = np.random.default_rng(60 + m)
    attn = (rng.normal(size=(m, QD)) * 0.3).astype(np.float32)
    resid = (rng.normal(size=(m, H)) * 0.5).astype(np.float32)
    _, jw, _, tw = _chain_inputs(m, seed=70 + m)
    norms = [(1 + rng.normal(size=(H,)) * 0.1).astype(np.float32)
             for _ in range(2)]
    if not with_qkv:
        jw[3], tw[3], norms[1] = None, None, None
    jq_, js = jqm.quantize_act_q8(jnp.asarray(attn))
    tq_, ts = tqm.quantize_act_q8(torch.from_numpy(attn))
    np.testing.assert_array_equal(tq_.numpy(), _np(jq_))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  _np(js).view(np.int32))
    tn = [None if n is None else torch.from_numpy(n) for n in norms]
    out, qkv = tqm.q8i_layer_fused_rows(torch.from_numpy(attn),
                                        torch.from_numpy(resid), tn[0],
                                        tn[1], *tw, EPS)
    assert out.shape == (m, H) and out.dtype == torch.float32
    assert (qkv is None) == (not with_qkv)
    jn = [None if n is None else jnp.asarray(n) for n in norms]
    for use_pallas in (False, True):
        want = jqm.q8i_layer_fused(jq_.T, js.T, jnp.asarray(resid.T), *jn,
                                   *jw, EPS, with_qkv=with_qkv,
                                   use_pallas=use_pallas,
                                   interpret=use_pallas)
        assert _rel(out.numpy().T, _np(want[0])) <= 1e-4
        if with_qkv:
            assert qkv.shape == (m, NQ)
            assert _rel(qkv.numpy().T, _np(want[1])) <= 1e-4


# ---------------------------------------------------------------------------
# the q8i decoder
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _trees():
    """(JAX packed q8_0 tree, JAX q8i tree, the port's q8i tree carried
    across, the port's q8i tree fused from its own packed tree)."""
    params = jq.init_qwen3_params(jax.random.PRNGKey(0), CFG)
    qp = jq.pack_qwen3_params(jq.quantize_lm_head(
        jq.quantize_qwen3_params(params, mode="pallas"), CFG, mode="pallas"))
    ip = jq.fuse_qwen3_params_q8i(qp)
    return (qp, ip, q8i_from_jax(_np(ip)),
            tq.fuse_qwen3_params_q8i(to_torch(_np(qp))))


P, PAD, S_LEN = 12, 3, 32


@functools.lru_cache(maxsize=None)
def _jax_steps(kv8):
    """JAX's prefill of a left-padded prompt, then one decode step and one
    9-row verify step on the q8i tree, each from the prefill's cache."""
    _, ip, _, _ = _trees()
    rng = np.random.default_rng(7)
    emb = (rng.normal(size=(1, P, CFG.hidden)) * 0.1).astype(np.float32)
    emb[:, :PAD] = 0.0
    mask = np.ones((1, P), np.float32)
    mask[:, :PAD] = 0.0
    toks = (rng.normal(size=(1, 9, CFG.hidden)) * 0.1).astype(np.float32)
    pos = P - PAD + np.arange(9)[None]
    logits, kv = jq.qwen3_prefill(ip, jnp.asarray(emb), jnp.asarray(mask),
                                  CFG, kv_max_len=S_LEN, kv_int8=kv8)
    dec, _ = jq.qwen3_decode_step(
        ip, kv, jnp.asarray(toks[:, 0]), jnp.asarray(P, jnp.int32),
        jnp.asarray(pos[:, 0], jnp.int32), jnp.asarray([PAD], jnp.int32),
        CFG)
    ver, _ = jq.qwen3_verify_step(
        ip, kv, jnp.asarray(toks), jnp.asarray([P], jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray([PAD], jnp.int32), CFG)
    return dict(emb=emb, mask=mask, toks=toks, pos=pos, kv=_np(kv),
                prefill=_np(logits), decode=_np(dec), verify=_np(ver))


def _port_step(params, want, step):
    kv = kv_from_jax(want["kv"])
    toks, pos = want["toks"], want["pos"]
    if step == "decode":
        return tq.qwen3_decode_step(params, kv, torch.from_numpy(toks[:, 0]),
                                    P, torch.from_numpy(pos[:, 0]),
                                    torch.tensor([PAD]), CFG)[0]
    return tq.qwen3_verify_step(params, kv, torch.from_numpy(toks),
                                torch.tensor([P]), torch.from_numpy(pos),
                                torch.tensor([PAD]), CFG)[0]


class _Count:
    """Counts the decoder's K6 and K7 calls (the plain versions here; K7
    through its folded entry)."""

    def __init__(self, monkeypatch):
        self.k6 = self.k7 = 0
        k6, k7 = tqm.q8dot_matmul, tq.q8i_layer_fused_rows

        def count6(*a, **kw):
            self.k6 += 1
            return k6(*a, **kw)

        def count7(*a, **kw):
            self.k7 += 1
            return k7(*a, **kw)
        monkeypatch.setattr(tqm, "q8dot_matmul", count6)
        monkeypatch.setattr(tq, "q8i_layer_fused_rows", count7)


@pytest.mark.parametrize("kv8", [False, True], ids=["plain_kv", "int8_kv"])
@pytest.mark.parametrize("step", ["decode", "verify"])
def test_q8i_steps_match_jax_q8i_tree(step, kv8, monkeypatch):
    """The ROADMAP criterion, cosine > 0.99999, and the same argmax; one
    step runs 2 K6 (layer 0's qkv, the head) and one K7 per layer."""
    monkeypatch.delenv("FUNASR_UNROLL_DECODE", raising=False)
    want = _jax_steps(kv8)
    tip = _trees()[2]
    count = _Count(monkeypatch)
    got = _port_step(tip, want, step)
    assert (count.k6, count.k7) == (2, CFG.n_layers)
    assert got.shape == np.shape(want[step])
    assert _cosine(got.numpy(), want[step]) > 0.99999
    assert np.array_equal(got.numpy().argmax(-1), want[step].argmax(-1))


@pytest.mark.parametrize("kv8", [False, True], ids=["plain_kv", "int8_kv"])
def test_q8i_prefill_matches_jax(kv8):
    """The prefill's layers take the dequant product (JAX's scanned prefill)
    and its head K6; the cache the prefill writes is JAX's."""
    want = _jax_steps(kv8)
    logits, kv = tq.qwen3_prefill(_trees()[2], torch.from_numpy(want["emb"]),
                                  torch.from_numpy(want["mask"]), CFG,
                                  kv_max_len=S_LEN, kv_int8=kv8)
    assert _cosine(logits.numpy(), want["prefill"]) > 0.99999
    jk = kv_from_jax(want["kv"]).k
    gk, wk = (kv.k.q, jk.q) if kv8 else (kv.k, jk)
    assert _cosine(gk.float().numpy(), wk.float().numpy()) > 0.99999


def test_q8i_fused_from_the_port_tree_equals_the_carried_tree():
    _, _, carried, own = _trees()
    want = _jax_steps(False)
    assert set(carried) == set(own)
    for key in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        assert isinstance(own["layers"][key], tqm.Q8DotWeight)
        for a, b in zip(own["layers"][key], carried["layers"][key]):
            assert torch.equal(a, b)
    assert torch.equal(_port_step(own, want, "decode"),
                       _port_step(carried, want, "decode"))


def _greedy_port(params, steps=6, chunks=2):
    want = _jax_steps(False)
    st = tg.prefill_init(params, torch.from_numpy(want["emb"]),
                         torch.from_numpy(want["mask"]),
                         torch.Generator().manual_seed(5), CFG,
                         max_len=P + steps * chunks)
    return [int(t) for _ in range(chunks) for t in tg.generate_chunk(
        params, st, CFG, 0.0, 1.0, 50, chunk_len=steps, stop_tokens=())[0]]


def test_q8i_greedy_ids_match_jax_q8i_path():
    """Two 6-step greedy chunks, as the mega route's test runs them."""
    _, ip, tip, _ = _trees()
    want = _jax_steps(False)
    st = jg.prefill_init(ip, jnp.asarray(want["emb"]),
                         jnp.asarray(want["mask"]), jax.random.PRNGKey(5),
                         CFG, max_len=P + 12)
    ids = []
    for _ in range(2):
        st, toks = jg.generate_chunk(ip, st, CFG, jnp.asarray(0.0),
                                     jnp.asarray(1.0), 50, chunk_len=6,
                                     stop_tokens=(), fuse_enabled=False,
                                     greedy=True)
        ids += [int(t) for t in np.asarray(toks)[0]]
    assert _greedy_port(tip) == ids


def test_q8i_greedy_speculation_emits_the_plain_loops_ids():
    """A perfect draft (verify rounds accept) and a garbage one."""
    tip = _trees()[2]
    ref = _greedy_port(tip, steps=16, chunks=1)
    want = _jax_steps(False)
    for draft_ids in (ref, [5, 5, 5, 11, 13, 17, 19, 23]):
        draft = torch.full((1, 24), -1, dtype=torch.int64)
        draft[0, :len(draft_ids)] = torch.tensor(draft_ids)
        st = tspec.spec_init(tg.prefill_init(
            tip, torch.from_numpy(want["emb"]),
            torch.from_numpy(want["mask"]), torch.Generator().manual_seed(5),
            CFG, max_len=P + 40))
        got = [int(t) for t in tspec.spec_generate_chunk(
            tip, st, draft, CFG, 0.0, 1.0, 50, spec_k=4, chunk_len=16,
            stop_tokens=(), limit=16)[0].tolist() if t >= 0]
        assert got == ref
        if draft_ids is ref:
            assert int(st.rounds[0]) < len(got)


# ---------------------------------------------------------------------------
# the fuse and the converter
# ---------------------------------------------------------------------------

def _refusals(tree, dense):
    """The five trees JAX's fuse refuses, built from a packed q8_0 tree;
    ``dense`` stands in for a weight that is not q8_0."""
    layers = tree["layers"]
    no_in = {k: v for k, v in layers.items() if k != "input_ln"}
    return {"q8_fused": {**tree, "q8_fused": np.zeros((0,), np.int8)},
            "sandwich": {**tree, "layers": {**layers,
                                            "attn_post_ln": layers["post_ln"]}},
            "post_norm_only": {**tree, "layers": no_in},
            "moe": {**tree, "layers": {**layers, "router_w": dense}},
            "not_q8_0": {**tree, "layers": {**layers, "o_w": dense}}}


@pytest.mark.parametrize("case", ["q8_fused", "sandwich", "post_norm_only",
                                  "moe", "not_q8_0"])
def test_fuse_q8i_refuses_what_jax_refuses(case):
    qp = _trees()[0]
    tp = to_torch(_np(qp))
    with pytest.raises(ValueError) as jerr:
        jq.fuse_qwen3_params_q8i(_refusals(qp, jnp.zeros((2, 4, 4)))[case])
    with pytest.raises(ValueError) as terr:
        tq.fuse_qwen3_params_q8i(_refusals(tp, torch.zeros(2, 4, 4))[case])
    # the same refusal: both messages name the same thing
    for word in ("q8_fused", "sandwich", "post-norm", "MoE", "o_w"):
        assert (word in str(jerr.value)) == (word in str(terr.value))


def test_fuse_q8i_relabels_without_copying():
    tp = to_torch(_np(_trees()[0]))
    ip = tq.fuse_qwen3_params_q8i(tp)
    assert "q8i_fused" in ip and "lm_head_q" not in ip
    assert tq.fuse_qwen3_params_q8i(ip) is ip
    head = ip["lm_head_qn"]
    assert isinstance(head, tqm.Q8DotWeight)
    assert head.q is tp["lm_head_q"].q and head.d is tp["lm_head_q"].d
    for key in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        assert ip["layers"][key].q is tp["layers"][key].q
    assert tq.lm_head_q8dot(ip) is ip
    no_head = {k: v for k, v in tp.items() if k != "lm_head_q"}
    assert tq.lm_head_q8dot(no_head) is no_head
    assert set(tp["layers"]) == set(ip["layers"])   # the input is kept
    assert isinstance(tp["layers"]["o_w"], tqm.Q8Weight)


def test_to_torch_scrambles_a_q8i_tree_and_q8i_from_jax_does_not():
    """The fault: ``to_torch`` takes every int8 (q, d) pair for a
    block-permuted ``QuantTensor`` and un-permutes k, which a natural-k
    ``QuantTensorN`` does not have. ``q8i_from_jax`` keeps the bytes; a
    product against JAX's shows which weight is right."""
    _, ip, tip, _ = _trees()
    tree = _np(ip)
    natural = tree["layers"]["o_w"].q
    wrong = to_torch(tree)["layers"]["o_w"].q
    assert np.array_equal(tip["layers"]["o_w"].q.numpy(), natural)
    assert np.array_equal(wrong.numpy(), block_unpermute(natural))
    assert not np.array_equal(wrong.numpy(), natural)
    x = np.random.default_rng(9).normal(size=(1, CFG.q_heads * CFG.head_dim))
    x = x.astype(np.float32)
    want = _np(jqm.q8dot_matmul(jnp.asarray(x), jqm.IndexedQuant(
        ip["layers"]["o_w"], 0), use_pallas=False))
    good = tqm.q8dot_matmul(torch.from_numpy(x),
                            tqm.layer(tip["layers"]["o_w"], 0))
    bad = tqm.q8dot_matmul(torch.from_numpy(x), tqm.Q8DotWeight(
        wrong[0], to_torch(tree)["layers"]["o_w"].d[0]))
    assert _cosine(good.numpy(), want) > 0.99999
    assert _cosine(bad.numpy(), want) < 0.5
