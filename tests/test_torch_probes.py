"""The port's probes P0–P4 and P6–P11 (``fun_asr_gguf_tpu_torch/probes/``)
against the JAX package's Pallas probes, on the CPU.

* P7–P11: ``experiments/q8_mega_probes.py`` is imported by path and run
  as it is, with ``pl.pallas_call`` wrapped so that it runs in interpret
  mode and records each call's inputs and output; the port's plain
  version then takes the recorded inputs.
* P6: the port's plain version is held to P6's own numpy reference (the
  natural order); JAX's interpret output is pinned to the tiled order
  (``pltpu.repeat`` tiles there), so that a JAX upgrade that changes it
  shows.
* P3, P4: their kernels are inline in ``experiments/q8_probe.py``
  ``main()``; each body is restated here and run with
  ``pl.pallas_call(..., interpret=True)``.
* P2: the port's plain multi-layer walk against JAX's staged kernel on
  the last layer's weights (interpret mode) and against one call per
  layer of the port's K4 plain version; barrier-only mode leaves its
  inputs as they were.
* P1: the port's chain against JAX's loop body (``q8_mlp_qkv_fused``,
  ``use_pallas=False``) at tiny widths.
* P0: its steps run on the CPU at ``Qwen3Config.tiny()``.

Nothing in the JAX package or in ``experiments/`` changes.
"""

import ast
import glob
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from fun_asr_gguf_tpu.ops import quant_matmul as jqm
from fun_asr_gguf_tpu_torch.models.config import Qwen3Config
from fun_asr_gguf_tpu_torch.ops import quant_matmul as tqm
from fun_asr_gguf_tpu_torch.probes import probe_launches
from fun_asr_gguf_tpu_torch.probes import q8_mega_probes as mp
from fun_asr_gguf_tpu_torch.probes import q8_probe as qp
from test_torch_fused import TOL_PALLAS, WIDE, _chain_inputs, _np

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-6


def _load_mega_probes():
    spec = importlib.util.spec_from_file_location(
        "experiments_q8_mega_probes",
        os.path.join(REPO, "experiments", "q8_mega_probes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probes():
    return _load_mega_probes()


@pytest.fixture
def recorded(monkeypatch):
    """``pl.pallas_call`` in interpret mode, recording (inputs, output) of
    every call as numpy arrays."""
    calls = []
    orig = pl.pallas_call

    def wrapped(kernel, **kw):
        call = orig(kernel, interpret=True, **kw)

        def run(*args):
            out = call(*args)
            calls.append(([np.asarray(a) for a in args], np.asarray(out)))
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", wrapped)
    return calls


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------------- P7 - P11

# (probe, its calls: the port's plain version on the recorded inputs and
# the tolerance on max |port - JAX|, with the reason)
# P7, P10: a copy and exact products, equal. P8: the same f32 products
# and sum; XLA may contract one into an FMA, one f32 ulp at |x| <= 4.
# P9, P11: JAX's own atol (p9 :124, p11 :157), sums in another order.
PARITY = {
    "p7": [(mp.transpose_plain, 0.0)],
    "p8": [(mp.rope_shuffle_plain, 1e-6), (mp.rope_matrix_plain, 1e-6)],
    "p9": [(mp.batched_dot_plain, 1e-3)],
    "p10": [(mp.pair_scale_plain, 0.0)],
    "p11": [(mp.head_sum_plain, 1e-4)],
}


@pytest.mark.parametrize("probe", sorted(PARITY))
def test_probe_plain_matches_jax_interpret(probe, jax_probes, recorded):
    assert getattr(jax_probes, probe)()          # the probe's own checks
    assert len(recorded) == len(PARITY[probe])
    for (args, want), (plain, tol) in zip(recorded, PARITY[probe]):
        if probe == "p8":                         # cos, sin arrive [1, 128]
            args = [a.reshape(-1) if a.shape == (1, 128) else a
                    for a in args]
        got = plain(*_t(*args)).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got - want).max() <= tol


def test_probe_inputs_are_the_jax_probes_inputs(jax_probes, recorded):
    """The port's inputs for P6–P11 are the JAX probes' own draws."""
    for name, mine in (("p6", mp.p6_inputs()), ("p7", mp.p7_inputs()),
                       ("p8", mp.p8_inputs()), ("p9", mp.p9_inputs()),
                       ("p10", mp.p10_inputs()), ("p11", mp.p11_inputs())):
        recorded.clear()
        try:
            getattr(jax_probes, name)()
        except AssertionError:          # P6's own check: see the P6 tests
            assert name == "p6"
        args = recorded[0][0]
        if name == "p8":                # P8a's q, cos, sin; R is P8b's
            args = args + [recorded[1][0][1]]
            mine = (mine[0], mine[2], mine[3], mine[1])
        for a, b in zip(args, mine):
            np.testing.assert_array_equal(a.reshape(b.shape), b.numpy())


# ------------------------------------------------------------------ P6

def test_p6_plain_meets_p6_reference():
    """The natural order (lane i takes d[i // 32]) within P6's own
    tolerance (relative error < 1e-2, :51-52: two bf16 roundings)."""
    q, d = mp.p6_inputs()
    got = mp.expand_scales(q, d, tiled=False).numpy()
    ref = q.numpy().astype(np.float32) * np.repeat(d.numpy(), 32, axis=1)
    assert np.max(np.abs(got - ref) / (np.abs(ref) + 1e-6)) < mp.P6_REF_TOL


def test_p6_jax_interpret_computes_the_tiled_order(jax_probes, recorded):
    """In interpret mode ``pltpu.repeat`` tiles: JAX's P6 output is
    bf16(q * tile(bf16(d))) (within one bf16 ulp at |x| < 128, 0.5: JAX
    may keep the f32 product) and P6's own natural-order check fails."""
    with pytest.raises(AssertionError, match="relerr"):
        jax_probes.p6()
    (q, d), want = recorded[0]
    tiled = mp.expand_scales_plain(*_t(q, d), tiled=True).numpy()
    natural = mp.expand_scales_plain(*_t(q, d), tiled=False).numpy()
    assert np.abs(want - tiled).max() <= 0.5
    assert np.abs(want - natural).max() > 10.0


# ------------------------------------------------------------------ P3, P4

@pytest.mark.parametrize("shape_in,shape_out", qp.RESHAPES)
def test_p3_reshape_matches_pallas_interpret(shape_in, shape_out):
    def rk(i_ref, o_ref, so=shape_out):          # q8_probe.py:282-283
        o_ref[:] = i_ref[:].reshape(so)
    x = jnp.arange(np.prod(shape_in), dtype=jnp.float32).reshape(shape_in)
    want = np.asarray(pl.pallas_call(
        rk, out_shape=jax.ShapeDtypeStruct(shape_out, jnp.float32),
        interpret=True)(x))
    got = qp.reshape(torch.from_numpy(np.array(x)), shape_out)
    assert tuple(got.shape) == shape_out
    np.testing.assert_array_equal(got.numpy(), want)


def test_p4_f16_scales_match_pallas_interpret():
    def f16k(q_ref, d_ref, o_ref):               # q8_probe.py:297-300
        dexp = jnp.concatenate([d_ref[:].astype(jnp.bfloat16)] * 32,
                               axis=1)
        o_ref[:] = (q_ref[:].astype(jnp.bfloat16) * dexp).astype(jnp.float32)
    q, d = qp.p4_inputs()
    want = np.asarray(pl.pallas_call(
        f16k, out_shape=jax.ShapeDtypeStruct((256, 1024), jnp.float32),
        interpret=True)(jnp.asarray(q.numpy()), jnp.asarray(d.numpy())))
    got = mp.expand_scales(q, d, tiled=True).numpy()
    # the same rounding points; JAX may keep the exact f32 product of the
    # two bf16 factors instead of rounding it: half a bf16 ulp
    assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -8)
    # P4's own reference (q * tile(d) in f32, :308-310): the roundings
    ref = q.numpy().astype(np.float32) * np.tile(
        d.numpy().astype(np.float32), (1, 32))
    assert np.abs(got - ref).max() <= 0.5 + 1e-6


# ------------------------------------------------------------------ P2

L_P2 = 3


def _p2_stack(seed):
    """L_P2 layers of ``_chain_inputs`` weights at WIDE widths stacked [L,
    n, k] (port layout), the last layer's JAX set-up beside them."""
    layers = [_chain_inputs(1, WIDE, seed + i) for i in range(L_P2)]
    jargs, jw, targs, _ = layers[-1]
    ws = [tqm.Q8Weight(torch.stack([lay[3][k].q for lay in layers]),
                       torch.stack([lay[3][k].d for lay in layers]))
          for k in ("o", "gu", "dn", "qkv")]
    return jargs, jw, targs, ws


def test_p2_plain_matches_jax_staged_kernel_interpret(monkeypatch):
    # FUNASR_Q8_STAGE_TARGET and the plan as tests/test_torch_fused.py
    # runs JAX's staged kernel at these widths
    monkeypatch.setenv("FUNASR_Q8_STAGE_TARGET", "65536")
    jargs, jw, targs, ws = _p2_stack(seed=40)
    qd, h, ffn, nq = WIDE
    xm, resid, pw, nw = jargs

    def stk(w):
        return jqm.QuantTensor(q=w.q[None], d=w.d[None])

    want_out, want_qkv = jqm._q8_mega_staged_call(
        xm.astype(jnp.bfloat16), resid, pw.reshape(1, h), nw.reshape(1, h),
        stk(jw["o"]), 0, stk(jw["gu"]), 0, stk(jw["dn"]), 0, stk(jw["qkv"]),
        0, EPS, (2, 4, 2, 3), True)
    out, qkv = qp.p2_walk(*targs, ws, EPS)
    assert out.shape == (1, h) and qkv.shape == (1, nq)
    for got, want in ((out, _np(jqm.block_unpermute(want_out))),
                      (qkv, _np(want_qkv))):
        got, want = got.numpy().astype(np.float64), want.astype(np.float64)
        assert np.abs(got - want).max() / np.abs(want).max() < TOL_PALLAS


def test_p2_plain_matches_the_last_layers_k4_plain_call():
    # layers do not chain (every layer reads the same xm and res), so only
    # the last layer's weights reach the output; that the walk reads every
    # layer shows in its time, not here. The same rounding points; the
    # stacked products sum in another order
    _, _, targs, ws = _p2_stack(seed=50)
    out, qkv = qp.p2_walk(*targs, ws, EPS)
    want = tqm.q8_mlp_qkv_fused_plain(
        *targs, *(tqm.layer(w, L_P2 - 1) for w in ws), EPS)
    for got, ref in zip((out, qkv), want):
        assert qp.rel_err(got, ref) < 1e-5


def test_p2_barrier_only_returns_its_inputs_untouched():
    xm, res, pw, nw, ws = qp.p2_inputs(layers=2, dims=(64, 32, 64, 96))
    before = [t.clone() for t in (xm, res, pw, nw, *ws[0], *ws[3])]
    launches = dict(probe_launches)
    out, qkv = qp.p2_walk(xm, res, pw, nw, ws, barriers=6)
    assert torch.equal(out, res) and out.dtype == torch.float32
    assert qkv.shape == (1, 96) and not qkv.any()
    for a, b in zip(before, (xm, res, pw, nw, *ws[0], *ws[3])):
        assert torch.equal(a, b)
    assert probe_launches == launches             # the CPU launches nothing


# ------------------------------------------------------------------ P1

TINY_P1 = (64, 32, 64, 96)      # qd, h, ffn, nq (nq >= qd: xm <- qkv[:qd])
# per layer the same rounding points as the jnp reference (TOL_REF of
# tests/test_torch_fused.py); the chain carries three layers' flips
TOL_P1 = 3e-3


def test_p1_chain_matches_jax_loop_body():
    """JAX's P1 body (q8_probe.py:109-114), ``use_pallas=False``, with the
    port's residual rounded to bf16 between calls as K4 takes it; JAX's
    activations in its perm space."""
    layers = [_chain_inputs(1, TINY_P1, seed=60 + i) for i in range(3)]
    qd = TINY_P1[0]
    jx, jres, jpw, jnw = layers[0][0]
    tx, tres, tpw, tnw = layers[0][2]
    for jargs, jw, targs, tw in layers:
        jres, jq = jqm.q8_mlp_qkv_fused(
            jx.astype(jnp.bfloat16), jres.astype(jnp.bfloat16), jpw, jnw,
            jw["o"], jw["gu"], jw["dn"], jw["qkv"], EPS, use_pallas=False)
        jx = jqm.block_permute(jq[:, :qd]).astype(jnp.bfloat16)
    ws = [tqm.Q8Weight(torch.stack([lay[3][k].q for lay in layers]),
                       torch.stack([lay[3][k].d for lay in layers]))
          for k in ("o", "gu", "dn", "qkv")]
    out, qkv = qp.p1_chain(tx, tres, tpw, tnw, ws, EPS)
    for got, want in ((out, _np(jqm.block_unpermute(jres))), (qkv, _np(jq))):
        got, want = got.numpy().astype(np.float64), want.astype(np.float64)
        assert np.abs(got - want).max() / np.abs(want).max() < TOL_P1


def test_p1_chain_on_the_cpu_is_its_plain_chain():
    xm, res, pw, nw, ws = qp.p2_inputs(layers=3, dims=TINY_P1)
    before = tqm.fused_launches
    got = qp.p1_chain(xm, res, pw, nw, ws)
    want = qp.p1_chain(xm, res, pw, nw, ws, plain=True)
    assert tqm.fused_launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------------------ P0

def test_p0_steps_run_on_the_cpu(monkeypatch):
    """P0's fused and all-layers steps at ``Qwen3Config.tiny()``; the
    two-point timer is stubbed to one run of each (a CPU time is no
    measurement)."""
    runs = []

    def one_run(run, *args, **kw):
        runs.append(run(2))
        return 0.0
    monkeypatch.setattr(qp, "two_point_ms", one_run)
    res = qp.p0("cpu", Qwen3Config.tiny(), p_len=12, max_len=20)
    assert len(runs) == 2 and all(np.isfinite(runs))
    assert res["cos"] > qp.P0_COS
    for name in ("fused", "mega"):
        assert res[name]["logits"].shape == (1, Qwen3Config.tiny().vocab_size)
        assert torch.isfinite(res[name]["logits"]).all()


def test_p0_params_take_the_fused_and_the_all_layers_routes():
    cfg = Qwen3Config.tiny()
    fused, mega = qp.q8_decode_params(cfg, torch.device("cpu"))
    assert "q8_fused" in fused and "q8_mega" not in fused
    assert "q8_mega" in mega and mega["norms_next"].shape == (
        cfg.n_layers, cfg.hidden)


# ------------------------------------------------------------------ wiring

@pytest.mark.parametrize("call", [
    lambda: mp.expand_scales(*mp.p6_inputs(), tiled=False),
    lambda: mp.transpose(*mp.p7_inputs()),
    lambda: mp.rope_shuffle(*(mp.p8_inputs()[i] for i in (0, 2, 3))),
    lambda: mp.rope_matrix(*mp.p8_inputs()),
    lambda: mp.batched_dot(*mp.p9_inputs()),
    lambda: mp.pair_scale(*mp.p10_inputs()),
    lambda: mp.head_sum(*mp.p11_inputs()),
    lambda: qp.reshape(torch.zeros(1, 512), (4, 128)),
])
def test_probe_wrappers_take_the_plain_version_on_the_cpu(call):
    launches = dict(probe_launches)
    assert torch.isfinite(call()).all()
    assert probe_launches == launches


def test_p11_slot_major_sum_equals_the_head_major_one():
    (kv,) = mp.p11_inputs()
    np.testing.assert_array_equal(
        mp.head_sum(kv.transpose(0, 1).contiguous(), slot_major=True),
        mp.head_sum(kv))


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_probes_import_nothing_of_jax_or_experiments():
    files = glob.glob(os.path.join(REPO, "fun_asr_gguf_tpu_torch", "probes",
                                   "*.py")) + [os.path.join(REPO,
                                                            "chip_smoke.py")]
    assert len(files) >= 5
    bad = {os.path.basename(f): m for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "fun_asr_gguf_tpu", "experiments")}
    assert not bad, bad
