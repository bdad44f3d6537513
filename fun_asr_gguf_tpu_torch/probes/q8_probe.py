"""P0–P4 on Hopper: where the time of a q8_0 decode layer goes
(``experiments/q8_probe.py``).

The same bytes three ways, 28 layers of Qwen3-0.6B's q8_0 projections (o
1024 x 2048, gate_up 6144 x 1024, down 1024 x 3072, packed qkv 4096 x
1024: 17.69 MB a layer, :func:`q8_bw_probe.make_weights`):

* P1 (:104-122): 28 chained K4a launches (``q8_mlp_qkv_fused`` on layer
  views) with no attention between them; between calls ``xm ←
  bf16(qkv[:, :2048])`` and the residual goes on, rounded to bf16 as K4
  takes it (the port's fused decode does the same).
* P2 (:124-276, ``mega_multi`` :246): ONE cooperative launch that walks
  the 28 layers with K4's stages and grid barriers, every layer on the
  same ``xm`` [1, 2048] bf16 and ``res`` [1, 1024] f32 (the layers do not
  chain), returning the last layer's ``out`` and ``qkv``
  (``csrc/q8_probe.cu``: 3 grid barriers a layer, 84 in all). Its
  barrier-only mode runs the same launch with the stages skipped, at K4's
  grid with P2's 84 barriers and at K5's grid with K5's 140 (5 a layer).
* P5(a)'s stream sum over the same weights, in the same process, is the
  achievable stream rate.

Per layer: P1 − P2 is the per-call fixed cost, barrier-only the barriers,
P2 − barrier-only − bytes / P5(a) the stages' work beyond the stream. P0
(:316-352) is the real step on one set of full-width random weights: the
q8_0 fused decode (K1 + 28 × (K2 + K4)) and the all-layers one (one K5),
from a 204-token prompt with ``max_len`` 268, in ms/token by P0's
two-point method (4 and 16 steps on the host clock, best of three).
P3 (:278-294) is a row-major reshape inside a kernel, exact; P4
(:296-314) the scale expansion in its tiled order from f16 scales, both
kernels of ``csrc/probes.cu``.

    python -m fun_asr_gguf_tpu_torch.probes.q8_probe
"""

import json
import math
import time

import numpy as np
import torch

from ..ops.quant_matmul import (Q8Weight, _rms_f32, dequantize, layer,
                                q8_decode_all_grid, q8_layer_fused_grid,
                                q8_mlp_qkv_fused,
                                q8_mlp_qkv_fused_plain)
from . import SLEEP_CYCLES, check_cuda, launch, nbytes, rel_err, time_ms
from . import q8_bw_probe as p5
from .q8_mega_probes import BLOCK, expand_scales, expand_scales_plain

LAYERS = 28
QD, H, FFN, NQ = 2048, 1024, 3072, 4096
KV_HEADS, VOCAB_PAD = 8, 152576
EPS = 1e-6
P2_BARRIERS_PER_LAYER = 3     # K4's: o | gate_up | down | qkv
K5_BARRIERS_PER_LAYER = 5     # q8_decode_all.cu: qkv | attention | o |
                              # gate_up | down
P_LEN, MAX_LEN = 204, 268     # P0's prompt and cache (:329-334)
HBM_BYTES_PER_S = 3.35e12     # the H100 SXM data sheet
# P2 against its plain version: K4's tolerance (the same bf16 products;
# f32 sums in another order flip isolated bf16 ulps of the normed rows)
P2_TOL = 5e-3
# P1 against its plain chain: K4's flips carried through 28 chained
# layers, as K5's tolerance allows for its 28 layers
P1_TOL = 3e-2
# P0: the fused step (bf16 residual between layers) against the
# all-layers step (f32 residual), cosine of the first step's logits
P0_COS = 0.99
RESHAPES = (((1, 2048), (16, 128)), ((1, 512), (4, 128)),
            ((16, 128), (1, 2048)))


# ------------------------------------------------------------------ P2

def p2_inputs(device="cpu", layers=LAYERS, dims=(QD, H, FFN, NQ), seed=0):
    """P2's inputs: xm [1, qd] bf16, res [1, h] f32 (both ``rand * 0.1``,
    :91-93), the post and next norms pw, nw [h] (``rand``, :89-90, in bf16
    as K4 takes them) from a numpy seed, and the stacked q8_0 weights (o,
    gate_up, down, qkv) of :func:`q8_bw_probe.make_weights`."""
    qd, h, ffn, nq = dims
    rng = np.random.default_rng(seed)
    pw = torch.from_numpy(rng.random(h, dtype=np.float32))
    nw = torch.from_numpy(rng.random(h, dtype=np.float32))
    xm = torch.from_numpy(rng.random((1, qd), dtype=np.float32) * 0.1)
    res = torch.from_numpy(rng.random((1, h), dtype=np.float32) * 0.1)
    shapes = (("o", h, qd), ("gate_up", 2 * ffn, h), ("down", h, ffn),
              ("qkv", nq, h))
    ws = p5.make_weights(device, layers=layers, shapes=shapes, seed=seed)
    bf = torch.bfloat16
    return (xm.to(device, bf), res.to(device), pw.to(device, bf),
            nw.to(device, bf), ws)


def _stack_matmul(x, w: Q8Weight):
    """bf16(x) [..., m, k] · bf16(q · d)ᵀ of every layer of a stacked
    [L, n, k] weight → [L, m, n] f32."""
    return torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                        dequantize(w).to(torch.float32).transpose(-1, -2))


def p2_plain(xm, res, pw, nw, ws, eps=EPS):
    """P2's function, every layer at once on the stacked weights: h1 = xm ·
    o[l]ᵀ + res, the post norm, gate_up, the SiLU gate, out = act ·
    down[l]ᵀ + h1, the next norm and qkv → the last layer's (out [1, h],
    qkv [1, nq]) f32."""
    o, gu, dn, qk = ws
    h1 = _stack_matmul(xm, o) + res.to(torch.float32)
    g = _stack_matmul(_rms_f32(h1, pw, eps), gu)
    f = g.shape[-1] // 2
    act = torch.nn.functional.silu(g[..., :f]) * g[..., f:]
    out = _stack_matmul(act, dn) + h1
    qkv = _stack_matmul(_rms_f32(out, nw, eps), qk)
    return out[-1], qkv[-1]


def p2_buffers(res, ws):
    """The launch's outputs and scratch: ``out`` starts as a copy of
    ``res`` and ``qkv`` as zeros, what barrier-only mode leaves them."""
    dev, h = res.device, res.shape[-1]
    return dict(out=res.to(torch.float32).clone().reshape(1, h),
                qkv=torch.zeros((1, ws[3].q.shape[1]), dtype=torch.float32,
                                device=dev),
                h1=torch.empty(h, dtype=torch.float32, device=dev),
                act=torch.empty(ws[2].q.shape[-1], dtype=torch.bfloat16,
                                device=dev))


def p2_walk(xm, res, pw, nw, ws, eps=EPS, barriers=0, blocks=None,
            bufs=None):
    """P2: the walk over every layer in one launch on CUDA (the plain
    version on the CPU) → the last layer's (out [1, h], qkv [1, nq]) f32.
    ``barriers`` > 0 is barrier-only mode: that many grid barriers and no
    stage, so ``out`` is ``res`` and ``qkv`` zeros, as they entered.
    ``blocks``: the grid on the card (K4's by default); ``bufs``: reused
    :func:`p2_buffers`, so that a timed call launches and nothing else."""
    if xm.device.type == "cpu":
        if barriers:
            b = p2_buffers(res, ws)
            return b["out"], b["qkv"]
        return p2_plain(xm, res, pw, nw, ws, eps)
    bufs = bufs or p2_buffers(res, ws)
    _launch_p2(xm, res, pw, nw, ws, eps, barriers, blocks, bufs)
    return bufs["out"], bufs["qkv"]


def k4_grid(h=H):
    """K4a's grid at m = 1 and width h, Qwen3-0.6B's other widths
    (``ops.quant_matmul.q8_layer_fused_grid``: the blocks its split is
    sized for)."""
    return q8_layer_fused_grid(1, h, QD, FFN, NQ)


def k5_grid(h=H):
    """K5's grid at width h, Qwen3-0.6B's other widths
    (``ops.quant_matmul.q8_decode_all_grid``: the blocks its split is
    sized for)."""
    return q8_decode_all_grid(h, QD, FFN, KV_HEADS, VOCAB_PAD)


def _launch_p2(xm, res, pw, nw, ws, eps, barriers, blocks, bufs):
    o, gu, dn, qk = ws
    n_layers, h, qd = o.q.shape
    f, nq = dn.q.shape[-1], qk.q.shape[1]
    i8, f32, bf = torch.int8, torch.float32, torch.bfloat16
    shapes = [(n_layers, h, qd), (n_layers, 2 * f, h), (n_layers, h, f),
              (n_layers, nq, h)]
    check_cuda(
        (xm, res, pw, nw, *(t for w in ws for t in w), *bufs.values()),
        (bf, f32, bf, bf) + (i8, f32) * 4 + (f32, f32, f32, bf),
        [(1, qd), (1, h), (h,), (h,)]
        + [s if i % 2 == 0 else s[:-1] + (s[-1] // BLOCK,)
           for s in shapes for i in range(2)]
        + [(1, h), (1, nq), (h,), (f,)], "q8_probe_p2")
    if qd % BLOCK or h % BLOCK or f % BLOCK:
        raise ValueError("q8_probe_p2 takes widths of whole q8_0 blocks")
    launch("p2_barrier_only" if barriers else "p2_q8_layer_walk",
           "q8_probe_p2", xm, res, pw, nw, *(t for w in ws for t in w),
           *(bufs[k] for k in ("h1", "act", "out", "qkv")), n_layers, qd, h,
           f, nq, float(eps), int(barriers), int(blocks or k4_grid(h)))


# ------------------------------------------------------------------ P1

def p1_chain(xm, res, pw, nw, ws, eps=EPS, plain=False):
    """P1: one K4a launch per layer (``q8_mlp_qkv_fused`` on layer views;
    with ``plain`` its plain version on any device), no attention; between
    calls ``xm ← bf16(qkv[:, :qd])`` and the residual, rounded to bf16 as
    K4 takes it → the last call's (out [1, h], qkv [1, nq]) f32."""
    fn = q8_mlp_qkv_fused_plain if plain else q8_mlp_qkv_fused
    o, gu, dn, qk = ws
    qd = xm.shape[-1]
    xm, r = xm.to(torch.bfloat16), res.to(torch.bfloat16)
    for l in range(o.q.shape[0]):
        out, qkv = fn(xm, r, pw, nw, layer(o, l), layer(gu, l),
                      layer(dn, l), layer(qk, l), eps)
        xm, r = qkv[:, :qd].to(torch.bfloat16), out.to(torch.bfloat16)
    return out, qkv


def enqueue_ms(fn, reps=5):
    """The host's median ms to enqueue ``fn()`` while the card is held by
    a long sleep (so nothing the host does waits for the card)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(50 * SLEEP_CYCLES)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def graph_ms(fn):
    """Median device ms of one replay of ``fn()`` captured in a CUDA graph
    (one launch for the host to enqueue)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay)


# ------------------------------------------------------------------ P3, P4

def reshape_plain(x, shape):
    """P3: x's elements in row-major order as ``shape``, by an index
    gather."""
    return x.reshape(-1)[torch.arange(x.numel(), device=x.device)
                         ].reshape(shape)


def reshape(x, shape):
    """P3 on CUDA: the reshape through the kernel's shared memory."""
    if x.device.type == "cpu":
        return reshape_plain(x, shape)
    y = torch.empty(shape, dtype=torch.float32, device=x.device)
    check_cuda((x, y), (torch.float32,) * 2, (None, None), "reshape")
    if x.dim() != 2 or y.dim() != 2 or x.numel() != y.numel():
        raise ValueError(f"reshape takes 2-D shapes of one size, got "
                         f"{tuple(x.shape)} -> {tuple(shape)}")
    launch("p3_reshape", "probe_reshape", x, y, *x.shape, *shape)
    return y


def p4_inputs(device="cpu", seed=0):
    """P4's q int8 [256, 1024] and f16 scales d [256, 32] (its shapes and
    draws, :303-304)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (256, 1024), np.int8)
    d = rng.random((256, 32), np.float32).astype(np.float16)
    return torch.from_numpy(q).to(device), torch.from_numpy(d).to(device)


# ------------------------------------------------------------------ P0

def q8_decode_params(cfg, device, seed=2):
    """Random q8_0 decoder weights at ``cfg``'s widths, made on the device
    from a seed (int8 values, f16-representable f32 block scales, bf16
    norms and embedding), marked for the fused decode (K4) → (fused tree,
    the same tree marked for the all-layers kernel, K5)."""
    from ..models.qwen3 import fuse_qwen3_params_q8, fuse_qwen3_params_q8_mega
    gen = torch.Generator(device=device).manual_seed(seed)
    n, h, hd, f = cfg.n_layers, cfg.hidden, cfg.head_dim, cfg.ffn_dim
    qd = cfg.q_heads * hd
    nq = qd + 2 * cfg.kv_heads * hd

    def q8(*shape):
        q = torch.randint(-128, 128, shape, generator=gen, device=device,
                          dtype=torch.int8)
        d = (torch.rand(*shape[:-1], shape[-1] // BLOCK, generator=gen,
                        device=device) * 1.5e-4 + 2e-4).half().float()
        return Q8Weight(q, d)

    def norm(*shape):
        return (1 + 0.1 * torch.randn(*shape, generator=gen, device=device)
                ).to(torch.bfloat16)

    layers = dict(input_ln=norm(n, h), post_ln=norm(n, h),
                  q_norm=norm(n, hd), k_norm=norm(n, hd), qkv_w=q8(n, nq, h),
                  o_w=q8(n, h, qd), gate_up_w=q8(n, 2 * f, h),
                  down_w=q8(n, h, f))
    vocab_pad = cfg.vocab_size + -cfg.vocab_size % 1024
    params = dict(
        embed=(0.02 * torch.randn(cfg.vocab_size, h, generator=gen,
                                  device=device)).to(torch.bfloat16),
        final_ln=norm(h), layers=layers, lm_head_q=q8(vocab_pad, h))
    fused = fuse_qwen3_params_q8(params)
    return fused, fuse_qwen3_params_q8_mega(fused, cfg)


def two_point_ms(run, n1=4, n2=16, repeats=3):
    """P0's two-point method (:49-64): ms per step from the host times of
    ``run(n1)`` and ``run(n2)`` (each ends in a sync), the best of
    ``repeats`` each, after one warm-up of both."""
    def timed(n):
        t0 = time.perf_counter()
        run(n)
        return time.perf_counter() - t0
    timed(n1)
    timed(n2)
    t1 = min(timed(n1) for _ in range(repeats))
    t2 = min(timed(n2) for _ in range(repeats))
    return max((t2 - t1) / (n2 - n1), 1e-9) * 1e3


def p0(device, cfg=None, seed=2, p_len=P_LEN, max_len=MAX_LEN):
    """P0: the q8_0 fused and the all-layers decode step from a ``p_len``
    token prompt, each step writing slot ``p_len`` (:336-348) → per route
    ms/token (:func:`two_point_ms`) and the first step's logits."""
    from ..models.config import Qwen3Config
    from ..models.generate import prefill_init
    from ..models.qwen3 import embed_tokens, qwen3_decode_step
    cfg = cfg or Qwen3Config()
    dev = torch.device(device)
    fused, mega = q8_decode_params(cfg, dev, seed)
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.normal(size=(1, p_len, cfg.hidden)).astype(
        np.float32) * 0.05).to(dev, torch.bfloat16)
    pmask = torch.ones((1, p_len), dtype=torch.float32, device=dev)
    pos = torch.tensor([p_len], device=dev)
    valid_from = torch.zeros(1, dtype=torch.int64, device=dev)
    res = {}
    for name, params in (("fused", fused), ("mega", mega)):
        state = prefill_init(params, prompt, pmask,
                             torch.Generator(device=dev).manual_seed(0), cfg,
                             max_len=max_len)

        def run(n, params=params, kv=state.kv):
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n):
                emb = embed_tokens(params, torch.full((1,), i % 7,
                                                      device=dev))
                logits, _ = qwen3_decode_step(params, kv, emb, p_len, pos,
                                              valid_from, cfg)
                acc = acc + logits.sum()
            return float(acc)

        emb = embed_tokens(params, torch.zeros(1, dtype=torch.int64,
                                               device=dev))
        logits = qwen3_decode_step(params, state.kv, emb, p_len, pos,
                                   valid_from, cfg)[0]
        if not torch.isfinite(logits).all():
            raise RuntimeError(f"P0 {name}: non-finite logits")
        res[name] = dict(ms=two_point_ms(run), logits=logits.float())
    a, b = res["fused"]["logits"].double(), res["mega"]["logits"].double()
    res["cos"] = float((a.flatten() @ b.flatten())
                       / (a.norm() * b.norm() + 1e-30))
    if not res["cos"] > P0_COS:
        raise RuntimeError(f"P0: fused vs all-layers logits cosine "
                           f"{res['cos']:.5f} <= {P0_COS}")
    return res


# ------------------------------------------------------------------ main

def _max_abs(got, ref):
    return max((g - r).abs().max().item() for g, r in zip(got, ref))


def main(device="cuda"):
    """P5(a), P2 (and barrier-only at K4's and K5's grids), P1, P3, P4 and
    P0 on the card, each kernel against its plain version; prints one line
    per measurement and the per-layer split, returns the numbers."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("P0-P4 measure the card: they need a CUDA device")
    xm, res, pw, nw, ws = p2_inputs(dev)
    n_layers = ws[0].q.shape[0]
    w_bytes = p5.n_bytes(ws)
    layer_bytes = w_bytes / n_layers
    out = {}

    # P5(a) over the same bytes: the achievable stream rate
    isum, _ = p5.stream_sum(ws)
    if int(isum.sum()) != p5.stream_sum_plain(ws)[0]:
        raise RuntimeError("P5a: int sum differs from the plain version")
    a_ms = time_ms(lambda: p5.stream_sum(ws))
    rate = w_bytes / (a_ms * 1e-3)
    out["p5a"] = dict(ms=a_ms, gbps=rate / 1e9)
    print(f"[P5a] stream sum of the {n_layers} layers' "
          f"{w_bytes / 1e6:.2f} MB: {a_ms:.4f} ms = {rate / 1e9:.1f} GB/s",
          flush=True)

    # P2, and its barrier-only launch at K4's grid and at K5's
    grid4, grid5 = k4_grid(), k5_grid()
    got = p2_walk(xm, res, pw, nw, ws)
    ref = p2_plain(xm, res, pw, nw, ws)
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    if not (all(torch.isfinite(g).all() for g in got)
            and max(errs) < P2_TOL):
        raise RuntimeError(f"P2: rel err out {errs[0]:.3e}, qkv "
                           f"{errs[1]:.3e} >= {P2_TOL}")
    bufs = p2_buffers(res, ws)
    p2_ms = time_ms(lambda: p2_walk(xm, res, pw, nw, ws, blocks=grid4,
                                    bufs=bufs), iters=10)
    plain_ms = time_ms(lambda: p2_plain(xm, res, pw, nw, ws), iters=3,
                       warmup=1)
    out["p2_q8_layer_walk"] = dict(
        ms=p2_ms, plain_ms=plain_ms, library_ms=None,
        max_abs_err=_max_abs(got, ref), rel_err=max(errs), blocks=grid4,
        n_ops=2 * sum(w.q.numel() for w in ws),
        n_bytes=w_bytes + nbytes(xm, res, pw, nw, *got))
    print(f"[P2] one launch, {n_layers} layers x {P2_BARRIERS_PER_LAYER} "
          f"grid barriers on {grid4} blocks (K4's grid): rel err out "
          f"{errs[0]:.2e} qkv {errs[1]:.2e} (tol {P2_TOL:g}) kernel "
          f"{p2_ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
    n_bar = P2_BARRIERS_PER_LAYER * n_layers
    n_bar5 = K5_BARRIERS_PER_LAYER * n_layers
    bufs = p2_buffers(res, ws)
    got = p2_walk(xm, res, pw, nw, ws, barriers=n_bar, blocks=grid4,
                  bufs=bufs)
    if not (torch.equal(got[0], res.float()) and not got[1].any()):
        raise RuntimeError("P2 barrier-only: an output moved")
    bar_ms = time_ms(lambda: p2_walk(xm, res, pw, nw, ws, barriers=n_bar,
                                     blocks=grid4, bufs=bufs))
    bar5_ms = time_ms(lambda: p2_walk(xm, res, pw, nw, ws, barriers=n_bar5,
                                      blocks=grid5, bufs=bufs))
    # the plain version of barrier-only mode hands back its buffers
    out["p2_barrier_only"] = dict(
        ms=bar_ms, plain_ms=time_ms(lambda: p2_buffers(res, ws)),
        library_ms=None, max_abs_err=0.0, blocks=grid4, barriers=n_bar,
        n_bytes=0, n_ops=0)
    out["p2_barrier_only_k5"] = dict(ms=bar5_ms, blocks=grid5,
                                     barriers=n_bar5)
    print(f"[P2] barrier-only, outputs untouched: {n_bar} barriers on "
          f"{grid4} blocks (K4's grid) {bar_ms:.4f} ms = "
          f"{bar_ms * 1e3 / n_bar:.3f} us a barrier; {n_bar5} on {grid5} "
          f"blocks (K5's grid) {bar5_ms:.4f} ms = "
          f"{bar5_ms * 1e3 / n_bar5:.3f} us a barrier", flush=True)

    # P1: 28 K4a launches; the sleep ahead of the timed calls must outlast
    # the host's enqueue of all 28, else the host is timed
    got = p1_chain(xm, res, pw, nw, ws)
    ref = p1_chain(xm, res, pw, nw, ws, plain=True)
    p1_err = max(rel_err(g, r) for g, r in zip(got, ref))
    if not (all(torch.isfinite(g).all() for g in got) and p1_err < P1_TOL):
        raise RuntimeError(f"P1: rel err {p1_err:.3e} >= {P1_TOL}")
    enq = enqueue_ms(lambda: p1_chain(xm, res, pw, nw, ws))
    sleep_ms = time_ms(lambda: torch.cuda._sleep(SLEEP_CYCLES), iters=5)
    cycles = SLEEP_CYCLES * max(1, math.ceil(2 * enq / sleep_ms))
    p1_ms = time_ms(lambda: p1_chain(xm, res, pw, nw, ws), iters=10,
                    sleep_cycles=cycles)
    p1_graph_ms = graph_ms(lambda: p1_chain(xm, res, pw, nw, ws))
    out["p1"] = dict(ms=p1_ms, graph_ms=p1_graph_ms, enqueue_ms=enq,
                     sleep_ms=sleep_ms, rel_err=p1_err)
    print(f"[P1] {n_layers} chained K4a launches, no attention: rel err "
          f"{p1_err:.2e} (tol {P1_TOL:g}); host enqueue {enq:.3f} ms "
          f"against a {sleep_ms:.3f} ms sleep ("
          f"{'covered' if enq < sleep_ms else 'NOT covered: sleep x'}"
          f"{'' if enq < sleep_ms else cycles // SLEEP_CYCLES}); "
          f"{p1_ms:.4f} ms, in a CUDA graph {p1_graph_ms:.4f} ms",
          flush=True)

    # the split, per layer
    us = {k: v * 1e3 / n_layers for k, v in (
        ("p1", p1_ms), ("p1_graph", p1_graph_ms), ("p2", p2_ms),
        ("barriers", bar_ms), ("barriers_k5", bar5_ms))}
    stream_us = layer_bytes / rate * 1e6
    split = dict(us_per_layer=us, layer_mb=layer_bytes / 1e6,
                 floor_us=layer_bytes / HBM_BYTES_PER_S * 1e6,
                 stream_us=stream_us, fixed_us=us["p1"] - us["p2"],
                 fixed_graph_us=us["p1_graph"] - us["p2"],
                 barrier_us=us["barriers"],
                 stage_us=us["p2"] - us["barriers"] - stream_us)
    out["split"] = split
    print(f"[P0-P2 split] per layer ({layer_bytes / 1e6:.2f} MB): P1 "
          f"{us['p1']:.2f} us (graph {us['p1_graph']:.2f}), P2 "
          f"{us['p2']:.2f} us, barrier-only {us['barriers']:.2f} us (K5's "
          f"grid, 5 a layer: {us['barriers_k5']:.2f} us); byte floor "
          f"{split['floor_us']:.2f} us at 3.35 TB/s, {stream_us:.2f} us at "
          f"P5(a)'s {rate / 1e9:.1f} GB/s; per-call fixed cost P1 - P2 "
          f"{split['fixed_us']:.2f} us (graph {split['fixed_graph_us']:.2f})"
          f", barriers {split['barrier_us']:.2f} us, stage work beyond the "
          f"stream P2 - barriers - stream {split['stage_us']:.2f} us",
          flush=True)

    # P3: reshapes through shared memory, exact
    errs = []
    for shape_in, shape_out in RESHAPES:
        x = torch.arange(math.prod(shape_in), dtype=torch.float32,
                         device=dev).reshape(shape_in)
        y = reshape(x, shape_out)
        errs.append((y - reshape_plain(x, shape_out)).abs().max().item())
        if errs[-1] != 0 or tuple(y.shape) != shape_out:
            raise RuntimeError(f"P3 {shape_in} -> {shape_out}: not exact")
    x = torch.arange(2048, dtype=torch.float32, device=dev).reshape(1, 2048)
    out["p3_reshape"] = dict(
        ms=time_ms(lambda: reshape(x, (16, 128))),
        plain_ms=time_ms(lambda: reshape_plain(x, (16, 128))),
        library_ms=time_ms(lambda: x.reshape(16, 128).clone()),
        max_abs_err=max(errs), n_bytes=2 * nbytes(x), n_ops=0)
    r3 = out["p3_reshape"]
    print(f"[P3] reshape {' '.join(f'{a}->{b}' for a, b in RESHAPES)}: "
          f"exact; (1, 2048)->(16, 128) kernel {r3['ms']:.4f} ms plain "
          f"{r3['plain_ms']:.4f} ms library (reshape().clone()) "
          f"{r3['library_ms']:.4f} ms", flush=True)

    # P4: f16 scales in the tiled order, two bf16 roundings, exact
    q, d = p4_inputs(dev)
    y = expand_scales(q, d, tiled=True)
    err = (y - expand_scales_plain(q, d, tiled=True)).abs().max().item()
    if err != 0:
        raise RuntimeError(f"P4: max abs err {err:.3e} against the plain "
                           f"version")
    want = q.float() * d.float().repeat(1, BLOCK)
    out["p4_scale_expand_f16_tiled"] = dict(
        ms=time_ms(lambda: expand_scales(q, d, tiled=True)),
        plain_ms=time_ms(lambda: expand_scales_plain(q, d, tiled=True)),
        library_ms=None, max_abs_err=err,
        n_bytes=nbytes(q, d, y), n_ops=q.numel())
    print(f"[P4] f16 scales, tiled order [256, 1024]: exact against the "
          f"plain version; against P4's f32 reference q * tile(d) max err "
          f"{(y - want).abs().max().item():.4g} (the bf16 roundings); "
          f"kernel {out['p4_scale_expand_f16_tiled']['ms']:.4f} ms plain "
          f"{out['p4_scale_expand_f16_tiled']['plain_ms']:.4f} ms",
          flush=True)

    r = p0(dev)
    out["p0"] = dict(fused_ms=r["fused"]["ms"], mega_ms=r["mega"]["ms"],
                     cos=r["cos"])
    print(f"[P0] real q8_0 decode step, {P_LEN}-token prompt, max_len "
          f"{MAX_LEN}: fused (K1 + 28 x (K2 + K4)) "
          f"{r['fused']['ms']:.3f} ms/token, all-layers (K5) "
          f"{r['mega']['ms']:.3f} ms/token; first-step logits cosine "
          f"{r['cos']:.6f} (> {P0_COS})", flush=True)
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
