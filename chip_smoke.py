"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # needs one CUDA card

Phases, one line each (any failure raises and exits non-zero):

1. device: torch's device name, and ``nvidia-smi``'s name and power limit;
2. kernel build from ``fun_asr_gguf_tpu_torch/csrc`` (seconds);
3. every kernel of the main paths against its plain PyTorch version on the
   card, at the shapes those paths give it: max-abs and relative error
   against the stated tolerance, both median device times (CUDA events
   around one call, with the queue kept busy while the host enqueues it,
   so the time excludes the host's launch cost), the time of one PyTorch
   call that computes the same function where there is one
   (``scaled_dot_product_attention`` for K2 and K3; for K1's prefill GEMM
   a cuBLAS ``torch.matmul`` on the weight dequantized beforehand, as a
   yardstick of another function) and the bound (the
   larger of bytes over 3.35 TB/s and operations over the input type's
   peak): the decode-sized q8_0 product, one kernel under two dot
   contracts (K1 and K6: the 152576-row head and the layer-0 qkv at m = 1,
   2, 8, 9 and 16, and K1 at o, gate_up and down at m = 1, timed cold,
   cycling the 28 stacked layers), K1's prefill GEMM (warpgroup MMA) at
   Qwen3-0.6B's four projections at m = 256 and 512, its bf16 entry
   bit-equal to the f32 entry's cast, K2 and
   K2-i8 (split-KV) at T = 1 and at the verify step's T = 9 on stacked
   28-layer caches, up to S = 2313, K3 (warpgroup MMA) on SANM's strided
   views at T = 1001, a ragged T = 257 and D = 64, bit-equal to its
   contiguous entry, timed at each key split, K4 (the fused layer chain,
   with and without the next-layer
   qkv stage) and K4c (the last layer's chain with the final norm and the
   152576-row head, timed beside the K4b + K1 head calls it replaces) at
   m = 1 and m = 9 on layer views of stacked [28, n, k] weights, split
   by stage with K4's stage timer (K4a at m = 1 and 9, K4c at m = 1), K5
   (the whole decode step in one launch) at full width on 28-layer
   head-major caches of S = 768 and 1024, with every slot visible and
   with one (the attention's share is the difference), split by stage
   with its stage timer, each GEMV stage's bytes over its time beside
   P5's rates, and K7
   (the int8-dot layer chain on the streaming engine, with and without the
   next-layer qkv, the attention rows quantized in the kernel) at m = 1,
   2, 8, 9 and 16 on the same layer views, bit-equal to its JAX-signature
   entry, split by stage with its stage timer at m = 1 and 9; then the
   probes, each kernel
   against its plain version: P12 (the split-KV stage alone at chunk
   counts 1 ... 32), P6-P11 (the natural-order scale expansion, a
   transpose, rope by lane shuffle and by a rotation product, a batched
   f32 dot, row-pair slices, a head sum over head- and slot-major
   blocks), P0-P4 (P2: the 28 layers of K4's chain in one launch, and its
   barrier-only launch at K4's and at K5's grid; P1: 28 K4 launches; the
   split of a layer's time into stream, per-call fixed cost, barriers and
   stage work; P3, P4; P0: the real fused and all-layers decode steps in
   ms/token) and P5 (the achievable stream rate of 28 layers of q8_0
   bytes, summed, through the dequant GEMV and with f16 scales);
4. end-to-end transcription through ``create_asr_engine(...).transcribe()``
   of a 60 s synthetic clip on a full-width random checkpoint (70-layer
   SANM encoder + Qwen3-0.6B): the JAX facade's defaults (``auto`` →
   per-channel int8 weights and head, bf16 cache, CTC-draft speculation
   with its guardrail), greedy; the int8 KV cache (K2-i8), greedy and with
   the guardrail off (``spec_min_accept=0``) so verify rounds run across
   the whole clip; q8_0 weights (fused decode, K4), greedy, at the
   default temperature and with the guardrail off; the all-layers route
   (q8_0, ``speculative=False``, ``fuse_qwen3_params_q8_mega``: one K5
   launch per step), greedy; the fused-head route (q8_0 under
   ``FUNASR_Q8_FUSED_HEAD=1``: K4c in the last layer), greedy; and the
   int8-dot route (packed, unfused q8_0 through ``fuse_qwen3_params_q8i``:
   K6 for layer 0's qkv and the head, K7 per layer), greedy and with the
   guardrail off. First the
   card paths of those engines against the CPU f32 path on small inputs,
   and a q8_0 engine built with ``n_predict=2048`` (cache S = 2313): a
   prefill and one verify round through ``spec_generate``, and its card
   path against the CPU f32 path at that cache length; then stage timings, verify rounds and each kernel's launch count per
   path; the launches of one decode step and of one verify round per
   engine, and of one encode (K3: 70) and one 200-token prefill (K1's
   GEMM: 112 on the q8_0-weight engines, with bf16 outputs) beside its
   prefill buckets; ms per decode step and per verify round, engine against
   engine in turns, with K1's launches a step on the q8_0 weights without
   the fused chain (4 a layer and the head); and the host's enqueue of one
   all-layers step.

Then the wall time; the second-to-last line is ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``. Imports nothing of
JAX.

    python3 chip_smoke.py --parent DIR   # DIR: another checkout (e.g.
                                         # the parent commit)

also times that checkout's K1 and K6 (every decode-sized shape above),
K1's prefill GEMM and K3 (the shapes above), K4a, K4b, K4c, K7 (m = 1
and 9) and K5 in turns with this one's (phase 3), on the same inputs in
the same process, with the parent decoder's per-layer ``quantize_act_q8``
+ K7 against the folded K7, compares the machine code of the kernels
both trees build from shared sources and this one did not redesign (K4,
K4c, K7, K5, K1 / K6 at m <= 16, K2), and times its all-layers decode
step on this one's engine (phase 4). Phase 3 always checks that the
SASS of K1's prefill GEMM and of K3 holds warpgroup MMA (HGMMA).
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# median device ms of one call, CUDA events behind a sleep kernel so the
# host's enqueue is not timed (shared with the probes)
from fun_asr_gguf_tpu_torch.probes import time_ms

# (name, m, n, k) — K1's prefill GEMM at Qwen3-0.6B's q8_0 projections,
# packed (qkv, gate_up), at both prefill buckets: 256 rows (the 60 s
# clip's prompt, 126 audio tokens and the ChatML text) and 512
K1_SHAPES = [(f"{name} m={m}", m, n, k) for m in (256, 512)
             for name, n, k in (("qkv", 4096, 1024), ("o", 1024, 2048),
                                ("gate_up", 6144, 1024),
                                ("down", 1024, 3072))]
# (name, BH, T, D, valid keys) — K3 at the 60 s clip's encoder (4 heads of
# 128, T = 1001, the last 101 keys masked), a ragged short T, and D = 64
K3_SHAPES = [("T=1001 D=128", 4, 1001, 128, 900),
             ("T=257 D=128", 4, 257, 128, 250),
             ("T=1001 D=64", 8, 1001, 64, 900)]
# The decode-sized product (K1 at m <= 16, and K6 at the head and qkv):
# (name, key of stacked_weights, row counts). m = 1 is a decode step, 9 a
# verify round (spec_k + 1 rows), 2, 8 and 16 the edges of the m classes;
# o, gate_up and down run at m = 1 on the q8_0 route without the fused
# chain. Timed calls cycle the 28 stacked layers (the head alone is
# larger than L2), so L2 is cold.
MATVEC_SHAPES = [
    ("lm_head", "head", (1, 2, 8, 9, 16)),
    ("qkv", "qkv", (1, 2, 8, 9, 16)),
    ("o", "o", (1,)),
    ("gate_up", "gu", (1,)),
    ("down", "dn", (1,)),
]
# relative tolerances on max|err| / max|ref|, with the reason
K1_TOL = 1e-4     # same bf16 products, f32 sums in another order
K2_TOL = 2e-2     # bf16 output: __expf and sum order move results by ~1 ulp
                  # (K2 and K2-i8)
K3_TOL = 2e-2     # bf16 P.V operands vs the plain f32 softmax, bf16 output
K4_TOL = 5e-3     # same bf16 products; f32 sums in another order flip
                  # isolated bf16 ulps of the normed rows and gated product
                  # (K4 and K4c)
K5_TOL = 3e-2     # K4's flips through 28 layers of one f32 residual, plus
                  # expf and the attention sums in another order (measured
                  # <= 2.2e-2 on an H100, the parent design's K5 the same
                  # on the same inputs)
K5_COS = 0.9995   # cosine of the logits against the plain version (measured
                  # >= 0.99972)
K6_TOL = 1e-4     # the same integer partials; the scales and the block sum
                  # in f32, in another order
K7_TOL = 5e-3     # as K6, and the kernel's IEEE 1/sqrt against the plain
                  # torch.rsqrt can flip an isolated int8 value at a .5
                  # boundary of a quantized row
LAYERS = 28       # Qwen3-0.6B: K4 rows cycle the layers, so L2 is cold
# the bound of a kernel: NVIDIA's H100 SXM data sheet at 700 W (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12,
                  "f32": 67e12}   # f32 outside the tensor cores


def log(msg):
    print(msg, flush=True)


def bound(n_bytes, n_ops, kind="bf16"):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for the input type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[kind]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(a.numel() * a.element_size() for a in tensors)


def compare(name, got, ref, tol):
    got, ref = got.to(torch.float32), ref.to(torch.float32)
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    err = (got - ref).abs().max().item()
    scale = max(ref.abs().max().item(), 1e-6)
    if err > tol * scale:
        raise RuntimeError(f"{name}: max abs err {err:.3e} > {tol:g} x "
                           f"max|ref| {scale:.3e}")
    return err, err / scale


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs one GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"[1] device: {name} | nvidia-smi: {smi.stdout.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build():
    from fun_asr_gguf_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.lib()
    log(f"[2] kernel build: {time.perf_counter() - t0:.2f} s "
        f"({build.library_path().name} in {build.library_path().parent})")


def phase_kernels(dev, parent=None):
    from fun_asr_gguf_tpu_torch.ops import (flash_attention, flash_decode,
                                            quant_matmul)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    w = stacked_weights(dev, gen)
    rows.update(phase_matvec(dev, gen, w, parent))
    rows["q8_gemm"] = phase_k1_gemm(dev, gen, parent)

    rows.update(phase_k2(dev, gen))
    rows["q8_layer_fused"] = phase_k4(dev, gen, w, parent)
    rows["q8_layer_head_fused"] = phase_k4c(dev, gen, w, parent)
    rows["q8_decode_all"], k5_gbps = phase_k5(dev, gen, w, parent)
    rows["q8i_layer_fused"] = phase_k7(dev, gen, w, parent)
    del w
    wgmma_check()
    if parent is not None:
        machine_code_check(parent)
    probe_rows, p5_gbps = phase_probes(dev)
    rows.update(probe_rows)
    log("[3] K5 stream rates (S=768, 1 visible slot; bytes over 28 layers "
        "/ stage time with its barrier; head: block 0's share): "
        + ", ".join(f"{k} {v:.1f}" for k, v in k5_gbps.items())
        + f" GB/s; P5(a) {p5_gbps['a']:.1f}, P5(b) {p5_gbps['b']:.1f} GB/s")

    rows["flash_attention"] = phase_k3(dev, gen, parent)
    torch.cuda.synchronize()
    return rows


def phase_k1_gemm(dev, gen, parent=None):
    """K1's prefill GEMM (m > 16) at every shape of :data:`K1_SHAPES`: the
    f32 entry (the JAX signature) against ``q8_matmul_plain``, the bf16
    entry (``_proj``'s) bit-equal to the f32 result's cast, the bf16 entry
    timed, with ``parent`` (another checkout's ``ops.quant_matmul``) in
    turns with that tree's GEMM (its f32 entry, which its ``_proj`` cast),
    beside the yardstick: one ``torch.matmul`` of bf16 x with the weight
    dequantized to bf16 beforehand (cuBLAS; not the same function: it
    reads 2 bytes a weight, not 1.125, and does no dequant), never called
    by the port. Returns the kernels line's row (qkv at m = 256, the 60 s
    clip's; max_abs_err over every shape)."""
    from fun_asr_gguf_tpu_torch.ops import quant_matmul as qm
    row, worst, per_layer = {}, 0.0, {}
    for name, m, n, k in K1_SHAPES:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        q = torch.randint(-128, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        d = (torch.rand(n, k // 32, generator=gen, device=dev) * 1.5e-4
             + 2e-4).half().float()
        wt = qm.Q8Weight(q, d)
        got = qm.q8_matmul(x, wt)
        err, rel = compare(f"K1 q8_gemm {name}", got,
                           qm.q8_matmul_plain(x, wt), K1_TOL)
        if not torch.equal(qm.q8_matmul(x, wt, torch.bfloat16),
                           got.to(torch.bfloat16)):
            raise RuntimeError(f"K1 q8_gemm {name}: the bf16 entry is not "
                               "the f32 entry's cast")
        worst = max(worst, err)
        ms = in_turns(f"K1 q8_gemm {name}",
                      lambda: qm.q8_matmul(x, wt, torch.bfloat16),
                      None if parent is None else
                      (lambda: parent.q8_matmul(x, wt)))
        pms = time_ms(lambda: qm.q8_matmul_plain(x, wt), iters=5)
        wd = qm.dequantize(wt)
        lms = time_ms(lambda: torch.matmul(x, wd.t()))
        del wd
        b = bound(nbytes(x, q, d) + m * n * 2, 2 * m * n * k)
        plan = qm.q8_gemm_plan(m, n, k, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        log(f"[3] K1 q8_gemm {name:14s} [{m}x{k}]x[{n}x{k}]^T {plan}: "
            f"max_abs_err {err:.3e} rel {rel:.2e} (tol {K1_TOL:g}); bf16 "
            f"entry bit-equal to the f32 entry's cast; kernel {ms:.4f} ms "
            f"plain {pms:.4f} ms cublas bf16 (yardstick) {lms:.4f} ms bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        per_layer.setdefault(m, []).append(ms)
        if name == "qkv m=256":
            row = dict(ms=ms, plain_ms=pms, library_ms=lms, **b)
        del x, q, d, wt
    for m, times in per_layer.items():
        log(f"[3] K1 q8_gemm per layer at m={m} (qkv + o + gate_up + down): "
            f"{sum(times):.4f} ms, {28 * sum(times):.3f} ms a 28-layer "
            "prefill")
    row["max_abs_err"] = worst
    return row


def phase_k3(dev, gen, parent=None):
    """K3 at every shape of :data:`K3_SHAPES` on the SANM views of a
    packed [1, T, 3 BH D] projection (the main path's strided entry,
    ``attention_with_mask``) against the plain version on contiguous
    copies, bit-equal to the contiguous entry (``flash_attention``); at
    the encoder's shape timed (the kernel alone, its bias rows made
    beforehand), with ``parent`` (another checkout's
    ``ops.flash_attention``) in turns with that tree's kernel on the
    contiguous copies, at each key split, and beside the yardstick
    ``scaled_dot_product_attention`` with the same bias as a bf16 mask.
    Returns the kernels line's row (the encoder's shape)."""
    from fun_asr_gguf_tpu_torch.ops import flash_attention as fa
    row, worst = {}, 0.0
    for name, bh, t, dd, valid in K3_SHAPES:
        qkv = torch.randn(1, t, 3 * bh * dd, generator=gen,
                          device=dev).to(torch.bfloat16)

        def heads(x):
            return x.reshape(1, t, bh, dd).transpose(1, 2)
        qv, kv, vv = qkv.split(bh * dd, dim=-1)
        qh, kh, vh = heads(qv) * (dd ** -0.5), heads(kv), heads(vv)
        mask = (torch.arange(t, device=dev) < valid).to(torch.float32)[None]
        q, k, v = (a.reshape(bh, t, dd).contiguous() for a in (qh, kh, vh))
        bias = ((mask - 1.0) * 1e4).expand(bh, t).contiguous()
        strided = fa.attention_with_mask(qh, kh, vh, mask).reshape(bh, t, dd)
        err, rel = compare(f"flash_attention {name}", strided,
                           fa.flash_attention_plain(q, k, v, bias), K3_TOL)
        if not torch.equal(strided, fa.flash_attention(q, k, v, bias)):
            raise RuntimeError(f"flash_attention {name}: the strided entry "
                               "is not the contiguous entry")
        worst = max(worst, err)
        msg = (f"[3] K3 flash_attention {name} BH={bh} ({valid} keys "
               f"valid): max_abs_err {err:.3e} rel {rel:.2e} (tol "
               f"{K3_TOL:g}); strided entry bit-equal to the contiguous")
        if name == K3_SHAPES[0][0]:
            rows_b = fa._bias_rows(bias[:1])
            pfa = None if parent is None else parent_module(
                parent, "flash_attention")
            ms = in_turns(f"K3 flash_attention {name}",
                          lambda: fa._launch(qh, kh, vh, rows_b),
                          None if pfa is None else
                          (lambda: pfa.flash_attention(q, k, v, bias)))
            splits = {c: time_ms(lambda c=c: fa._launch(qh, kh, vh, rows_b,
                                                        chunks=c))
                      for c in (1, 2, 4, 8)}
            pms = time_ms(lambda: fa.flash_attention_plain(q, k, v, bias))
            mask_bf = bias.to(torch.bfloat16)[:, None, :]
            lms = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask_bf, scale=1.0))
            b = bound(nbytes(q, k, v, bias) + q.numel() * 2,
                      4 * bh * t * t * dd)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            msg += (f"; kernel {ms:.4f} ms (chunks "
                    f"{fa.attention_chunks(bh, t, sms)}; at 1 / 2 / 4 / 8: "
                    + " / ".join(f"{v:.4f}" for v in splits.values())
                    + f") plain {pms:.4f} ms sdpa {lms:.4f} ms bound "
                    f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
            row = dict(ms=ms, plain_ms=pms, library_ms=lms, **b)
        log(msg)
    row["max_abs_err"] = worst
    return row


def stacked_weights(dev, gen):
    """Random Qwen3-0.6B q8_0 weights: stacked [28, n, k] o, gate_up, down
    and packed qkv, the [152576, 1024] head, and bf16 norm weights [28, 2,
    1024] (post, next input)."""
    from fun_asr_gguf_tpu_torch.ops import quant_matmul as qm

    def q8(*shape):
        q = torch.randint(-128, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        d = (torch.rand(*shape[:-1], shape[-1] // 32, generator=gen,
                        device=dev) * 1.5e-4 + 2e-4).half().float()
        return qm.Q8Weight(q, d)

    return dict(o=q8(LAYERS, 1024, 2048), gu=q8(LAYERS, 6144, 1024),
                dn=q8(LAYERS, 1024, 3072), qkv=q8(LAYERS, 4096, 1024),
                head=q8(152576, 1024),
                norms=(1 + 0.1 * torch.randn(LAYERS, 2, 1024, generator=gen,
                                             device=dev)).to(torch.bfloat16))


def in_turns(name, run, parent_run):
    """``run``'s ms; with ``parent_run`` (the --parent checkout's same
    call) timed in turns, parent / this / this / parent, logged, and the
    median of this one's two turns returned."""
    if parent_run is None:
        return time_ms(run)
    turns = [time_ms(f) for f in (parent_run, run, run, parent_run)]
    log(f"[3] {name} in turns parent / this / this / parent: "
        + " / ".join(f"{t:.4f}" for t in turns) + " ms")
    return float(np.median(turns[1:3]))


def k4_stages(name, runs):
    """K4's stage timer (``ops.quant_matmul.q8_layer_fused_stage_ms``):
    the median over ``runs`` (one call each, cycling the layers) of each
    stage's ms, each to its grid barrier, logged."""
    got = [run()[0] for run in runs]
    med = {k: float(np.median([g[k] for g in got])) for k in got[0]}
    log(f"[3] {name} stages (ms, each to its grid barrier, median of "
        f"{len(runs)}): " + ", ".join(f"{k} {v:.4f}" for k, v in med.items()))
    return med


def phase_k4(dev, gen, w, parent=None):
    """K4 at full width on layer views of stacked [28, n, k] weights: the
    next-layer-qkv form (layers 0..26) and the last-layer form, at m = 1
    (decode) and m = 9 (verify). Timed calls cycle the layers; with
    ``parent`` (another checkout's ``ops.quant_matmul``) its K4 is timed
    on the same inputs in turns with this one. K4a's stage timer splits
    its launch at m = 1 and m = 9."""
    from fun_asr_gguf_tpu_torch.ops import quant_matmul as qm
    bf = torch.bfloat16
    o, gu, dn, qkv, norms = w["o"], w["gu"], w["dn"], w["qkv"], w["norms"]
    ln = [0]

    def args(l, with_qkv):
        w = [qm.layer(o, l), qm.layer(gu, l), qm.layer(dn, l)]
        if with_qkv:
            return [norms[l, 0], norms[l, 1], *w, qm.layer(qkv, l)]
        return [norms[l, 0], *w]

    def call(fn, xm, res, with_qkv, cycle=True):
        if cycle:
            ln[0] = (ln[0] + 1) % LAYERS
        out = fn(xm, res, *args(ln[0], with_qkv), 1e-6)
        return out if with_qkv else (out,)

    row, worst = {}, 0.0
    for m in (1, 9):
        xm = torch.randn(m, 2048, generator=gen, device=dev).to(bf)
        res = torch.randn(m, 1024, generator=gen, device=dev).to(bf)
        for with_qkv, name, kern, plain in (
                (True, "K4a q8_mlp_qkv_fused", qm.q8_mlp_qkv_fused,
                 qm.q8_mlp_qkv_fused_plain),
                (False, "K4b q8_mlp_fused", qm.q8_mlp_fused,
                 qm.q8_mlp_fused_plain)):
            errs = [compare(f"{name} m={m}", g, r, K4_TOL) for g, r in zip(
                call(kern, xm, res, with_qkv, cycle=False),
                call(plain, xm, res, with_qkv, cycle=False))]
            err = max(e for e, _ in errs)
            rel = max(r for _, r in errs)
            worst = max(worst, err)
            pk = None if parent is None else getattr(parent, kern.__name__)
            ms = in_turns(f"{name} m={m}",
                          lambda: call(kern, xm, res, with_qkv),
                          pk and (lambda: call(pk, xm, res, with_qkv)))
            pms = time_ms(lambda: call(plain, xm, res, with_qkv))
            if with_qkv:
                k4_stages(f"K4a q8_mlp_qkv_fused m={m}", [
                    lambda l=l: qm.q8_layer_fused_stage_ms(
                        xm, res, *args(l, True), 1e-6)
                    for l in range(0, LAYERS, 4)])
            ws = args(0, with_qkv)[1 + with_qkv:]
            b = bound(nbytes(xm, res, *norms[0, :1 + with_qkv],
                             *(a for w in ws for a in w))
                      + m * (1024 + (4096 if with_qkv else 0)) * 4,
                      2 * m * sum(w.q.numel() for w in ws))
            log(f"[3] {name} m={m} (o 1024x2048, gate_up 6144x1024, down "
                f"1024x3072{', qkv 4096x1024' if with_qkv else ''}): "
                f"max_abs_err {err:.3e} rel {rel:.2e} (tol {K4_TOL:g}) "
                f"kernel {ms:.4f} ms plain {pms:.4f} ms bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
            if with_qkv and m == 1:
                row = dict(ms=ms, plain_ms=pms, library_ms=None, **b)
    row["max_abs_err"] = worst
    return row


@contextlib.contextmanager
def env_vars(values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


FUSED_HEAD = {"FUNASR_Q8_FUSED_HEAD": "1"}


def phase_k4c(dev, gen, w, parent=None):
    """K4c (the last layer's chain + final norm + the 152576-row head) at
    m = 1 (decode) and m = 9 (verify) on layer views of the stacked
    weights, beside the calls it replaces: K4b, the final RMSNorm and the
    K1 head, as the decoder runs them with the knob off; with ``parent``
    its K4c in turns with this one. K4c's stage timer splits its launch at
    m = 1."""
    from fun_asr_gguf_tpu_torch.models.common import rms_norm
    from fun_asr_gguf_tpu_torch.ops import quant_matmul as qm
    bf = torch.bfloat16
    head, norms = w["head"], w["norms"]
    final = norms[0, 1]
    ln = [0]

    def layer_w(cycle):
        if cycle:
            ln[0] = (ln[0] + 1) % LAYERS
        l = ln[0]
        return [norms[l, 0], qm.layer(w["o"], l), qm.layer(w["gu"], l),
                qm.layer(w["dn"], l)]

    def fused(fn, xm, res, cycle=True):
        post, o, gu, dn = layer_w(cycle)
        return fn(xm, res, post, final, o, gu, dn, head, 1e-6)

    def replaced(xm, res):
        post, o, gu, dn = layer_w(True)
        out = qm.q8_mlp_fused(xm, res, post, o, gu, dn, 1e-6)
        return qm.q8_matmul(rms_norm(out.to(bf), final, 1e-6), head)

    row, worst = {}, 0.0
    with env_vars(FUSED_HEAD):
        for m in (1, 9):
            xm = torch.randn(m, 2048, generator=gen, device=dev).to(bf)
            res = torch.randn(m, 1024, generator=gen, device=dev).to(bf)
            errs = [compare(f"K4c q8_layer_head_fused m={m}", g, r, K4_TOL)
                    for g, r in zip(
                        fused(qm.q8_layer_head_fused, xm, res, cycle=False),
                        fused(qm.q8_layer_head_fused_plain, xm, res,
                              cycle=False))]
            err = max(e for e, _ in errs)
            rel = max(r for _, r in errs)
            worst = max(worst, err)
            pk = None if parent is None else parent.q8_layer_head_fused
            ms = in_turns(f"K4c q8_layer_head_fused m={m}",
                          lambda: fused(qm.q8_layer_head_fused, xm, res),
                          pk and (lambda: fused(pk, xm, res)))
            pms = time_ms(lambda: fused(qm.q8_layer_head_fused_plain, xm,
                                        res))
            if m == 1:
                k4_stages("K4c q8_layer_head_fused m=1", [
                    lambda: qm.q8_layer_fused_stage_ms(
                        xm, res, layer_w(True)[0], final,
                        *layer_w(False)[1:], head, 1e-6, head=True)
                    for _ in range(7)])
            rms = time_ms(lambda: replaced(xm, res))
            ws = layer_w(False)[1:] + [head]
            b = bound(nbytes(xm, res, norms[0, 0], final,
                             *(a for q in ws for a in q))
                      + m * (1024 + 152576) * 4,
                      2 * m * sum(q.q.numel() for q in ws))
            log(f"[3] K4c q8_layer_head_fused m={m} (o 1024x2048, gate_up "
                f"6144x1024, down 1024x3072, head 152576x1024): max_abs_err "
                f"{err:.3e} rel {rel:.2e} (tol {K4_TOL:g}) kernel {ms:.4f} ms "
                f"plain {pms:.4f} ms; replaces K4b + final norm + K1 head "
                f"{rms:.4f} ms; bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']})")
            if m == 1:
                row = dict(ms=ms, plain_ms=pms, library_ms=None, **b)
    row["max_abs_err"] = worst
    return row


def mega_inputs(dev, gen, w, s_len, valid_from, slot):
    """K5's inputs at full width: the token's f32 embedding row and its
    bf16 layer-0 norm, the norm weights, f32 rope rows for position slot,
    the bias row (cached slots [valid_from, slot) visible) and a random
    28-layer head-major bf16 cache [28, 8, S, 128]."""
    bf = torch.bfloat16
    x0 = torch.randn(1, 1024, generator=gen, device=dev) * 0.1
    nhb0 = (x0 * torch.rsqrt(x0.square().mean(-1, keepdim=True) + 1e-6)
            * w["norms"][0, 1].float()).to(bf)
    qk_norms = (1 + 0.1 * torch.randn(2, LAYERS, 128, generator=gen,
                                      device=dev)).to(bf)
    inv = 1.0 / (1e6 ** (torch.arange(64, device=dev) / 64))
    ang = torch.cat([slot * inv, slot * inv])[None]
    j = torch.arange(s_len, device=dev)
    bias = torch.where((j >= valid_from) & (j < slot), 0.0,
                       -1e30).to(torch.float32)[None]
    cache = [torch.randn(LAYERS, 8, s_len, 128, generator=gen,
                         device=dev).to(bf) for _ in range(2)]
    norms_next = torch.cat([w["norms"][1:, 1], w["norms"][:1, 1]])
    return (x0, nhb0, w["norms"][:, 0].contiguous(), norms_next.contiguous(),
            qk_norms[0], qk_norms[1], ang.cos(), ang.sin(), bias, *cache,
            w["qkv"], w["o"], w["gu"], w["dn"], w["head"], 1e-6)


# bytes of K5's streamed matrices at Qwen3-0.6B width (int8 + f32
# scales): each GEMV stage over 28 layers, and the head
K5_STAGE_BYTES = {"qkv": LAYERS * 4096 * 1152, "o": LAYERS * 1024 * 2304,
                  "gate_up": LAYERS * 6144 * 1152,
                  "down": LAYERS * 1024 * 3456, "head": 152576 * 1152}


def phase_k5(dev, gen, w, parent=None):
    """K5 at full width (28 layers, GQA 16/8, head-major bf16 caches): S =
    768 (the 256-token bucket + 512 new tokens) with every cached slot but
    the last visible, and S = 1024 with valid_from = 56 (a left-padded
    200-token prompt) and slot 1000; then the same two caches with one
    visible slot (the difference is the part of the attention that grows
    with the visible slots). K5's stage timer splits each launch into its
    stages (qkv, attention, o, gate_up, down, each with its grid barrier,
    and the head), the median of 5 timed launches. The bound counts the
    visible slots' cache bytes: the kernel reads no masked tile. With
    ``parent`` (another checkout's ``ops.quant_matmul``, see
    :func:`load_parent`) its K5 runs on the same inputs in turns with this
    one (parent, this, this, parent) and its stage timer beside this one's.
    Returns the kernels-line row and each GEMV stage's (and the head's)
    GB/s at S = 768 with one visible slot."""
    from fun_asr_gguf_tpu_torch.ops import quant_matmul as qm
    row, worst, times, gbps = {}, 0.0, {}, {}

    def stage_ms(mod, args):
        runs = [mod.q8_decode_all_stage_ms(*args)[0] for _ in range(5)]
        return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}

    for s_len, vf, slot in ((768, 0, 767), (1024, 56, 1000), (768, 766, 767),
                            (1024, 999, 1000)):
        args = mega_inputs(dev, gen, w, s_len, vf, slot)
        got = qm.q8_decode_all_fused(*args)
        ref = qm.q8_decode_all_fused_plain(*args)
        cos = _cos(got[0], ref[0])
        errs = [compare(f"K5 q8_decode_all S={s_len} {name}", g, r, K5_TOL)
                for name, g, r in zip(("logits", "k_new", "v_new"), got,
                                      ref)]
        if not cos > K5_COS:
            raise RuntimeError(f"K5 S={s_len}: logits cosine {cos:.6f} <= "
                               f"{K5_COS}")
        worst = max([worst] + [e for e, _ in errs])
        visible = slot - vf
        if parent is None:
            ms = time_ms(lambda: qm.q8_decode_all_fused(*args), iters=10)
        else:
            turns = [time_ms(lambda m=m: m.q8_decode_all_fused(*args),
                             iters=10) for m in (parent, qm, qm, parent)]
            ms = float(np.median(turns[1:3]))
            old = parent.q8_decode_all_fused(*args)
            log(f"[3] K5 S={s_len} {visible} visible slots, in turns "
                f"parent / this / this / parent: "
                + " / ".join(f"{t:.4f}" for t in turns) + " ms; parent's "
                f"logits rel err {_rel(old[0], ref[0]):.2e} cosine "
                f"{_cos(old[0], ref[0]):.7f} against the plain version")
            del old
        pms = time_ms(lambda: qm.q8_decode_all_fused_plain(*args), iters=5,
                      warmup=1)
        times[(s_len, visible)] = ms
        ws = [w[k] for k in ("qkv", "o", "gu", "dn", "head")]
        n_bytes = (nbytes(*(a for q in ws for a in q), *args[:9])
                   + visible * LAYERS * 8 * 128 * 2 * 2
                   + 152576 * 4 + 2 * LAYERS * 8 * 128 * 4)
        b = bound(n_bytes, 2 * sum(q.q.numel() for q in ws)
                  + LAYERS * 4 * 16 * visible * 128)
        log(f"[3] K5 q8_decode_all 28 layers S={s_len} visible slots "
            f"[{vf}, {slot}): logits rel {errs[0][1]:.2e} cosine {cos:.7f}, "
            f"k_new rel {errs[1][1]:.2e}, v_new rel {errs[2][1]:.2e} (tol "
            f"{K5_TOL:g}, cosine > {K5_COS}) kernel {ms:.4f} ms plain "
            f"{pms:.4f} ms bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
            f"{n_bytes / 1e6:.2f} MB)")
        if (s_len, visible) == (768, 767):
            row = dict(ms=ms, plain_ms=pms, library_ms=None, **b)
        stages = stage_ms(qm, args)
        log(f"[3] K5 stages S={s_len} {visible} visible slots (ms over 28 "
            f"layers, each to its grid barrier): " + ", ".join(
                f"{k} {v:.4f}" for k, v in stages.items()))
        if parent is not None:
            log(f"[3] K5 parent stages S={s_len} {visible} visible slots: "
                + ", ".join(f"{k} {v:.4f}"
                            for k, v in stage_ms(parent, args).items()))
        if (s_len, visible) == (768, 1):
            gbps = {k: n / stages[k] / 1e6 for k, n in K5_STAGE_BYTES.items()}
        del args, got, ref
    for s_len, visible in ((768, 767), (1024, 944)):
        one = times[(s_len, 1)]
        log(f"[3] K5 visible-slot part S={s_len}: {visible} visible slots "
            f"{times[(s_len, visible)]:.4f} ms - 1 visible slot {one:.4f} ms "
            f"= {times[(s_len, visible)] - one:.4f} ms")
    row["max_abs_err"] = worst
    return row, gbps


# the kernels this tree did not redesign, whose sources it shares with the
# parent's (q8_stream.cuh, q8_slab.cuh, split_kv.cuh, q8_matmul.cu): K4 /
# K4c / K7, K5, K1 / K6 at m <= 16 and K2 / K2-i8
SHARED_KERNELS = ("q8_layer_fused_kernel", "q8_decode_all_kernel",
                  "q8_matvec_kernel", "flash_decode_kernel")
# the redesigned kernels, on warpgroup MMA: HGMMA in their SASS
WGMMA_KERNELS = ("q8_gemm_kernel", "flash_attention_kernel")


def sass(lib_path):
    """{mangled function name: its SASS} of a kernel library, by
    ``cuobjdump -sass`` (the path hashes of internal names taken out)."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    # names of internal linkage carry hashes of their source file
    out = re.sub(r"\d*_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?_cu)_[0-9a-f]{8}",
                 r"<\1>", out)
    out = re.sub(r"_INTERNAL_[0-9a-fA-F]+", "_INTERNAL_", out)
    parts = re.split(r"\n\s*Function : (\S+)\n", out)
    return {name: body.split("\n\t\t....")[0].strip()
            for name, body in zip(parts[1::2], parts[2::2])}


def machine_code_check(parent):
    """Whether this tree's kernels that were not redesigned are the parent
    checkout's machine code: every instance of :data:`SHARED_KERNELS` in
    both libraries, compared instruction for instruction, logged."""
    import importlib
    from fun_asr_gguf_tpu_torch.kernels import build
    pbuild = importlib.import_module(
        parent.__package__.rsplit(".", 1)[0] + ".kernels.build")
    this, theirs = sass(build.build()), sass(pbuild.build())
    names = sorted(n for n in this if any(k in n for k in SHARED_KERNELS))
    same = [n for n in names if theirs.get(n) == this[n]]
    log(f"[3] machine code (cuobjdump -sass) of {', '.join(SHARED_KERNELS)} "
        f"against the parent's: {len(same)} of {len(names)} instances "
        "identical" + ("" if len(same) == len(names) else
                       f"; differ: {[n for n in names if n not in same]}"))


def wgmma_check():
    """Every instance of :data:`WGMMA_KERNELS` issues warpgroup MMA: its
    SASS (``cuobjdump -sass``) holds HGMMA instructions; raises where one
    does not."""
    import re
    from fun_asr_gguf_tpu_torch.kernels import build
    code = sass(build.build())
    found = {n: code[n].count("HGMMA") for n in sorted(code)
             if any(k in n for k in WGMMA_KERNELS)}
    instance = re.compile("(" + "|".join(WGMMA_KERNELS) + r")ILi(\d+)")
    log("[3] HGMMA instructions in the SASS of " + ", ".join(
        "{}<{}>: {}".format(*instance.search(n).groups(), c)
        for n, c in found.items()))
    if not (all(any(k in n for n in found) for k in WGMMA_KERNELS)
            and all(found.values())):
        raise RuntimeError(f"a warpgroup-MMA kernel has no HGMMA: {found}")


def load_parent(root):
    """``ops.quant_matmul`` of the port in another checkout (``root``, e.g.
    the parent commit unpacked with ``git archive``), imported as package
    ``parent_port`` with its own kernel build, so that its K5 runs in the
    same process as this one's (its kernels build at its first call)."""
    import importlib
    import importlib.util
    pkg = os.path.join(os.path.abspath(root), "fun_asr_gguf_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_port", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_port.ops.quant_matmul")


def parent_module(parent, name):
    """Module ``ops.<name>`` of the checkout :func:`load_parent` loaded."""
    import importlib
    return importlib.import_module(f"{parent.__package__}.{name}")


def phase_matvec(dev, gen, w, parent=None):
    """The decode-sized q8_0 product, one kernel under two dot contracts:
    K1 (``q8_matmul``, m <= 16) at every shape of :data:`MATVEC_SHAPES`
    and K6 (``q8dot_matmul``) at the head's and qkv's, on bf16
    activations as the decoder passes them, each against its plain version
    and timed cold (the layer matrices cycle the 28 stacked layers); with
    ``parent`` (another checkout's ``ops.quant_matmul``) its K1 and K6 on
    the same inputs in turns with this one's. No single PyTorch call
    computes either function (``torch._int_mm`` has no block scales).
    Returns the kernels line's rows (the head at m = 1; max_abs_err over
    every shape)."""
    from fun_asr_gguf_tpu_torch.ops import quant_matmul as qm
    rows = {}
    worst = {"q8_matmul": 0.0, "q8dot_matmul": 0.0}
    for name, key, ms_ in MATVEC_SHAPES:
        full = w[key]
        ln = [0]

        def weight(cycle, full=full, ln=ln):
            if full.q.dim() == 2:
                return full
            if cycle:
                ln[0] = (ln[0] + 1) % LAYERS
            return qm.layer(full, ln[0])

        n, k = full.q.shape[-2:]
        for m in ms_:
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            for kern, label, cls, tol, kind in (
                    ("q8_matmul", "K1", qm.Q8Weight, K1_TOL, "bf16"),
                    ("q8dot_matmul", "K6", qm.Q8DotWeight, K6_TOL, "int8")):
                if kern == "q8dot_matmul" and key not in ("head", "qkv"):
                    continue
                fn = getattr(qm, kern)
                plain = getattr(qm, kern + "_plain")
                wt = cls(*weight(False))
                err, rel = compare(f"{label} {kern} {name} m={m}",
                                   fn(x, wt), plain(x, wt), tol)
                worst[kern] = max(worst[kern], err)
                pfn = None if parent is None else getattr(parent, kern)
                ms = in_turns(
                    f"{label} {kern} {name} m={m}",
                    lambda: fn(x, cls(*weight(True))),
                    None if pfn is None else
                    (lambda: pfn(x, cls(*weight(True)))))
                pms = (time_ms(lambda: plain(x, cls(*weight(True))), iters=5)
                       if m in (1, 9) else None)
                b = bound(nbytes(x, *wt) + m * n * 4, 2 * m * n * k, kind)
                log(f"[3] {label} {kern} {name} m={m} [{m}x{k}]x[{n}x{k}]^T "
                    f"(cold): max_abs_err {err:.3e} rel {rel:.2e} (tol "
                    f"{tol:g}) kernel {ms:.4f} ms plain "
                    + ("-" if pms is None else f"{pms:.4f}")
                    + f" ms bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
                    "library: no single call")
                if (name, m) == ("lm_head", 1):
                    rows[kern] = dict(ms=ms, plain_ms=pms, library_ms=None,
                                      **b)
    for kern, err in worst.items():
        rows[kern]["max_abs_err"] = err
    return rows


def phase_k7(dev, gen, w, parent=None):
    """K7 on layer views of the stacked weights (relabelled as the q8i
    fuse does; timed calls cycle the layers, so L2 is cold): the
    next-layer-qkv form and the last-layer form at m = 1 (decode), 9
    (verify) and the m classes' edges 2, 8 and 16, through the decoder's
    entry (``q8i_layer_fused_rows``: bf16 attention rows, quantized in the
    kernel, and the f32 residual rows) against its plain version; that
    entry bit-equal to JAX's signature (``q8i_layer_fused``) on the rows
    ``quantize_act_q8`` makes; at m = 1 and 9 the stage timer, and with
    ``parent`` (another checkout's ``ops.quant_matmul``) its K7 in turns
    with this one on the same q8_0 columns, and its decoder's per-layer
    work (``quantize_act_q8``, then K7) in turns with the folded entry."""
    from fun_asr_gguf_tpu_torch.ops import quant_matmul as qm
    norms = w["norms"]
    n_layers = len(norms)
    h, qd = w["o"].q.shape[1:]
    ln = [0]

    def args(l, with_qkv):
        ws = [qm.Q8DotWeight(*qm.layer(w[key], l)) for key in ("o", "gu",
                                                               "dn")]
        nxt = qm.Q8DotWeight(*qm.layer(w["qkv"], l)) if with_qkv else None
        return [norms[l, 0], norms[l, 1] if with_qkv else None, *ws, nxt]

    def layer_args(cycle, with_qkv):
        if cycle:
            ln[0] = (ln[0] + 1) % n_layers
        return args(ln[0], with_qkv)

    def rows(fn, attn, res, with_qkv, cycle=True):
        return fn(attn, res, *layer_args(cycle, with_qkv), 1e-6)

    def cols(mod, attn_q, attn_s, res, with_qkv, cycle=True):
        return mod.q8i_layer_fused(attn_q.t(), attn_s.t(), res.t(),
                                   *layer_args(cycle, with_qkv), 1e-6,
                                   with_qkv=with_qkv)

    def decoder_then(mod, attn, res, with_qkv):
        """the parent decoder's per-layer work: quantize, then K7"""
        return cols(mod, *mod.quantize_act_q8(attn.float()), res, with_qkv)

    row, worst = {}, 0.0
    for m in (1, 2, 8, 9, 16):
        attn = torch.randn(m, qd, generator=gen, device=dev).to(
            torch.bfloat16)
        res = torch.randn(m, h, generator=gen, device=dev)
        aq, as_ = qm.quantize_act_q8(attn)
        for with_qkv, name in ((True, "K7 q8i_layer_fused"),
                               (False, "K7 q8i_layer_fused (no qkv)")):
            got = rows(qm.q8i_layer_fused_rows, attn, res, with_qkv, False)
            ref = rows(qm.q8i_layer_fused_rows_plain, attn, res, with_qkv,
                       False)
            errs = [compare(f"{name} m={m}", g, r, K7_TOL)
                    for g, r in zip(got, ref) if r is not None]
            err = max(e for e, _ in errs)
            rel = max(r for _, r in errs)
            worst = max(worst, err)
            jax_sig = cols(qm, aq, as_, res, with_qkv, cycle=False)
            if not all(g is None or torch.equal(g, c.t())
                       for g, c in zip(got, jax_sig)):
                raise RuntimeError(f"{name} m={m}: the decoder's entry and "
                                   f"JAX's signature are not bit-equal")
            ms = time_ms(lambda: rows(qm.q8i_layer_fused_rows, attn, res,
                                      with_qkv))
            ws = [a for a in args(0, with_qkv)[2:] if a is not None]
            nq = ws[3].q.shape[0] if with_qkv else 0
            b = bound(nbytes(attn, res, *norms[0, :1 + with_qkv],
                             *(t for q in ws for t in q))
                      + m * (h + nq) * 4,
                      2 * m * sum(q.q.numel() for q in ws), "int8")
            extra = ""
            if m in (1, 9):
                pms = time_ms(lambda: rows(qm.q8i_layer_fused_rows_plain,
                                           attn, res, with_qkv), iters=10)
                pk = None if parent is None else (
                    lambda: cols(parent, aq, as_, res, with_qkv))
                sig = in_turns(f"{name} m={m} (JAX signature, q8_0 "
                               f"columns)",
                               lambda: cols(qm, aq, as_, res, with_qkv), pk)
                extra = f" plain {pms:.4f} ms; JAX signature {sig:.4f} ms"
                if parent is not None:
                    dec = in_turns(
                        f"{name} m={m} (decoder's per-layer work: parent "
                        f"quantize_act_q8 + K7 / this folded entry)",
                        lambda: rows(qm.q8i_layer_fused_rows, attn, res,
                                     with_qkv),
                        lambda: decoder_then(parent, attn, res, with_qkv))
                    extra += f"; folded entry in turns {dec:.4f} ms"
                k4_stages(f"{name} m={m}", [
                    lambda l=l: qm.q8i_layer_fused_stage_ms(
                        attn, res, *args(l, with_qkv), 1e-6)
                    for l in range(0, n_layers, 4)])
                if with_qkv and m == 1:
                    row = dict(ms=ms, plain_ms=pms, library_ms=None, **b)
            log(f"[3] {name} m={m} (o {h}x{qd}, gate_up "
                f"{ws[1].q.shape[0]}x{h}, down {h}x{ws[2].q.shape[1]}"
                f"{f', qkv {nq}x{h}' if with_qkv else ''}; bf16 attention "
                f"rows quantized in the kernel): max_abs_err {err:.3e} rel "
                f"{rel:.2e} (tol {K7_TOL:g}), bit-equal to JAX's signature; "
                f"kernel {ms:.4f} ms{extra}; bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']}); library: no single call")
    row["max_abs_err"] = worst
    return row


# (T, S): the decode step (T = 1) at the 256-token bucket + 512 new
# tokens and at 1024; the verify step (T = 9 rows for spec_k = 8) at the
# same plus 9, and at 2313 (an engine built with n_predict = 2048)
K2_SHAPES = ((1, 768), (1, 1024), (9, 777), (9, 1033), (9, 2313))


def phase_k2(dev, gen):
    """K2 (bf16 cache) and K2-i8 (int8 cache, bf16 scales) over one layer
    of a stacked 28-layer cache (timed calls cycle the layers, so the
    cache is cold in L2 as in a decode step) at ``K2_SHAPES`` (verify row
    i sees slots <= base + i). The yardstick is
    ``scaled_dot_product_attention`` on the bf16 cache (GQA, the bias as a
    float mask), printed beside K2 at every shape; no single PyTorch call
    takes an int8 cache with scales."""
    from fun_asr_gguf_tpu_torch.models.qwen3 import _kv_quantize
    from fun_asr_gguf_tpu_torch.ops import flash_decode as fd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, hd = 16, 8, 128
    rows, worst = {}, {"flash_decode": 0.0, "flash_decode_i8": 0.0}
    for t, s_len in K2_SHAPES:
        q = (torch.randn(1, t, qh, hd, generator=gen, device=dev)
             * (hd ** -0.5)).to(torch.bfloat16)
        j = torch.arange(s_len, device=dev)
        i = torch.arange(t, device=dev)[:, None]
        bias = torch.where((j >= 40) & (j <= s_len - 100 - t + i), 0.0,
                           -1e30).to(torch.float32)[None].contiguous()
        mask_bf = bias.to(torch.bfloat16)[:, None]
        qt = q.transpose(1, 2)
        io_bytes = nbytes(q, bias) + q.numel() * 2      # q, bias in; out
        ops = 4 * t * qh * s_len * hd
        for name in ("flash_decode", "flash_decode_i8"):
            k = torch.randn(LAYERS, 1, s_len, kh, hd, generator=gen,
                            device=dev).to(torch.bfloat16)
            v = torch.randn(LAYERS, 1, s_len, kh, hd, generator=gen,
                            device=dev).to(torch.bfloat16)
            if name == "flash_decode":
                cache = (k, v)
                ln = [0]

                def lib_call(k=k, v=v, ln=ln, qt=qt, mask_bf=mask_bf):
                    ln[0] = (ln[0] + 1) % LAYERS
                    return sdpa(qt, k[ln[0]].transpose(1, 2),
                                v[ln[0]].transpose(1, 2), attn_mask=mask_bf,
                                scale=1.0, enable_gqa=True)
                library = time_ms(lib_call)
                b = bound(io_bytes + nbytes(k[0], v[0]), ops)
            else:
                (kq, ks), (vq, vs) = _kv_quantize(k), _kv_quantize(v)
                cache = (kq, vq, ks, vs)
                library = None
                b = bound(io_bytes + nbytes(kq[0], vq[0], ks[0], vs[0]), ops,
                          "int8")
            del k, v
            ln = [0]

            def call(fn, cache=cache, ln=ln, q=q, bias=bias):
                ln[0] = (ln[0] + 1) % LAYERS
                l = ln[0]
                return fn(q, cache[0][l], cache[1][l], bias,
                          *(c[l] for c in cache[2:]))

            got = fd.flash_decode_attention(q, *(c[0] for c in cache[:2]),
                                            bias, *(c[0] for c in cache[2:]))
            ref = fd.flash_decode_plain(q, *(c[0] for c in cache[:2]), bias,
                                        *(c[0] for c in cache[2:]))
            err, rel = compare(f"{name} T={t} S={s_len}", got, ref, K2_TOL)
            worst[name] = max(worst[name], err)
            ms = time_ms(lambda: call(fd.flash_decode_attention))
            pms = time_ms(lambda: call(fd.flash_decode_plain))
            lib = f" sdpa {library:.4f} ms" if library is not None else ""
            log(f"[3] {'K2' if name == 'flash_decode' else 'K2-i8'} {name} "
                f"B=1 T={t} qh=16 kh=8 hd=128 S={s_len}: max_abs_err "
                f"{err:.3e} rel {rel:.2e} (tol {K2_TOL:g}) kernel {ms:.4f} ms "
                f"plain {pms:.4f} ms{lib} bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']})")
            if (t, s_len) == (1, 1024):
                rows[name] = dict(ms=ms, plain_ms=pms, library_ms=library,
                                  **b)
            del cache, got, ref
    for name, err in worst.items():
        rows[name]["max_abs_err"] = err
    return rows


def phase_probes(dev):
    """The probes, each kernel against its plain version: P12 (the
    split-KV stage alone at chunk counts 1 ... 32) and P6-P11
    (``q8_mega_probes``), P5 (the stream rate of 28 layers of q8_0 bytes:
    summed, through the m = 1 dequant GEMV, and with f16 scales), and
    P0-P4 (``q8_probe``: P2's walk of 28 layers in one launch and its
    barrier-only launch at K4's and K5's grids, P1's 28 K4 launches, the
    split of a layer's time, P3, P4, and P0's real fused and all-layers
    steps in ms/token); their rows for the kernels line (on no path: 0
    launches), and P5(a)'s and P5(b)'s GB/s."""
    from fun_asr_gguf_tpu_torch.probes import q8_bw_probe as p5
    from fun_asr_gguf_tpu_torch.probes import q8_mega_probes as p12
    from fun_asr_gguf_tpu_torch.probes import q8_probe as p0
    rows = {}
    res = p12.main(dev)
    at = next(r for r in res["rows"] if r["chunk"] == p12.CS)
    rows["p12_split_kv_stage"] = dict(
        ms=at["ms"], plain_ms=res["plain_ms"], library_ms=None,
        max_abs_err=max(r["max_abs_err"] for r in res["rows"]),
        **bound(res["n_bytes"], 4 * p12.QH * (p12.SLOT + 1) * p12.D))
    for key, r in res["probes"].items():
        rows[key] = probe_row(r, "f32")
    res = p0.main(dev)
    for key in ("p2_q8_layer_walk", "p2_barrier_only", "p3_reshape",
                "p4_scale_expand_f16_tiled"):
        rows[key] = probe_row(res[key],
                              "bf16" if key == "p2_q8_layer_walk" else "f32")
    sp = res["split"]
    us = sp["us_per_layer"]
    log(f"[3] P0-P2 per layer: P1 (28 K4a launches) {us['p1']:.2f} us, "
        f"P2 (one launch) {us['p2']:.2f} us, barriers "
        f"{sp['barrier_us']:.2f} us (K5's grid of {p0.k5_grid()} blocks "
        f"and 140 barriers: {res['p2_barrier_only_k5']['ms']:.4f} ms a "
        f"step), stream at "
        f"P5(a) {sp['stream_us']:.2f} us; P0 fused "
        f"{res['p0']['fused_ms']:.3f} ms/token, all-layers "
        f"{res['p0']['mega_ms']:.3f} ms/token")
    res = p5.main(dev)
    for way, name, ops in (("a", "p5a_q8_stream_sum", 0),
                           ("b", "p5b_q8_stream_gemv", 2),
                           ("c", "p5c_q8_stream_gemv_f16", 2)):
        r = res[way]
        n_w = p5.LAYERS * sum(n * k for _, n, k in p5.SHAPES)
        rows[name] = dict(ms=r["ms"], plain_ms=r["plain_ms"], library_ms=None,
                          max_abs_err=r["max_abs_err"],
                          **bound(r["bytes"], ops * n_w))
    log(f"[3] P5a achievable stream rate {res['a']['gbps']:.1f} GB/s "
        f"({100 * res['a']['gbps'] * 1e9 / HBM_BYTES_PER_S:.1f} % of the "
        f"3.35 TB/s data sheet peak)")
    return rows, {way: res[way]["gbps"] for way in ("a", "b")}


def probe_row(r, kind):
    """A probe's row of the kernels line from its numbers."""
    return dict(ms=r["ms"], plain_ms=r["plain_ms"],
                library_ms=r["library_ms"], max_abs_err=r["max_abs_err"],
                **bound(r["n_bytes"], r["n_ops"], kind))


# (name, CUDA source, the TPU kernel it replaces)
KERNELS = [
    ("q8_matmul", "fun_asr_gguf_tpu_torch/csrc/q8_matmul.cu",
     "fun_asr_gguf_tpu/ops/quant_matmul.py:176"),
    ("q8_gemm", "fun_asr_gguf_tpu_torch/csrc/q8_gemm.cu",
     "fun_asr_gguf_tpu/ops/quant_matmul.py:176 (m > 16)"),
    ("flash_decode", "fun_asr_gguf_tpu_torch/csrc/flash_decode.cu",
     "fun_asr_gguf_tpu/ops/flash_decode.py:132"),
    ("flash_decode_i8", "fun_asr_gguf_tpu_torch/csrc/flash_decode.cu",
     "fun_asr_gguf_tpu/ops/flash_decode.py:132 (k_scale/v_scale :80-117)"),
    ("flash_attention", "fun_asr_gguf_tpu_torch/csrc/flash_attention.cu",
     "fun_asr_gguf_tpu/ops/flash_attention.py:90"),
    ("q8_layer_fused", "fun_asr_gguf_tpu_torch/csrc/q8_layer_fused.cu",
     "fun_asr_gguf_tpu/ops/quant_matmul.py:832, :649"),
    ("q8_layer_head_fused", "fun_asr_gguf_tpu_torch/csrc/q8_layer_fused.cu",
     "fun_asr_gguf_tpu/ops/quant_matmul.py:953"),
    ("q8_decode_all", "fun_asr_gguf_tpu_torch/csrc/q8_decode_all.cu",
     "fun_asr_gguf_tpu/ops/quant_matmul.py:1970"),
    ("q8dot_matmul", "fun_asr_gguf_tpu_torch/csrc/q8_matmul.cu",
     "fun_asr_gguf_tpu/ops/quant_matmul.py:1416"),
    ("q8i_layer_fused", "fun_asr_gguf_tpu_torch/csrc/q8_layer_fused.cu",
     "fun_asr_gguf_tpu/ops/quant_matmul.py:1586"),
]
# the probes (on no path of the engine: 0 launches in phase 4)
PROBES = [
    ("p12_split_kv_stage", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_mega_probes.py:220"),
    ("p5a_q8_stream_sum", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_bw_probe.py:92 (sum_kern :104)"),
    ("p5b_q8_stream_gemv", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_bw_probe.py:92 (dq_kern :144)"),
    ("p5c_q8_stream_gemv_f16", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_bw_probe.py:196"),
    ("p2_q8_layer_walk", "fun_asr_gguf_tpu_torch/csrc/q8_probe.cu",
     "experiments/q8_probe.py:247 (mega_multi :246)"),
    ("p2_barrier_only", "fun_asr_gguf_tpu_torch/csrc/q8_probe.cu",
     "experiments/q8_probe.py:247 (mega_multi :246)"),
    ("p3_reshape", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_probe.py:287"),
    ("p4_scale_expand_f16_tiled", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_probe.py:305"),
    ("p6_scale_expand_natural", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_mega_probes.py:46"),
    ("p7_transpose", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_mega_probes.py:62"),
    ("p8a_rope_shuffle", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_mega_probes.py:87"),
    ("p8b_rope_matrix", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_mega_probes.py:103"),
    ("p9_batched_dot", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_mega_probes.py:121"),
    ("p10_pair_scale", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_mega_probes.py:137"),
    ("p11_head_sum", "fun_asr_gguf_tpu_torch/csrc/probes.cu",
     "experiments/q8_mega_probes.py:154"),
]

def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout of the repo (e.g. the parent "
                    "commit from git archive): its kernels are timed in "
                    "turns with this one's in phase 3")
    opts = ap.parse_args()
    t0 = time.perf_counter()
    kind = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    parent = load_parent(opts.parent) if opts.parent else None
    rows = phase_kernels(dev, parent)
    launches = phase_e2e(dev, parent)
    log(f"[5] wall time {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches.get(name, 0), **rows[name])
        for name, src, rep in KERNELS + PROBES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


# bf16 activations through 70 + 28 layers vs f32 on CPU: measured min
# cosine 0.999854 on an H100 80GB HBM3 (700 W); the limit allows ~7x that gap
REF_COS = 0.999


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-6)


def _cos(a, b):
    a, b = a.double().flatten().cpu(), b.double().flatten().cpu()
    return float((a @ b) / (a.norm() * b.norm() + 1e-30))


def write_inputs(root):
    """Full-width random checkpoint, a 60515-entry tokens.txt, a 60 s WAV."""
    import base64
    from fun_asr_gguf_tpu_torch.audio import write_wav
    from fun_asr_gguf_tpu_torch.models.config import HybridConfig
    from fun_asr_gguf_tpu_torch.models.loaders import write_random_checkpoint
    ckpt = os.path.join(root, "ckpt")
    t0 = time.perf_counter()
    cfg = write_random_checkpoint(ckpt, HybridConfig(), seed=0)
    n_vocab = cfg.ctc.vocab_size
    with open(os.path.join(ckpt, "tokens.txt"), "w", encoding="utf-8") as f:
        for i in range(n_vocab):
            ch = chr(0x4E00 + i % 20000) if i < n_vocab - 1 else "<blk>"
            f.write(f"{base64.b64encode(ch.encode()).decode()} {i}\n")
    sr = 16000
    rng = np.random.default_rng(0)
    t = np.arange(60 * sr) / sr
    sig = 0.1 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 0.5 * t))
    sig += 0.02 * rng.normal(size=t.size)
    wav = os.path.join(root, "clip60.wav")
    write_wav(wav, sig, sr)
    log(f"[4] inputs: full-width random checkpoint + 60 s WAV written in "
        f"{time.perf_counter() - t0:.1f} s")
    return ckpt, wav, cfg


def cpu_f32(tree):
    """A parameter tree on the card → the same weights on the CPU, float
    tensors in f32 (int8 values and q8_0 bytes as they are)."""
    if isinstance(tree, dict):
        return {k: cpu_f32(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [cpu_f32(a) for a in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    t = tree.cpu()
    return t.float() if t.is_floating_point() else t


def reference_check(engines, ckpt):
    """The card's kernel path (bf16) against the CPU plain path (f32) on
    small inputs, the CPU path on the same weights as the card's: the
    encoder and CTC logits; then per decoder (the default int8 weights, the
    int8 KV cache, bf16 weights, the fused q8_0 weights and the int8-dot
    q8_0 weights) prefill logits, two teacher-forced decode steps and one
    verify step of 9 tokens (spec_k = 8); the bf16 decoder gives prefill
    logits only, the all-layers (K5) decoder prefill and decode steps (its
    head-major cache takes no verify step)."""
    from fun_asr_gguf_tpu_torch.frontend import frontend_constants
    from fun_asr_gguf_tpu_torch.models import (adaptor, audio_encoder,
                                               generate, loaders, qwen3)
    m = engines["int8"].models
    cpu, dev = torch.device("cpu"), m.device
    t0 = time.perf_counter()
    cfg, enc, ada, ctc, _, _ = loaders.load_checkpoint(ckpt, cpu,
                                                       torch.float32)
    dense = loaders.load_checkpoint(ckpt, dev, torch.bfloat16,
                                    llm_keep_quantized=False)[4]
    # (label, params, int8 cache, decode steps, verify step)
    decoders = [("int8", m.llm_params, False, True, True),
                ("int8 kv8", engines["int8 kv8"].models.llm_params,
                 True, True, True),
                ("bf16", qwen3.pack_qwen3_params(dense), False, False, False),
                ("q8_0 fused", engines["q8_0"].models.llm_params, False, True,
                 True),
                ("q8_0 mega", engines["q8_0 mega"].models.llm_params, False,
                 True, False),
                (Q8I, engines[Q8I].models.llm_params, False, True, True)]
    if not (isinstance(m.llm_params["layers"]["qkv_w"],
                       qwen3.Int8Weight) and "lm_head_i8" in m.llm_params):
        raise RuntimeError("the default engine does not hold int8 weights "
                           "and the int8 head")
    if "q8_fused" not in engines["q8_0"].models.llm_params:
        raise RuntimeError("the q8_0 engine's params are not fused")
    if "q8_mega" not in engines["q8_0 mega"].models.llm_params:
        raise RuntimeError("the mega engine's params are not marked")
    if "q8i_fused" not in engines[Q8I].models.llm_params:
        raise RuntimeError("the q8i engine's params are not marked")
    rng = np.random.default_rng(1)
    audio = (0.05 * rng.normal(size=(1, 3 * 16000))).astype(np.float32)
    n = torch.tensor([audio.shape[1]])
    prompt_ids = torch.from_numpy(rng.integers(0, 256, size=(1, 48)))
    verify_ids = torch.from_numpy(rng.integers(0, 256, size=(1, 9)))
    outs = {"ref": {}, "card": {}}
    for side, d, dtype, p_enc, p_ada, p_ctc in (
            ("ref", cpu, torch.float32, enc, ada, ctc),
            ("card", dev, m._compute_dtype, m.encoder_params,
             m.adaptor_params, m.ctc_params)):
        with torch.inference_mode():
            e, embd, _ = audio_encoder.audio_encoder_forward(
                {"encoder": p_enc, "adaptor": p_ada},
                frontend_constants(m.audio_cfg.frontend, d),
                torch.from_numpy(audio).to(d), n.to(d), m.audio_cfg,
                compute_dtype=dtype)
            outs[side].update(encoder=e, embd=embd,
                              ctc_logits=adaptor.ctc_logits_forward(
                                  p_ctc, e.to(dtype), cfg.ctc))
    for label, p_card, kv8, decode, verify in decoders:
        for side, d, p_llm in (("ref", cpu, cpu_f32(p_card)),
                               ("card", dev, p_card)):
            with torch.inference_mode():
                emb = qwen3.embed_tokens(p_llm, prompt_ids.to(d))
                mask = torch.ones(1, 48, device=d)
                mask[:, :8] = 0
                state = generate.prefill_init(
                    p_llm, emb, mask, torch.Generator(device=d).manual_seed(0),
                    cfg.llm, max_len=64, kv_int8=kv8)
                got = {f"{label} prefill": state.logits}
                if state.kv.head_major != (label == "q8_0 mega"):
                    raise RuntimeError(f"{label}: unexpected cache layout")
                if decode:
                    for k, tok in enumerate((11, 22)):
                        emb = qwen3.embed_tokens(
                            p_llm, torch.tensor([tok], device=d))
                        got[f"{label} decode{k + 1}"] = \
                            qwen3.qwen3_decode_step(
                                p_llm, state.kv, emb, 48 + k,
                                state.prompt_len + k, state.valid_from,
                                cfg.llm)[0]
                if verify:
                    got[f"{label} verify"] = qwen3.qwen3_verify_step(
                        p_llm, state.kv, qwen3.embed_tokens(
                            p_llm, verify_ids.to(d)),
                        torch.tensor([50], device=d),
                        state.prompt_len[:, None] + 2
                        + torch.arange(9, device=d),
                        state.valid_from, cfg.llm)[0]
            outs[side].update(got)
    del dense, decoders
    worst = 1.0
    parts = []
    for key in outs["ref"]:
        c = _cos(outs["ref"][key], outs["card"][key])
        worst = min(worst, c)
        parts.append(f"{key} {c:.6f}")
    log(f"[4] reference (card bf16 kernels vs CPU f32 plain, same weights, "
        f"small inputs): cosine {', '.join(parts)} (min {worst:.6f}, tol > "
        f"{REF_COS}) in {time.perf_counter() - t0:.1f} s")
    if not worst > REF_COS:
        raise RuntimeError(f"card path disagrees with the CPU reference: "
                           f"min cosine {worst:.6f}")


# the q8_0 engine built with n_predict = 2048: its cache holds 256 + 2048 +
# 9 slots, past the shared memory of the one-block-per-head K2 it replaced
LONG_N_PREDICT = 2048


def long_cache_check(ckpt, mods):
    """A q8_0 engine built with ``n_predict=2048`` (cache S = 2313 at the
    256-token bucket): a prefill of a 200-token prompt and one verify round
    through ``spec_generate`` (28 K2 launches at S = 2313), then its card
    path against the CPU f32 path on the same weights (prefill of 48 ids
    and a 9-row verify step into a 2313-slot cache)."""
    from fun_asr_gguf_tpu_torch import create_asr_engine
    from fun_asr_gguf_tpu_torch.models import generate, qwen3
    t0 = time.perf_counter()
    eng = create_asr_engine(ckpt, verbose=False, llm_weight_format="q8_0",
                            n_predict=LONG_N_PREDICT)
    try:
        m = eng.models
        cfg = m.hybrid_cfg.llm
        rng = np.random.default_rng(3)
        prompt = (0.05 * rng.normal(size=(200, cfg.hidden))).astype(
            np.float32)
        state = m.spec_prepare(m.prefill(prompt, rng_seed=0))
        s_len = state.kv.k.shape[2]
        draft = torch.full((1, m.config.spec_draft_len), -1,
                           dtype=torch.int64, device=m.device)
        torch.cuda.synchronize()
        _reset(mods)
        tokens = m.spec_generate(state, draft, 0.0, 1.0, 50, chunk_len=64,
                                 limit=1)
        torch.cuda.synchronize()
        counts = _counts(mods)
        if (s_len != 256 + LONG_N_PREDICT + 9 or int(state.rounds[0]) != 1
                or counts["flash_decode"] != LAYERS
                or int((tokens[0] >= 0).sum()) < 1):
            raise RuntimeError(f"n_predict={LONG_N_PREDICT} verify round: S "
                               f"{s_len}, rounds {int(state.rounds[0])}, "
                               f"launches {counts}")
        ids = torch.from_numpy(rng.integers(0, 256, size=(1, 48)))
        vids = torch.from_numpy(rng.integers(0, 256, size=(1, 9)))
        outs = {}
        for side, d, p_llm in (("ref", torch.device("cpu"),
                                cpu_f32(m.llm_params)),
                               ("card", m.device, m.llm_params)):
            with torch.inference_mode():
                st = generate.prefill_init(
                    p_llm, qwen3.embed_tokens(p_llm, ids.to(d)),
                    torch.ones(1, 48, device=d),
                    torch.Generator(device=d).manual_seed(0), cfg,
                    max_len=s_len)
                outs[side] = (st.logits, qwen3.qwen3_verify_step(
                    p_llm, st.kv, qwen3.embed_tokens(p_llm, vids.to(d)),
                    torch.tensor([48], device=d),
                    st.prompt_len[:, None] + torch.arange(9, device=d),
                    st.valid_from, cfg)[0])
        cos = [_cos(a, b) for a, b in zip(outs["ref"], outs["card"])]
        log(f"[4] n_predict={LONG_N_PREDICT} q8_0 engine: cache S={s_len}; "
            f"one verify round (9 rows) launched {counts['flash_decode']} "
            f"K2; card vs CPU f32 at S={s_len}: prefill {cos[0]:.6f}, verify "
            f"{cos[1]:.6f} (tol > {REF_COS}) in "
            f"{time.perf_counter() - t0:.1f} s")
        if not min(cos) > REF_COS:
            raise RuntimeError(f"the S={s_len} verify step disagrees with the "
                               f"CPU reference: cosine {cos}")
    finally:
        eng.cleanup()


def _counts(mods):
    return {name: getattr(mod, attr) for name, (mod, attr) in mods.items()}


def _reset(mods):
    for mod, attr in mods.values():
        setattr(mod, attr, 0)


def count_verify_rounds(models):
    """Wrap ``models.spec_generate`` so each call adds its verify rounds
    and emitted tokens to the returned dict."""
    stats = {"rounds": 0, "tokens": 0}
    inner = models.spec_generate

    def spec_generate(state, *args, **kwargs):
        r0 = int(state.rounds[0])
        tokens = inner(state, *args, **kwargs)
        stats["rounds"] += int(state.rounds[0]) - r0
        stats["tokens"] += int((tokens[0] >= 0).sum())
        return tokens
    models.spec_generate = spec_generate
    return stats


# a guardrail-off run of the 60 s clip verifies until n_predict (512 on
# random weights, PR 2's runs); far fewer rounds mean the guardrail held
MIN_VERIFY_ROUNDS = 64

def per_step(**counts):
    """Launches of one decode step / verify round: 0 for unnamed kernels."""
    return {name: counts.get(name, 0) for name, _, _ in KERNELS}


MEGA = "q8_0 mega"     # its params get fuse_qwen3_params_q8_mega
Q8I = "q8_0 q8i"       # its packed params get fuse_qwen3_params_q8i
MARKERS = ("q8_fused", "q8_mega", "q8i_fused")   # the decoder routes
# The engines of phase 4: how each is built, its transcriptions
# (temperature, spec_min_accept; None keeps the engine's 1.35), the
# launches one decode step and one verify round must make (28 layers),
# and the environment its runs and steps see
ENGINES = [
    ("int8", {}, [(0.0, None)], per_step(flash_decode=28), {}),
    ("int8 kv8", {"kv_cache_dtype": "int8"}, [(0.0, None), (0.4, 0.0)],
     per_step(flash_decode_i8=28), {}),
    ("q8_0", {"llm_weight_format": "q8_0"},
     [(0.0, None), (0.4, None), (0.4, 0.0)],
     per_step(q8_matmul=2, flash_decode=28, q8_layer_fused=28), {}),
    ("q8_0 head", {"llm_weight_format": "q8_0"}, [(0.0, None)],
     per_step(q8_matmul=1, flash_decode=28, q8_layer_fused=27,
              q8_layer_head_fused=1), FUSED_HEAD),
    (MEGA, {"llm_weight_format": "q8_0", "speculative": False},
     [(0.0, None)], per_step(q8_decode_all=1), {}),
    (Q8I, {"llm_weight_format": "q8_0", "fuse_projections": False},
     [(0.0, None), (0.4, 0.0)],
     per_step(q8dot_matmul=2, flash_decode=28, q8i_layer_fused=28), {}),
]


def phase_e2e(dev, parent=None):
    from fun_asr_gguf_tpu_torch import create_asr_engine
    from fun_asr_gguf_tpu_torch.models.qwen3 import (
        fuse_qwen3_params_q8_mega, fuse_qwen3_params_q8i, pack_qwen3_params)
    from fun_asr_gguf_tpu_torch.ops import (flash_attention, flash_decode,
                                            quant_matmul)
    mods = {"q8_matmul": (quant_matmul, "launches"),
            "q8_gemm": (quant_matmul, "gemm_launches"),
            "flash_decode": (flash_decode, "launches"),
            "flash_decode_i8": (flash_decode, "launches_i8"),
            "flash_attention": (flash_attention, "launches"),
            "q8_layer_fused": (quant_matmul, "fused_launches"),
            "q8_layer_head_fused": (quant_matmul, "head_fused_launches"),
            "q8_decode_all": (quant_matmul, "mega_launches"),
            "q8dot_matmul": (quant_matmul, "q8dot_launches"),
            "q8i_layer_fused": (quant_matmul, "q8i_launches")}
    launches = dict.fromkeys(mods, 0)
    engines = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        ckpt, wav, cfg = write_inputs(root)
        try:
            for name, kwargs, _, _, _ in ENGINES:
                t0 = time.perf_counter()
                # the facade as a user calls it: the card is the default
                engines[name] = create_asr_engine(ckpt, verbose=False,
                                                  **kwargs)
                m = engines[name].models
                if name == MEGA:
                    m.llm_params = fuse_qwen3_params_q8_mega(m.llm_params,
                                                             cfg.llm)
                elif name == Q8I:
                    m.llm_params = fuse_qwen3_params_q8i(
                        pack_qwen3_params(m.llm_params))
                c = engines[name].models.config
                log(f"[4] engine {name} {kwargs}: init (load, quantize, "
                    f"warm-up) {time.perf_counter() - t0:.1f} s; weight "
                    f"format {engines[name].models.weight_format}, kv "
                    f"{c.kv_cache_dtype}, speculative={c.speculative} "
                    f"spec_k={c.spec_k} spec_min_accept={c.spec_min_accept}"
                    f" fuse_projections={c.fuse_projections} markers "
                    f"{[k for k in MARKERS if k in m.llm_params]}")
            reference_check(engines, ckpt)
            long_cache_check(ckpt, mods)
            for name, _, runs, _, env in ENGINES:
                with env_vars(env):
                    path = transcribe_runs(engines[name], name, wav, runs,
                                           mods)
                for k, v in path.items():
                    launches[k] += v
            missing = [k for k, v in launches.items() if v <= 0]
            if missing:
                raise RuntimeError(f"main path never launched {missing}")
            for name, _, _, want, env in ENGINES:
                with env_vars(env):
                    step_launches(engines[name], name, mods, want)
                    encode_prefill_launches(engines[name], name, mods, wav)
            decode_step_ms(engines, parent)
        finally:
            for eng in engines.values():
                eng.cleanup()
    return launches


def transcribe_runs(engine, name, wav, runs, mods):
    """The 60 s clip through ``engine.transcribe`` once per (temperature,
    spec_min_accept); logs each run and returns the kernel launches of
    them all, counted from 0."""
    c = engine.models.config
    default_min = c.spec_min_accept
    spec = count_verify_rounds(engine.models)
    results = []
    _reset(mods)
    try:
        for temp, min_acc in runs:
            n_tok = [0]

            def count(_piece, n_tok=n_tok):
                n_tok[0] += 1

            def reset(n_tok=n_tok):
                n_tok[0] = 0
            c.spec_min_accept = default_min if min_acc is None else min_acc
            spec.update(rounds=0, tokens=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = engine.transcribe(wav, verbose=False, temperature=temp,
                                    on_stream=count, on_stream_reset=reset)
            torch.cuda.synchronize()
            results.append((temp, c.spec_min_accept, res, n_tok[0],
                            time.perf_counter() - t0, dict(spec)))
        counts = _counts(mods)
    finally:
        del engine.models.spec_generate    # back to the unwrapped method
        c.spec_min_accept = default_min
    for temp, min_acc, res, n_tok, wall, st in results:
        t = res.timings
        check_result(res)
        per_round = st["tokens"] / max(st["rounds"], 1)
        log(f"[4] transcribe {name} T={temp} spec_min_accept={min_acc}: "
            f"encode {t.encode*1e3:.1f} ms, ctc {t.ctc*1e3:.1f} ms, "
            f"inject (prefill) {t.inject*1e3:.1f} ms, generate "
            f"{n_tok} pieces in {t.llm_generate*1e3:.1f} ms "
            f"({n_tok / max(t.llm_generate, 1e-9):.1f} pieces/s), "
            f"verify rounds {st['rounds']} emitting "
            f"{st['tokens']} tokens ({per_round:.3f} per round), "
            f"align {t.align*1e3:.2f} ms, total {t.total:.3f} s "
            f"(wall {wall:.3f} s); ctc chars {len(res.ctc_text)}, "
            f"text chars {len(res.text)}, segments "
            f"{len(res.segments)}")
        if min_acc == 0 and st["rounds"] < MIN_VERIFY_ROUNDS:
            raise RuntimeError(f"the spec_min_accept=0 run of {name} ran "
                               f"only {st['rounds']} verify rounds")
    log(f"[4] kernel launches in the {name} transcriptions: {counts}")
    return counts


def check_result(res):
    """What a transcription must look like on any weights."""
    if not (isinstance(res.text, str) and isinstance(res.ctc_text, str)):
        raise RuntimeError("transcription text is not a string")
    if not res.ctc_text:
        raise RuntimeError("the CTC branch produced no text on a 60 s clip")
    t = res.timings
    if not (t.encode > 0 and t.ctc > 0 and t.inject > 0
            and t.llm_generate > 0 and t.total > 0):
        raise RuntimeError(f"a stage did not run: {t}")
    starts = [s["start"] for s in res.segments]
    if starts != sorted(starts) or any(set(s) != {"char", "start"}
                                       for s in res.segments):
        raise RuntimeError("malformed timestamp segments")
    if abs(res.audio_seconds - 60.0) > 1e-6:
        raise RuntimeError(f"clip length {res.audio_seconds} s, expected 60")


def step_launches(engine, name, mods, want):
    """Kernel launches of one decode step and, for a speculative engine, of
    one verify round of an engine against what its path must launch."""
    m = engine.models
    p = np.zeros((200, m.hybrid_cfg.llm.hidden), np.float32)
    # a step of this shape first: it captures the decode graph (an eager
    # step, then the capture), which the counted step replays
    m.generate(m.prefill(p, rng_seed=0), 0.0, 1.0, 50, chunk_len=64,
               limit=1)
    state = m.prefill(p, rng_seed=0)
    torch.cuda.synchronize()
    _reset(mods)
    m.generate(state, 0.0, 1.0, 50, chunk_len=64, limit=1)
    torch.cuda.synchronize()
    step = verify = _counts(mods)
    if m.config.speculative:
        sstate = m.spec_prepare(m.prefill(p, rng_seed=0))
        draft = torch.full((1, m.config.spec_draft_len), -1,
                           dtype=torch.int64, device=m.device)
        torch.cuda.synchronize()
        _reset(mods)
        m.spec_generate(sstate, draft, 0.0, 1.0, 50, chunk_len=64, limit=1)
        torch.cuda.synchronize()
        verify = _counts(mods)
    log(f"[4] {name}: launches per decode step {step}, per verify round "
        f"(9 rows) {verify if m.config.speculative else '(no speculation)'}"
        f"; expected {want}")
    if step != want or verify != want:
        raise RuntimeError(f"a decode step or verify round of {name} did "
                           "not run its path's kernels")


def encode_prefill_launches(engine, name, mods, wav, prompt=200):
    """K3's launches in one encode of the 60 s clip (one a SANM layer: 70)
    and K1 GEMM's in one prefill of a ``prompt``-token prompt (the 256
    bucket): 4 a layer on the q8_0-weight engines (packed qkv, o, packed
    gate_up, down; the head takes the last row only, at m = 1), none on
    the int8 ones, whose products are plain f32; every GEMM output of the
    prefill in the decoder's compute dtype, so ``_proj`` casts nothing
    after it. Logged beside the engine's prefill buckets."""
    import collections
    from fun_asr_gguf_tpu_torch.audio import load_audio
    from fun_asr_gguf_tpu_torch.ops import quant_matmul
    m = engine.models
    cfg = m.hybrid_cfg
    audio = load_audio(wav, 16000)
    torch.cuda.synchronize()
    _reset(mods)
    m.encode_audio(audio)
    torch.cuda.synchronize()
    encode = _counts(mods)["flash_attention"]
    inner, outs = quant_matmul.q8_matmul, collections.Counter()

    def counted(x, w, out_dtype=torch.float32):
        y = inner(x, w, out_dtype)
        if x.shape[0] > quant_matmul.MATVEC_MAX_ROWS:
            outs[str(y.dtype).replace("torch.", "")] += 1
        return y
    p = np.zeros((prompt, cfg.llm.hidden), np.float32)
    quant_matmul.q8_matmul = counted
    try:
        _reset(mods)
        m.prefill(p, rng_seed=0)
        torch.cuda.synchronize()
    finally:
        quant_matmul.q8_matmul = inner
    gemm = _counts(mods)["q8_gemm"]
    q8 = m.weight_format == "q8_0"
    want = (cfg.encoder.num_blocks + cfg.encoder.tp_blocks,
            4 * cfg.llm.n_layers if q8 else 0)
    log(f"[4] {name}: prefill buckets {sorted(m.config.prefill_buckets)} (a "
        f"{prompt}-token prompt: {m.prompt_bucket(prompt)}); K3 launches an "
        f"encode {encode}, K1 GEMM launches a prefill {gemm}, their outputs "
        f"{dict(outs)}; expected {want[0]} and {want[1]}")
    if (encode, gemm) != want or (q8 and set(outs) != {"bfloat16"}):
        raise RuntimeError(f"the {name} engine's encode or prefill did not "
                           "run its path's kernels")


def decode_step_ms(engines, parent=None, steps=64):
    """ms per decode step (64-step greedy chunk) of every engine (the
    fused-head engine under its knob, the all-layers engine on its own
    params) and of the q8_0 weights unfused, in turns and back; ms per
    verify round (spec_k = 8, empty draft) of every speculative engine;
    the host's enqueue of the all-layers step, with ``parent`` also the
    parent checkout's step on the same params, in turns."""
    from fun_asr_gguf_tpu_torch.models.generate import generate_chunk
    from fun_asr_gguf_tpu_torch.ops import quant_matmul
    q8 = engines["q8_0"].models
    envs = {name: env for name, _, _, _, env in ENGINES}
    turns = [(name, engines[name].models, engines[name].models.llm_params)
             for name in engines]
    turns.insert(1 + list(engines).index("q8_0"), (
        "q8_0 unfused", q8,
        {k: v for k, v in q8.llm_params.items() if k != "q8_fused"}))
    res, k1 = {}, []
    for name, m, params in turns + turns[::-1]:
        state = m.prefill(np.zeros((200, m.hybrid_cfg.llm.hidden),
                                   np.float32), rng_seed=0)
        with torch.inference_mode(), env_vars(envs.get(name, {})):
            generate_chunk(params, state, m.hybrid_cfg.llm, 0.0, 1.0, 50,
                           chunk_len=steps, stop_tokens=m.stop_tokens,
                           limit=4, graphs=m.decode_graphs)
            torch.cuda.synchronize()
            t0, step0 = time.perf_counter(), state.step
            k1_0 = quant_matmul.launches
            generate_chunk(params, state, m.hybrid_cfg.llm, 0.0, 1.0, 50,
                           chunk_len=steps, stop_tokens=m.stop_tokens,
                           graphs=m.decode_graphs)
            torch.cuda.synchronize()
        # the chunk stops early once its row is done (a stop id or the
        # repetition fuse): divide by the steps it ran
        ran = max(state.step - step0, 1)
        res.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3 / ran)
        if name == "q8_0 unfused":
            k1.append((quant_matmul.launches - k1_0) / ran)
    # without the fused chain every projection is a K1 launch: 4 a layer
    # (packed qkv and gate_up, o, down) and the head
    want = 4 * q8.hybrid_cfg.llm.n_layers + 1
    log(f"[4] q8_0 unfused: K1 launches per decode step {k1} (expected "
        f"{want})")
    if any(n != want for n in k1):
        raise RuntimeError(f"the q8_0 unfused step made {k1} K1 launches, "
                           f"not {want}")
    verify = {}
    for name, eng in engines.items():
        m = eng.models
        if not m.config.speculative:
            continue
        sstate = m.spec_prepare(m.prefill(np.zeros(
            (200, m.hybrid_cfg.llm.hidden), np.float32), rng_seed=0))
        draft = torch.full((1, m.config.spec_draft_len), -1,
                           dtype=torch.int64, device=m.device)
        with env_vars(envs[name]):
            m.spec_generate(sstate, draft, 0.0, 1.0, 50, chunk_len=steps,
                            limit=4)
            torch.cuda.synchronize()
            r0, t0 = int(sstate.rounds[0]), time.perf_counter()
            m.spec_generate(sstate, draft, 0.0, 1.0, 50, chunk_len=steps,
                            limit=steps)
            torch.cuda.synchronize()
        verify[name] = (time.perf_counter() - t0) * 1e3 / max(
            int(sstate.rounds[0]) - r0, 1)
    log(f"[4] decode step (28 layers + head as a CUDA graph replay, "
        f"sampling eager), ms/step in "
        f"turns {' / '.join(n for n, _, _ in turns)} and back: "
        + "; ".join(f"{n} {' / '.join(f'{x:.3f}' for x in v)}"
                    for n, v in res.items())
        + "; verify round (9 rows, T=0, empty draft), ms/round: "
        + ", ".join(f"{n} {v:.3f}" for n, v in verify.items()))
    log(f"[4] {Q8I} (K6 + K7) against q8_0 fused (K1 + K4), ms/step in the "
        f"turns above: {' / '.join(f'{x:.3f}' for x in res[Q8I])} against "
        f"{' / '.join(f'{x:.3f}' for x in res['q8_0'])}; median ratio "
        f"{np.median(res[Q8I]) / np.median(res['q8_0']):.3f}")
    from fun_asr_gguf_tpu_torch.models import qwen3
    turns = [("this", qwen3)]
    if parent is not None:
        import importlib
        pq = importlib.import_module(
            parent.__package__.rsplit(".", 1)[0] + ".models.qwen3")
        turns = [("parent", pq), ("this", qwen3), ("this", qwen3),
                 ("parent", pq)]
    res = [(name, *mega_enqueue_ms(engines[MEGA].models,
                                   mod.qwen3_decode_step))
           for name, mod in turns]
    log(f"[4] {MEGA} decode step alone (qwen3_decode_step: K5 and the calls "
        f"around it, no sampling), 32 steps, in turns "
        f"{' / '.join(n for n, _, _ in res)}: the host's enqueue "
        + " / ".join(f"{e:.4f}" for _, e, _ in res)
        + " ms/step with no synchronize; "
        + " / ".join(f"{w:.4f}" for _, _, w in res)
        + " ms/step to the synchronize")


def mega_enqueue_ms(m, decode_step, steps=32):
    """The host's enqueue of the mega route's decode step: a host clock
    around ``steps`` calls of ``decode_step`` (``qwen3_decode_step`` of
    this port or of the ``--parent`` checkout) with no synchronize (the
    card runs behind), and the same calls' time to the synchronize that
    follows them. Returns both in ms per step."""
    from fun_asr_gguf_tpu_torch.models.qwen3 import embed_tokens
    state = m.prefill(np.zeros((200, m.hybrid_cfg.llm.hidden), np.float32),
                      rng_seed=0)
    params, cfg = m.llm_params, m.hybrid_cfg.llm
    emb = embed_tokens(params, torch.zeros(1, dtype=torch.int64,
                                           device=m.device))

    def step(i):
        decode_step(params, state.kv, emb, state.prompt_slots + i,
                    state.prompt_len + i, state.valid_from, cfg)

    with torch.inference_mode():
        for i in range(4):
            step(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return (t1 - t0) * 1e3 / steps, (t2 - t0) * 1e3 / steps


if __name__ == "__main__":
    sys.exit(main())
