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
   (``scaled_dot_product_attention`` for K2 and K3) and the bound (the
   larger of bytes over 3.35 TB/s and operations over the input type's
   peak): K1 at decode (m = 1), verify (m = 9) and prefill rows, K2 and
   K2-i8 at T = 1 and at the verify step's T = 9 on stacked 28-layer
   caches, K3, and K4 (the fused layer chain, with and without the
   next-layer qkv stage) at m = 1 and m = 9 on layer views of stacked
   [28, n, k] weights;
4. end-to-end transcription through ``create_asr_engine(...).transcribe()``
   of a 60 s synthetic clip on a full-width random checkpoint (70-layer
   SANM encoder + Qwen3-0.6B): the JAX facade's defaults (``auto`` →
   per-channel int8 weights and head, bf16 cache, CTC-draft speculation
   with its guardrail), greedy; the int8 KV cache (K2-i8), greedy and with
   the guardrail off (``spec_min_accept=0``) so verify rounds run across
   the whole clip; and q8_0 weights (fused decode, K4), greedy, at the
   default temperature and with the guardrail off. First the card paths
   of those engines against the CPU f32 path on small inputs; then stage
   timings, verify rounds and each kernel's launch count per path; the
   launches of one decode step and of one verify round per engine; and ms
   per decode step and per verify round, engine against engine in turns.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# (name, m, n, k) — Qwen3-0.6B q8_0 projections, packed (qkv, gate_up),
# at decode (m = 1) and at the 512-token prefill bucket, plus the lm_head;
# the verify round's layer-0 qkv and lm_head at m = 9 (spec_k + 1 rows)
K1_SHAPES = [
    ("lm_head m=1", 1, 152576, 1024),
    ("lm_head m=9", 9, 152576, 1024),
    ("qkv m=9", 9, 4096, 1024),
    ("qkv m=1", 1, 4096, 1024),
    ("o m=1", 1, 1024, 2048),
    ("gate_up m=1", 1, 6144, 1024),
    ("down m=1", 1, 1024, 3072),
    ("qkv m=512", 512, 4096, 1024),
    ("o m=512", 512, 1024, 2048),
    ("gate_up m=512", 512, 6144, 1024),
    ("down m=256", 256, 1024, 3072),
]
# relative tolerances on max|err| / max|ref|, with the reason
K1_TOL = 1e-4     # same bf16 products, f32 sums in another order
K2_TOL = 2e-2     # bf16 output: __expf and sum order move results by ~1 ulp
                  # (K2 and K2-i8)
K3_TOL = 2e-2     # bf16 P.V operands vs the plain f32 softmax, bf16 output
K4_TOL = 5e-3     # same bf16 products; f32 sums in another order flip
                  # isolated bf16 ulps of the normed rows and gated product
LAYERS = 28       # Qwen3-0.6B: K4 rows cycle the layers, so L2 is cold
# the bound of a kernel: NVIDIA's H100 SXM data sheet at 700 W (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Median device milliseconds of one ``fn()`` (CUDA events). A sleep
    kernel ahead of the start event keeps the card busy while the host
    enqueues ``fn``, so the time is the card's, without the host's launch
    cost (which would otherwise dominate a call of a few microseconds)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


SLEEP_CYCLES = 4_000_000   # ~2 ms at the H100's clock: longer than any
                           # plain version's host-side enqueue


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


def phase_kernels(dev):
    from fun_asr_gguf_tpu_torch.ops import (flash_attention, flash_decode,
                                            quant_matmul)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # K1
    worst = 0.0
    for name, m, n, k in K1_SHAPES:
        x = randn(m, k)
        q = torch.randint(-128, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        d = (torch.rand(n, k // 32, generator=gen, device=dev) * 1.5e-4
             + 2e-4).half().float()
        w = quant_matmul.Q8Weight(q, d)
        err, rel = compare(f"q8_matmul {name}", quant_matmul.q8_matmul(x, w),
                           quant_matmul.q8_matmul_plain(x, w), K1_TOL)
        worst = max(worst, err)
        ms = time_ms(lambda: quant_matmul.q8_matmul(x, w))
        pms = time_ms(lambda: quant_matmul.q8_matmul_plain(x, w))
        b = bound(nbytes(x, q, d) + m * n * 4, 2 * m * n * k)
        log(f"[3] K1 q8_matmul {name:14s} [{m}x{k}]x[{n}x{k}]^T: max_abs_err "
            f"{err:.3e} rel {rel:.2e} (tol {K1_TOL:g}) kernel {ms:.4f} ms "
            f"plain {pms:.4f} ms bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})")
        if name == "lm_head m=1":
            rows["q8_matmul"] = dict(ms=ms, plain_ms=pms, library_ms=None,
                                     **b)
        del x, q, d, w
    rows["q8_matmul"]["max_abs_err"] = worst

    rows.update(phase_k2(dev, gen))
    rows["q8_layer_fused"] = phase_k4(dev, gen)

    # K3: SANM attention at the 60 s window (T = 1001), 4 heads of 128
    bh, t, dd = 4, 1001, 128
    q = randn(bh, t, dd) * (dd ** -0.5)
    k = randn(bh, t, dd)
    v = randn(bh, t, dd)
    mask = (torch.arange(t, device=dev) < 900).to(torch.float32)
    bias = ((mask - 1.0) * 1e4).expand(bh, t).contiguous()
    err, rel = compare("flash_attention",
                       flash_attention.flash_attention(q, k, v, bias),
                       flash_attention.flash_attention_plain(q, k, v, bias),
                       K3_TOL)
    ms = time_ms(lambda: flash_attention.flash_attention(q, k, v, bias))
    pms = time_ms(lambda: flash_attention.flash_attention_plain(q, k, v, bias))
    # yardstick: the same additive key bias as a bf16 float mask
    mask_bf = bias.to(torch.bfloat16)[:, None, :]
    lms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask_bf, scale=1.0))
    b3 = bound(nbytes(q, k, v, bias) + q.numel() * 2, 4 * bh * t * t * dd)
    log(f"[3] K3 flash_attention BH=4 T=1001 D=128: max_abs_err {err:.3e} "
        f"rel {rel:.2e} (tol {K3_TOL:g}) kernel {ms:.4f} ms plain "
        f"{pms:.4f} ms sdpa {lms:.4f} ms bound {b3['bound_ms']:.4f} ms "
        f"({b3['bound_by']})")
    rows["flash_attention"] = dict(ms=ms, plain_ms=pms, max_abs_err=err,
                                   library_ms=lms, **b3)
    torch.cuda.synchronize()
    return rows


def phase_k4(dev, gen):
    """K4 at full width on layer views of stacked [28, n, k] weights: the
    next-layer-qkv form (layers 0..26) and the last-layer form, at m = 1
    (decode) and m = 9 (verify). Timed calls cycle the layers."""
    from fun_asr_gguf_tpu_torch.ops import quant_matmul as qm
    bf = torch.bfloat16

    def stacked(n, k):
        q = torch.randint(-128, 128, (LAYERS, n, k), generator=gen,
                          device=dev, dtype=torch.int8)
        d = (torch.rand(LAYERS, n, k // 32, generator=gen, device=dev)
             * 1.5e-4 + 2e-4).half().float()
        return qm.Q8Weight(q, d)

    o, gu, dn, qkv = (stacked(1024, 2048), stacked(6144, 1024),
                      stacked(1024, 3072), stacked(4096, 1024))
    norms = (1 + 0.1 * torch.randn(LAYERS, 2, 1024, generator=gen,
                                   device=dev)).to(bf)
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
            ms = time_ms(lambda: call(kern, xm, res, with_qkv))
            pms = time_ms(lambda: call(plain, xm, res, with_qkv))
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


def phase_k2(dev, gen):
    """K2 (bf16 cache) and K2-i8 (int8 cache, bf16 scales) over one layer
    of a stacked 28-layer cache (timed calls cycle the layers, so the
    cache is cold in L2 as in a decode step): the decode step (T = 1; S =
    256-token bucket + 512 new tokens, and 1024) and the verify step (T = 9
    rows for spec_k = 8; row i sees slots <= base + i). The yardstick is
    ``scaled_dot_product_attention`` on the bf16 cache (GQA, the bias as a
    float mask); no single PyTorch call takes an int8 cache with scales."""
    from fun_asr_gguf_tpu_torch.models.qwen3 import _kv_quantize
    from fun_asr_gguf_tpu_torch.ops import flash_decode as fd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, hd = 16, 8, 128
    rows, worst = {}, {"flash_decode": 0.0, "flash_decode_i8": 0.0}
    for t, s_len in ((1, 768), (1, 1024), (9, 777), (9, 1033)):
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


# (name, CUDA source, the TPU kernel it replaces)
KERNELS = [
    ("q8_matmul", "fun_asr_gguf_tpu_torch/csrc/q8_matmul.cu",
     "fun_asr_gguf_tpu/ops/quant_matmul.py:176"),
    ("flash_decode", "fun_asr_gguf_tpu_torch/csrc/flash_decode.cu",
     "fun_asr_gguf_tpu/ops/flash_decode.py:132"),
    ("flash_decode_i8", "fun_asr_gguf_tpu_torch/csrc/flash_decode.cu",
     "fun_asr_gguf_tpu/ops/flash_decode.py:132 (k_scale/v_scale :80-117)"),
    ("flash_attention", "fun_asr_gguf_tpu_torch/csrc/flash_attention.cu",
     "fun_asr_gguf_tpu/ops/flash_attention.py:90"),
    ("q8_layer_fused", "fun_asr_gguf_tpu_torch/csrc/q8_layer_fused.cu",
     "fun_asr_gguf_tpu/ops/quant_matmul.py:832, :649"),
]


def main():
    kind = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev)
    launches = phase_e2e(dev)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **rows[name])
        for name, src, rep in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


# bf16 activations through 70 + 28 layers vs f32 on CPU: measured min
# cosine 0.999854 on an H100 80GB HBM3 (700 W); the limit allows ~7x that gap
REF_COS = 0.999


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
    int8 KV cache, bf16 weights and the fused q8_0 weights) prefill
    logits, two teacher-forced decode steps and one verify step of 9
    tokens (spec_k = 8); the bf16 decoder gives prefill logits only."""
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
    decoders = [("int8", m.llm_params, False, 3),
                ("int8 kv8", engines["int8 kv8"].models.llm_params,
                 True, 3),
                ("bf16", qwen3.pack_qwen3_params(dense), False, 0),
                ("q8_0 fused", engines["q8_0"].models.llm_params, False, 3)]
    if not (isinstance(m.llm_params["layers"]["qkv_w"],
                       qwen3.Int8Weight) and "lm_head_i8" in m.llm_params):
        raise RuntimeError("the default engine does not hold int8 weights "
                           "and the int8 head")
    if "q8_fused" not in engines["q8_0"].models.llm_params:
        raise RuntimeError("the q8_0 engine's params are not fused")
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
    for label, p_card, kv8, n_steps in decoders:
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
                if n_steps:
                    for k, tok in enumerate((11, 22)):
                        emb = qwen3.embed_tokens(
                            p_llm, torch.tensor([tok], device=d))
                        got[f"{label} decode{k + 1}"] = \
                            qwen3.qwen3_decode_step(
                                p_llm, state.kv, emb, 48 + k,
                                state.prompt_len + k, state.valid_from,
                                cfg.llm)[0]
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

# The engines of phase 4: how each is built, its transcriptions
# (temperature, spec_min_accept; None keeps the engine's 1.35), and the
# launches one decode step and one verify round must make (28 layers)
ENGINES = [
    ("int8", {}, [(0.0, None)],
     {"q8_matmul": 0, "flash_decode": 28, "flash_decode_i8": 0,
      "flash_attention": 0, "q8_layer_fused": 0}),
    ("int8 kv8", {"kv_cache_dtype": "int8"}, [(0.0, None), (0.4, 0.0)],
     {"q8_matmul": 0, "flash_decode": 0, "flash_decode_i8": 28,
      "flash_attention": 0, "q8_layer_fused": 0}),
    ("q8_0", {"llm_weight_format": "q8_0"},
     [(0.0, None), (0.4, None), (0.4, 0.0)],
     {"q8_matmul": 2, "flash_decode": 28, "flash_decode_i8": 0,
      "flash_attention": 0, "q8_layer_fused": 28}),
]


def phase_e2e(dev):
    from fun_asr_gguf_tpu_torch import create_asr_engine
    from fun_asr_gguf_tpu_torch.ops import (flash_attention, flash_decode,
                                            quant_matmul)
    mods = {"q8_matmul": (quant_matmul, "launches"),
            "flash_decode": (flash_decode, "launches"),
            "flash_decode_i8": (flash_decode, "launches_i8"),
            "flash_attention": (flash_attention, "launches"),
            "q8_layer_fused": (quant_matmul, "fused_launches")}
    launches = dict.fromkeys(mods, 0)
    engines = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        ckpt, wav, cfg = write_inputs(root)
        try:
            for name, kwargs, _, _ in ENGINES:
                t0 = time.perf_counter()
                # the facade as a user calls it: the card is the default
                engines[name] = create_asr_engine(ckpt, verbose=False,
                                                  **kwargs)
                c = engines[name].models.config
                log(f"[4] engine {name} {kwargs}: init (load, quantize, "
                    f"warm-up) {time.perf_counter() - t0:.1f} s; weight "
                    f"format {engines[name].models.weight_format}, kv "
                    f"{c.kv_cache_dtype}, speculative={c.speculative} "
                    f"spec_k={c.spec_k} spec_min_accept={c.spec_min_accept}"
                    f" fuse_projections={c.fuse_projections}")
            reference_check(engines, ckpt)
            for name, _, runs, _ in ENGINES:
                path = transcribe_runs(engines[name], name, wav, runs, mods)
                for k, v in path.items():
                    launches[k] += v
            missing = [k for k, v in launches.items() if v <= 0]
            if missing:
                raise RuntimeError(f"main path never launched {missing}")
            for name, _, _, want in ENGINES:
                step_launches(engines[name], name, mods, want)
            decode_step_ms(engines)
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
    """Kernel launches of one decode step and of one verify round of an
    engine against what its path must launch."""
    m = engine.models
    p = np.zeros((200, m.hybrid_cfg.llm.hidden), np.float32)
    state = m.prefill(p, rng_seed=0)
    torch.cuda.synchronize()
    _reset(mods)
    m.generate(state, 0.0, 1.0, 50, chunk_len=64, limit=1)
    torch.cuda.synchronize()
    step = _counts(mods)
    sstate = m.spec_prepare(m.prefill(p, rng_seed=0))
    draft = torch.full((1, m.config.spec_draft_len), -1, dtype=torch.int64,
                       device=m.device)
    torch.cuda.synchronize()
    _reset(mods)
    m.spec_generate(sstate, draft, 0.0, 1.0, 50, chunk_len=64, limit=1)
    torch.cuda.synchronize()
    verify = _counts(mods)
    log(f"[4] {name}: launches per decode step {step}, per verify round "
        f"(9 rows) {verify}; expected {want}")
    if step != want or verify != want:
        raise RuntimeError(f"a decode step or verify round of {name} did "
                           "not run its path's kernels")


def decode_step_ms(engines, steps=64):
    """ms per decode step (64-step greedy chunk) of every engine and of the
    q8_0 weights unfused, in turns and back; ms per verify round (spec_k =
    8, empty draft) of every engine."""
    from fun_asr_gguf_tpu_torch.models.generate import generate_chunk
    q8 = engines["q8_0"].models
    turns = [(name, engines[name].models, engines[name].models.llm_params)
             for name in engines]
    turns.insert(1 + list(engines).index("q8_0"), (
        "q8_0 unfused", q8,
        {k: v for k, v in q8.llm_params.items() if k != "q8_fused"}))
    res = {}
    for name, m, params in turns + turns[::-1]:
        state = m.prefill(np.zeros((200, m.hybrid_cfg.llm.hidden),
                                   np.float32), rng_seed=0)
        with torch.inference_mode():
            generate_chunk(params, state, m.hybrid_cfg.llm, 0.0, 1.0, 50,
                           chunk_len=steps, stop_tokens=m.stop_tokens,
                           limit=4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate_chunk(params, state, m.hybrid_cfg.llm, 0.0, 1.0, 50,
                           chunk_len=steps, stop_tokens=m.stop_tokens)
            torch.cuda.synchronize()
        res.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3 / steps)
    verify = {}
    for name, eng in engines.items():
        m = eng.models
        sstate = m.spec_prepare(m.prefill(np.zeros(
            (200, m.hybrid_cfg.llm.hidden), np.float32), rng_seed=0))
        draft = torch.full((1, m.config.spec_draft_len), -1,
                           dtype=torch.int64, device=m.device)
        m.spec_generate(sstate, draft, 0.0, 1.0, 50, chunk_len=steps,
                        limit=4)
        torch.cuda.synchronize()
        r0, t0 = int(sstate.rounds[0]), time.perf_counter()
        m.spec_generate(sstate, draft, 0.0, 1.0, 50, chunk_len=steps,
                        limit=steps)
        torch.cuda.synchronize()
        verify[name] = (time.perf_counter() - t0) * 1e3 / max(
            int(sstate.rounds[0]) - r0, 1)
    log(f"[4] decode step (28 layers + head + sampling, eager), ms/step in "
        f"turns {' / '.join(n for n, _, _ in turns)} and back: "
        + "; ".join(f"{n} {' / '.join(f'{x:.3f}' for x in v)}"
                    for n, v in res.items())
        + "; verify round (9 rows, T=0, empty draft), ms/round: "
        + ", ".join(f"{n} {v:.3f}" for n, v in verify.items()))


if __name__ == "__main__":
    sys.exit(main())
