"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # needs one CUDA card

Phases, one line each (any failure raises and exits non-zero):

1. device: torch's device name, and ``nvidia-smi``'s name and power limit;
2. kernel build from ``fun_asr_gguf_tpu_torch/csrc`` (seconds);
3. every kernel of the main path against its plain PyTorch version on the
   card, at the shapes the main path gives it: max-abs and relative error
   against the stated tolerance, and both median device times (CUDA
   events around one call, with the queue kept busy while the host
   enqueues it, so the time excludes the host's launch cost): K1 at
   decode (m = 1), verify (m = 9) and prefill rows, K2 at T = 1 and at the
   verify step's T = 9, K3, and K4 (the fused layer chain,
   with and without the next-layer qkv stage) at m = 1 and m = 9 on layer
   views of stacked [28, n, k] weights;
4. end-to-end transcription through ``create_asr_engine(...).transcribe()``
   of a 60 s synthetic clip on a full-width random checkpoint (70-layer
   SANM encoder + Qwen3-0.6B q8_0) with the engine's defaults (fused
   decode, CTC-draft speculation with its guardrail): greedy, at the
   default temperature, and with the guardrail off (``spec_min_accept=0``)
   so verify rounds run across the whole clip; stage timings, verify
   rounds and each kernel's launch count from those runs; the launches of
   one decode step and of one verify round; and ms per decode step, fused
   against unfused, and per verify round.

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
K3_TOL = 2e-2     # bf16 P.V operands vs the plain f32 softmax, bf16 output
K4_TOL = 5e-3     # same bf16 products; f32 sums in another order flip
                  # isolated bf16 ulps of the normed rows and gated product
LAYERS = 28       # Qwen3-0.6B: K4 rows cycle the layers, so L2 is cold


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
        log(f"[3] K1 q8_matmul {name:14s} [{m}x{k}]x[{n}x{k}]^T: max_abs_err "
            f"{err:.3e} rel {rel:.2e} (tol {K1_TOL:g}) kernel {ms:.4f} ms "
            f"plain {pms:.4f} ms")
        if name == "lm_head m=1":
            rows["q8_matmul"] = dict(ms=ms, plain_ms=pms)
        del x, q, d, w
    rows["q8_matmul"]["max_abs_err"] = worst

    # K2 over one layer of a stacked 28-layer cache (timed calls cycle the
    # layers, so the cache is cold in L2 as in a decode step): the decode
    # step (T = 1; S = 256-token bucket + 512 new tokens) and the verify
    # step (T = 9 rows for spec_k = 8; row i sees slots <= base + i)
    worst = 0.0
    for t, s_len in ((1, 768), (1, 1024), (9, 777), (9, 1033)):
        qh, kh, hd = 16, 8, 128
        q = randn(1, t, qh, hd) * (hd ** -0.5)
        k = randn(LAYERS, 1, s_len, kh, hd)
        v = randn(LAYERS, 1, s_len, kh, hd)
        j = torch.arange(s_len, device=dev)
        i = torch.arange(t, device=dev)[:, None]
        bias = torch.where((j >= 40) & (j <= s_len - 100 - t + i), 0.0,
                           -1e30).to(torch.float32)[None].contiguous()
        ln = [0]

        def call(fn, q=q, k=k, v=v, bias=bias, ln=ln):
            ln[0] = (ln[0] + 1) % LAYERS
            return fn(q, k[ln[0]], v[ln[0]], bias)

        err, rel = compare(f"flash_decode T={t} S={s_len}",
                           flash_decode.flash_decode_attention(q, k[0], v[0],
                                                               bias),
                           flash_decode.flash_decode_plain(q, k[0], v[0],
                                                           bias),
                           K2_TOL)
        worst = max(worst, err)
        ms = time_ms(lambda: call(flash_decode.flash_decode_attention))
        pms = time_ms(lambda: call(flash_decode.flash_decode_plain))
        log(f"[3] K2 flash_decode B=1 T={t} qh=16 kh=8 hd=128 S={s_len}: "
            f"max_abs_err {err:.3e} rel {rel:.2e} (tol {K2_TOL:g}) kernel "
            f"{ms:.4f} ms plain {pms:.4f} ms")
        if (t, s_len) == (1, 768):
            rows["flash_decode"] = dict(ms=ms, plain_ms=pms)
        del k, v
    rows["flash_decode"]["max_abs_err"] = worst

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
    log(f"[3] K3 flash_attention BH=4 T=1001 D=128: max_abs_err {err:.3e} "
        f"rel {rel:.2e} (tol {K3_TOL:g}) kernel {ms:.4f} ms plain "
        f"{pms:.4f} ms")
    rows["flash_attention"] = dict(ms=ms, plain_ms=pms, max_abs_err=err)
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
            log(f"[3] {name} m={m} (o 1024x2048, gate_up 6144x1024, down "
                f"1024x3072{', qkv 4096x1024' if with_qkv else ''}): "
                f"max_abs_err {err:.3e} rel {rel:.2e} (tol {K4_TOL:g}) "
                f"kernel {ms:.4f} ms plain {pms:.4f} ms")
            if with_qkv and m == 1:
                row = dict(ms=ms, plain_ms=pms)
    row["max_abs_err"] = worst
    return row


# (name, CUDA source, the TPU kernel it replaces)
KERNELS = [
    ("q8_matmul", "fun_asr_gguf_tpu_torch/csrc/q8_matmul.cu",
     "fun_asr_gguf_tpu/ops/quant_matmul.py:176"),
    ("flash_decode", "fun_asr_gguf_tpu_torch/csrc/flash_decode.cu",
     "fun_asr_gguf_tpu/ops/flash_decode.py:132"),
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
    from fun_asr_gguf_tpu.audio import write_wav
    from fun_asr_gguf_tpu.models.config import HybridConfig
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


def reference_check(engine, ckpt):
    """The card's kernel path (bf16) against the CPU plain path (f32) on
    small inputs of the same full-width weights: encoder, CTC logits,
    prefill logits, two teacher-forced fused decode steps and one fused
    verify step of 9 tokens (spec_k = 8)."""
    from fun_asr_gguf_tpu_torch.models import (adaptor, audio_encoder,
                                               generate, loaders, qwen3)
    from fun_asr_gguf_tpu_torch.frontend import frontend_constants
    m = engine.models
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cfg, enc, ada, ctc, llm, _ = loaders.load_checkpoint(ckpt, cpu,
                                                         torch.float32)
    llm = qwen3.fuse_qwen3_params_q8(qwen3.pack_qwen3_params(
        qwen3.quantize_lm_head(llm, cfg.llm)))
    if "q8_fused" not in m.llm_params:
        raise RuntimeError("the engine's default params are not fused")
    rng = np.random.default_rng(1)
    audio = (0.05 * rng.normal(size=(1, 3 * 16000))).astype(np.float32)
    n = torch.tensor([audio.shape[1]])
    prompt_ids = torch.from_numpy(rng.integers(0, 256, size=(1, 48)))
    verify_ids = torch.from_numpy(rng.integers(0, 256, size=(1, 9)))
    outs = {}
    for name, dev, dtype, p_enc, p_ada, p_ctc, p_llm in (
            ("ref", cpu, torch.float32, enc, ada, ctc, llm),
            ("card", m.device, m._compute_dtype, m.encoder_params,
             m.adaptor_params, m.ctc_params, m.llm_params)):
        with torch.inference_mode():
            e, embd, _ = audio_encoder.audio_encoder_forward(
                {"encoder": p_enc, "adaptor": p_ada},
                frontend_constants(m.audio_cfg.frontend, dev),
                torch.from_numpy(audio).to(dev), n.to(dev), m.audio_cfg,
                compute_dtype=dtype)
            logits = adaptor.ctc_logits_forward(p_ctc, e.to(dtype), cfg.ctc)
            emb = qwen3.embed_tokens(p_llm, prompt_ids.to(dev))
            mask = torch.ones(1, 48, device=dev)
            mask[:, :8] = 0
            state = generate.prefill_init(
                p_llm, emb, mask, torch.Generator(device=dev).manual_seed(0),
                cfg.llm, max_len=64)
            steps = [state.logits]
            for k, tok in enumerate((11, 22)):
                lg, _ = qwen3.qwen3_decode_step(
                    p_llm, state.kv, qwen3.embed_tokens(
                        p_llm, torch.tensor([tok], device=dev)), 48 + k,
                    state.prompt_len + k, state.valid_from, cfg.llm)
                steps.append(lg)
            vlg, _ = qwen3.qwen3_verify_step(
                p_llm, state.kv, qwen3.embed_tokens(p_llm,
                                                    verify_ids.to(dev)),
                torch.tensor([50], device=dev),
                state.prompt_len[:, None] + 2 + torch.arange(9, device=dev),
                state.valid_from, cfg.llm)
        outs[name] = dict(encoder=e, embd=embd, ctc_logits=logits,
                          **{f"decode{k}": s for k, s in enumerate(steps)},
                          verify=vlg)
    worst = 1.0
    parts = []
    for key in outs["ref"]:
        c = _cos(outs["ref"][key], outs["card"][key])
        worst = min(worst, c)
        parts.append(f"{key} {c:.6f}")
    log(f"[4] reference (card bf16 kernels vs CPU f32 plain, small inputs; "
        f"decode and verify fused): cosine {', '.join(parts)} (min "
        f"{worst:.6f}, tol > {REF_COS}) in {time.perf_counter() - t0:.1f} s")
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


def phase_e2e(dev):
    from fun_asr_gguf_tpu_torch import create_asr_engine
    from fun_asr_gguf_tpu_torch.ops import (flash_attention, flash_decode,
                                            quant_matmul)
    mods = {"q8_matmul": (quant_matmul, "launches"),
            "flash_decode": (flash_decode, "launches"),
            "flash_attention": (flash_attention, "launches"),
            "q8_layer_fused": (quant_matmul, "fused_launches")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        ckpt, wav, cfg = write_inputs(root)
        t0 = time.perf_counter()
        engine = create_asr_engine(ckpt, verbose=False, device="cuda")
        c = engine.models.config
        log(f"[4] engine init (load, q8_0 head, fuse, warm-up): "
            f"{time.perf_counter() - t0:.1f} s; stop ids "
            f"{engine.models.stop_tokens}; speculative={c.speculative} "
            f"spec_k={c.spec_k} spec_min_accept={c.spec_min_accept} "
            f"fuse_projections={c.fuse_projections}")
        try:
            reference_check(engine, ckpt)
            runs = [(0.0, c.spec_min_accept), (0.4, c.spec_min_accept),
                    (0.4, 0.0)]
            spec = count_verify_rounds(engine.models)
            _reset(mods)
            results = []
            for temp, min_acc in runs:
                n_tok = [0]

                def count(_piece, n_tok=n_tok):
                    n_tok[0] += 1

                def reset(n_tok=n_tok):
                    n_tok[0] = 0
                c.spec_min_accept = min_acc
                spec.update(rounds=0, tokens=0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = engine.transcribe(wav, verbose=False, temperature=temp,
                                        on_stream=count,
                                        on_stream_reset=reset)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                results.append((temp, min_acc, res, n_tok[0], wall,
                                dict(spec)))
            launches = _counts(mods)
            del engine.models.spec_generate   # back to the unwrapped method
            c.spec_min_accept = runs[0][1]
            for temp, min_acc, res, n_tok, wall, spec in results:
                t = res.timings
                check_result(res)
                per_round = spec["tokens"] / max(spec["rounds"], 1)
                log(f"[4] transcribe T={temp} spec_min_accept={min_acc}: "
                    f"encode {t.encode*1e3:.1f} ms, ctc {t.ctc*1e3:.1f} ms, "
                    f"inject (prefill) {t.inject*1e3:.1f} ms, generate "
                    f"{n_tok} pieces in {t.llm_generate*1e3:.1f} ms "
                    f"({n_tok / max(t.llm_generate, 1e-9):.1f} pieces/s), "
                    f"verify rounds {spec['rounds']} emitting "
                    f"{spec['tokens']} tokens ({per_round:.3f} per round), "
                    f"align {t.align*1e3:.2f} ms, total {t.total:.3f} s "
                    f"(wall {wall:.3f} s); ctc chars {len(res.ctc_text)}, "
                    f"text chars {len(res.text)}, segments "
                    f"{len(res.segments)}")
            if results[-1][-1]["rounds"] < 64:
                raise RuntimeError("the spec_min_accept=0 run ran only "
                                   f"{results[-1][-1]['rounds']} verify "
                                   "rounds")
            log(f"[4] kernel launches in the three transcriptions: "
                f"{launches}")
            missing = [k for k, v in launches.items() if v <= 0]
            if missing:
                raise RuntimeError(f"main path never launched {missing}")
            step_launches(engine, mods, cfg.llm.n_layers)
            decode_step_ms(engine)
        finally:
            engine.cleanup()
    return launches


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


def step_launches(engine, mods, n_layers):
    """Kernel launches of one fused decode step and of one verify round:
    K4 and K2 once per layer, K1 for layer 0's qkv and the head."""
    m = engine.models
    p = np.zeros((200, m.hybrid_cfg.llm.hidden), np.float32)
    want = {"q8_matmul": 2, "flash_decode": n_layers, "flash_attention": 0,
            "q8_layer_fused": n_layers}
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
    log(f"[4] launches per decode step {step}, per verify round (9 rows) "
        f"{verify}; expected {want}")
    if step != want or verify != want:
        raise RuntimeError("a decode step or verify round did not run the "
                           "fused path")


def decode_step_ms(engine, steps=64):
    """ms per decode step (64-step greedy chunk), fused and unfused on the
    same weights, and ms per verify round (spec_k = 8, empty draft)."""
    from fun_asr_gguf_tpu_torch.models.generate import generate_chunk
    m = engine.models
    fused = m.llm_params
    unfused = {k: v for k, v in fused.items() if k != "q8_fused"}
    p = np.zeros((200, m.hybrid_cfg.llm.hidden), np.float32)
    res = {}
    for name, params in (("fused", fused), ("unfused", unfused),
                         ("fused", fused), ("unfused", unfused)):
        state = m.prefill(p, rng_seed=0)
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
    sstate = m.spec_prepare(m.prefill(p, rng_seed=0))
    draft = torch.full((1, m.config.spec_draft_len), -1, dtype=torch.int64,
                       device=m.device)
    m.spec_generate(sstate, draft, 0.0, 1.0, 50, chunk_len=steps, limit=4)
    torch.cuda.synchronize()
    r0, t0 = int(sstate.rounds[0]), time.perf_counter()
    m.spec_generate(sstate, draft, 0.0, 1.0, 50, chunk_len=steps,
                    limit=steps)
    torch.cuda.synchronize()
    rounds = int(sstate.rounds[0]) - r0
    verify_ms = (time.perf_counter() - t0) * 1e3 / max(rounds, 1)
    log(f"[4] decode step (28 layers + q8_0 head + sampling, eager), in "
        f"turns fused / unfused / fused / unfused: "
        f"{' / '.join(f'{x:.3f}' for x in (res['fused'][0], res['unfused'][0], res['fused'][1], res['unfused'][1]))} "
        f"ms/step; verify round (9 rows, T=0, empty draft): "
        f"{verify_ms:.3f} ms/round over {rounds} rounds")


if __name__ == "__main__":
    sys.exit(main())
