"""P12 on Hopper: one split-KV attention stage over a chunked head-major
cache, started from the current token (``experiments/q8_mega_probes.py``
``p12`` :161-238).

P12's shapes: S = 512 cache slots, slots < 300 visible, 16 query heads
over 8 kv heads (GQA 2), head_dim 128, the current token's k / v as the
initial state, chunk 256. Its f32 inputs (numpy, seed 5, x 0.3) are
rounded to bf16, the cache dtype the all-layers kernel reads; the plain
version (P12's XLA reference: one exact softmax over the visible slots and
the current token) takes the same rounded values. The kernel
(``csrc/probes.cu`` ``split_kv_probe``) is the chunk stage and combine of
``csrc/split_kv.cuh`` that K2 and K5 run, launched alone with a chosen
chunk; :func:`main` holds it against the plain version and times it at
chunk counts 1, 2, 4, ... 32.

    python -m fun_asr_gguf_tpu_torch.probes.q8_mega_probes
"""

import json

import numpy as np
import torch

from . import rel_err, time_ms

S, CS, D, QH, KH, SLOT = 512, 256, 128, 16, 8, 300
CHUNK_COUNTS = (1, 2, 4, 8, 16, 32)
# bf16 probabilities in the mix against the plain f32 softmax
TOL = 2e-2

launches = 0            # split_kv_probe launches since the last reset


def p12_inputs(device="cpu", seed=5):
    """P12's inputs (its rng, its order), rounded to bf16: q [QH, D], the
    cache k / v [KH, S, D], the current token's kc / vc [KH, D], and the
    f32 bias row [S] (0 below SLOT, -1e30 above)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(QH, D)).astype(np.float32) * 0.3
    k = rng.normal(size=(KH, S, D)).astype(np.float32) * 0.3
    v = rng.normal(size=(KH, S, D)).astype(np.float32) * 0.3
    kc = rng.normal(size=(KH, D)).astype(np.float32) * 0.3
    vc = rng.normal(size=(KH, D)).astype(np.float32) * 0.3
    bf = [torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)
          for a in (q, k, v, kc, vc)]
    bias = torch.where(torch.arange(S, device=device) < SLOT, 0.0,
                       -1e30).to(torch.float32)
    return (*bf, bias)


def p12_plain(q, k, v, kc, vc, bias):
    """P12's reference: per kv head the visible slots and the current token
    in one exact f32 softmax → [QH, D] f32."""
    f32 = torch.float32
    group = q.shape[0] // k.shape[0]
    vis = bias > -1e29
    out = []
    for h in range(q.shape[0]):
        hk = h // group
        kk = torch.cat([k[hk][vis], kc[hk][None]]).to(f32)
        vv = torch.cat([v[hk][vis], vc[hk][None]]).to(f32)
        p = torch.softmax(kk @ q[h].to(f32) * D ** -0.5, dim=0)
        out.append(p @ vv)
    return torch.stack(out)


def p12_stage(q, k, v, kc, vc, bias, chunk):
    """The split-KV stage with chunks of ``chunk`` slots, the current token
    first → [QH, D] f32: the kernel on CUDA, ``split_kv_plain`` on the
    CPU."""
    from ..ops.flash_decode import split_kv_plain
    scale = D ** -0.5
    if q.device.type == "cpu":
        qh, kh = q.shape[0], k.shape[0]
        group = qh // kh
        s_cur = (q.float().reshape(kh, group, D)
                 * kc.float()[:, None]).sum(-1) * scale
        return split_kv_plain(
            q.reshape(1, 1, qh, D), k.transpose(0, 1)[None],
            v.transpose(0, 1)[None], bias[None, None], chunk,
            cur=(s_cur.reshape(1, qh, 1), vc.float()[None]),
            scale=scale).reshape(qh, D)
    return _launch(q, k, v, kc, vc, bias, chunk, scale)


def _launch(q, k, v, kc, vc, bias, chunk, scale):
    global launches
    from ..kernels import build
    qh, kh, s_len = q.shape[0], k.shape[0], k.shape[1]
    tensors = (q, k, v, kc, vc)
    if not (all(t.dtype == torch.bfloat16 for t in tensors)
            and bias.dtype == torch.float32):
        raise TypeError("split_kv_probe takes bf16 q, k, v, kc, vc and an "
                        "f32 bias")
    if (q.shape != (qh, D) or k.shape != (kh, s_len, D) or v.shape != k.shape
            or kc.shape != (kh, D) or vc.shape != kc.shape
            or bias.shape != (s_len,) or qh % kh):
        raise ValueError("split_kv_probe shapes")
    if not all(t.is_cuda and t.is_contiguous() for t in (*tensors, bias)):
        raise ValueError("split_kv_probe takes contiguous CUDA tensors")
    if -(-s_len // chunk) > 64:
        raise ValueError("split_kv_probe takes at most 64 chunks")
    out = torch.empty((qh, D), dtype=torch.float32, device=q.device)
    work = torch.empty(kh * -(-s_len // chunk) * (qh // kh) * (D + 2),
                       dtype=torch.float32, device=q.device)
    code = build.lib().split_kv_probe(
        *(build.ptr(t) for t in (q, kc, vc, k, v, bias, out, work)),
        build.ptr(build.tickets(q.device, kh)), qh, kh, s_len, chunk,
        float(scale), build.stream_ptr(q.device))
    build.check(code, "split_kv_probe")
    launches += 1
    return out


def main(device="cuda"):
    """Hold the stage against P12's reference at every chunk count and
    time both; print one line per count and return the rows."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("P12 measures the card: it needs a CUDA device")
    args = p12_inputs(dev)
    ref = p12_plain(*args)
    plain_ms = time_ms(lambda: p12_plain(*args), iters=5, warmup=1)
    # bytes the stage must move: the visible slots' k, v rows, q, the
    # current token, the bias row, the output
    n_bytes = (2 * KH * SLOT * D * 2 + QH * D * 2 + 2 * KH * D * 2 + S * 4
               + QH * D * 4)
    rows = []
    for n in CHUNK_COUNTS:
        chunk = -(-S // n)
        got = p12_stage(*args, chunk)
        err = rel_err(got, ref)
        if not (torch.isfinite(got).all() and err < TOL):
            raise RuntimeError(f"P12 chunks={n}: rel err {err:.3e} >= {TOL}")
        ms = time_ms(lambda: p12_stage(*args, chunk))
        rows.append(dict(chunks=n, chunk=chunk, ms=ms, rel_err=err,
                         max_abs_err=(got - ref).abs().max().item()))
        print(f"[P12] split-KV stage S={S} chunks={n} (chunk {chunk}) "
              f"qh={QH} kh={KH} visible < {SLOT}: rel err {err:.2e} (tol "
              f"{TOL:g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"({n_bytes / 1e6:.3f} MB to move)", flush=True)
    return dict(rows=rows, plain_ms=plain_ms, n_bytes=n_bytes)


if __name__ == "__main__":
    print(json.dumps(main()))
