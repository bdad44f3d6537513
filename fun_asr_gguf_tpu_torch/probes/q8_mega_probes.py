"""P6–P12 on Hopper: the feasibility probes of JAX's all-layers kernel
(``experiments/q8_mega_probes.py``), each the function its Pallas kernel
computes, as a kernel of ``csrc/probes.cu`` beside a plain version.

* P6 (``p6`` :36-53): q8_0 block scales expanded in the NATURAL order —
  lane i of a row takes ``d[i // 32]`` — as ``bf16(q) * bf16(d)`` rounded
  to bf16, out in f32, q int8 [256, 1024], d f32 [256, 32]. That is P6's
  own reference (``np.repeat``) and the order of every q8_0 tensor of the
  port. JAX's kernel, run on the CPU in interpret mode, computes the TILED
  order instead (``pltpu.repeat`` there tiles, lane i takes ``d[i mod
  32]``, and P6's own assertion fails), which is one reason the JAX package
  works in its perm space. The port is held to P6's reference, the
  function the probe asks for; ``tests/test_torch_probes.py`` pins JAX's
  interpret output to the tiled order so that a change shows.
* P7 (``p7`` :56-65): a transpose, f32 [64, 32] → [32, 64].
* P8 (``p8`` :68-108): NeoX rope at position 37 (θ = 1e6, half 64) of
  f32 q [16, 128]: (a) the half swap with its sign by lane shuffle, how K5's
  prologue ropes; (b) the same through a [128, 128] rotation matrix, the
  product in f32 FMAs.
* P9 (``p9`` :111-125): the batched product hqd,hsd→hqs, f32 [8, 2, 128] ×
  [8, 256, 128] → [8, 2, 256], in f32 FMAs (a bare tf32 ``mma.sync`` would
  miss JAX's atol 1e-3 on these 128-term sums of N(0, 1)).
* P10 (``p10`` :128-141): row-pair slices, ``out[2h:2h+2] = x[2h:2h+2] *
  (h + 1)``, f32 [16, 128].
* P11 (``p11`` :144-158): a head sum over a head-major block, Σₕ kv[h] ·
  (h + 1), f32 [8, 256, 128] → [256, 128]; also over a slot-major copy
  [256, 8, 128] (equal bytes, a strided read per head): the two layouts
  K5's split-KV stage and K2 read a cache in.
* P12 (``p12`` :161-238): one split-KV attention stage over a chunked
  head-major cache, started from the current token. P12's shapes: S = 512
  cache slots, slots < 300 visible, 16 query heads over 8 kv heads (GQA 2),
  head_dim 128, the current token's k / v as the initial state, chunk 256.
  Its f32 inputs (numpy, seed 5, x 0.3) are rounded to bf16, the cache
  dtype the all-layers kernel reads; the plain version (P12's XLA
  reference: one exact softmax over the visible slots and the current
  token) takes the same rounded values. The kernel (``split_kv_probe``)
  is the chunk stage and combine of ``csrc/split_kv.cuh`` that K2 and K5
  run, launched alone with a chosen chunk, timed at chunk counts 1 … 32.

Inputs come from each probe's numpy seed and order. :func:`main` holds
every kernel against its plain version on the card and times both.

    python -m fun_asr_gguf_tpu_torch.probes.q8_mega_probes
"""

import json

import numpy as np
import torch

from ..models.common import apply_rope
from . import check_cuda, launch, nbytes, rel_err, time_ms

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


# ------------------------------------------------------------- P6 - P11

BLOCK = 32
ROPE_POS, ROPE_THETA, ROPE_HALF = 37, 1e6, 64
# the kernels round as the plain versions do (no FMA contraction): equal
EXACT_TOL = 0.0
# P8b, P9: f32 sums in another order; JAX's own tolerance (p9 :124)
SUM_TOL = 1e-3
# P6's own reference: relative error against q * repeat(d) in f32, two
# bf16 roundings of at most 2^-9 each (p6 :51-52)
P6_REF_TOL = 1e-2


def p6_inputs(device="cpu", seed=0):
    """P6's q int8 [256, 1024] and d f32 [256, 32] (its rng, its order)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (256, 1024), np.int8)
    d = rng.random((256, 32), np.float32)
    return (torch.from_numpy(q).to(device), torch.from_numpy(d).to(device))


def expand_scales_plain(q, d, tiled):
    """bf16(q) * bf16(d expanded) rounded to bf16 → f32 [rows, cols]: lane
    i takes ``d[i mod (cols / 32)]`` when ``tiled`` (P4's
    ``concatenate([d] * 32)``) and ``d[i // 32]`` otherwise (P6, the
    natural q8_0 order). int8 → bf16 is exact and the product of two bf16
    values is exact in f32, so it is rounded once."""
    cols = q.shape[-1]
    lane = torch.arange(cols, device=q.device)
    idx = lane % d.shape[-1] if tiled else lane // BLOCK
    s = d.float().to(torch.bfloat16).float()[:, idx]
    return (q.float() * s).to(torch.bfloat16).float()


def expand_scales(q, d, tiled):
    """:func:`expand_scales_plain` (the kernel on CUDA: P4's tiled order
    with f16 scales, P6's natural order with f32 ones)."""
    if q.device.type == "cpu":
        return expand_scales_plain(q, d, tiled)
    rows, cols = q.shape
    dt = torch.float16 if d.dtype == torch.float16 else torch.float32
    y = torch.empty((rows, cols), dtype=torch.float32, device=q.device)
    check_cuda((q, d, y), (torch.int8, dt, torch.float32),
               ((rows, cols), (rows, cols // BLOCK), None), "scale_expand")
    if cols % BLOCK:
        raise ValueError("scale_expand takes rows of whole q8_0 blocks")
    launch("p4_scale_expand_f16_tiled" if tiled
           else "p6_scale_expand_natural", "probe_scale_expand", q, d, y,
           rows, cols, int(dt == torch.float16), int(tiled))
    return y


def p7_inputs(device="cpu"):
    return (torch.arange(2048, dtype=torch.float32,
                         device=device).reshape(64, 32),)


def transpose_plain(x):
    """x [r, c] → [c, r] by an index gather."""
    r, c = x.shape
    return x[torch.arange(r, device=x.device)[None, :],
             torch.arange(c, device=x.device)[:, None]]


def transpose(x):
    if x.device.type == "cpu":
        return transpose_plain(x)
    r, c = x.shape
    y = torch.empty((c, r), dtype=torch.float32, device=x.device)
    check_cuda((x, y), (torch.float32,) * 2, (None, None), "transpose")
    launch("p7_transpose", "probe_transpose", x, y, r, c)
    return y


def p8_inputs(device="cpu", seed=1):
    """P8's q f32 [16, 128], R [128, 128] (x . R is the half swap with its
    sign) and cos, sin f32 [128] at position 37, θ = 1e6."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(16, 128)).astype(np.float32)
    inv = 1.0 / (ROPE_THETA ** (np.arange(ROPE_HALF) / ROPE_HALF))
    ang = ROPE_POS * inv
    cos = np.concatenate([np.cos(ang), np.cos(ang)]).astype(np.float32)
    sin = np.concatenate([np.sin(ang), np.sin(ang)]).astype(np.float32)
    r = np.zeros((128, 128), np.float32)
    for i in range(ROPE_HALF):
        r[i, i + ROPE_HALF] = 1.0
        r[i + ROPE_HALF, i] = -1.0
    return tuple(torch.from_numpy(a).to(device) for a in (q, r, cos, sin))


def rope_shuffle_plain(q, cos, sin):
    """P8a: ``q * cos + [-q[:, 64:], q[:, :64]] * sin`` (the port's
    ``apply_rope``)."""
    return apply_rope(q, cos, sin)


def rope_shuffle(q, cos, sin):
    if q.device.type == "cpu":
        return rope_shuffle_plain(q, cos, sin)
    y = torch.empty_like(q)
    check_cuda((q, cos, sin, y), (torch.float32,) * 4,
               ((q.shape[0], 128), (128,), (128,), None), "rope_shuffle")
    launch("p8a_rope_shuffle", "probe_rope_shuffle", q, cos, sin, y,
           q.shape[0])
    return y


def rope_matrix_plain(q, r, cos, sin):
    """P8b: ``q * cos + (q . R) * sin``, the product in f32."""
    return q * cos + torch.matmul(q, r) * sin


def rope_matrix(q, r, cos, sin):
    if q.device.type == "cpu":
        return rope_matrix_plain(q, r, cos, sin)
    y = torch.empty_like(q)
    check_cuda((q, r, cos, sin, y), (torch.float32,) * 5,
               ((q.shape[0], 128), (128, 128), (128,), (128,), None),
               "rope_matrix")
    launch("p8b_rope_matrix", "probe_rope_matrix", q, r, cos, sin, y,
           q.shape[0])
    return y


def p9_inputs(device="cpu", seed=2):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(8, 2, 128)).astype(np.float32)
    b = rng.normal(size=(8, 256, 128)).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def batched_dot_plain(a, b):
    """P9: hqd,hsd→hqs as a broadcast product summed over d, in f32."""
    return (a[:, :, None, :] * b[:, None, :, :]).sum(-1)


def batched_dot(a, b):
    if a.device.type == "cpu":
        return batched_dot_plain(a, b)
    n, m, _ = a.shape
    s = b.shape[1]
    y = torch.empty((n, m, s), dtype=torch.float32, device=a.device)
    check_cuda((a, b, y), (torch.float32,) * 3,
               ((n, m, 128), (n, s, 128), None), "batched_dot")
    if m > 8:
        raise ValueError("batched_dot takes at most 8 rows per batch")
    launch("p9_batched_dot", "probe_batched_dot", a, b, y, n, m, s)
    return y


def p10_inputs(device="cpu", seed=3):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(16, 128)).astype(np.float32)
                             ).to(device),)


def pair_scale_plain(x):
    """P10: rows 2h and 2h + 1 times h + 1."""
    w = torch.arange(x.shape[0], device=x.device) // 2 + 1
    return x * w.to(torch.float32)[:, None]


def pair_scale(x):
    if x.device.type == "cpu":
        return pair_scale_plain(x)
    y = torch.empty_like(x)
    check_cuda((x, y), (torch.float32,) * 2, ((x.shape[0], 128), None),
               "pair_scale")
    launch("p10_pair_scale", "probe_pair_scale", x, y, x.shape[0])
    return y


def p11_inputs(device="cpu", seed=4):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(8, 256, 128)).astype(
        np.float32)).to(device),)


def head_sum_plain(kv, slot_major=False):
    """P11: Σₕ kv[h] · (h + 1), heads in order, over a head-major [H, S,
    D] block or a slot-major [S, H, D] one."""
    heads = kv.shape[1 if slot_major else 0]
    acc = torch.zeros_like(kv[:, 0] if slot_major else kv[0])
    for h in range(heads):
        acc = acc + (kv[:, h] if slot_major else kv[h]) * (h + 1.0)
    return acc


def head_sum(kv, slot_major=False):
    if kv.device.type == "cpu":
        return head_sum_plain(kv, slot_major)
    s, heads = (kv.shape[0], kv.shape[1]) if slot_major else (kv.shape[1],
                                                             kv.shape[0])
    y = torch.empty((s, 128), dtype=torch.float32, device=kv.device)
    check_cuda((kv, y), (torch.float32,) * 2, ((kv.shape[0], kv.shape[1],
                                                128), None), "head_sum")
    launch("p11_head_sum", "probe_head_sum", kv, y, heads, s,
           int(slot_major))
    return y


def small_probes(dev):
    """P6–P11 on the card: each kernel against its plain version (and P6,
    P8 against their probes' own references), both timed, and the one
    PyTorch call that computes the same function where there is one. Returns
    per probe its times, max abs error, bytes and operations."""
    out = {}

    def run(name, kernel, plain, args, tol, n_ops, library=None, note=""):
        got, ref = kernel(*args), plain(*args)
        err = (got - ref).abs().max().item()
        if not (torch.isfinite(got).all() and err <= tol):
            raise RuntimeError(f"{name}: max abs err {err:.3e} > {tol:g}")
        ms = time_ms(lambda: kernel(*args))
        pms = time_ms(lambda: plain(*args))
        lms = time_ms(lambda: library(*args)) if library else None
        n_bytes = nbytes(*args, got)
        out[name] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                         max_abs_err=err, n_bytes=n_bytes, n_ops=n_ops)
        print(f"[{name.split('_')[0].upper()}] {tuple(args[0].shape)}: "
              f"max abs err {err:.3e} (tol {tol:g}) kernel {ms:.4f} ms "
              f"plain {pms:.4f} ms" + (f" library {lms:.4f} ms" if lms else "")
              + f" ({n_bytes / 1e3:.1f} KB){note}", flush=True)
        return got

    q, d = p6_inputs(dev)
    got = run("p6_scale_expand_natural",
              lambda q, d: expand_scales(q, d, False),
              lambda q, d: expand_scales_plain(q, d, False), (q, d),
              EXACT_TOL, q.numel())
    want = q.float() * d.repeat_interleave(BLOCK, dim=1)
    ref_err = ((got - want).abs() / (want.abs() + 1e-6)).max().item()
    if not ref_err < P6_REF_TOL:
        raise RuntimeError(f"P6 against its reference: rel err {ref_err:.3e}")
    print(f"[P6] natural order against P6's reference q * repeat(d, 32): "
          f"rel err {ref_err:.2e} (tol {P6_REF_TOL:g})", flush=True)
    run("p7_transpose", transpose, transpose_plain, p7_inputs(dev),
        EXACT_TOL, 0, library=lambda x: x.t().contiguous())
    q, r, cos, sin = p8_inputs(dev)
    want = (q.double() * cos.double()
            + torch.cat([-q[:, 64:], q[:, :64]], 1).double() * sin.double())
    got = run("p8a_rope_shuffle", rope_shuffle, rope_shuffle_plain,
              (q, cos, sin), EXACT_TOL, 3 * q.numel())
    note_a = (got.double() - want).abs().max().item()
    got = run("p8b_rope_matrix", rope_matrix, rope_matrix_plain,
              (q, r, cos, sin), SUM_TOL,
              2 * q.shape[0] * 128 * 128 + 3 * q.numel())
    print(f"[P8] against the f64 rope: lane shuffle {note_a:.2e}, rotation "
          f"product {(got.double() - want).abs().max().item():.2e}",
          flush=True)
    a, b = p9_inputs(dev)
    run("p9_batched_dot", batched_dot, batched_dot_plain, (a, b), SUM_TOL,
        2 * a.shape[0] * a.shape[1] * b.shape[1] * 128,
        library=lambda a, b: torch.bmm(a, b.transpose(1, 2)))
    (x,) = p10_inputs(dev)
    run("p10_pair_scale", pair_scale, pair_scale_plain, (x,), EXACT_TOL,
        x.numel())
    (kv,) = p11_inputs(dev)
    run("p11_head_sum", head_sum, head_sum_plain, (kv,), EXACT_TOL,
        2 * kv.numel())
    kv_s = kv.transpose(0, 1).contiguous()           # [256, 8, 128]
    got = head_sum(kv_s, slot_major=True)
    err = (got - head_sum_plain(kv_s, True)).abs().max().item()
    if err > EXACT_TOL:
        raise RuntimeError(f"p11 slot-major: max abs err {err:.3e}")
    ms = time_ms(lambda: head_sum(kv_s, slot_major=True))
    out["p11_head_sum"]["slot_major_ms"] = ms
    print(f"[P11] slot-major [256, 8, 128] (a strided read per head, equal "
          f"bytes): max abs err {err:.3e} kernel {ms:.4f} ms against "
          f"head-major {out['p11_head_sum']['ms']:.4f} ms", flush=True)
    return out


def main(device="cuda"):
    """Hold P12's stage against its reference at every chunk count, and
    P6–P11 against their plain versions, and time them; print one line
    per measurement and return P12's rows and the other probes' numbers
    (``probes``)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("P6-P12 measure the card: they need a CUDA device")
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
    return dict(rows=rows, plain_ms=plain_ms, n_bytes=n_bytes,
                probes=small_probes(dev))


if __name__ == "__main__":
    print(json.dumps(main()))
