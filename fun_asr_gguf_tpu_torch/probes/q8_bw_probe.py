"""P5 on Hopper: how fast the q8_0 decode's weight bytes stream from HBM
(``experiments/q8_bw_probe.py`` :92-204).

28 layers of Qwen3-0.6B's q8_0 projections in the port's layout — int8
values [L, n, k] and f32 block scales [L, n, k / 32] for o 1024 x 2048,
gate_up 6144 x 1024, down 1024 x 3072 and qkv 4096 x 1024, 17.69 MB a
layer, 495.45 MB in all (ten times the 50 MB L2, so every call reads them
cold) — streamed three ways (``csrc/probes.cu``):

(a) ``q8_stream_sum``: every int8 value and scale once with 16-byte loads
    and a trivial sum, as ``sum_kern`` :104 does. Its rate is the
    achievable stream rate of the card for these bytes.
(b) ``q8_stream_gemv``: the m = 1 dequant GEMV of K4 / K5 (one warp per
    output row, q8_0 dequant rounded to bf16, f32 sums) over every layer,
    as ``dq_kern`` :144 does.
(c) the same GEMV reading f16 block scales (what the GGUF holds: 6.25 %
    fewer bytes), the Hopper form of P5c :186-204.

Each way is held against its plain version; the rate is bytes over the
median device time.

    python -m fun_asr_gguf_tpu_torch.probes.q8_bw_probe
"""

import json

import torch

from ..ops.quant_matmul import Q8Weight, layer, q8_matmul_plain
from . import rel_err, time_ms

LAYERS = 28
# (name, n, k): o, gate_up, down, packed qkv
SHAPES = (("o", 1024, 2048), ("gate_up", 6144, 1024), ("down", 1024, 3072),
          ("qkv", 4096, 1024))
GEMV_TOL = 1e-4     # the same bf16 products, f32 sums in another order
SUM_TOL = 1e-4      # the scales' f32 sum in another order

launches = 0        # P5 kernel launches since the last reset


def make_weights(device="cpu", layers=LAYERS, shapes=SHAPES, seed=0):
    """Random stacked q8_0 weights (int8 values, f16-representable f32
    scales) from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ws = []
    for _, n, k in shapes:
        q = torch.randint(-128, 128, (layers, n, k), generator=gen,
                          device=device, dtype=torch.int8)
        d = (torch.rand(layers, n, k // 32, generator=gen, device=device)
             * 1.5e-4 + 2e-4).half().float()
        ws.append(Q8Weight(q, d))
    return ws


def n_bytes(ws):
    return sum(w.q.numel() * w.q.element_size()
               + w.d.numel() * w.d.element_size() for w in ws)


def stream_sum_plain(ws):
    """(a) plain: (sum of every int8 value, int64; sum of every scale,
    f64)."""
    return (sum(int(w.q.sum(dtype=torch.int64)) for w in ws),
            sum(float(w.d.double().sum()) for w in ws))


def stream_sum(ws):
    """(a) on the card (the plain version on the CPU)."""
    if ws[0].q.device.type == "cpu":
        return stream_sum_plain(ws)
    return _launch_sum(ws)


def gemv_plain(ws, x):
    """(b) / (c) plain: y [L, sum n] f32, each layer's four products of
    ``x[:k]`` (bf16 [1, max k]) with bf16(q * d), f32 sums."""
    layers = ws[0].q.shape[0]
    return torch.stack([
        torch.cat([q8_matmul_plain(x[:, :w.q.shape[-1]], layer(w, l))[0]
                   for w in ws]) for l in range(layers)])


def gemv(ws, x):
    """(b), or (c) when the scales are f16, on the card (the plain version,
    scales in f32, on the CPU)."""
    if x.device.type == "cpu":
        return gemv_plain([Q8Weight(w.q, w.d.float()) for w in ws], x)
    return _launch_gemv(ws, x)


def _check(ws, scale_dtype):
    if len(ws) != 4 or not all(
            w.q.dtype == torch.int8 and w.d.dtype == scale_dtype
            and w.q.is_cuda and w.q.is_contiguous() and w.d.is_contiguous()
            and w.q.shape[0] == ws[0].q.shape[0]
            and w.d.shape == (*w.q.shape[:-1], w.q.shape[-1] // 32)
            and w.q.shape[-1] % 512 == 0 for w in ws):
        raise ValueError("the P5 kernels take four stacked int8 weights of "
                         f"one depth with {scale_dtype} block scales, k a "
                         "multiple of 512, contiguous on one CUDA device")


def _launch_sum(ws):
    global launches
    from ..kernels import build
    _check(ws, torch.float32)
    dev = ws[0].q.device
    blocks = 4 * build.sm_count(dev)
    isum = torch.empty(blocks, dtype=torch.int64, device=dev)
    fsum = torch.empty(blocks, dtype=torch.float32, device=dev)
    code = build.lib().q8_stream_sum(
        *(build.ptr(w.q) for w in ws), *(build.ptr(w.d) for w in ws),
        build.ptr(isum), build.ptr(fsum), *(w.q.numel() for w in ws), blocks,
        build.stream_ptr(dev))
    build.check(code, "q8_stream_sum")
    launches += 1
    return isum, fsum


def _launch_gemv(ws, x):
    global launches
    from ..kernels import build
    f16 = ws[0].d.dtype == torch.float16
    _check(ws, torch.float16 if f16 else torch.float32)
    if not (x.dtype == torch.bfloat16 and x.is_contiguous() and x.dim() == 2
            and x.shape[0] == 1
            and x.shape[1] >= max(w.q.shape[-1] for w in ws)):
        raise ValueError("q8_stream_gemv takes one contiguous bf16 row as "
                         "wide as the widest k")
    dev = x.device
    layers = ws[0].q.shape[0]
    y = torch.empty((layers, sum(w.q.shape[1] for w in ws)),
                    dtype=torch.float32, device=dev)
    dims = [d for w in ws for d in w.q.shape[1:]]
    code = build.lib().q8_stream_gemv(
        *(build.ptr(w.q) for w in ws), *(build.ptr(w.d) for w in ws),
        build.ptr(x), build.ptr(y), *dims, layers, int(f16),
        build.stream_ptr(dev))
    build.check(code, "q8_stream_gemv")
    launches += 1
    return y


def main(device="cuda", seed=0):
    """(a), (b), (c) on the card, each against its plain version; prints
    one line per way and returns the rates."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("P5 measures the card: it needs a CUDA device")
    ws = make_weights(dev, seed=seed)
    res = {}
    # (a)
    isum, fsum = stream_sum(ws)
    want_i, want_f = stream_sum_plain(ws)
    got_i, got_f = int(isum.sum()), float(fsum.double().sum())
    f_err = abs(got_f - want_f) / abs(want_f)
    if got_i != want_i or not f_err < SUM_TOL:
        raise RuntimeError(f"P5a: int sum {got_i} vs {want_i}, scale sum "
                           f"rel err {f_err:.3e}")
    b_a = n_bytes(ws)
    ms = time_ms(lambda: stream_sum(ws))
    pms = time_ms(lambda: stream_sum_plain(ws), iters=3, warmup=1)
    res["a"] = dict(ms=ms, plain_ms=pms, gbps=b_a / ms / 1e6, bytes=b_a,
                    max_abs_err=abs(got_f - want_f))
    print(f"[P5a] stream sum, {LAYERS} layers x {b_a / LAYERS / 1e6:.2f} "
          f"MB (int8 + f32 scales): int sum exact, scale sum rel err "
          f"{f_err:.2e} (tol {SUM_TOL:g}); kernel {ms:.4f} ms = "
          f"{b_a / ms / 1e6:.1f} GB/s; plain {pms:.4f} ms", flush=True)
    # (b), (c)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    kmax = max(k for _, _, k in SHAPES)
    x = torch.randn(1, kmax, generator=gen, device=dev).to(torch.bfloat16)
    ref = gemv_plain(ws, x)
    pms = time_ms(lambda: gemv_plain(ws, x), iters=3, warmup=1)
    for way, weights in (("b", ws), ("c", [Q8Weight(w.q, w.d.half())
                                           for w in ws])):
        got = gemv(weights, x)
        err = rel_err(got, ref)
        if not (torch.isfinite(got).all() and err < GEMV_TOL):
            raise RuntimeError(f"P5{way}: rel err {err:.3e} >= {GEMV_TOL}")
        nb = n_bytes(weights) + x.numel() * 2 + ref.numel() * 4
        ms = time_ms(lambda: gemv(weights, x))
        res[way] = dict(ms=ms, plain_ms=pms, gbps=nb / ms / 1e6, bytes=nb,
                        max_abs_err=(got - ref).abs().max().item())
        print(f"[P5{way}] dequant GEMV m=1, {LAYERS} layers, "
              f"{'f16' if way == 'c' else 'f32'} scales ({nb / 1e6:.2f} MB): "
              f"rel err {err:.2e} (tol {GEMV_TOL:g}); kernel {ms:.4f} ms = "
              f"{nb / ms / 1e6:.1f} GB/s; plain {pms:.4f} ms", flush=True)
    return res


if __name__ == "__main__":
    print(json.dumps(main()))
