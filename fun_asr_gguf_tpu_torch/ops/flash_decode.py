"""K2: decode attention over one layer of a bf16 or an int8 KV cache.

Counterpart of ``fun_asr_gguf_tpu/ops/flash_decode.py``
(``flash_decode_attention`` :132, both branches) with the numerics of
``fun_asr_gguf_tpu/models/qwen3.py:_attend_cache`` :315: f32 scores, an
exact softmax over the whole cache row, probabilities normalised in f32
(``max(l, 1e-30)`` clamp) then cast to the activation dtype for the mix,
f32 accumulation, output in the activation dtype. The CUDA kernels are in
``csrc/flash_decode.cu`` (one block per (kv head, batch row); its note says
what bounds them). They serve the decode step (T = 1) and the speculative
verify step (T = spec_k + 1 query rows).

The int8 cache (``QuantKV``, ``qwen3.py:196``) keeps one scale per (slot,
kv head) in JAX's layout ``[B, S, kh, 1]``, in the activation dtype. The
scales commute out of the head_dim contraction (``_attend_cache``'s QuantKV
branch :334-353): scores are taken on the raw int8 K, multiplied by K's
scale of the slot; V's scale multiplies the normalised probabilities
before their cast, and the mix runs on the raw int8 V. That variant is
K2-i8, with its own C entry and its own launch count (``launches_i8``).

GQA: query head ``h`` reads kv head ``h // group``.

Dispatch is by device only: CPU tensors take :func:`flash_decode_plain`,
CUDA tensors launch the kernel or raise.
"""

import torch

MAX_ROWS = 18          # T * group query rows per kernel block (verify at
                       # spec_k = 8: 9 rows x GQA group 2)
HEAD_DIM = 128
SMEM_LIMIT = 227 * 1024

launches = 0           # K2 (bf16 cache) launches since the last reset
launches_i8 = 0        # K2-i8 (int8 cache) launches since the last reset


def flash_decode_plain(q, k, v, bias, k_scale=None, v_scale=None):
    """q [B,T,qh,hd] pre-scaled, k/v [B,S,kh,hd], bias [B,T,S] f32 →
    [B,qh,T,hd] in the activation dtype (v's, or the scales' for an int8
    cache with ``k_scale``/``v_scale`` [B,S,kh,1])."""
    b, t, qh, hd = q.shape
    kh = k.shape[2]
    group = qh // kh
    act = v.dtype if v_scale is None else v_scale.dtype
    qg = q.reshape(b, t, kh, group, hd).to(torch.float32)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.to(torch.float32))
    if k_scale is not None:
        # [B,S,kh,1] → [B,kh,1,1,S]: the slot's K scale on its score
        scores = scores * k_scale[..., 0].to(torch.float32).permute(
            0, 2, 1)[:, :, None, None, :]
    scores = scores + bias.to(torch.float32)[:, None, None, :, :]
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    probs = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if v_scale is not None:
        probs = probs * v_scale[..., 0].to(torch.float32).permute(
            0, 2, 1)[:, :, None, None, :]
    probs = probs.to(act).to(torch.float32)
    out = torch.einsum("bkgts,bskd->bkgtd", probs, v.to(torch.float32))
    return out.reshape(b, qh, t, hd).to(act)


def flash_decode_attention(q, k, v, bias, k_scale=None, v_scale=None):
    """Fused decode attention (kernel on CUDA); see :func:`flash_decode_plain`.
    ``k_scale``/``v_scale`` given: the cache is int8 (K2-i8)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, bias, k_scale, v_scale)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("flash_decode: give both k_scale and v_scale or "
                         "neither")
    if k_scale is None:
        return _launch(q, k, v, bias)
    return _launch_i8(q, k, v, bias, k_scale, v_scale)


def _check(q, k, v, bias, cache_dtype, scales=()):
    """Raise unless the kernel takes the call: shapes, types, devices,
    contiguity and shared memory."""
    b, t, qh, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    if (k.shape != (b, s, kh, hd) or v.shape != k.shape
            or tuple(bias.shape) != (b, t, s)
            or any(a.shape != (b, s, kh, 1) for a in scales)):
        raise ValueError(
            f"flash_decode shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, bias {tuple(bias.shape)}, scales "
            f"{[tuple(a.shape) for a in scales]}")
    if hd != HEAD_DIM or qh % kh or t * (qh // kh) > MAX_ROWS:
        raise ValueError(f"flash_decode kernel takes head_dim {HEAD_DIM} and "
                         f"T*group <= {MAX_ROWS}, got hd={hd}, T={t}, "
                         f"qh={qh}, kh={kh}")
    if not (q.dtype == torch.bfloat16 and k.dtype == v.dtype == cache_dtype
            and bias.dtype == torch.float32
            and all(a.dtype == torch.bfloat16 for a in scales)):
        raise TypeError(
            f"flash_decode kernel takes bf16 q, {cache_dtype} k/v, f32 bias"
            f"{' and bf16 scales' if scales else ''}, got q {q.dtype}, k "
            f"{k.dtype}, v {v.dtype}, bias {bias.dtype}, scales "
            f"{[a.dtype for a in scales]}")
    tensors = (k, v, bias, *scales)
    if not (q.is_cuda and all(a.device == q.device for a in tensors)):
        raise ValueError("flash_decode: all inputs must be on one CUDA device")
    if not all(a.is_contiguous() for a in (q, *tensors)):
        raise ValueError("flash_decode kernel takes contiguous inputs")
    rows = t * (qh // kh)
    # scores [rows][S] (padded to 4), the per-warp partial sums [8][rows][hd]
    # and, for the int8 cache, the V scales [S]
    smem = (-(-rows * s // 4) * 4 + 8 * rows * hd + (s if scales else 0)) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_decode: cache length {s} needs {smem} B of "
                         "shared memory (split-KV is not implemented)")


def _launch(q, k, v, bias):
    global launches
    from ..kernels import build
    _check(q, k, v, bias, torch.bfloat16)
    b, t, qh, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, qh, t, hd), dtype=q.dtype, device=q.device)
    code = build.lib().flash_decode_bf16(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(bias),
        build.ptr(out), b, t, qh, kh, s, hd, build.stream_ptr(q.device))
    build.check(code, "flash_decode_bf16")
    launches += 1
    return out


def _launch_i8(q, k, v, bias, k_scale, v_scale):
    global launches_i8
    from ..kernels import build
    _check(q, k, v, bias, torch.int8, (k_scale, v_scale))
    b, t, qh, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, qh, t, hd), dtype=torch.bfloat16, device=q.device)
    code = build.lib().flash_decode_i8(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(k_scale),
        build.ptr(v_scale), build.ptr(bias), build.ptr(out), b, t, qh, kh, s,
        hd, build.stream_ptr(q.device))
    build.check(code, "flash_decode_i8")
    launches_i8 += 1
    return out
