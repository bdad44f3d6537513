"""K2: decode attention over one layer of a bf16 or an int8 KV cache.

Counterpart of ``fun_asr_gguf_tpu/ops/flash_decode.py``
(``flash_decode_attention`` :132, both branches) with the numerics of
``fun_asr_gguf_tpu/models/qwen3.py:_attend_cache`` :315: f32 scores, an
exact softmax over the whole cache row, probabilities normalised in f32
(``max(l, 1e-30)`` clamp) then cast to the activation dtype for the mix,
f32 accumulation, output in the activation dtype. The CUDA kernels are in
``csrc/flash_decode.cu`` on the split-KV design of ``csrc/split_kv.cuh``
(its note says what bounds them): the cache is cut into chunks of slots,
one block per (chunk, kv head, batch row), each chunk keeps its own
(m, l, acc) and the last block of a head merges them in order.
:func:`split_kv_plain` is that chunked combine written out on tensors;
the rounding point of the probabilities moves with it (each chunk rounds
its unnormalised ``exp(s - m)``), within the kernel's tolerance of
:func:`flash_decode_plain`. The kernels serve the decode step (T = 1) and
the speculative verify step (T = spec_k + 1 query rows), at any cache
length.

The int8 cache (``QuantKV``, ``qwen3.py:196``) keeps one scale per (slot,
kv head) in JAX's layout ``[B, S, kh, 1]``, in the activation dtype. The
scales commute out of the head_dim contraction (``_attend_cache``'s QuantKV
branch :334-353): scores are taken on the raw int8 K, multiplied by K's
scale of the slot; V's scale multiplies the probabilities before their
cast, and the mix runs on the raw int8 V. That variant is K2-i8, with its
own C entry and its own launch count (``launches_i8``).

GQA: query head ``h`` reads kv head ``h // group``.

Dispatch is by device only: CPU tensors take :func:`flash_decode_plain`,
CUDA tensors launch the kernel or raise.
"""

import torch

MAX_ROWS = 18          # T * group query rows per kernel block (verify at
                       # spec_k = 8: 9 rows x GQA group 2)
HEAD_DIM = 128
TILE = 32              # cache slots per staged tile (split_kv.cuh kTile)

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


def split_kv_plain(q, k, v, bias, chunk, k_scale=None, v_scale=None,
                   cur=None, scale=1.0):
    """The split-KV combine the kernels run, on tensors: q [B,T,qh,hd]
    (multiplied by ``scale`` after the dot), k/v [B,S,kh,hd], bias [B,T,S]
    f32 → [B,qh,T,hd] in the activation dtype (f32 with ``cur``).

    The slots are cut into chunks of ``chunk``; each chunk walks its slots
    in tiles of ``TILE`` with an online softmax (running max m, sum l of
    ``exp(s - m)``, the mix of the probabilities rounded to the activation
    dtype — after V's scale for an int8 cache — unnormalised, rescaled by
    ``exp(m_old - m_new)``); then the chunks' (m, l, acc) are merged in
    order. ``cur = (s_cur [B,qh,T] f32, v_cur [B,kh,hd] f32)`` starts the
    merge from the current token's term (m = s_cur, l = 1, acc = v_cur), as
    the all-layers kernel and P12 do. A query row with no visible slot
    (and no ``cur``) is the one case that differs from
    :func:`flash_decode_plain`: it averages V over the tiles the other rows
    of its batch row see, or gives 0 when they see none (the decoders
    never pass such a row)."""
    f32 = torch.float32
    b, t, qh, hd = q.shape
    s_len, kh = k.shape[1], k.shape[2]
    group = qh // kh
    act = v.dtype if v_scale is None else v_scale.dtype
    qg = q.reshape(b, t, kh, group, hd).to(f32)
    masked = (bias <= -1e29).all(dim=1)                       # [B, S]
    dev = q.device
    parts = []                     # (m, l, acc) in merge order
    if cur is not None:
        m_cur = cur[0].to(f32).reshape(b, kh, group, t)
        parts.append((m_cur, torch.ones_like(m_cur), cur[1].to(f32)[
            :, :, None, None, :].expand(b, kh, group, t, hd)))
    for c0 in range(0, s_len, chunk):
        m = torch.full((b, kh, group, t), -torch.inf, device=dev)
        l = torch.zeros(b, kh, group, t, device=dev)
        acc = torch.zeros(b, kh, group, t, hd, device=dev)
        for s0 in range(c0, min(s_len, c0 + chunk), TILE):
            s1 = min(s_len, c0 + chunk, s0 + TILE)
            # a tile no query row of a batch row sees is not read for it
            seen = ~masked[:, s0:s1].all(dim=1)                  # [B]
            if not bool(seen.any()):
                continue
            kt = k[:, s0:s1].to(f32)
            sc = torch.einsum("btkgd,bskd->bkgts", qg, kt) * scale
            if k_scale is not None:
                sc = sc * k_scale[:, s0:s1, :, 0].to(f32).permute(
                    0, 2, 1)[:, :, None, None, :]
            sc = sc + bias[:, None, None, :, s0:s1].to(f32)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.where(m_new == -torch.inf, 1.0,
                                torch.exp(m - m_new))
            p = torch.exp(sc - m_new[..., None])
            l_new = l * alpha + p.sum(-1)
            if v_scale is not None:
                p = p * v_scale[:, s0:s1, :, 0].to(f32).permute(
                    0, 2, 1)[:, :, None, None, :]
            acc_new = acc * alpha[..., None] + torch.einsum(
                "bkgts,bskd->bkgtd", p.to(act).to(f32), v[:, s0:s1].to(f32))
            keep = seen[:, None, None, None]
            m = torch.where(keep, m_new, m)
            l = torch.where(keep, l_new, l)
            acc = torch.where(keep[..., None], acc_new, acc)
        parts.append((m, l, acc))
    mx = torch.full((b, kh, group, t), -torch.inf, device=dev)
    for m, _, _ in parts:
        mx = torch.maximum(mx, m)
    l_all = torch.zeros(b, kh, group, t, device=dev)
    o_all = torch.zeros(b, kh, group, t, hd, device=dev)
    for m, l, acc in parts:
        w = torch.where(m == -torch.inf, 0.0, torch.exp(m - mx))
        l_all = l_all + w * l
        o_all = o_all + w[..., None] * acc
    out = torch.where(l_all[..., None] > 0,
                      o_all / l_all.clamp_min(1e-30)[..., None], 0.0)
    out = out.reshape(b, qh, t, hd)
    return out if cur is not None else out.to(act)


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
    """Raise unless the kernel takes the call: shapes, types, devices and
    contiguity (any cache length)."""
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


def _outputs(q, s, kh, chunk):
    """out [B, qh, T, hd] bf16, the f32 work buffer of the chunks' partials
    and the ticket buffer. ``chunk`` 0 lets the launch size the chunks (in
    whole tiles, so at most one per tile); a test may give its own."""
    from ..kernels import build
    b, t, qh, hd = q.shape
    chunks = -(-s // (chunk or TILE))
    work = torch.empty(b * kh * chunks * t * (qh // kh) * (hd + 2),
                       dtype=torch.float32, device=q.device)
    out = torch.empty((b, qh, t, hd), dtype=torch.bfloat16, device=q.device)
    return out, work, build.tickets(q.device, b * kh)


def _launch(q, k, v, bias, chunk=0):
    global launches
    from ..kernels import build
    _check(q, k, v, bias, torch.bfloat16)
    b, t, qh, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    out, work, tickets = _outputs(q, s, kh, chunk)
    code = build.lib().flash_decode_bf16(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(bias),
        build.ptr(out), build.ptr(work), build.ptr(tickets), b, t, qh, kh, s,
        hd, chunk, build.stream_ptr(q.device))
    build.check(code, "flash_decode_bf16")
    launches += 1
    return out


def _launch_i8(q, k, v, bias, k_scale, v_scale, chunk=0):
    global launches_i8
    from ..kernels import build
    _check(q, k, v, bias, torch.int8, (k_scale, v_scale))
    b, t, qh, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    out, work, tickets = _outputs(q, s, kh, chunk)
    code = build.lib().flash_decode_i8(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(k_scale),
        build.ptr(v_scale), build.ptr(bias), build.ptr(out), build.ptr(work),
        build.ptr(tickets), b, t, qh, kh, s, hd, chunk,
        build.stream_ptr(q.device))
    build.check(code, "flash_decode_i8")
    launches_i8 += 1
    return out
