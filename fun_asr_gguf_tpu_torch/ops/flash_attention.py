"""K3: masked non-causal attention for the SANM encoder.

Counterpart of ``fun_asr_gguf_tpu/ops/flash_attention.py``
(``flash_attention`` :90 and its wrapper ``attention_with_mask`` :143).
The CUDA kernel is ``csrc/flash_attention.cu`` (warpgroup MMA, the keys of
a query tile split over the blocks of a cluster; its note says what
bounds it). It masks the ragged T edge itself, so T is never padded to a
block multiple, and takes q, k, v and out by their (batch, head, row)
strides, so the SANM views of the packed qkv projection are passed as
they are.

The mask is the reference's additive key bias ``(mask - 1) * 1e4`` — not
−inf: masked keys keep a (vanishing) weight, exactly as in JAX.

Dispatch is by device only: CPU tensors take :func:`flash_attention_plain`
(the JAX ``use_pallas=False`` path: f32 scores and softmax), CUDA tensors
launch the kernel or raise. Unlike the JAX wrapper there is no batch-size
gate: every SANM layer goes through the kernel on the GPU.
:func:`flash_attention_split_plain` is the kernel's own arithmetic (64-key
tiles, per-chunk statistics, the fixed-order combine) in plain PyTorch,
for the tests.
"""

import ctypes

import torch

NEG_BIG = -1e9
HEAD_DIMS = (64, 128)
TILE = 64          # keys of a tile
ROWS = 128         # query rows of a block
MAX_CHUNKS = 8     # blocks of a cluster

launches = 0


def flash_attention_plain(q, k, v, key_bias):
    """q (pre-scaled), k, v [BH, T, D]; key_bias [BH, T] → [BH, T, D]
    in q's dtype."""
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), k.to(torch.float32))
    s = s + key_bias.to(torch.float32)[:, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)


def attention_chunks(bh: int, t: int, sms: int = 132) -> int:
    """Blocks (a cluster) over which the kernel splits the keys of each
    128-row query tile: doubled from 1 while the doubled grid stays within
    half the card's ``sms`` SMs and each block keeps at least one 64-key
    tile, at most :data:`MAX_CHUNKS`. At the encoder's BH = 4, T = 1001: 2,
    64 blocks of 8 key tiles (measured on an H100: 4 chunks on 128 SMs
    lose more to the combine than they gain)."""
    tiles = -(-t // TILE)
    blocks = bh * -(-t // ROWS)
    chunks = 1
    while (chunks < MAX_CHUNKS and 2 * chunks <= tiles
           and 4 * blocks * chunks <= sms):
        chunks *= 2
    return chunks


def flash_attention_split_plain(q, k, v, key_bias, chunks: int):
    """The kernel's arithmetic in f32: the 64-key tiles of T in ``chunks``
    contiguous ranges of ceil(tiles / chunks) tiles; per range an online
    softmax over its tiles (m from ``NEG_BIG``, keys >= T out, P rounded
    to bf16 for P.V, l summed unrounded); then o = sum_c e^(m_c - M) o_c
    and l likewise over the ranges in order, M the largest m_c, out = o /
    max(l, 1e-30) in q's dtype. A range past T keeps l = 0, o = 0."""
    bh, t, d = q.shape
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    bias = key_bias.to(f32)
    tiles = -(-t // TILE)
    per = -(-tiles // chunks)
    parts = []
    for c in range(chunks):
        m = torch.full((bh, t), NEG_BIG, dtype=f32)
        l = torch.zeros((bh, t), dtype=f32)
        o = torch.zeros((bh, t, d), dtype=f32)
        for j in range(c * per, min(tiles, (c + 1) * per)):
            lo, hi = j * TILE, min(t, (j + 1) * TILE)
            s = (torch.einsum("bqd,bkd->bqk", qf, kf[:, lo:hi])
                 + bias[:, None, lo:hi])
            mx = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - mx[..., None])
            scale = torch.exp(m - mx)
            l = l * scale + p.sum(-1)
            o = o * scale[..., None] + torch.einsum(
                "bqk,bkd->bqd", p.to(torch.bfloat16).to(f32), vf[:, lo:hi])
            m = mx
        parts.append((m, l, o))
    big = torch.stack([p[0] for p in parts]).amax(0)
    o = torch.zeros((bh, t, d), dtype=f32)
    l = torch.zeros((bh, t), dtype=f32)
    for m_c, l_c, o_c in parts:
        w = torch.exp(m_c - big)
        o = o + w[..., None] * o_c
        l = l + w * l_c
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def flash_attention(q, k, v, key_bias):
    """Masked attention (kernel on CUDA); see :func:`flash_attention_plain`.
    q, k, v [BH, T, D], key_bias [BH, T]: JAX's signature."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_bias)
    bh, t, d = q.shape
    if tuple(key_bias.shape) != (bh, t):
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, bias "
                         f"{tuple(key_bias.shape)}")
    out = _launch(q[:, None], k[:, None], v[:, None], _bias_rows(key_bias))
    return out.reshape(bh, t, d)


def _bias_rows(bias):
    """``bias`` [B, T] as the kernel's tensor map takes it: f32 rows of
    contiguous keys, 16-byte aligned (a padded copy where they are not)."""
    if (bias.stride(1) == 1 and bias.stride(0) % 4 == 0
            and bias.data_ptr() % 16 == 0):
        return bias
    out = _padded_rows(*bias.shape, bias.device)
    out.copy_(bias)
    return out


def _padded_rows(b: int, t: int, device):
    """An f32 [b, t] view of [b, t rounded up to 4]: 16-byte aligned rows."""
    return torch.empty((b, -(-t // 4) * 4), dtype=torch.float32,
                       device=device)[:, :t]


def _launch(q, k, v, bias, chunks=None):
    """The kernel on [B, H, T, D] q, k, v (any strides with the head dims
    contiguous) and an f32 bias [B, T]; returns [B, H, T, D], a view of a
    [B, T, H, D] tensor. ``chunks``: the key split (default
    :func:`attention_chunks`)."""
    global launches
    from ..kernels import build
    b, h, t, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or \
            tuple(bias.shape) != (b, t):
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, bias "
                         f"{tuple(bias.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and bias.dtype == torch.float32):
        raise TypeError(f"flash_attention kernel takes bf16 q/k/v and f32 "
                        f"bias, got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{bias.dtype}")
    if not all(a.is_cuda and a.device == q.device for a in (k, v, bias)):
        raise ValueError("flash_attention: inputs must be on one CUDA device")
    for a in (q, k, v):
        if a.stride(3) != 1 or any(s % 8 for s in a.stride()[:3]) \
                or a.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel takes q, k, v with "
                             f"contiguous head dims, 16-byte aligned, strides "
                             f"of 8 elements; got strides {a.stride()}")
    if (bias.stride(1) != 1 and t > 1) or bias.stride(0) % 4 \
            or bias.data_ptr() % 16:
        raise ValueError("flash_attention kernel takes 16-byte aligned bias "
                         "rows of contiguous keys")
    if chunks is None:
        chunks = attention_chunks(b * h, t, build.sm_count(q.device))
    out = torch.empty((b, t, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for a in (q, k, v, out)
                                          for s in a.stride()[:3]))
    code = build.lib().flash_attention_bf16(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(bias),
        build.ptr(out), ctypes.cast(strides, ctypes.c_void_p),
        bias.stride(0), b, h, t, d, chunks, build.stream_ptr(q.device))
    build.check(code, "flash_attention_bf16")
    launches += 1
    return out


def attention_with_mask(q_heads, k_heads, v_heads, mask):
    """[B, H, T, D] heads + [B, T] validity mask → [B, H, T, D]. On the card
    the heads go to the kernel as the views they are, with the [B, T] bias
    row of each batch row; the output is a view of a [B, T, H, D] tensor,
    so merging the heads back is free."""
    b, h, t, d = q_heads.shape
    if q_heads.device.type != "cpu":
        bias = _padded_rows(b, t, q_heads.device)
        torch.mul(mask.to(torch.float32) - 1.0, 10000.0, out=bias)
        return _launch(q_heads, k_heads, v_heads, bias)
    bias = (mask.to(torch.float32) - 1.0) * 10000.0            # [B, T]
    out = flash_attention_plain(q_heads.reshape(b * h, t, d),
                                k_heads.reshape(b * h, t, d),
                                v_heads.reshape(b * h, t, d),
                                bias.repeat_interleave(h, dim=0))
    return out.reshape(b, h, t, d)
