"""Numpy q8_0 quantization, bit-compatible with ggml's Q8_0 layout.

Layout facts (independently implemented from the GGUF format spec; parity
target is the reference's dequant at ``fun_asr_gguf/llama.py:779-784`` and
quant at ``fun_asr_gguf/gguf/quants.py:378-403``):

* block size 32 values -> 34 bytes: 2-byte fp16 scale ``d`` then 32 int8
  quants; ``d = absmax/127``; ``q = round_half_away(x/d)``.

The split representation (int8 values + fp16 scales as separate arrays) is
what the TPU path consumes: int8 tiles feed Pallas dequant-matmuls, scales
ride along in a second operand.
"""

import numpy as np

Q8_0_BLOCK = 32
Q8_0_BLOCK_BYTES = 34


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """C roundf semantics (ties away from zero), unlike np.round's ties-to-even."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def q8_0_quantize(x: np.ndarray):
    """Quantize along the last axis.

    Args:
        x: float array [..., K] with K % 32 == 0.
    Returns:
        (q int8 [..., K], d float16 [..., K//32])
    """
    x = np.asarray(x, dtype=np.float32)
    k = x.shape[-1]
    if k % Q8_0_BLOCK != 0:
        raise ValueError(f"last dim {k} not a multiple of {Q8_0_BLOCK}")
    try:
        # single-pass C++ kernel (native/quant_kernels.cc), bit-identical;
        # the numpy path below costs ~10 full memory passes, which on a
        # 1-core host turns a 0.6B-param export into minutes
        from ..native import q8_0_quantize_native
        out = q8_0_quantize_native(x)
        if out is not None:
            return out
    except ImportError:
        pass
    blocks = x.reshape(*x.shape[:-1], k // Q8_0_BLOCK, Q8_0_BLOCK)
    d = np.abs(blocks).max(axis=-1, keepdims=True) / 127.0
    # ggml quantizes against the UNROUNDED f32 scale and only then stores d
    # as fp16 (quantize_row_q8_0_ref); matching that keeps our bytes
    # bit-identical to ggml/gguf-py for every input. One deviation, shared
    # by the C++ and on-device paths: a SUBNORMAL d (absmax < ~1.5e-36)
    # flushes to a zero block — 1/d would overflow to inf (UB in ggml's
    # own reference, denormal-flushed to q=0 on TPU), and the stored fp16
    # scale underflows to 0 anyway, so the dequantized block is 0 either
    # way; flushing makes all three quantizers byte-identical.
    d = np.where(d < np.finfo(np.float32).tiny, 0.0, d)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d == 0, 0.0, 1.0 / d)
    q = _round_half_away(blocks * inv)
    q = np.clip(q, -127, 127).astype(np.int8)
    return q.reshape(x.shape), d.astype(np.float16).squeeze(-1)


def q8_0_dequantize(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Inverse of :func:`q8_0_quantize`. Returns float32 [..., K]."""
    k = q.shape[-1]
    blocks = q.reshape(*q.shape[:-1], k // Q8_0_BLOCK, Q8_0_BLOCK).astype(np.float32)
    out = blocks * d[..., None].astype(np.float32)
    return out.reshape(q.shape)


def q8_0_to_blocks(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Pack (q, d) into the ggml on-disk byte stream (uint8 [n_blocks*34])."""
    try:
        from ..native import q8_0_pack_blocks_native
        out = q8_0_pack_blocks_native(q, d)
        if out is not None:
            return out
    except ImportError:
        pass
    k = q.shape[-1]
    nb = int(np.prod(q.shape[:-1], dtype=np.int64)) * (k // Q8_0_BLOCK)
    qb = q.reshape(nb, Q8_0_BLOCK).view(np.uint8)
    db = d.reshape(nb, 1).view(np.uint8)
    return np.concatenate([db, qb], axis=1).reshape(-1)


def q8_0_from_blocks(raw: np.ndarray, shape) -> tuple:
    """Unpack a ggml q8_0 byte stream into (q int8 [shape], d fp16 [..., K//32])."""
    raw = np.frombuffer(np.ascontiguousarray(raw), dtype=np.uint8)
    nb = raw.size // Q8_0_BLOCK_BYTES
    blocks = raw[: nb * Q8_0_BLOCK_BYTES].reshape(nb, Q8_0_BLOCK_BYTES)
    d = blocks[:, :2].copy().view(np.float16).reshape(nb)
    q = blocks[:, 2:].copy().view(np.int8)
    shape = tuple(int(s) for s in shape)
    k = shape[-1]
    q = q.reshape(*shape[:-1], k)
    d = d.reshape(*shape[:-1], k // Q8_0_BLOCK)
    return q, d


def q8_0_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Dequantize a ggml q8_0 byte stream straight to float32 [shape]."""
    q, d = q8_0_from_blocks(raw, shape)
    return q8_0_dequantize(q, d)


# ---------------------------------------------------------------------------
# Legacy 4/5-bit formats (read-side support for arbitrary llama.cpp GGUFs)
# ---------------------------------------------------------------------------
# Block layouts per the GGUF/ggml spec; all blocks cover 32 values, low
# nibbles hold elements 0..15 and high nibbles 16..31.

def _blocks(raw: np.ndarray, block_bytes: int) -> np.ndarray:
    raw = np.frombuffer(np.ascontiguousarray(raw), dtype=np.uint8)
    nb = raw.size // block_bytes
    return raw[: nb * block_bytes].reshape(nb, block_bytes)


def _nibbles(qbytes: np.ndarray) -> np.ndarray:
    """[nb, 16] packed bytes -> [nb, 32] int nibble values (0..15)."""
    lo = qbytes & 0x0F
    hi = qbytes >> 4
    return np.concatenate([lo, hi], axis=1).astype(np.int32)


def _high_bits(qh: np.ndarray) -> np.ndarray:
    """[nb] uint32 -> [nb, 32] single-bit values."""
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh[:, None] >> shifts[None, :]) & 1).astype(np.int32)


def q4_0_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Q4_0: 18-byte block = f16 d + 16 packed nibbles; v = (q - 8) * d."""
    b = _blocks(raw, 18)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)
    q = _nibbles(b[:, 2:]) - 8
    return (q * d).astype(np.float32).reshape(shape)


def q4_1_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Q4_1: 20-byte block = f16 d + f16 m + 16 nibbles; v = q*d + m."""
    b = _blocks(raw, 20)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    q = _nibbles(b[:, 4:])
    return (q * d + m).astype(np.float32).reshape(shape)


def q5_0_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Q5_0: 22-byte block = f16 d + u32 qh + 16 nibbles;
    v = ((q | (hb << 4)) - 16) * d."""
    b = _blocks(raw, 22)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)
    qh = b[:, 2:6].copy().view(np.uint32).reshape(-1)
    q = _nibbles(b[:, 6:]) | (_high_bits(qh) << 4)
    return ((q - 16) * d).astype(np.float32).reshape(shape)


def q5_1_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Q5_1: 24-byte block = f16 d + f16 m + u32 qh + 16 nibbles;
    v = (q | (hb << 4)) * d + m."""
    b = _blocks(raw, 24)
    d = b[:, :2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    qh = b[:, 4:8].copy().view(np.uint32).reshape(-1)
    q = _nibbles(b[:, 8:]) | (_high_bits(qh) << 4)
    return (q * d + m).astype(np.float32).reshape(shape)


def _signed_absmax(x: np.ndarray) -> np.ndarray:
    """Per-row value with the largest magnitude, sign preserved ([nb, 1])."""
    idx = np.argmax(np.abs(x), axis=1)
    return x[np.arange(x.shape[0]), idx][:, None]


def _pack_nibbles(q: np.ndarray) -> np.ndarray:
    """[nb, 32] values (low 4 bits used) → [nb, 16] packed bytes."""
    return ((q[:, :16] & 0x0F) | (q[:, 16:] << 4)).astype(np.uint8)


def _pack_high_bits(q: np.ndarray) -> np.ndarray:
    """[nb, 32] 5-bit values → [nb, 4] bytes of bit-4s (little-endian)."""
    bits = ((q >> 4) & 1).astype(np.uint8)
    shifts = np.arange(32, dtype=np.uint32) % 8
    packed = (bits.astype(np.uint32) << shifts[None, :]).reshape(-1, 4, 8)
    return packed.sum(axis=-1).astype(np.uint8)


def _f16_bytes(v: np.ndarray) -> np.ndarray:
    return v.astype(np.float16).view(np.uint8).reshape(-1, 2)


def q4_0_quantize(x: np.ndarray, qw=None) -> np.ndarray:
    """Quantize to the q4_0 byte stream, bit-exact with ggml.

    d = signed-absmax / -8; q = trunc(x/d + 8.5) clipped to [0, 15]
    (ggml's quantize_row_q4_0_ref rounding), quantized against the
    unrounded f32 scale.

    ``qw`` (imatrix row, per input channel): the weighted make_qx scale
    search replaces the absmax scale (ggml quantize_row_q4_0_impl with
    quant_weights) — same byte format, importance-aware rounding.
    """
    if qw is not None:
        qwb = _expand_qw(qw, x).reshape(-1, Q8_0_BLOCK)
    x = np.asarray(x, dtype=np.float32).reshape(-1, Q8_0_BLOCK)
    if qw is not None:
        w = _imatrix_weights(qwb, x, (x * x).mean(axis=1, keepdims=True))
        scale, L = _make_qx_quants(x, 8, w)
        return np.concatenate(
            [_f16_bytes(scale.astype(np.float32)[:, None]),
             _pack_nibbles(L.astype(np.uint8))], axis=1).reshape(-1)
    d = _signed_absmax(x) / -8.0
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d == 0, 0.0, 1.0 / d)
    q = np.clip(np.trunc(x * inv + np.float32(8.5)), 0, 15).astype(np.uint8)
    return np.concatenate([_f16_bytes(d), _pack_nibbles(q)],
                          axis=1).reshape(-1)


def _q41_style_weighted(x, qw, nmax: int, with_high: bool) -> np.ndarray:
    """Weighted q4_1/q5_1 encoder: make_qkx2 (scale, min) search with
    imatrix weights; same block layout, better rounding."""
    qwb = _expand_qw(qw, x).reshape(-1, Q8_0_BLOCK)
    xb = np.asarray(x, np.float32).reshape(-1, Q8_0_BLOCK)
    w = _imatrix_weights(qwb, xb, (xb * xb).mean(axis=1, keepdims=True))
    scale, the_min, L = _make_qkx2_quants(xb, w, nmax)
    q = L.astype(np.uint8)
    parts = [_f16_bytes(scale.astype(np.float32)[:, None]),
             _f16_bytes((-the_min).astype(np.float32)[:, None])]
    if with_high:
        parts.append(_pack_high_bits(q))
    parts.append(_pack_nibbles(q))
    return np.concatenate(parts, axis=1).reshape(-1)


def q4_1_quantize(x: np.ndarray, qw=None) -> np.ndarray:
    """q4_1 byte stream: d = (max-min)/15, m = min; q = trunc((x-m)/d + .5).
    ``qw``: weighted asymmetric (scale, min) search (make_qkx2 family)."""
    if qw is not None:
        return _q41_style_weighted(x, qw, nmax=15, with_high=False)
    x = np.asarray(x, dtype=np.float32).reshape(-1, Q8_0_BLOCK)
    mx = x.max(axis=1, keepdims=True)
    mn = x.min(axis=1, keepdims=True)
    d = (mx - mn) / 15.0
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d == 0, 0.0, 1.0 / d)
    q = np.clip(np.trunc((x - mn) * inv + np.float32(0.5)), 0,
                15).astype(np.uint8)
    return np.concatenate([_f16_bytes(d), _f16_bytes(mn), _pack_nibbles(q)],
                          axis=1).reshape(-1)


def q5_0_quantize(x: np.ndarray, qw=None) -> np.ndarray:
    """q5_0 byte stream: d = signed-absmax / -16; 5-bit values, bit 4 in qh.
    ``qw``: weighted scale search, as :func:`q4_0_quantize`."""
    if qw is not None:
        qwb = _expand_qw(qw, x).reshape(-1, Q8_0_BLOCK)
        xb = np.asarray(x, dtype=np.float32).reshape(-1, Q8_0_BLOCK)
        w = _imatrix_weights(qwb, xb, (xb * xb).mean(axis=1, keepdims=True))
        scale, L = _make_qx_quants(xb, 16, w)
        q = L.astype(np.uint8)
        return np.concatenate(
            [_f16_bytes(scale.astype(np.float32)[:, None]),
             _pack_high_bits(q), _pack_nibbles(q)], axis=1).reshape(-1)
    x = np.asarray(x, dtype=np.float32).reshape(-1, Q8_0_BLOCK)
    d = _signed_absmax(x) / -16.0
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d == 0, 0.0, 1.0 / d)
    q = np.clip(np.trunc(x * inv + np.float32(16.5)), 0, 31).astype(np.uint8)
    return np.concatenate(
        [_f16_bytes(d), _pack_high_bits(q), _pack_nibbles(q)],
        axis=1).reshape(-1)


def q5_1_quantize(x: np.ndarray, qw=None) -> np.ndarray:
    """q5_1 byte stream: d = (max-min)/31, m = min; bit 4 in qh.
    ``qw``: weighted asymmetric (scale, min) search (make_qkx2 family)."""
    if qw is not None:
        return _q41_style_weighted(x, qw, nmax=31, with_high=True)
    x = np.asarray(x, dtype=np.float32).reshape(-1, Q8_0_BLOCK)
    mx = x.max(axis=1, keepdims=True)
    mn = x.min(axis=1, keepdims=True)
    d = (mx - mn) / 31.0
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d == 0, 0.0, 1.0 / d)
    q = np.clip(np.trunc((x - mn) * inv + np.float32(0.5)), 0,
                31).astype(np.uint8)
    return np.concatenate(
        [_f16_bytes(d), _f16_bytes(mn), _pack_high_bits(q),
         _pack_nibbles(q)], axis=1).reshape(-1)


# ---------------------------------------------------------------------------
# K-quants (256-value superblocks) — read support for llama.cpp exports like
# q4_K_M, the most common GGUF quantization in the wild. Layouts per the
# GGUF/ggml spec; parity target is the reference's vendored
# ``gguf/quants.py:404-572`` (tested bit-exactly in test_gguf_interop.py).
# ---------------------------------------------------------------------------

QK_K = 256


def _kquant_scale_min(scales: np.ndarray):
    """Unpack the 12-byte 6-bit scale/min table of Q4_K/Q5_K.

    Bytes 0-3 carry the low 6 bits of scales 0-3 (top 2 bits: high bits of
    scales 4-7); bytes 4-7 the same for mins; bytes 8-11 the low nibbles of
    scales/mins 4-7. Returns (sc [nb, 8], mn [nb, 8]) uint8.
    """
    a = scales[:, 0:4]
    b = scales[:, 4:8]
    c = scales[:, 8:12]
    sc = np.concatenate([a & 0x3F, (c & 0x0F) | ((a >> 2) & 0x30)], axis=1)
    mn = np.concatenate([b & 0x3F, (c >> 4) | ((b >> 2) & 0x30)], axis=1)
    return sc, mn


def _nibble_rows(qs: np.ndarray, group: int) -> np.ndarray:
    """[nb, n_bytes] packed nibbles → [nb, 2*n_bytes//group, group] values,
    sub-block order (chunk-lo, chunk-hi, ...) as ggml stores them."""
    nb = qs.shape[0]
    chunks = qs.reshape(nb, -1, group)            # [nb, C, group]
    lo = chunks & 0x0F
    hi = chunks >> 4
    return np.stack([lo, hi], axis=2).reshape(nb, -1, group)


def q2_k_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Q2_K: 84-byte superblock = 16 scale bytes (lo nibble: scale, hi:
    min) + 64 2-bit quant bytes + f16 d + f16 dmin."""
    b = _blocks(raw, 84)
    scales = b[:, :16]
    qs = b[:, 16:80]
    d = b[:, 80:82].copy().view(np.float16).astype(np.float32)
    dmin = b[:, 82:84].copy().view(np.float16).astype(np.float32)
    nb = b.shape[0]
    dl = d * (scales & 0x0F).astype(np.float32)            # [nb, 16]
    ml = dmin * (scales >> 4).astype(np.float32)
    chunks = qs.reshape(nb, 2, 32)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    q = ((chunks[:, :, None, :] >> shifts[None, None, :, None]) & 3)
    q = q.reshape(nb, 16, 16).astype(np.float32)
    out = dl[:, :, None] * q - ml[:, :, None]
    return out.reshape(shape).astype(np.float32)


def q3_k_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Q3_K: 110-byte superblock = 32 high-bit-mask bytes + 64 2-bit quant
    bytes + 12 packed 6-bit scale bytes + f16 d. Values are
    (q2 | high<<2 as sign offset) scaled by per-16 6-bit scales - 32."""
    b = _blocks(raw, 110)
    hmask = b[:, :32]
    qs = b[:, 32:96]
    scales = b[:, 96:108]
    d = b[:, 108:110].copy().view(np.float16).astype(np.float32)
    nb = b.shape[0]

    # 6-bit scales: 8 bytes of low nibble pairs + 4 bytes of 2-bit highs
    ls = scales[:, :8]
    hs = scales[:, 8:12]
    lo = np.concatenate([ls & 0x0F, ls >> 4], axis=1)       # [nb, 16]
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    hi = ((hs[:, None, :] >> shifts[None, :, None]) & 3).reshape(nb, 16)
    sc = ((lo | (hi << 4)).astype(np.int8).astype(np.int32) - 32
          ).astype(np.float32)
    dl = d * sc                                             # [nb, 16]

    chunks = qs.reshape(nb, 2, 32)
    ql = ((chunks[:, :, None, :] >> shifts[None, None, :, None]) & 3)
    ql = ql.reshape(nb, 16, 16).astype(np.int32)
    bit_shifts = np.arange(8, dtype=np.uint8)
    qh = ((hmask[:, None, :] >> bit_shifts[None, :, None]) & 1)
    qh = qh.reshape(nb, 16, 16).astype(np.int32)
    q = (ql - ((qh ^ 1) << 2)).astype(np.float32)   # offset 0 when bit set
    out = dl[:, :, None] * q
    return out.reshape(shape).astype(np.float32)


def q4_k_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Q4_K: 144-byte superblock = f16 d + f16 dmin + 12 scale bytes + 128
    nibble bytes; v = d·sc·q − dmin·mn per 32-value sub-block."""
    b = _blocks(raw, 144)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _kquant_scale_min(b[:, 4:16])
    q = _nibble_rows(b[:, 16:144], 32).astype(np.float32)   # [nb, 8, 32]
    dl = d * sc.astype(np.float32)                          # [nb, 8]
    ml = dmin * mn.astype(np.float32)
    out = dl[:, :, None] * q - ml[:, :, None]
    return out.reshape(shape).astype(np.float32)


def q5_k_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Q5_K: 176-byte superblock = Q4_K header + 32 high-bit bytes + 128
    nibble bytes; q = nibble | (bit<<4)."""
    b = _blocks(raw, 176)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _kquant_scale_min(b[:, 4:16])
    qh = b[:, 16:48]
    ql = _nibble_rows(b[:, 48:176], 32)                     # [nb, 8, 32]
    nb = b.shape[0]
    bit_shifts = np.arange(8, dtype=np.uint8)
    hb = ((qh[:, None, :] >> bit_shifts[None, :, None]) & 1)  # [nb, 8, 32]
    q = (ql | (hb << 4)).astype(np.float32)
    dl = d * sc.astype(np.float32)
    ml = dmin * mn.astype(np.float32)
    out = dl[:, :, None] * q - ml[:, :, None]
    return out.reshape(shape).astype(np.float32)


def q6_k_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Q6_K: 210-byte superblock = 128 low-nibble bytes + 64 2-bit-high
    bytes + 16 int8 scales + f16 d; v = d·scale[i/16]·(q − 32)."""
    b = _blocks(raw, 210)
    ql = b[:, :128]
    qh = b[:, 128:192]
    scales = b[:, 192:208].copy().view(np.int8).astype(np.float32)
    d = b[:, 208:210].copy().view(np.float16).astype(np.float32)
    nb = b.shape[0]
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    chunks = qh.reshape(nb, 2, 32)
    high = ((chunks[:, :, None, :] >> shifts[None, None, :, None]) & 3)
    high = high.reshape(nb, -1, 32).astype(np.int32)
    # low nibbles come in 64-wide chunks (lo then hi per chunk), pairing
    # with the 2-bit highs in stored shift order per chunk
    lo2 = ql.reshape(nb, 2, 64)
    lo_vals = np.stack([lo2 & 0x0F, lo2 >> 4], axis=2)      # [nb, 2, 2, 64]
    q = (lo_vals.reshape(nb, -1, 32).astype(np.int32)
         | (high << 4)) - 32
    q = q.reshape(nb, 16, 16).astype(np.float32)
    dl = d * scales                                         # [nb, 16]
    out = dl[:, :, None] * q
    return out.reshape(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# IQ 4-bit non-linear formats — read support for modern llama.cpp exports
# (iq4_nl / iq4_xs). A shared 16-entry signed codebook replaces the linear
# q = 0..15 mapping; parity target is the reference's vendored
# ``gguf/quants.py:1271-1318``.
# ---------------------------------------------------------------------------

# the ggml IQ4 codebook: non-uniform int8 levels indexed by each nibble
IQ4_KVALUES = np.array([-127, -104, -83, -65, -49, -35, -22, -10,
                        1, 13, 25, 38, 53, 69, 89, 113], dtype=np.int8)


def iq4_nl_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """IQ4_NL: 18-byte block = f16 d + 16 nibble bytes;
    v = d · kvalues[q] with nibbles in (all-lo, all-hi) order."""
    b = _blocks(raw, 18)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)   # [nb, 1]
    qs = b[:, 2:18]
    nb = b.shape[0]
    idx = np.concatenate([qs & 0x0F, qs >> 4], axis=1)         # [nb, 32]
    vals = IQ4_KVALUES[idx].astype(np.float32)
    return (d * vals).reshape(shape).astype(np.float32)


def iq4_xs_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """IQ4_XS: 136-byte superblock = f16 d + u16 scales_h + 4 scales_l
    bytes + 128 nibble bytes; per-32 6-bit scale = (lo | hi<<4) − 32,
    v = d·scale·kvalues[q]."""
    b = _blocks(raw, 136)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)   # [nb, 1]
    sh = b[:, 2:4].copy().view(np.uint16)                      # [nb, 1]
    sl = b[:, 4:8]                                             # [nb, 4]
    qs = b[:, 8:136]
    lo = np.stack([sl & 0x0F, sl >> 4], axis=2).reshape(nb, 8)
    shifts = np.arange(0, 16, 2, dtype=np.uint16)
    hi = ((sh >> shifts[None, :]) & 3).astype(np.uint8)        # [nb, 8]
    scales = ((lo | (hi << 4)).astype(np.int8) - np.int8(32)
              ).astype(np.float32)
    dl = d * scales                                            # [nb, 8]
    # each 32-value group is 16 bytes, nibbles in (all-lo, all-hi) order
    g = qs.reshape(nb, 8, 16)
    idx = np.concatenate([g & 0x0F, g >> 4], axis=2)           # [nb, 8, 32]
    vals = IQ4_KVALUES[idx].astype(np.float32)
    out = dl[:, :, None] * vals
    return out.reshape(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# I-quants (codebook lattice formats) — read support for llama.cpp's
# smallest exports (iq1_s .. iq3_s). Each group of 4 or 8 values is one
# point from a fixed lattice codebook (formats/iq_codebooks.py), flipped by
# per-group sign bits and scaled by a per-sub-block scale. Parity target is
# the reference's vendored ``gguf/quants.py:707-1268``.
# ---------------------------------------------------------------------------

from .iq_codebooks import (GRID_IQ1, GRID_IQ2_S, GRID_IQ2_XS, GRID_IQ2_XXS,
                           GRID_IQ3_S, GRID_IQ3_XXS, KSIGNS)


def _sign_bits(sbytes: np.ndarray) -> np.ndarray:
    """uint8 sign bytes [..] → [.., 8] float32 factors (bit set → −1)."""
    bits = (sbytes[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    return np.where(bits == 0, np.float32(1), np.float32(-1))


def _u16_views(b: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Little-endian u16 view of a byte-column slice (copy, alignment-safe)."""
    return b[:, lo:hi].copy().view(np.uint16)


def iq2_xxs_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """IQ2_XXS: 66-byte superblock = f16 d + 8 u32 pairs; per 32-value
    group, word0's 4 bytes index the 256×8 grid, word1 holds 4×7-bit sign
    codes (bits 0..27) and a 4-bit scale (bits 28..31);
    v = d·(0.5+scale)·0.25 · grid · sign."""
    b = _blocks(raw, 66)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)   # [nb, 1]
    words = b[:, 2:].copy().view(np.uint32).reshape(nb, 8, 2)
    gidx = words[:, :, 0].copy().view(np.uint8).reshape(nb, 8, 4)
    meta = words[:, :, 1]                                      # [nb, 8]
    db = d * (0.5 + (meta >> 28)).astype(np.float32) * 0.25    # [nb, 8]
    scode = (meta[..., None] >> np.array([0, 7, 14, 21], dtype=np.uint32)
             ) & 0x7F                                          # [nb, 8, 4]
    signs = _sign_bits(KSIGNS[scode])                          # [nb, 8, 4, 8]
    vals = GRID_IQ2_XXS[gidx]                                  # [nb, 8, 4, 8]
    out = db[:, :, None, None] * vals * signs
    return out.reshape(shape).astype(np.float32)


def iq2_xs_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """IQ2_XS: 74-byte superblock = f16 d + 32 u16 codes + 8 scale bytes;
    each u16 = 9-bit grid index (512×8) | 7-bit sign code; nibble scales
    cover 16 values; v = d·(0.5+scale)·0.25 · grid · sign."""
    b = _blocks(raw, 74)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)   # [nb, 1]
    codes = _u16_views(b, 2, 66).reshape(nb, 32)
    sc = b[:, 66:74]                                           # [nb, 8]
    sc = np.stack([sc & 0x0F, sc >> 4], axis=2).reshape(nb, 16)
    db = d * (0.5 + sc).astype(np.float32) * 0.25              # [nb, 16]
    vals = GRID_IQ2_XS[codes & 0x1FF]                          # [nb, 32, 8]
    signs = _sign_bits(KSIGNS[codes >> 9])                     # [nb, 32, 8]
    out = db[:, :, None] * (vals * signs).reshape(nb, 16, 16)
    return out.reshape(shape).astype(np.float32)


def iq2_s_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """IQ2_S: 82-byte superblock = f16 d + 32 low-index bytes + 32 raw sign
    bytes + 8 high-bit bytes (2 bits per index) + 8 nibble-scale bytes;
    grid is 1024×8; v = d·(0.5+scale)·0.25 · grid · sign."""
    b = _blocks(raw, 82)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)   # [nb, 1]
    qs = b[:, 2:34].astype(np.uint16)                          # [nb, 32]
    sbytes = b[:, 34:66]                                       # [nb, 32]
    qh = b[:, 66:74]                                           # [nb, 8]
    sc = b[:, 74:82]
    sc = np.stack([sc & 0x0F, sc >> 4], axis=2).reshape(nb, 16)
    db = d * (0.5 + sc).astype(np.float32) * 0.25              # [nb, 16]
    hi = (qh[:, :, None] >> np.array([0, 2, 4, 6], dtype=np.uint8)) & 0x03
    idx = qs | (hi.reshape(nb, 32).astype(np.uint16) << 8)
    vals = GRID_IQ2_S[idx]                                     # [nb, 32, 8]
    signs = _sign_bits(sbytes)                                 # [nb, 32, 8]
    out = db[:, :, None] * (vals * signs).reshape(nb, 16, 16)
    return out.reshape(shape).astype(np.float32)


def iq3_xxs_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """IQ3_XXS: 98-byte superblock = f16 d + 64 grid-index bytes (256×4
    grid, 4 values each) + 8 u32 sign/scale words (4×7-bit sign codes +
    4-bit scale per 32 values); v = d·(0.5+scale)·0.5 · grid · sign."""
    b = _blocks(raw, 98)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)   # [nb, 1]
    gidx = b[:, 2:66].reshape(nb, 8, 8)                        # [nb, 8, 8]
    meta = b[:, 66:98].copy().view(np.uint32)                  # [nb, 8]
    db = d * (0.5 + (meta >> 28)).astype(np.float32) * 0.5     # [nb, 8]
    scode = (meta[..., None] >> np.array([0, 7, 14, 21], dtype=np.uint32)
             ) & 0x7F                                          # [nb, 8, 4]
    signs = _sign_bits(KSIGNS[scode])                          # [nb, 8, 4, 8]
    vals = GRID_IQ3_XXS[gidx].reshape(nb, 8, 4, 8)
    out = db[:, :, None, None] * vals * signs
    return out.reshape(shape).astype(np.float32)


def iq3_s_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """IQ3_S: 110-byte superblock = f16 d + 64 low-index bytes (512×4
    grid) + 8 high-bit bytes (1 bit per index) + 32 raw sign bytes + 4
    nibble-scale bytes; v = d·(1+2·scale) · grid · sign."""
    b = _blocks(raw, 110)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)   # [nb, 1]
    qs = b[:, 2:66].astype(np.uint16)                          # [nb, 64]
    qh = b[:, 66:74]                                           # [nb, 8]
    sbytes = b[:, 74:106]                                      # [nb, 32]
    sc = b[:, 106:110]                                         # [nb, 4]
    sc = np.stack([sc & 0x0F, sc >> 4], axis=2).reshape(nb, 8)
    db = d * (1 + 2 * sc).astype(np.float32)                   # [nb, 8]
    hi = (qh[:, :, None] >> np.arange(8, dtype=np.uint8)) & 0x01
    idx = qs | (hi.reshape(nb, 64).astype(np.uint16) << 8)
    vals = GRID_IQ3_S[idx].reshape(nb, 8, 32)                  # 8 per scale
    signs = _sign_bits(sbytes).reshape(nb, 8, 32)
    out = db[:, :, None] * vals * signs
    return out.reshape(shape).astype(np.float32)


IQ1_DELTA = np.float32(0.125)


def iq1_s_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """IQ1_S: 50-byte superblock = f16 d + 32 low-index bytes (2048×8
    ternary grid) + 8 u16 words; per 32-value group one word carries 4×3
    high index bits (shifts 0/3/6/9), a 3-bit scale (bits 12..14) and a
    delta sign (bit 15); v = d·(2·scale+1)·(grid ± 0.125)."""
    b = _blocks(raw, 50)
    nb = b.shape[0]
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)   # [nb, 1]
    qs = b[:, 2:34].astype(np.uint16)                          # [nb, 32]
    qhw = _u16_views(b, 34, 50)                                # [nb, 8]
    dl = d * (2 * ((qhw >> 12) & 7) + 1).astype(np.float32)    # [nb, 8]
    delta = np.where((qhw & 0x8000) == 0, IQ1_DELTA, -IQ1_DELTA)
    hi = (qhw[:, :, None] >> np.array([0, 3, 6, 9], dtype=np.uint16)) & 7
    idx = qs | (hi.reshape(nb, 32) << 8)
    vals = GRID_IQ1[idx].reshape(nb, 8, 32)
    out = dl[:, :, None] * (vals + delta[:, :, None])
    return out.reshape(shape).astype(np.float32)


def iq1_m_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """IQ1_M: 56-byte superblock = 32 low-index bytes + 16 high-nibble
    bytes (3 index bits + delta sign each) + 8 scale bytes; the f16 super
    scale is scattered across the top nibbles of the 4 scale words, and
    3-bit sub-scales (shifts 0/3/6/9) cover 16 values each;
    v = d·(2·scale+1)·(grid ± 0.125)."""
    b = _blocks(raw, 56)
    nb = b.shape[0]
    qs = b[:, 0:32].astype(np.uint16)                          # [nb, 32]
    qh = b[:, 32:48]                                           # [nb, 16]
    scw = _u16_views(b, 48, 56)                                # [nb, 4]
    dbits = (scw & np.uint16(0xF000)) >> np.array(
        [12, 8, 4, 0], dtype=np.uint16)
    d = (dbits[:, 0] | dbits[:, 1] | dbits[:, 2] | dbits[:, 3]
         ).astype(np.uint16).view(np.float16).astype(np.float32)  # [nb]
    sc = (scw[:, :, None] >> np.array([0, 3, 6, 9], dtype=np.uint16)) & 7
    dl = d[:, None] * (2 * sc.reshape(nb, 16) + 1).astype(np.float32)
    nib = np.stack([qh & 0x0F, qh >> 4], axis=2).reshape(nb, 32)
    idx = qs | ((nib & 7).astype(np.uint16) << 8)
    delta = np.where((nib & 0x08) == 0, IQ1_DELTA, -IQ1_DELTA)  # [nb, 32]
    vals = GRID_IQ1[idx]                                       # [nb, 32, 8]
    out = dl.reshape(nb, 16, 1, 1) * (
        vals + delta[:, :, None]).reshape(nb, 16, 2, 8)
    return out.reshape(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Ternary (BitNet) and microscaling formats. TQ1_0 packs 5 trits per byte
# in base-3 (×243/256 fixed-point decode), TQ2_0 packs 4 trits per byte in
# 2 bits; MXFP4 is OCP-MX e2m1 with a shared e8m0 power-of-two scale.
# Parity target: reference ``gguf/quants.py:575-705`` both directions.
# ---------------------------------------------------------------------------

def _ternary_quants(x: np.ndarray):
    """Per-256-block ternary quantization: returns (q in {0,1,2} uint8
    [nb, 256], d f16-bytes [nb, 2])."""
    d = np.abs(x).max(axis=-1, keepdims=True)
    with np.errstate(divide="ignore"):
        inv = np.where(d == 0, 0.0, 1.0 / d)
    q = (_round_half_away(x * inv).astype(np.int8) + np.int8(1)
         ).astype(np.uint8)
    return q, d.astype(np.float16).view(np.uint8)


def tq1_0_quantize(x: np.ndarray) -> np.ndarray:
    """TQ1_0: 54-byte block. Trits are packed 5-per-byte as
    ceil(sum(q_i·3^(4-i))·256/243): 32 bytes cover values 0..159 (stride
    32), 16 bytes cover 160..239 (stride 16), 4 bytes cover the last 16
    (stride 4, only 4 trits each); f16 d at the end."""
    x = np.asarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    q, d = _ternary_quants(x)
    p5 = np.array([81, 27, 9, 3, 1], dtype=np.uint8)
    g0 = (q[:, :160].reshape(nb, 5, 32) * p5[None, :, None]).sum(
        axis=1).reshape(nb, 32)
    g1 = (q[:, 160:240].reshape(nb, 5, 16) * p5[None, :, None]).sum(
        axis=1).reshape(nb, 16)
    g2 = (q[:, 240:].reshape(nb, 4, 4) * p5[None, :4, None]).sum(
        axis=1).reshape(nb, 4)
    packed = np.concatenate([g0, g1, g2], axis=1).astype(np.uint16)
    packed = ((packed * 256 + 242) // 243).astype(np.uint8)
    return np.concatenate([packed, d], axis=1).reshape(-1)


def tq1_0_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Inverse of :func:`tq1_0_quantize`; trit i of byte b is
    ((b·3^(i+1)) >> 8) − 1."""
    b = _blocks(raw, 54)
    nb = b.shape[0]
    d = b[:, 52:54].copy().view(np.float16).astype(np.float32)  # [nb, 1]
    p5 = np.array([1, 3, 9, 27, 81], dtype=np.uint8)
    g0 = (b[:, 0:32].reshape(nb, 1, 32) * p5[None, :, None]
          ).reshape(nb, 160)
    g1 = (b[:, 32:48].reshape(nb, 1, 16) * p5[None, :, None]
          ).reshape(nb, 80)
    g2 = (b[:, 48:52].reshape(nb, 1, 4) * p5[None, :4, None]
          ).reshape(nb, 16)
    q = np.concatenate([g0, g1, g2], axis=1).astype(np.uint16)
    q = ((q * 3) >> 8).astype(np.int8) - np.int8(1)
    return (d * q.astype(np.float32)).reshape(shape)


def tq2_0_quantize(x: np.ndarray) -> np.ndarray:
    """TQ2_0: 66-byte block = 64 bytes of 2-bit trits (4 per byte, 32-value
    stride per bit-plane) + f16 d."""
    x = np.asarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    q, d = _ternary_quants(x)
    planes = q.reshape(nb, 2, 4, 32) << np.array(
        [0, 2, 4, 6], dtype=np.uint8).reshape(1, 1, 4, 1)
    packed = np.bitwise_or.reduce(planes, axis=2).reshape(nb, 64)
    return np.concatenate([packed, d], axis=1).reshape(-1)


def tq2_0_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Inverse of :func:`tq2_0_quantize`."""
    b = _blocks(raw, 66)
    nb = b.shape[0]
    d = b[:, 64:66].copy().view(np.float16).astype(np.float32)  # [nb, 1]
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    q = (b[:, :64].reshape(nb, 2, 1, 32) >> shifts[None, None, :, None]
         ) & 0x03
    q = q.reshape(nb, 256).astype(np.int8) - np.int8(1)
    return (d * q.astype(np.float32)).reshape(shape)


# the OCP-MX e2m1 value table (doubled), ggml kvalues_mxfp4
MXFP4_KVALUES = np.array([0, 1, 2, 3, 4, 6, 8, 12,
                          0, -1, -2, -3, -4, -6, -8, -12], dtype=np.int8)


def _e8m0_to_fp32_half(e: np.ndarray) -> np.ndarray:
    """Decode a biased e8m0 exponent byte to 2^(e-127)/2 as float32
    (subnormal-encoded below e=2), per ggml_e8m0_to_fp32_half."""
    e = e.astype(np.uint32)
    bits = np.where(e < 2, np.uint32(0x00200000) << e,
                    (e - 1).astype(np.uint32) << np.uint32(23))
    return bits.view(np.float32)


def mxfp4_quantize(x: np.ndarray) -> np.ndarray:
    """MXFP4: 17-byte block = e8m0 scale byte + 16 nibble bytes (elements
    0..15 in low nibbles). Scale = floor(log2(absmax)) − 2 (power of two);
    each value maps to the nearest of the 16 e2m1 codebook points."""
    x = np.asarray(x, dtype=np.float32).reshape(-1, Q8_0_BLOCK)
    nb = x.shape[0]
    absmax = np.abs(x).max(axis=-1, keepdims=True)
    with np.errstate(divide="ignore"):
        e = np.where(absmax > 0,
                     np.floor(np.log2(absmax)) - 2 + 127, 0).astype(np.uint8)
    d = _e8m0_to_fp32_half(e)                                   # [nb, 1]
    errs = np.abs(d[:, :, None] * MXFP4_KVALUES.astype(np.float32)
                  - x[:, :, None])                              # [nb, 32, 16]
    best = np.argmin(errs, axis=-1).astype(np.uint8)            # [nb, 32]
    qs = best.reshape(nb, 2, 16)
    return np.concatenate([e, qs[:, 0] | (qs[:, 1] << 4)],
                          axis=1).reshape(-1)


def mxfp4_dequantize_blocks(raw: np.ndarray, shape) -> np.ndarray:
    """Inverse of :func:`mxfp4_quantize`."""
    b = _blocks(raw, 17)
    d = _e8m0_to_fp32_half(b[:, 0:1])                           # [nb, 1]
    idx = np.concatenate([b[:, 1:] & 0x0F, b[:, 1:] >> 4], axis=1)
    return (d * MXFP4_KVALUES[idx].astype(np.float32)).reshape(shape)


def bf16_quantize(x: np.ndarray) -> np.ndarray:
    """fp32 → bf16 raw bits (uint16), ggml semantics: quiet NaNs, then
    round-to-nearest-even on the top 16 bits."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    u = np.where((u & 0x7FFFFFFF) > 0x7F800000,
                 (u & np.uint32(0xFFFF0000)) | np.uint32(64 << 16), u)
    u = (u.astype(np.uint64) + (0x7FFF + ((u >> 16) & 1))) >> 16
    return u.astype(np.uint16)


def bf16_dequantize(bits: np.ndarray) -> np.ndarray:
    """bf16 raw bits (uint16) → fp32."""
    return (bits.astype(np.uint16).astype(np.uint32) << 16).view(np.float32)


# ---------------------------------------------------------------------------
# K-quant WRITE support. The ggml quantizers pick per-group scales by a
# small search (make_qx_quants / make_qkx2_quants in ggml-quants.c); the
# same algorithm is implemented here vectorized over groups. Bit-exactness
# against ggml's C quantizer is unverifiable in this environment (the
# reference ships only Windows DLLs and its vendored gguf-py has no
# k-quant quantizer), so the tests pin what IS provable: the emitted
# bytes decode identically through our dequantizers and the reference's
# vendored gguf-py, and the search beats a naive absmax encoder on RMSE.
# ---------------------------------------------------------------------------

def _nearest_int(x: np.ndarray) -> np.ndarray:
    """ggml nearest_int: round-half-to-even (the 12582912.0f trick)."""
    return np.rint(x).astype(np.int32)


def _row_chunked(impl, n_out: int, chunk: int):
    """Wrap a [G, ...]-rowwise search so large tensors run in bounded
    memory: the candidate/error broadcasts inside the searches cost
    100s of bytes per element, so a whole-model call must not
    materialize them for every group at once."""
    def run(x, *rest):
        g = x.shape[0]
        if g <= chunk:
            return impl(x, *rest)
        outs = [impl(x[i:i + chunk],
                     *[r[i:i + chunk] for r in rest])
                for i in range(0, g, chunk)]
        return tuple(np.concatenate([o[j] for o in outs], axis=0)
                     for j in range(n_out))
    return run


def _make_qx_quants_impl(x: np.ndarray, nmax: int, qw=None):
    """Symmetric per-group scale search (ggml make_qx_quants, rmse_type 1).

    x: [G, n] float32. Returns (scale [G], L [G, n] ints in [0, 2*nmax-1]).
    Tries iscale = -(nmax + 0.1*is)/signed_absmax for is in {0, ±1..±9},
    keeping the candidate maximizing (Σw·x·L)²/Σw·L² with w = x² — or
    w = ``qw`` [G, n] when given (the imatrix path: callers pass
    importance·sqrt(σ²+x²), ggml's quantize_row_*_impl recipe).
    """
    x = x.astype(np.float32)
    g, n = x.shape
    idx = np.argmax(np.abs(x), axis=1)
    smax = x[np.arange(g), idx]                         # signed absmax [G]
    dead = np.abs(smax) < 1e-30
    safe = np.where(dead, 1.0, smax)

    steps = np.array([0] + list(range(-9, 0)) + list(range(1, 10)),
                     np.float32)
    iscale = (-(nmax + 0.1 * steps)[None, :] / safe[:, None]
              ).astype(np.float32)                      # [G, 19]
    lcand = np.clip(_nearest_int(iscale[:, :, None] * x[:, None, :]),
                    -nmax, nmax - 1)                    # [G, 19, n]
    w = ((x * x) if qw is None
         else qw.astype(np.float32))[:, None, :]
    sumlx = np.sum(w * x[:, None, :] * lcand, axis=2, dtype=np.float32)
    suml2 = np.sum(w * lcand * lcand, axis=2, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        metric = np.where(suml2 > 0, sumlx * sumlx / suml2, -np.inf)
    best = np.argmax(metric, axis=1)                    # first max wins
    gi = np.arange(g)
    L = lcand[gi, best]
    sl, s2 = sumlx[gi, best], suml2[gi, best]
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(s2 > 0, sl / s2, 0.0).astype(np.float32)
    scale = np.where(dead, 0.0, scale)
    L = np.where(dead[:, None], 0, L)
    return scale, L + nmax


def _make_qx_quants(x: np.ndarray, nmax: int, qw=None):
    if qw is None:
        return _row_chunked(lambda c: _make_qx_quants_impl(c, nmax),
                            2, 65536)(x)
    return _row_chunked(lambda c, w: _make_qx_quants_impl(c, nmax, w),
                        2, 65536)(x, qw)


def _expand_qw(qw, x) -> "np.ndarray":
    """Per-input-channel importance [k] (an imatrix row) broadcast to the
    tensor's shape, f32. Callers reshape it in lockstep with x."""
    return np.broadcast_to(np.asarray(qw, np.float32),
                           np.asarray(x).shape).astype(np.float32)


def _imatrix_weights(qw_blocks: np.ndarray, x_blocks: np.ndarray,
                     sigma2: np.ndarray) -> np.ndarray:
    """ggml's quantize_row_*_impl weighting: w = qw * sqrt(sigma2 + x^2),
    with sigma2 the block-scope mean square (broadcast over the block)."""
    return qw_blocks * np.sqrt(sigma2 + x_blocks * x_blocks)


def _make_qkx2_quants_impl(x: np.ndarray, weights: np.ndarray, nmax: int,
                           rmin: float = -1.0, rdelta: float = 0.1,
                           nstep: int = 20, use_mad: bool = False):
    """Asymmetric scale/min search (ggml make_qkx2_quants).

    x, weights: [G, n]. Returns (scale [G], the_min [G], L [G, n]).
    ``use_mad``: weighted absolute error instead of squared (the q2_K
    configuration).
    """
    x = x.astype(np.float32)
    w = weights.astype(np.float32)
    g, n = x.shape
    mn = np.minimum(x.min(axis=1), 0.0)                 # [G]
    mx = x.max(axis=1)
    flat = mx == mn
    span = np.where(flat, 1.0, mx - mn)

    sum_w = w.sum(axis=1)
    sum_x = (w * x).sum(axis=1)

    def quantize_at(iscale):
        return np.clip(_nearest_int(iscale[:, None] * (x - mn[:, None])),
                       0, nmax)

    # baseline: iscale = nmax/(max-min), scale = 1/iscale, min as-is
    iscale0 = (nmax / span).astype(np.float32)
    L = quantize_at(iscale0)
    scale = (1.0 / iscale0).astype(np.float32)
    cur_min = mn.copy()

    def werr(diff):
        pen = np.abs(diff) if use_mad else diff * diff
        return (w * pen).sum(axis=1)

    best_err = werr(scale[:, None] * L + cur_min[:, None] - x)

    for step in range(nstep + 1):
        iscale_t = ((rmin + rdelta * step + nmax) / span).astype(np.float32)
        Lt = quantize_at(iscale_t)
        sum_l = (w * Lt).sum(axis=1)
        sum_l2 = (w * Lt * Lt).sum(axis=1)
        sum_xl = (w * Lt * x).sum(axis=1)
        D = sum_w * sum_l2 - sum_l * sum_l
        with np.errstate(divide="ignore", invalid="ignore"):
            this_scale = (sum_w * sum_xl - sum_x * sum_l) / D
            this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D
            pos = this_min > 0
            this_min = np.where(pos, 0.0, this_min)
            this_scale = np.where(pos,
                                  np.where(sum_l2 > 0, sum_xl / sum_l2, 0.0),
                                  this_scale)
        err = werr(this_scale[:, None] * Lt + this_min[:, None] - x)
        better = (D > 0) & (err < best_err)
        best_err = np.where(better, err, best_err)
        scale = np.where(better, this_scale, scale).astype(np.float32)
        cur_min = np.where(better, this_min, cur_min).astype(np.float32)
        L = np.where(better[:, None], Lt, L)

    scale = np.where(flat, 0.0, scale)
    cur_min = np.where(flat, -mn, -cur_min)  # the_min = -min
    L = np.where(flat[:, None], 0, L)
    return scale, cur_min, L


def _make_qkx2_quants(x: np.ndarray, weights: np.ndarray, nmax: int,
                      rmin: float = -1.0, rdelta: float = 0.1,
                      nstep: int = 20, use_mad: bool = False):
    return _row_chunked(
        lambda c, w: _make_qkx2_quants_impl(c, w, nmax, rmin, rdelta,
                                            nstep, use_mad),
        3, 131072)(x, weights)


def _pack_kquant_scale_min(sc6: np.ndarray, mn6: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_kquant_scale_min`: 6-bit scales/mins [nb, 8]
    → the 12-byte packed table [nb, 12]."""
    sc6 = sc6.astype(np.uint8)
    mn6 = mn6.astype(np.uint8)
    a = (sc6[:, 0:4] & 0x3F) | ((sc6[:, 4:8] >> 4) << 6)
    b = (mn6[:, 0:4] & 0x3F) | ((mn6[:, 4:8] >> 4) << 6)
    c = (sc6[:, 4:8] & 0x0F) | ((mn6[:, 4:8] & 0x0F) << 4)
    return np.concatenate([a, b, c], axis=1)


def _kq45_header(x32: np.ndarray, nmax: int, qw32=None):
    """Shared q4_K/q5_K header math: per-32-value scale/min search, 6-bit
    requantized table, fp16 super scales, final L. x32: [nb, 8, 32].

    Group weights follow ggml quantize_row_q4_K_ref: sigma2 is the mean
    square over the WHOLE 256-value superblock, w = sqrt(sigma2) + |x|.
    With an imatrix (``qw32`` [nb, 8, 32]) the weights become
    qw·sqrt(2·sigma2 + x²) — ggml quantize_row_q4_K_impl.
    """
    nb = x32.shape[0]
    flat = x32.reshape(nb * 8, 32)
    if qw32 is not None:
        sigma2 = 2.0 * (x32.astype(np.float32) ** 2).mean(axis=(1, 2))
        w = _imatrix_weights(qw32.reshape(nb * 8, 32), flat,
                             np.repeat(sigma2, 8)[:, None])
    else:
        av = np.sqrt((x32.astype(np.float32) ** 2).mean(axis=(1, 2)))
        w = np.repeat(av, 8)[:, None] + np.abs(flat)
    scales, mins, _ = _make_qkx2_quants(flat, w, nmax)
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_scale = np.where(max_scale > 0, 63.0 / max_scale, 0.0)
        inv_min = np.where(max_min > 0, 63.0 / max_min, 0.0)
    ls = np.minimum(63, _nearest_int(inv_scale[:, None] * scales))
    lm = np.minimum(63, _nearest_int(inv_min[:, None] * mins))
    d = (max_scale / 63.0).astype(np.float16)
    dmin = (max_min / 63.0).astype(np.float16)
    # requantize against the rounded 6-bit scales (ggml does the same)
    dg = d.astype(np.float32)[:, None] * ls                 # [nb, 8]
    mg = dmin.astype(np.float32)[:, None] * lm
    with np.errstate(divide="ignore", invalid="ignore"):
        q = _nearest_int((x32 + mg[:, :, None]) /
                         np.where(dg == 0, 1.0, dg)[:, :, None])
    q = np.clip(q, 0, nmax)
    q = np.where((dg == 0)[:, :, None], 0, q)
    return d, dmin, _pack_kquant_scale_min(ls, lm), q


def _pack_group_nibbles(q: np.ndarray) -> np.ndarray:
    """[nb, 8, 32] values → [nb, 128] bytes in the ggml sub-block order
    (inverse of :func:`_nibble_rows` with group=32)."""
    nb = q.shape[0]
    pairs = q.reshape(nb, 4, 2, 32).astype(np.uint8)
    return (pairs[:, :, 0] | (pairs[:, :, 1] << 4)).reshape(nb, 128)


def q4_k_quantize(x: np.ndarray, qw=None) -> np.ndarray:
    """Quantize to the 144-byte q4_K superblock stream (ggml
    quantize_row_q4_K_ref algorithm; layout per
    :func:`q4_k_dequantize_blocks`). ``qw``: imatrix row → importance-
    weighted scale/min search (quantize_row_q4_K_impl)."""
    qw32 = None if qw is None else \
        _expand_qw(qw, x).reshape(-1, 8, 32)
    x32 = np.asarray(x, np.float32).reshape(-1, 8, 32)
    d, dmin, table, q = _kq45_header(x32, 15, qw32)
    return np.concatenate([
        d.view(np.uint8).reshape(-1, 2), dmin.view(np.uint8).reshape(-1, 2),
        table, _pack_group_nibbles(q)], axis=1).reshape(-1)


def q5_k_quantize(x: np.ndarray, qw=None) -> np.ndarray:
    """Quantize to the 176-byte q5_K superblock stream (high bit of each
    5-bit value in the 32-byte qh section; layout per
    :func:`q5_k_dequantize_blocks`). ``qw``: as :func:`q4_k_quantize`."""
    qw32 = None if qw is None else \
        _expand_qw(qw, x).reshape(-1, 8, 32)
    x32 = np.asarray(x, np.float32).reshape(-1, 8, 32)
    d, dmin, table, q = _kq45_header(x32, 31, qw32)
    nb = q.shape[0]
    # qh bit b of byte j = bit 4 of value [group b, pos j]
    highs = ((q >> 4) & 1).astype(np.uint8)                # [nb, 8, 32]
    qh = np.zeros((nb, 32), np.uint8)
    for b in range(8):
        qh |= highs[:, b, :] << b
    return np.concatenate([
        d.view(np.uint8).reshape(-1, 2), dmin.view(np.uint8).reshape(-1, 2),
        table, qh, _pack_group_nibbles(q & 0x0F)], axis=1).reshape(-1)


def q6_k_quantize(x: np.ndarray, qw=None) -> np.ndarray:
    """Quantize to the 210-byte q6_K superblock stream (ggml
    quantize_row_q6_K: per-16 symmetric scale search + int8 super-scaled
    scales; layout per :func:`q6_k_dequantize_blocks`). ``qw``: imatrix
    row → weighted search (quantize_row_q6_K_impl)."""
    qw16 = None if qw is None else _expand_qw(qw, x).reshape(-1, 16, 16)
    x16 = np.asarray(x, np.float32).reshape(-1, 16, 16)
    nb = x16.shape[0]
    flat = x16.reshape(nb * 16, 16)
    if qw16 is None:
        scales, _ = _make_qx_quants(flat, 32)
    else:
        sigma2 = 2.0 * (x16 ** 2).mean(axis=(1, 2))
        w = _imatrix_weights(qw16.reshape(nb * 16, 16), flat,
                             np.repeat(sigma2, 16)[:, None])
        scales, _ = _make_qx_quants(flat, 32, w)
    scales = scales.reshape(nb, 16)
    idx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), idx]                 # signed
    dead = np.abs(max_scale) < 1e-30
    safe = np.where(dead, 1.0, max_scale)
    iscale = (-128.0 / safe).astype(np.float32)
    d = np.where(dead, 0.0, 1.0 / iscale).astype(np.float16)
    sc8 = np.minimum(127, _nearest_int(iscale[:, None] * scales)
                     ).astype(np.int8)
    dg = d.astype(np.float32)[:, None] * sc8               # [nb, 16]
    with np.errstate(divide="ignore", invalid="ignore"):
        q = _nearest_int(x16 / np.where(dg == 0, 1.0, dg)[:, :, None])
    q = np.clip(q, -32, 31)
    q = np.where((dg == 0)[:, :, None], 0, q) + 32         # [nb, 16, 16]
    vals = q.reshape(nb, 2, 4, 32).astype(np.uint8)        # chunk, shift, j
    # ql: per 64-wide chunk, (lo nibble, hi nibble) pairs over shifts
    # 0/1 and 2/3 — the exact inverse of q6_k_dequantize_blocks
    lo = vals & 0x0F
    ql = np.concatenate([lo[:, :, 0] | (lo[:, :, 2] << 4),
                         lo[:, :, 1] | (lo[:, :, 3] << 4)],
                        axis=2).reshape(nb, 128)
    hi = (vals >> 4) & 0x03
    qh = (hi[:, :, 0] | (hi[:, :, 1] << 2) | (hi[:, :, 2] << 4)
          | (hi[:, :, 3] << 6)).reshape(nb, 64)
    return np.concatenate([
        ql, qh, sc8.view(np.uint8),
        d.view(np.uint8).reshape(-1, 2)], axis=1).reshape(-1)


# ---------------------------------------------------------------------------
# IQ4 WRITE support. The ggml C quantizer fits a scale to the non-linear
# 16-entry codebook per block (quantize_row_iq4_nl_impl); here the same
# fit runs vectorized: candidate scales around signed-absmax/kv_min, each
# refined by a weighted least-squares step on its codebook assignment,
# best candidate by weighted error. Format-valid output (decode-verified
# against gguf-py); not claimed bit-identical to ggml's C search.
# ---------------------------------------------------------------------------

def _iq4_fit_scale_impl(x: np.ndarray, w: np.ndarray):
    """Fit per-row scales to the IQ4 codebook. x, w: [G, n].
    Returns (d [G] float32, idx [G, n] uint8)."""
    kv = IQ4_KVALUES.astype(np.float32)                  # [16]
    g, n = x.shape
    idxmax = np.argmax(np.abs(x), axis=1)
    smax = x[np.arange(g), idxmax]
    dead = np.abs(smax) < 1e-30
    safe = np.where(dead, 1.0, smax)
    base = (safe / kv[0]).astype(np.float32)             # kv[0] = -127
    steps = 1.0 + 0.04 * np.arange(-8, 9, dtype=np.float32)
    cand = base[:, None] * steps[None, :]                # [G, 17]

    def assign(d):
        # d: [G, C]; nearest codebook entry per value
        err = np.abs(d[:, :, None, None] * kv[None, None, None, :]
                     - x[:, None, :, None])              # [G, C, n, 16]
        return np.argmin(err, axis=-1)                   # [G, C, n]

    q = kv[assign(cand)]                                 # [G, C, n]
    ww = w[:, None, :]
    sumqx = (ww * q * x[:, None, :]).sum(axis=2)
    sumq2 = (ww * q * q).sum(axis=2)
    with np.errstate(divide="ignore", invalid="ignore"):
        d_ls = np.where(sumq2 > 0, sumqx / sumq2, cand)  # LS refit [G, C]
    q2 = kv[assign(d_ls)]
    diff = d_ls[:, :, None] * q2 - x[:, None, :]
    errs = (ww * diff * diff).sum(axis=2)                # [G, C]
    best = np.argmin(errs, axis=1)
    d = d_ls[np.arange(g), best].astype(np.float32)
    d = np.where(dead, 0.0, d)
    # final assignment against the value that will actually be stored
    idx = np.argmin(np.abs(d[:, None, None] * kv[None, None, :]
                           - x[:, :, None]), axis=-1).astype(np.uint8)
    idx = np.where(dead[:, None], 8, idx)        # kv[8] = 1·0 → exact zero
    return d, idx


# the [G, 17, n, 16] candidate-error broadcast costs ~1.1 KB/element —
# chunk to ~70 MB slabs so whole-model tensors quantize in bounded RAM
_iq4_fit_scale = _row_chunked(_iq4_fit_scale_impl, 2, 8192)


def _iq4_pack_nibbles(idx: np.ndarray) -> np.ndarray:
    """[G, 32] codebook indices → [G, 16] bytes ((all-lo, all-hi) order,
    inverse of the iq4 dequantizers)."""
    return (idx[:, :16] | (idx[:, 16:] << 4)).astype(np.uint8)


def iq4_nl_quantize(x: np.ndarray, qw=None) -> np.ndarray:
    """Quantize to the 18-byte IQ4_NL block stream (f16 d + 16 nibble
    bytes into the shared non-linear codebook). ``qw``: imatrix row →
    importance-weighted codebook scale fit."""
    qwb = None if qw is None else _expand_qw(qw, x).reshape(-1, 32)
    x = np.asarray(x, np.float32).reshape(-1, 32)
    if qwb is None:
        w = np.sqrt((x * x).mean(axis=1, keepdims=True)) + np.abs(x)
    else:
        w = _imatrix_weights(qwb, x, (x * x).mean(axis=1, keepdims=True))
    d, idx = _iq4_fit_scale(x, w)
    d16 = d.astype(np.float16)
    # re-assign against the rounded stored scale so encode/decode agree
    df = d16.astype(np.float32)
    kv = IQ4_KVALUES.astype(np.float32)
    idx = np.argmin(np.abs(df[:, None, None] * kv[None, None, :]
                           - x[:, :, None]), axis=-1).astype(np.uint8)
    idx = np.where((df == 0)[:, None], 8, idx)
    return np.concatenate([d16.view(np.uint8).reshape(-1, 2),
                           _iq4_pack_nibbles(idx)], axis=1).reshape(-1)


def iq4_xs_quantize(x: np.ndarray, qw=None) -> np.ndarray:
    """Quantize to the 136-byte IQ4_XS superblock stream: per-32-group
    codebook scales, requantized through a 6-bit (−32..31) table under an
    f16 super scale (layout per :func:`iq4_xs_dequantize_blocks`).
    ``qw``: imatrix row → importance-weighted scale fit."""
    qw32 = None if qw is None else _expand_qw(qw, x).reshape(-1, 8, 32)
    x32 = np.asarray(x, np.float32).reshape(-1, 8, 32)
    nb = x32.shape[0]
    flat = x32.reshape(nb * 8, 32)
    if qw32 is None:
        w = np.sqrt((flat * flat).mean(axis=1, keepdims=True)) \
            + np.abs(flat)
    else:
        sigma2 = 2.0 * (x32 ** 2).mean(axis=(1, 2))
        w = _imatrix_weights(qw32.reshape(nb * 8, 32), flat,
                             np.repeat(sigma2, 8)[:, None])
    g_scale, _ = _iq4_fit_scale(flat, w)
    g_scale = g_scale.reshape(nb, 8)
    idxm = np.argmax(np.abs(g_scale), axis=1)
    smax = g_scale[np.arange(nb), idxm]                  # signed
    dead = np.abs(smax) < 1e-30
    safe = np.where(dead, 1.0, smax)
    d = np.where(dead, 0.0, safe / -32.0).astype(np.float16)
    df = d.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        ls = _nearest_int(g_scale / np.where(df == 0, 1.0, df)[:, None])
    ls = np.clip(ls, -32, 31)                            # [nb, 8]
    dg = df[:, None] * ls                                # [nb, 8]
    kv = IQ4_KVALUES.astype(np.float32)
    idx = np.argmin(np.abs(dg[:, :, None, None] * kv[None, None, None, :]
                           - x32[:, :, :, None]), axis=-1).astype(np.uint8)
    idx = np.where((dg == 0)[:, :, None], 8, idx)
    ls6 = (ls + 32).astype(np.uint8)                     # 0..63
    # scales_l bytes interleave adjacent groups: byte j = g[2j] | g[2j+1]<<4
    sl = (ls6[:, 0::2] & 0x0F) | ((ls6[:, 1::2] & 0x0F) << 4)
    sh = np.zeros(nb, np.uint16)
    for j in range(8):
        sh |= ((ls6[:, j] >> 4).astype(np.uint16)) << (2 * j)
    qs = _iq4_pack_nibbles(idx.reshape(nb * 8, 32)).reshape(nb, 128)
    return np.concatenate([
        d.view(np.uint8).reshape(-1, 2), sh.view(np.uint8).reshape(-1, 2),
        sl, qs], axis=1).reshape(-1)


def q2_k_quantize(x: np.ndarray, qw=None) -> np.ndarray:
    """Quantize to the 84-byte q2_K superblock stream (ggml
    quantize_row_q2_K_ref: per-16 asymmetric scale/min search with |x|
    weights, nmax 3, rmin −0.5, 15 steps, mad error; 4-bit scale/min
    nibbles under f16 super scales)."""
    qw16 = None if qw is None else _expand_qw(qw, x).reshape(-1, 16, 16)
    x16 = np.asarray(x, np.float32).reshape(-1, 16, 16)
    nb = x16.shape[0]
    flat = x16.reshape(nb * 16, 16)
    if qw16 is None:
        w2 = np.abs(flat)
        scales, mins, _ = _make_qkx2_quants(flat, w2, 3,
                                            rmin=-0.5, rdelta=0.1,
                                            nstep=15, use_mad=True)
    else:
        # ggml's imatrix variant (quantize_row_q2_K_impl) searches with
        # weighted MSE over a wider sweep, NOT the ref path's
        # mad/15-step settings — using those with imatrix weights was
        # measured to make held-out PPL WORSE than unweighted
        # (experiments/imatrix_ppl.py)
        sigma2 = 2.0 * (x16 ** 2).mean(axis=(1, 2))
        w2 = _imatrix_weights(qw16.reshape(nb * 16, 16), flat,
                              np.repeat(sigma2, 16)[:, None])
        scales, mins, _ = _make_qkx2_quants(flat, w2, 3,
                                            rmin=-0.9, rdelta=0.05,
                                            nstep=36, use_mad=False)
    scales = scales.reshape(nb, 16)
    mins = mins.reshape(nb, 16)
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_s = np.where(max_scale > 0, 15.0 / max_scale, 0.0)
        inv_m = np.where(max_min > 0, 15.0 / max_min, 0.0)
    ls = np.clip(_nearest_int(inv_s[:, None] * scales), 0, 15)
    lm = np.clip(_nearest_int(inv_m[:, None] * mins), 0, 15)
    d = np.where(max_scale > 0, max_scale / 15.0, 0.0).astype(np.float16)
    dmin = np.where(max_min > 0, max_min / 15.0, 0.0).astype(np.float16)
    dg = d.astype(np.float32)[:, None] * ls                # [nb, 16]
    mg = dmin.astype(np.float32)[:, None] * lm
    with np.errstate(divide="ignore", invalid="ignore"):
        q = _nearest_int((x16 + mg[:, :, None]) /
                         np.where(dg == 0, 1.0, dg)[:, :, None])
    q = np.clip(q, 0, 3)
    q = np.where((dg == 0)[:, :, None], 0, q).astype(np.uint8)
    sc_bytes = (ls | (lm << 4)).astype(np.uint8)           # [nb, 16]
    planes = q.reshape(nb, 2, 4, 32)
    qs = np.zeros((nb, 2, 32), np.uint8)
    for s in range(4):
        qs |= planes[:, :, s, :] << (2 * s)
    return np.concatenate([
        sc_bytes, qs.reshape(nb, 64),
        d.view(np.uint8).reshape(-1, 2),
        dmin.view(np.uint8).reshape(-1, 2)], axis=1).reshape(-1)


def q3_k_quantize(x: np.ndarray, qw=None) -> np.ndarray:
    """Quantize to the 110-byte q3_K superblock stream: per-16 symmetric
    scale search (the make_qx_quants family; ggml's q3 variant adds a
    coordinate-descent refinement — same format either way), 6-bit
    signed scales under an f16 super scale, values in [−4, 3] with the
    high bit mask inverted (layout per :func:`q3_k_dequantize_blocks`)."""
    qw16 = None if qw is None else _expand_qw(qw, x).reshape(-1, 16, 16)
    x16 = np.asarray(x, np.float32).reshape(-1, 16, 16)
    nb = x16.shape[0]
    flat = x16.reshape(nb * 16, 16)
    if qw16 is None:
        scales, _ = _make_qx_quants(flat, 4)
    else:
        sigma2 = 2.0 * (x16 ** 2).mean(axis=(1, 2))
        w = _imatrix_weights(qw16.reshape(nb * 16, 16), flat,
                             np.repeat(sigma2, 16)[:, None])
        scales, _ = _make_qx_quants(flat, 4, w)
    scales = scales.reshape(nb, 16)
    idx = np.argmax(np.abs(scales), axis=1)
    smax = scales[np.arange(nb), idx]
    dead = np.abs(smax) < 1e-30
    safe = np.where(dead, 1.0, smax)
    iscale = (-32.0 / safe).astype(np.float32)
    d = np.where(dead, 0.0, 1.0 / iscale).astype(np.float16)
    s6 = np.clip(_nearest_int(iscale[:, None] * scales), -32, 31)
    dg = d.astype(np.float32)[:, None] * s6                # [nb, 16]
    with np.errstate(divide="ignore", invalid="ignore"):
        q = _nearest_int(x16 / np.where(dg == 0, 1.0, dg)[:, :, None])
    q = np.clip(q, -4, 3)
    l = (np.where((dg == 0)[:, :, None], 0, q) + 4).astype(np.uint8)
    # hmask bit set ⇔ no −4 offset ⇔ stored value ≥ 4; byte j's bit b
    # covers flat value b*32 + j (inverse of the dequant's bit unpack)
    hbit = ((l >> 2) & 1).reshape(nb, 8, 32)               # [nb, bit, j]
    hmask = np.zeros((nb, 32), np.uint8)
    for b in range(8):
        hmask |= hbit[:, b, :] << b
    low = (l & 0x03).reshape(nb, 2, 4, 32)
    qs = np.zeros((nb, 2, 32), np.uint8)
    for s in range(4):
        qs |= low[:, :, s, :] << (2 * s)
    s6b = (s6 + 32).astype(np.uint8)                       # 0..63 biased
    ls_lo = (s6b[:, 0:8] & 0x0F) | ((s6b[:, 8:16] & 0x0F) << 4)
    hs = np.zeros((nb, 4), np.uint8)
    for s in range(4):
        hs |= (s6b[:, 4 * s:4 * s + 4] >> 4) << (2 * s)
    return np.concatenate([
        hmask, qs.reshape(nb, 64), ls_lo, hs,
        d.view(np.uint8).reshape(-1, 2)], axis=1).reshape(-1)
