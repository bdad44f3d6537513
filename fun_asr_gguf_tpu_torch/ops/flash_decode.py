"""K2: decode attention over one layer of a bf16 KV cache.

Counterpart of ``fun_asr_gguf_tpu/ops/flash_decode.py``
(``flash_decode_attention`` :132, bf16-cache branch) with the numerics of
``fun_asr_gguf_tpu/models/qwen3.py:_attend_cache`` :315: f32 scores, an
exact softmax over the whole cache row, probabilities normalised in f32
(``max(l, 1e-30)`` clamp) then cast to the cache dtype for the mix, f32
accumulation, output in the cache dtype. The CUDA kernel is
``csrc/flash_decode.cu`` (one block per (kv head, batch row); its note says
what bounds it). It serves the decode step (T = 1) and the speculative
verify step (T = spec_k + 1 query rows).

GQA: query head ``h`` reads kv head ``h // group``. The int8-cache variant
(scales commuted out of the contraction) is not ported yet.

Dispatch is by device only: CPU tensors take :func:`flash_decode_plain`,
CUDA tensors launch the kernel or raise.
"""

import torch

MAX_ROWS = 18          # T * group query rows per kernel block (verify at
                       # spec_k = 8: 9 rows x GQA group 2)
HEAD_DIM = 128

launches = 0


def flash_decode_plain(q, k, v, bias):
    """q [B,T,qh,hd] pre-scaled, k/v [B,S,kh,hd], bias [B,T,S] f32
    → [B,qh,T,hd] in v's dtype."""
    b, t, qh, hd = q.shape
    kh = k.shape[2]
    group = qh // kh
    qg = q.reshape(b, t, kh, group, hd).to(torch.float32)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.to(torch.float32))
    scores = scores + bias.to(torch.float32)[:, None, None, :, :]
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    probs = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    probs = probs.to(v.dtype).to(torch.float32)
    out = torch.einsum("bkgts,bskd->bkgtd", probs, v.to(torch.float32))
    return out.reshape(b, qh, t, hd).to(v.dtype)


def flash_decode_attention(q, k, v, bias):
    """Fused decode attention (kernel on CUDA); see :func:`flash_decode_plain`."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, bias)
    return _launch(q, k, v, bias)


def _launch(q, k, v, bias):
    global launches
    from ..kernels import build
    b, t, qh, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    if (k.shape != (b, s, kh, hd) or v.shape != k.shape
            or tuple(bias.shape) != (b, t, s)):
        raise ValueError(f"flash_decode shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, bias "
                         f"{tuple(bias.shape)}")
    if hd != HEAD_DIM or qh % kh or t * (qh // kh) > MAX_ROWS:
        raise ValueError(f"flash_decode kernel takes head_dim {HEAD_DIM} and "
                         f"T*group <= {MAX_ROWS}, got hd={hd}, T={t}, "
                         f"qh={qh}, kh={kh}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and bias.dtype == torch.float32):
        raise TypeError(f"flash_decode kernel takes bf16 q/k/v and f32 bias, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}, {bias.dtype}")
    if not all(a.is_cuda and a.device == q.device for a in (k, v, bias)):
        raise ValueError("flash_decode: all inputs must be on one CUDA device")
    if not all(a.is_contiguous() for a in (q, k, v, bias)):
        raise ValueError("flash_decode kernel takes contiguous inputs")
    rows = t * (qh // kh)
    smem = (-(-rows * s // 4) * 4 + 8 * rows * hd) * 4
    if smem > 227 * 1024:
        raise ValueError(f"flash_decode: cache length {s} needs {smem} B of "
                         "shared memory (split-KV is not implemented)")
    out = torch.empty((b, qh, t, hd), dtype=q.dtype, device=q.device)
    code = build.lib().flash_decode_bf16(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(bias),
        build.ptr(out), b, t, qh, kh, s, hd, build.stream_ptr(q.device))
    build.check(code, "flash_decode_bf16")
    launches += 1
    return out
