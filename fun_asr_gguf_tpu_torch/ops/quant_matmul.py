"""K1: q8_0 dequant-matmul, K4: the fused per-layer q8_0 chain, plus the
weight representation and dispatch.

Counterpart of ``fun_asr_gguf_tpu/ops/quant_matmul.py`` (``quant_matmul``
:176, ``_quant_matmul_impl`` :206, ``quant_matmul_indexed`` :303,
``q8_mlp_fused`` :649, ``q8_mlp_qkv_fused`` :832 and ``matmul_any``
:1690). The CUDA kernels are ``csrc/q8_matmul.cu`` (K1) and
``csrc/q8_layer_fused.cu`` (K4); their source notes say what bounds them on
the H100 and what their designs do about it.

Weights stay in the GGUF q8_0 form: ``Q8Weight(q=[..., n, k] int8,
d=[..., n, k/32] f32)`` in NATURAL k order — the TPU's block-permuted lane
order (``block_permute``) does not exist on the GPU. A layer of a stacked
``[L, n, k]`` weight is a view (:func:`layer`), i.e. a pointer offset.
Per-channel int8 (:class:`Int8Weight`) and dense weights take plain f32
products in :func:`matmul_any`; they never reach K1.

Numerics (both versions): ``y = bf16(x) @ bf16(q * d)^T`` with the product
``q * d`` formed in f32 and rounded to bf16 once, f32 accumulation, f32
output — the JAX reference path's contract. ``x`` is rounded to bf16 even
when the caller computes in float32.

Dispatch is by device only: a CPU tensor takes :func:`q8_matmul_plain`; a
CUDA tensor launches the kernel or raises on a layout it does not take.
"""

from typing import NamedTuple

import torch

BLOCK = 32
FUSED_MAX_ROWS = 16   # K4 serves decode (m = 1) and verify (m = spec_k + 1)

launches = 0          # K1 launches since the last reset (plain int)
fused_launches = 0    # K4 launches since the last reset


class Q8Weight(NamedTuple):
    q: torch.Tensor   # int8 [..., n, k]   natural k order
    d: torch.Tensor   # f32  [..., n, k // 32]

    @property
    def shape(self):
        return self.q.shape


class Int8Weight(NamedTuple):
    """Per-channel int8 weight (JAX ``models/qwen3.py`` ``Int8Weight`` :40):
    ``w8 [..., k, n]`` int8 and one bf16 scale per output channel,
    ``scale [..., 1, n]``. Its product is a plain one (:func:`matmul_any`),
    as in JAX, where XLA and not a Pallas kernel computes it."""
    w8: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.w8.shape


def layer(w, i: int):
    """Layer ``i`` of a stacked [L, ...] weight (a view, no copy)."""
    return type(w)(*(t[i] for t in w))


def dequantize(w: Q8Weight) -> torch.Tensor:
    """[n, k] weight in bf16: q * d in f32, rounded to bf16 once."""
    n, k = w.q.shape[-2], w.q.shape[-1]
    deq = (w.q.to(torch.float32).reshape(*w.q.shape[:-1], k // BLOCK, BLOCK)
           * w.d[..., None])
    return deq.reshape(*w.q.shape[:-2], n, k).to(torch.bfloat16)


def q8_matmul_plain(x: torch.Tensor, w: Q8Weight) -> torch.Tensor:
    """Plain PyTorch version: x [m, k] → [m, n] f32. bf16 x bf16 products
    are exact in f32, so the f32 matmul of the upcast operands is the
    bf16-in / f32-accumulate product."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xb, dequantize(w).to(torch.float32).t())


def q8_matmul(x: torch.Tensor, w: Q8Weight) -> torch.Tensor:
    """x [m, k] × q8_0 W [n, k] → [m, n] f32 (kernel on CUDA)."""
    if x.device.type == "cpu":
        return q8_matmul_plain(x, w)
    return _launch(x, w)


def _launch(x: torch.Tensor, w: Q8Weight) -> torch.Tensor:
    global launches
    from ..kernels import build
    if x.dim() != 2 or w.q.dim() != 2:
        raise ValueError(f"q8_matmul takes x [m, k] and q [n, k], got "
                         f"{tuple(x.shape)} and {tuple(w.q.shape)}")
    m, k = x.shape
    n = w.q.shape[0]
    if w.q.shape[1] != k or k % BLOCK or tuple(w.d.shape) != (n, k // BLOCK):
        raise ValueError(f"q8_matmul shape mismatch: x {tuple(x.shape)}, "
                         f"q {tuple(w.q.shape)}, d {tuple(w.d.shape)}")
    if w.q.dtype != torch.int8 or w.d.dtype != torch.float32:
        raise TypeError(f"q8_matmul takes int8 q and f32 d, got {w.q.dtype} "
                        f"and {w.d.dtype}")
    if not (w.q.is_cuda and w.d.is_cuda and w.q.device == x.device
            and w.d.device == x.device):
        raise ValueError("q8_matmul: x, q and d must be on the same CUDA "
                         "device")
    if not (w.q.is_contiguous() and w.d.is_contiguous()):
        raise ValueError("q8_matmul takes contiguous q and d")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16 or w.q.data_ptr() % 16:
        raise ValueError("q8_matmul needs 16-byte aligned x and q")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    code = build.lib().q8_matmul(build.ptr(xb), build.ptr(w.q),
                                 build.ptr(w.d), build.ptr(y), m, n, k,
                                 build.stream_ptr(x.device))
    build.check(code, "q8_matmul")
    launches += 1
    return y


def _rms_f32(x, w, eps):
    """``(x * rsqrt(mean(x^2) + eps)) * w`` in f32 (JAX ``_rms_apply``)."""
    return (x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
            ) * w.to(torch.float32)


def q8_mlp_fused_plain(xm, resid, post_w, o_w: Q8Weight, gu_w: Q8Weight,
                       down_w: Q8Weight, eps: float) -> torch.Tensor:
    """Plain version of K4 without the next-layer stage (JAX
    ``_q8_mlp_fused_ref`` :623 in natural order): xm [m, qd], resid [m, h]
    → the new residual [m, h] f32. :func:`q8_matmul_plain` rounds each
    product's activations to bf16, as the reference's ``astype`` calls do."""
    h = q8_matmul_plain(xm, o_w) + resid.to(torch.float32)
    gu = q8_matmul_plain(_rms_f32(h, post_w, eps), gu_w)
    f = gu.shape[-1] // 2
    act = torch.nn.functional.silu(gu[:, :f]) * gu[:, f:]
    return q8_matmul_plain(act, down_w) + h


def q8_mlp_qkv_fused_plain(xm, resid, post_w, next_in_w, o_w: Q8Weight,
                           gu_w: Q8Weight, down_w: Q8Weight,
                           next_qkv_w: Q8Weight, eps: float):
    """Plain version of K4 (JAX ``_q8_mlp_qkv_fused_ref`` :814): the chain
    above, then the next layer's input RMSNorm and packed qkv → (out
    [m, h] f32, qkv [m, nq] f32)."""
    out = q8_mlp_fused_plain(xm, resid, post_w, o_w, gu_w, down_w, eps)
    return out, q8_matmul_plain(_rms_f32(out, next_in_w, eps), next_qkv_w)


def q8_mlp_qkv_fused(xm, resid, post_w, next_in_w, o_w: Q8Weight,
                     gu_w: Q8Weight, down_w: Q8Weight, next_qkv_w: Q8Weight,
                     eps: float):
    """One layer's o-proj + residual → post norm → gate_up → SiLU gate →
    down + residual → the next layer's input norm → its packed qkv, in one
    launch on CUDA. See :func:`q8_mlp_qkv_fused_plain`."""
    if xm.device.type == "cpu":
        return q8_mlp_qkv_fused_plain(xm, resid, post_w, next_in_w, o_w,
                                      gu_w, down_w, next_qkv_w, eps)
    return _launch_fused(xm, resid, post_w, next_in_w, o_w, gu_w, down_w,
                         next_qkv_w, eps)


def q8_mlp_fused(xm, resid, post_w, o_w: Q8Weight, gu_w: Q8Weight,
                 down_w: Q8Weight, eps: float) -> torch.Tensor:
    """The chain without the next-layer stage (the last layer), the same
    kernel on CUDA. See :func:`q8_mlp_fused_plain`."""
    if xm.device.type == "cpu":
        return q8_mlp_fused_plain(xm, resid, post_w, o_w, gu_w, down_w, eps)
    return _launch_fused(xm, resid, post_w, None, o_w, gu_w, down_w, None,
                         eps)[0]


def _launch_fused(xm, resid, post_w, next_in_w, o_w, gu_w, down_w,
                  next_qkv_w, eps):
    global fused_launches
    from ..kernels import build
    if xm.dim() != 2 or resid.dim() != 2:
        raise ValueError(f"q8 layer chain takes xm [m, qd] and resid [m, h], "
                         f"got {tuple(xm.shape)} and {tuple(resid.shape)}")
    m, qd = xm.shape
    h = resid.shape[1]
    f = down_w.q.shape[-1]
    with_qkv = next_qkv_w is not None
    nq = next_qkv_w.q.shape[0] if with_qkv else 0
    if not 1 <= m <= FUSED_MAX_ROWS:
        raise ValueError(f"q8 layer chain kernel takes 1..{FUSED_MAX_ROWS} "
                         f"rows, got m={m}")
    weights = [(o_w, (h, qd)), (gu_w, (2 * f, h)), (down_w, (h, f))]
    if with_qkv:
        weights.append((next_qkv_w, (nq, h)))
    norms = [post_w] + ([next_in_w] if with_qkv else [])
    if (resid.shape[0] != m or any(tuple(w.q.shape) != s
                                   or tuple(w.d.shape) != (s[0], s[1] // BLOCK)
                                   for w, s in weights)
            or any(tuple(n.shape) != (h,) for n in norms)
            or qd % BLOCK or h % BLOCK or f % BLOCK):
        raise ValueError(
            f"q8 layer chain shapes: xm {tuple(xm.shape)}, resid "
            f"{tuple(resid.shape)}, norms {[tuple(n.shape) for n in norms]}, "
            f"weights {[(tuple(w.q.shape), tuple(w.d.shape)) for w, _ in weights]}")
    if not all(a.dtype == torch.bfloat16 for a in [xm, resid] + norms):
        raise TypeError("q8 layer chain kernel takes bf16 activations and "
                        "norm weights, got "
                        f"{[a.dtype for a in [xm, resid] + norms]}")
    if not all(w.q.dtype == torch.int8 and w.d.dtype == torch.float32
               for w, _ in weights):
        raise TypeError("q8 layer chain kernel takes int8 q and f32 d")
    tensors = [xm, resid] + norms + [t for w, _ in weights for t in w]
    if not all(t.is_cuda and t.device == xm.device for t in tensors):
        raise ValueError("q8 layer chain: all inputs must be on one CUDA "
                         "device")
    if not all(t.is_contiguous() for t in tensors[2:]):
        raise ValueError("q8 layer chain kernel takes contiguous weights")
    xm, resid = xm.contiguous(), resid.contiguous()
    if any(t.data_ptr() % 16 for t in tensors[2:] + [xm, resid]):
        raise ValueError("q8 layer chain kernel needs 16-byte aligned inputs")
    dev = xm.device
    h1 = torch.empty((m, h), dtype=torch.float32, device=dev)
    act = torch.empty((m, f), dtype=torch.bfloat16, device=dev)
    out = torch.empty((m, h), dtype=torch.float32, device=dev)
    qkv = torch.empty((m, nq), dtype=torch.float32, device=dev)
    null = build.ctypes.c_void_p(None)
    code = build.lib().q8_layer_fused(
        build.ptr(xm), build.ptr(resid), build.ptr(post_w),
        build.ptr(next_in_w) if with_qkv else null,
        build.ptr(o_w.q), build.ptr(o_w.d), build.ptr(gu_w.q),
        build.ptr(gu_w.d), build.ptr(down_w.q), build.ptr(down_w.d),
        build.ptr(next_qkv_w.q) if with_qkv else null,
        build.ptr(next_qkv_w.d) if with_qkv else null,
        build.ptr(h1), build.ptr(act), build.ptr(out), build.ptr(qkv),
        m, qd, h, f, nq, float(eps), build.stream_ptr(dev))
    build.check(code, "q8_layer_fused")
    fused_launches += 1
    return out, qkv


def matmul_any(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` in f32 for a q8_0 (K1), per-channel int8 or dense weight;
    leading batch dims on ``x`` are flattened (JAX ``matmul_any`` and
    ``_proj``'s ``Int8Weight`` branch, ``qwen3.py:425-431``).

    The int8 and dense products are plain PyTorch in f32: both operands
    upcast (int8 and bf16 values are exact in f32, so this is JAX's
    ``preferred_element_type=f32`` dot, without the bf16 rounding of the
    output that a bf16 ``torch.matmul`` on CUDA would add), then the int8
    weight's f32 per-channel scale."""
    if isinstance(w, Q8Weight):
        lead = x.shape[:-1]
        out = q8_matmul(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*lead, out.shape[-1])
    if isinstance(w, Int8Weight):
        return (torch.matmul(x.to(torch.float32), w.w8.to(torch.float32))
                * w.scale.to(torch.float32))
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))
