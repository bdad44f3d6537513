"""K1: q8_0 dequant-matmul, K4 / K4c: the fused per-layer q8_0 chain (with
the next layer's qkv, or with the final norm and the head), K5: the whole
b = 1 q8_0 decode step, K6 / K7: the int8-dot product and layer chain,
plus the weight representation and dispatch.

Counterpart of ``fun_asr_gguf_tpu/ops/quant_matmul.py`` (``quant_matmul``
:176, ``_quant_matmul_impl`` :206, ``quant_matmul_indexed`` :303,
``q8_mlp_fused`` :649, ``q8_mlp_qkv_fused`` :832, ``q8_layer_head_fused``
:953, ``quantize_act_q8`` :1340, ``q8dot_matmul`` :1416,
``q8i_layer_fused`` :1586, ``q8_decode_all_fused`` :1970 and ``matmul_any``
:1690). The CUDA kernels are ``csrc/q8_matmul.cu`` (K1 and K6: at m <= 16
one kernel templated on the dot contract, its split and layout from
:func:`q8_matvec_split`), ``csrc/q8_gemm.cu`` (K1 above 16 rows, the
prefill GEMM on warpgroup MMA, its x panels and cluster k split from
:func:`q8_gemm_plan`),
``csrc/q8_layer_fused.cu`` (K4, K4c and K7: one kernel templated on the
dot contract) and ``csrc/q8_decode_all.cu`` (K5); their source notes say
what bounds them on the H100 and what their designs do about it.

Weights stay in the GGUF q8_0 form: ``Q8Weight(q=[..., n, k] int8,
d=[..., n, k/32] f32)`` in NATURAL k order — the TPU's block-permuted lane
order (``block_permute``) does not exist on the GPU. A layer of a stacked
``[L, n, k]`` weight is a view (:func:`layer`), i.e. a pointer offset.
Per-channel int8 (:class:`Int8Weight`) and dense weights take plain f32
products in :func:`matmul_any`; they never reach K1.

Numerics (both versions): ``y = bf16(x) @ bf16(q * d)^T`` with the product
``q * d`` formed in f32 and rounded to bf16 once, f32 accumulation, f32
output — the JAX reference path's contract. ``x`` is rounded to bf16 even
when the caller computes in float32. ``out_dtype`` asks for another
output type: the f32 result cast to it (the prefill GEMM writes bf16
itself, from the same f32 sums).

A :class:`Q8DotWeight` holds the same bytes as a :class:`Q8Weight` and
selects the other contract, llama.cpp's q8_0 x q8_0 ``vec_dot`` (JAX's
``QuantTensorN`` path): the activations are quantized to q8_0 per 32-block
(:func:`quantize_act_q8`), s8 x s8 partials are exact per block, both
block scales multiply the partial, the partials are summed in f32. K6 and
K7 compute it; above 16 rows :func:`matmul_any` takes K1's dequant product
on the same bytes, as JAX does.

Dispatch is by device only: a CPU tensor takes the plain version (e.g.
:func:`q8_matmul_plain`); a CUDA tensor launches the kernel or raises on a
layout it does not take.
"""

import os
from typing import NamedTuple

import torch

from ..models.common import apply_rope

BLOCK = 32
FUSED_MAX_ROWS = 16   # K4 serves decode (m = 1) and verify (m = spec_k + 1)

launches = 0              # K1 launches at m <= 16 since the last reset
gemm_launches = 0         # K1's prefill GEMM launches (m > 16)
fused_launches = 0        # K4 launches since the last reset
head_fused_launches = 0   # K4c launches (K4 with the head in the qkv slot)
mega_launches = 0         # K5 launches
q8dot_launches = 0        # K6 launches
q8i_launches = 0          # K7 launches


class Q8Weight(NamedTuple):
    q: torch.Tensor   # int8 [..., n, k]   natural k order
    d: torch.Tensor   # f32  [..., n, k // 32]

    @property
    def shape(self):
        return self.q.shape


class Q8DotWeight(NamedTuple):
    """The tensors of a :class:`Q8Weight`, relabelled (never copied) for
    the int8-dot contract (JAX ``QuantTensorN`` :1313)."""
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


def q8_matmul(x: torch.Tensor, w: Q8Weight,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [m, k] × q8_0 W [n, k] → [m, n] f32, or the f32 product cast to
    ``out_dtype`` (kernel on CUDA)."""
    if x.device.type == "cpu":
        return q8_matmul_plain(x, w).to(out_dtype)
    return _launch(x, w, out_dtype)


def _launch(x: torch.Tensor, w: Q8Weight, out_dtype) -> torch.Tensor:
    global launches, gemm_launches
    from ..kernels import build
    if x.dim() != 2 or w.q.dim() != 2:
        raise ValueError(f"q8_matmul takes x [m, k] and q [n, k], got "
                         f"{tuple(x.shape)} and {tuple(w.q.shape)}")
    m, k = x.shape
    n = w.q.shape[0]
    if m < 1 or n < 1:
        raise ValueError(f"q8_matmul takes at least one row of x and of q, "
                         f"got m={m}, n={n}")
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
    if xb.data_ptr() % 16 or w.q.data_ptr() % 16 or w.d.data_ptr() % 16:
        raise ValueError("q8_matmul needs 16-byte aligned x, q and d")
    if m <= MATVEC_MAX_ROWS:
        _matvec_plan(x.device, n, k, m, q8i=False)
        y = torch.empty((m, n), dtype=torch.float32, device=x.device)
        code = build.lib().q8_matmul(build.ptr(xb), build.ptr(w.q),
                                     build.ptr(w.d), build.ptr(y), m, n, k,
                                     build.stream_ptr(x.device))
        build.check(code, "q8_matmul")
        launches += 1
        return y.to(out_dtype)
    plan = q8_gemm_plan(m, n, k, build.sm_count(x.device))
    bf16_out = out_dtype == torch.bfloat16
    y = torch.empty((m, n), dtype=torch.bfloat16 if bf16_out
                    else torch.float32, device=x.device)
    code = build.lib().q8_gemm(build.ptr(xb), build.ptr(w.q), build.ptr(w.d),
                               build.ptr(y), m, n, k, int(bf16_out),
                               plan.rows, plan.splits,
                               build.stream_ptr(x.device))
    build.check(code, "q8_gemm")
    gemm_launches += 1
    return y.to(out_dtype)


# K1's prefill GEMM (csrc/q8_gemm.cu q8_gemm_kernel): a block's weight
# rows and k columns a stage, its x panels' rows, and the k split's limit
# and least share
GEMM_ROWS = 128
GEMM_STEP = 64
GEMM_PANELS = (64, 128)
GEMM_MAX_SPLITS = 4
GEMM_MIN_SPLIT_STAGES = 8


class GemmPlan(NamedTuple):
    """K1's prefill GEMM over ``panels`` panels of ``rows`` rows of x, each
    against every :data:`GEMM_ROWS`-row tile of the weight (``tiles``), k
    split over ``splits`` blocks of a cluster: ``splits * tiles * panels``
    blocks."""
    rows: int
    panels: int
    splits: int
    tiles: int

    @property
    def blocks(self) -> int:
        return self.splits * self.tiles * self.panels


def q8_gemm_plan(m: int, n: int, k: int, sms: int = 132) -> GemmPlan:
    """The grid of K1's prefill GEMM on a card of ``sms`` SMs: x in panels
    of 128 rows (one of 64 where m <= 64); then k split in two while the
    doubled grid still fits one wave of one block an SM and each split
    keeps :data:`GEMM_MIN_SPLIT_STAGES` 64-column stages, at most
    :data:`GEMM_MAX_SPLITS` ways (measured on an H100: more, shorter
    splits lose more to the cluster's combine than they gain in blocks).
    Qwen3-0.6B at m = 256: qkv 2 splits (128 blocks), gate_up 1 (96), o
    and down 4 (64)."""
    rows = GEMM_PANELS[0] if m <= GEMM_PANELS[0] else GEMM_PANELS[1]
    panels = -(-m // rows)
    tiles = -(-n // GEMM_ROWS)
    stages = -(-k // GEMM_STEP)
    splits = 1
    while (splits < GEMM_MAX_SPLITS
           and stages >= 2 * splits * GEMM_MIN_SPLIT_STAGES
           and 2 * splits * tiles * panels <= sms):
        splits *= 2
    return GemmPlan(rows, panels, splits, tiles)


MATVEC_MAX_ROWS = 16   # K1 at m <= 16 and K6: the decode-sized product
# the layout's ints, in the order csrc/q8_matmul.cu reads them
K1_LAYOUT = ("x", "red", "bars", "ring", "slot", "rows", "depth", "xcols",
             "xstride")
K1_TILE_ROWS = 64      # rows of a ring tile, at most: eight 8-row subtiles
K1_MAX_DEPTH = 16      # ring slots, at most
K1_MISC = 8 * K1_MAX_DEPTH   # their mbarriers


class MatvecSplit(NamedTuple):
    """The decode-sized product's work split over a grid of ``blocks``
    blocks and the shared-memory layout it implies (``csrc/q8_matmul.cu``
    ``q8_matvec_kernel``: :data:`K1_LAYOUT`; the kernel computes block
    b's first row as ``b * n // blocks``, the rule of ``starts``)."""
    starts: torch.Tensor  # int32 [blocks + 1]: block b's rows are
                          # [starts[b], starts[b + 1])
    layout: dict          # K1_LAYOUT name -> int (byte offsets, sizes, ...)
    smem: int             # bytes of dynamic shared memory a block
    per_sm: int           # blocks an SM the layout is sized for

    @property
    def blocks(self) -> int:
        return self.starts.shape[0] - 1


def q8_matvec_split(n: int, k: int, m: int, blocks: int, q8i: bool = False,
                    per_sm: int = 2) -> MatvecSplit:
    """The split and shared-memory layout of the decode-sized q8_0
    product (K1 at m <= 16 and K6, ``q8i``) of an [n, k] weight against
    ``m`` activation rows on ``blocks`` blocks, ``per_sm`` of them an SM:
    block b takes the contiguous rows [b n // blocks, (b + 1) n // blocks)
    (counts differ by at most one), which arrive as a ring of ``rows``-row
    tiles (int8 rows, then their f32 scales; slots of 16-byte multiples).
    Beside the ring: the activation rows (K1 bf16 rows of ``xcols``
    columns padded by 16 bytes, K6 q8_0 rows, see
    :func:`k7_activation_bytes`), two buffers of the eight warps' partial
    tiles and the ring's mbarriers. The warps' eight items of a tile are
    its 8-row subtiles, each cut into slices of its 64-column spans (a
    64-row tile: whole rows, one a warp). The tile is
    :data:`K1_TILE_ROWS` rows (fewer where a block has fewer, or shared
    memory has no room for two), the ring as deep as the block's shared
    memory allows (at most :data:`K1_MAX_DEPTH`, two slots where a block
    has more than one tile); where m rows of k columns leave no room for
    that, they are taken in column chunks of whole spans. The partial tiles
    hold 8 activation rows at m <= 8, 16 above (the kernel's two modes). A
    layout sized for m serves any row count of m's class (1, 2..8, 9..16).
    A pure function of its arguments."""
    if not 1 <= m <= MATVEC_MAX_ROWS:
        raise ValueError(f"the decode-sized q8_0 product takes "
                         f"1..{MATVEC_MAX_ROWS} rows, got m={m}")
    if n < 1 or k < BLOCK or k % BLOCK or blocks < 1 or per_sm < 1:
        raise ValueError(f"q8_matvec_split: n={n}, k={k} (a multiple of "
                         f"{BLOCK}), blocks={blocks}, per_sm={per_sm}")
    budget = min(K4_SMEM_BLOCK, K4_SMEM_SM // per_sm - K4_SMEM_RESERVED)
    b = torch.arange(blocks + 1, dtype=torch.int64)
    starts = (b * n // blocks).to(torch.int32)
    most = -(-n // blocks)
    spans = -(-k // K4_SPAN)
    red = K4_WARPS * (128 if m > 8 else 64)   # floats of the partial tiles
    rows_all = []
    r = min(K1_TILE_ROWS, most)
    while r >= 1:
        rows_all.append(r)
        r //= 2
    for xcols in range(spans * K4_SPAN, 0, -K4_SPAN):
        if q8i:
            xstride, x_bytes = k7_activation_bytes(max(m, 2), xcols)
        else:
            xstride = 2 * xcols + 16
            x_bytes = m * xstride
        for rows in rows_all:
            tiles = -(-most // rows)
            slot = _r16(mega_slab_bytes(rows, k))
            base = _r16(x_bytes) + _r16(2 * 4 * red) + _r16(K1_MISC)
            depth = min(K1_MAX_DEPTH, tiles, max(0, budget - base) // slot)
            if depth < min(2, tiles):
                continue
            off = dict(x=0, red=_r16(x_bytes))
            off["bars"] = off["red"] + _r16(2 * 4 * red)
            off["ring"] = off["bars"] + _r16(K1_MISC)
            layout = dict(off, slot=slot, rows=rows, depth=depth,
                          xcols=xcols, xstride=xstride)
            return MatvecSplit(starts, layout, off["ring"] + depth * slot,
                               per_sm)
    raise ValueError(f"q8_matvec_split: no shared-memory layout of {budget} "
                     f"bytes a block at n={n}, k={k}, m={m}")


def matvec_blocks_per_sm(n: int, sms: int):
    """The blocks an SM the decode-sized product tries, in order: two
    where each block gets at least one 8-row subtile (an mma's weight
    rows) of the n rows, else one (o and down: 8 rows a block, not 4)."""
    return (2, 1) if n >= 2 * sms * K4_TILE else (1, 2)


_matvec_plans = {}


def _matvec_plan(dev, n, k, m, q8i):
    """The decode-sized product's split on the card's co-resident grid
    (blocks an SM as :func:`matvec_blocks_per_sm` orders them, the first
    whose layout fits), sized for the largest m of m's class and registered
    with the kernel library (``q8_matvec_plan``), cached per (device, n, k,
    m class, contract)."""
    from ..kernels import build
    rows = 1 if m == 1 else 8 if m <= 8 else MATVEC_MAX_ROWS
    key = (dev.index, n, k, rows, q8i)
    split = _matvec_plans.get(key)
    if split is None:
        sms = build.sm_count(dev)
        splits = []
        for per_sm in matvec_blocks_per_sm(n, sms):
            try:
                splits.append(q8_matvec_split(n, k, rows, per_sm * sms, q8i,
                                              per_sm))
            except ValueError:   # half an SM's shared memory is too little
                pass
        if not splits:
            raise ValueError(f"q8_matvec_split: no shared-memory layout at "
                             f"n={n}, k={k}, m={m}")
        for split in splits:
            layout = (build.ctypes.c_int * len(K1_LAYOUT))(
                *(split.layout[name] for name in K1_LAYOUT))
            if build.grid_blocks("q8_matvec_plan", n, k, rows, int(q8i),
                                 layout, split.blocks,
                                 split.smem) >= split.blocks:
                break
        else:
            raise RuntimeError(f"q8_matvec_plan: no co-resident grid at "
                               f"n={n}, k={k}, m={m}")
        _matvec_plans[key] = split
    return split


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


def q8_layer_head_fused_plain(xm, resid, post_w, final_w, o_w: Q8Weight,
                              gu_w: Q8Weight, down_w: Q8Weight,
                              head_w: Q8Weight, eps: float):
    """Plain version of K4c (JAX ``q8_layer_head_fused(use_pallas=False)``
    :990-995): :func:`q8_mlp_qkv_fused_plain` with the final norm and the
    q8_0 head in the next-layer slot → (new residual [m, h] f32, logits
    [m, vocab_pad] f32)."""
    return q8_mlp_qkv_fused_plain(xm, resid, post_w, final_w, o_w, gu_w,
                                  down_w, head_w, eps)


def fused_head_on() -> bool:
    """Whether ``FUNASR_Q8_FUSED_HEAD`` is set and not ``"0"``, as it reads
    now."""
    return os.environ.get("FUNASR_Q8_FUSED_HEAD", "0") != "0"


def q8_layer_head_fused(xm, resid, post_w, final_w, o_w: Q8Weight,
                        gu_w: Q8Weight, down_w: Q8Weight, head_w: Q8Weight,
                        eps: float):
    """The last layer's chain, its final norm and the q8_0 head in one
    launch on CUDA (K4c: K4 with ``final_w`` as the next norm and the head
    as the next qkv) → (new residual, logits), see
    :func:`q8_layer_head_fused_plain`; ``None`` unless
    ``FUNASR_Q8_FUSED_HEAD`` is set and not ``"0"`` (JAX's knob for the
    last layer's kernel path, read at call time as in ``quant_matmul.py:
    996-1003``). The knob decides on both devices, so the CPU runs the
    path the card runs; JAX on the CPU (``use_pallas=False``) takes its
    fused reference whatever the knob says."""
    if not fused_head_on():
        return None
    if xm.device.type == "cpu":
        return q8_layer_head_fused_plain(xm, resid, post_w, final_w, o_w,
                                         gu_w, down_w, head_w, eps)
    return _launch_fused(xm, resid, post_w, final_w, o_w, gu_w, down_w,
                         head_w, eps, head=True)


K4_MATS = ("o", "gate_up", "down", "qkv")   # K4's split table rows (qkv:
                                            # the head in K4c)
# the plan's leading ints, in the order csrc/q8_layer_fused.cu reads them
K4_LAYOUT = ("x", "red", "bars", "slot_o", "slot_gate_up", "slot_down",
             "slot_qkv", "size_gate_up", "xcols", "xstride", "s_o",
             "s_gate_up", "s_down", "s_qkv", "head_rows", "head_tiles",
             "red_floats")
K4_SMEM_BLOCK = 232448    # H100: a block's dynamic shared memory, at most
K4_SMEM_SM = 233472       # an SM's, 1024 bytes of it reserved per block
K4_SMEM_RESERVED = 1024
K4_WARPS = 8              # warps of a block (q8_gemv.cuh kWarps)
K4_SPAN = 64              # columns of an mma span (m > 1)
K4_TILE = 8               # weight rows of an mma tile
K4_GROUP = 4              # tiles of an mma work item
K4_HEAD_TILE_ROWS = 32    # rows of a tile of K4c's head ring
K4_MAX_HEAD_TILES = 16
K4_MISC = 8 * (4 + K4_MAX_HEAD_TILES) + 4 * K4_WARPS   # mbarriers, partials


class K4Split(NamedTuple):
    """K4's work split over a grid of ``blocks`` blocks and the shared
    memory layout it implies: the table the kernel reads (``plan`` in
    ``csrc/q8_layer_fused.cu``: :data:`K4_LAYOUT`, then the row starts)."""
    starts: torch.Tensor  # int32 [4, blocks + 1]: block b's slab of
                          # K4_MATS[i] is rows [starts[i, b], starts[i, b+1])
                          # (gate_up: gate/up row pairs)
    widths: tuple         # k of each of K4_MATS
    layout: dict          # K4_LAYOUT name -> int (byte offsets, sizes, ...)
    smem: int             # bytes of dynamic shared memory a block
    per_sm: int           # blocks an SM the layout is sized for

    @property
    def blocks(self) -> int:
        return self.starts.shape[1] - 1

    def table(self) -> torch.Tensor:
        return torch.cat([torch.tensor([self.layout[k] for k in K4_LAYOUT],
                                       dtype=torch.int32),
                          self.starts.flatten()])


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def q8_layer_fused_split(h: int, qd: int, ffn: int, nq: int, m: int,
                         blocks: int, head: bool = False,
                         per_sm: int = None, q8i: bool = False) -> K4Split:
    """K4's split of o, gate_up (gate row j with up row j), down and the
    qkv (K4c: the head) over ``blocks`` blocks, contiguous ranges of whole
    rows (counts differ by at most one), and the shared memory layout at
    ``m`` activation rows: the activation rows (m = 1: one f32 row; else
    bf16 rows of ``xcols`` columns, 16 bytes of padding a row; ``q8i``, K7:
    q8_0 rows, int8 and their f32 block scales, see
    :func:`k7_activation_bytes`), the unit sums, the mbarriers, and one slot
    per slab. K7's gate_up ranges at m > 1 are whole blocks of 32 pairs
    (block counts differ by at most one): a block quantizes the gated rows
    it produces, once, for every block's down stage. The qkv slab has its own
    slot where the block's budget allows (requested at the start), else it
    shares gate_up's (requested after gate_up's barrier); K4c's head ring
    starts at gate_up's slot. Where even that
    does not fit, the activation rows are taken in chunks of fewer columns.
    ``per_sm``: blocks an SM (default: two at m = 1, else one). A pure
    function of the widths, m and the grid."""
    if not 1 <= m <= FUSED_MAX_ROWS:
        raise ValueError(f"K4 takes 1..{FUSED_MAX_ROWS} rows, got m={m}")
    if q8i and head:
        raise ValueError("K7 has no head form")
    per_sm = per_sm or (2 if m == 1 else 1)
    mma = m > 1
    budget = min(K4_SMEM_BLOCK, K4_SMEM_SM // per_sm - K4_SMEM_RESERVED)
    rows = (h, ffn, h, nq)
    widths = (qd, h, ffn, h)
    b = torch.arange(blocks + 1, dtype=torch.int64)
    starts = torch.stack([b * n // blocks for n in rows])
    if q8i and m > 1:
        starts[1] = b * (ffn // BLOCK) // blocks * BLOCK
    starts = starts.to(torch.int32)
    most = (starts[:, 1:] - starts[:, :-1]).amax(1).tolist()
    slab_rows = [most[0], 2 * most[1], most[2], most[3]]
    size = [mega_slab_bytes(r, k) for r, k in zip(slab_rows, widths)]
    hr = K4_HEAD_TILE_ROWS if head else 0
    tb = mega_slab_bytes(hr, h)
    stride = 128 if m > 8 else 64    # floats of an mma item's partial tile

    def work(r, k):   # (slices of spans, floats of unit sums) of a slab
        if not mma:
            return 1, r * -(-k // MEGA_UNIT_COLS)
        groups = max(1, -(-r // (K4_TILE * K4_GROUP)))
        s = max(1, min(-(-k // K4_SPAN), -(-K4_WARPS // groups)))
        return s, groups * s * K4_GROUP * stride

    stage = [work(r, k) for r, k in zip(slab_rows[:3] + [hr or slab_rows[3]],
                                        widths)]
    red_head = stage[3][1] if head else 0
    red = 4 * max(max(w[1] for w in stage), 2 * red_head)
    kmax = max(widths)
    span = K4_SPAN
    xcols_all = ([kmax] if not mma else
                 range(-(-kmax // span) * span, -(-h // span) * span - 1,
                       -span))
    for xcols in xcols_all:
        if q8i:
            xstride, x_bytes = k7_activation_bytes(m, xcols)
            if m > 1 and 4 * m * most[1] > x_bytes:   # stage 2's gated rows
                continue
        else:
            xstride = 2 * xcols + 16 if mma else 4 * kmax
            x_bytes = m * xstride if mma else 4 * kmax
        base = _r16(x_bytes) + _r16(red) + _r16(K4_MISC)
        if head:
            tiles = min(K4_MAX_HEAD_TILES, (budget - base - _r16(size[0])
                                            - _r16(size[2])) // tb)
            places = [("ring", max(size[1], tiles * tb))] if tiles >= 2 else []
        else:
            places = [("own", size[1]), ("gate_up", max(size[1], size[3]))]
        for place, gu in places:
            q = size[3] if place == "own" else 0
            total = base + _r16(size[0]) + _r16(gu) + _r16(size[2]) + _r16(q)
            if total > budget:
                continue
            off = dict(x=0, red=_r16(x_bytes))
            off["bars"] = off["red"] + _r16(red)
            off["slot_o"] = off["bars"] + _r16(K4_MISC)
            off["slot_gate_up"] = off["slot_o"] + _r16(size[0])
            off["slot_down"] = off["slot_gate_up"] + _r16(gu)
            off["slot_qkv"] = (off["slot_down"] + _r16(size[2])
                               if place == "own" else off["slot_gate_up"])
            layout = dict(
                off, size_gate_up=size[1], xcols=xcols,
                xstride=xstride if mma else 0, s_o=stage[0][0],
                s_gate_up=stage[1][0], s_down=stage[2][0],
                s_qkv=stage[3][0], head_rows=hr,
                head_tiles=tiles if head else 0,
                red_floats=red_head)
            return K4Split(starts, widths, layout, total, per_sm)
    raise ValueError(f"q8_layer_fused: no shared-memory layout of "
                     f"{budget} bytes a block at h={h}, qd={qd}, f={ffn}, "
                     f"nq={nq}, m={m} on {blocks} blocks")


def k7_activation_bytes(m: int, xcols: int):
    """K7's q8_0 activation rows in shared memory: (bytes a row, bytes in
    all). m = 1: one int8 row of ``xcols`` columns, then its f32 scales;
    m > 1: m int8 rows of ``xcols`` columns padded by 32 bytes (the mma
    form's 8-byte fragment loads are then conflict-free), then the scales
    block-major, 8 rows a block at m <= 8, 16 above (the mma's row tiles)."""
    if m == 1:
        return 0, xcols + xcols // 8
    return xcols + 32, m * (xcols + 32) + (xcols // 32) * 4 * (
        8 if m <= 8 else 16)


_k4_plans = {}


def _k4_plan(dev, h, qd, ffn, nq, m, head, q8i=False):
    """K4's (``q8i``: K7's) split on the card's co-resident grid (two
    blocks an SM at m = 1 where registers allow, else one) and its table on
    the card, cached per (device, widths, head, m, contract)."""
    from ..kernels import build
    key = (dev.index, h, qd, ffn, nq, head, m, q8i)
    plan = _k4_plans.get(key)
    if plan is None:
        sms = build.sm_count(dev)
        query = "q8i_layer_fused_grid" if q8i else "q8_layer_fused_grid"
        for per_sm in ((2, 1) if m == 1 else (1,)):
            split = q8_layer_fused_split(h, qd, ffn, nq, m, per_sm * sms,
                                         head, per_sm, q8i)
            if build.grid_blocks(query, m, split.smem) >= split.blocks:
                break
        else:
            raise RuntimeError(f"{query}: no co-resident grid of one "
                               f"block an SM at h={h}, m={m}")
        plan = _k4_plans[key] = (split, split.table().to(dev))
    return plan


def q8_layer_fused_grid(m: int, h: int, qd: int, ffn: int, nq: int) -> int:
    """K4a's grid (blocks) at m rows and these widths on the current card
    (the P2 probe runs its walk on it)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    return _k4_plan(dev, h, qd, ffn, nq, m, False)[0].blocks


K4_STAMPS = 7


def q8_layer_fused_stage_ms(xm, resid, post_w, next_in_w, o_w, gu_w, down_w,
                            next_qkv_w, eps, head=False):
    """K4's time by stage, read by its stage timer in one launch on CUDA
    (the arguments of :func:`q8_mlp_qkv_fused`; ``next_in_w`` and
    ``next_qkv_w`` None for K4b; ``head``: K4c, the final norm and the
    head in their place): ms of each stage, from the grid barrier before
    it to the one after it (the last to block 0's end) as block 0 sees it
    — ``o``, ``gate_up`` (with the post norm), ``down`` and ``qkv`` or
    ``head`` (with its norm) — and ``span``, block 0's whole run on the
    card's global timer, which the stages add up to. Returns (that dict,
    the launch's outputs)."""
    stamps = torch.zeros(K4_STAMPS, dtype=torch.int64, device=xm.device)
    out = _launch_fused(xm, resid, post_w, next_in_w, o_w, gu_w, down_w,
                        next_qkv_w, eps, head=head, stamps=stamps)
    names = ["o", "gate_up", "down"]
    if next_qkv_w is not None:
        names.append("head" if head else "qkv")
    return _stages(stamps, names), out


def _stages(stamps, names):
    """The stage timer's stamps (K4's and K7's) → ms of each stage, block
    0's clock cycles scaled to its span on the global timer, and ``span``."""
    st = stamps.cpu()
    span_ns = int(st[-1] - st[0])
    cycles = st[1:2 + len(names)].diff().double()
    ms = cycles * (span_ns / 1e6 / float(cycles.sum()))
    stages = dict(zip(names, ms.tolist()))
    stages["span"] = span_ns / 1e6
    return stages


def _launch_fused(xm, resid, post_w, next_in_w, o_w, gu_w, down_w,
                  next_qkv_w, eps, head=False, stamps=None):
    global fused_launches, head_fused_launches
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
    split, table = _k4_plan(dev, h, qd, f, nq, m, head)
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
        null if stamps is None else build.ptr(stamps), build.ptr(table),
        m, qd, h, f, nq, float(eps), split.blocks, split.smem,
        build.stream_ptr(dev))
    build.check(code, "q8_layer_fused")
    if head:
        head_fused_launches += 1
    else:
        fused_launches += 1
    return out, qkv


def q8_decode_all_fused_plain(x0, nhb0, post_lns, norms_next, q_norms,
                              k_norms, cos, sin, bias_row, kv_k, kv_v,
                              qkv_w: Q8Weight, o_w: Q8Weight, gu_w: Q8Weight,
                              down_w: Q8Weight, head_w: Q8Weight,
                              eps: float, chunk: int = None):
    """Plain version of K5 (JAX ``_q8_decode_all_kernel`` :1773 in natural
    order), step by step: per layer the packed qkv, qk-norm and rope in f32,
    GQA attention of the current token (f32 score, f32 value) and the
    cached slots (bf16 q, k, v, probabilities rounded to bf16 for p.v, one
    exact softmax with the f32 sum), o + residual, post norm, gate_up, SiLU
    gate, down + residual and ``norms_next[l]``; the residual stays f32;
    then the head. With ``chunk`` the attention is the kernel's split-KV
    combine instead (``flash_decode.split_kv_plain``: chunks of ``chunk``
    slots, the current token's term first). Returns (logits [1, vocab_pad]
    f32, k_new, v_new [L, kh, D] f32)."""
    from .flash_decode import split_kv_plain
    f32, bf16 = torch.float32, torch.bfloat16
    n_layers, kh, _, hd = kv_k.shape
    qd = o_w.q.shape[-1]
    group = qd // hd // kh
    ffn = down_w.q.shape[-1]
    scale = hd ** -0.5
    cos, sin = cos.to(f32), sin.to(f32)
    bias = bias_row.to(f32)
    res, nh = x0.to(f32), nhb0
    k_new, v_new = [], []
    for l in range(n_layers):
        qkv = q8_matmul_plain(nh, layer(qkv_w, l))[0]
        q = qkv[:qd].reshape(kh * group, hd)
        k = qkv[qd:qd + kh * hd].reshape(kh, hd)
        v = qkv[qd + kh * hd:].reshape(kh, hd)
        q = apply_rope(_rms_f32(q, q_norms[l], eps), cos, sin)
        k = apply_rope(_rms_f32(k, k_norms[l], eps), cos, sin)
        k_new.append(k)
        v_new.append(v)
        qg = q.reshape(kh, group, hd)
        s_cur = (qg * k[:, None]).sum(-1) * scale                # [kh, g]
        if chunk is not None:
            xm = split_kv_plain(
                qg.to(bf16).reshape(1, 1, kh * group, hd),
                kv_k[l].to(bf16).transpose(0, 1)[None],
                kv_v[l].to(bf16).transpose(0, 1)[None], bias[:, None],
                chunk, cur=(s_cur.reshape(1, kh * group, 1), v[None]),
                scale=scale).reshape(1, qd)
        else:
            s = torch.einsum("kgd,ksd->kgs", qg.to(bf16).to(f32),
                             kv_k[l].to(bf16).to(f32)) * scale + bias
            m = torch.maximum(s.amax(-1), s_cur)
            p, p_cur = torch.exp(s - m[..., None]), torch.exp(s_cur - m)
            acc = (torch.einsum("kgs,ksd->kgd", p.to(bf16).to(f32),
                                kv_v[l].to(bf16).to(f32))
                   + p_cur[..., None] * v[:, None])
            xm = (acc / (p.sum(-1) + p_cur)[..., None]).reshape(1, qd)
        h1 = q8_matmul_plain(xm, layer(o_w, l)) + res
        gu = q8_matmul_plain(_rms_f32(h1, post_lns[l], eps), layer(gu_w, l))
        act = torch.nn.functional.silu(gu[:, :ffn]) * gu[:, ffn:]
        res = q8_matmul_plain(act, layer(down_w, l)) + h1
        nh = _rms_f32(res, norms_next[l], eps)
    return (q8_matmul_plain(nh, head_w), torch.stack(k_new),
            torch.stack(v_new))


def q8_decode_all_fused(x0, nhb0, post_lns, norms_next, q_norms, k_norms,
                        cos, sin, bias_row, kv_k, kv_v, qkv_w: Q8Weight,
                        o_w: Q8Weight, gu_w: Q8Weight, down_w: Q8Weight,
                        head_w: Q8Weight, eps: float):
    """One whole b = 1 q8_0 decode step (every layer, attention and the
    head) in ONE launch on CUDA (K5; JAX ``q8_decode_all_fused`` :1970).

    x0 [1, H] f32 (the token embedding); nhb0 [1, H] bf16 (its layer-0
    input norm); post_lns / norms_next [L, H] (``norms_next[l]`` is layer
    l+1's input norm, the last the final norm); q_norms / k_norms [L, D];
    cos / sin [1, D] f32 for this position; bias_row [1, S] f32 (0 where a
    cached slot is visible: ``valid_from <= j < slot``); kv_k / kv_v the
    head-major cache [L, kh, S, D], not yet holding this token; stacked
    q8_0 weights ``qkv_w`` [L, nq, H], ``o_w``, ``gu_w``, ``down_w`` and the
    head ``head_w`` [vocab_pad, H]. Returns (logits [1, vocab_pad] f32,
    k_new [L, kh, D] f32, v_new [L, kh, D] f32); the caller writes the new
    rows at the slot. See :func:`q8_decode_all_fused_plain`."""
    if x0.device.type == "cpu":
        return q8_decode_all_fused_plain(x0, nhb0, post_lns, norms_next,
                                         q_norms, k_norms, cos, sin, bias_row,
                                         kv_k, kv_v, qkv_w, o_w, gu_w,
                                         down_w, head_w, eps)
    return _launch_mega(x0, nhb0, post_lns, norms_next, q_norms, k_norms,
                        cos, sin, bias_row, kv_k, kv_v, qkv_w, o_w, gu_w,
                        down_w, head_w, eps)


MEGA_HEAD_DIM = 128           # K5: 32 lanes x 4 columns per head
MEGA_STAGES = ("qkv", "attention", "o", "gate_up", "down")   # per layer
MEGA_MATS = ("qkv", "o", "gate_up", "down", "head")  # K5's split table rows
MEGA_UNIT_COLS = 512          # K5: columns of a slab's unit (q8_stream.cuh)
MEGA_HEAD_TILE_ROWS = 16      # K5: rows of a tile of the head's ring
MEGA_WIDTH_MULTIPLE = 128     # K5: h, qd, f (whole 16-byte scale words)


class MegaSplit(NamedTuple):
    """K5's work split over a grid of ``blocks`` blocks: the table the
    kernel reads (``split`` in ``csrc/q8_decode_all.cu``) and the shared
    memory it implies."""
    starts: torch.Tensor  # int32 [5, blocks + 1]: block b's slab of
                          # MEGA_MATS[m] is rows [starts[m, b],
                          # starts[m, b + 1]) (gate_up: gate/up row pairs)
    widths: tuple         # k of each of MEGA_MATS
    slot0: int            # bytes of the ring's slot 0 (qkv, gate_up slabs)
    slot1: int            # bytes of slot 1 (o, down slabs)
    red: int              # floats of one stage's unit sums (slab or tile)
    head_rows: int        # rows of a head tile

    @property
    def blocks(self) -> int:
        return self.starts.shape[1] - 1


def mega_slab_bytes(rows: int, k: int) -> int:
    """Bytes of a K5 slab of ``rows`` q8_0 rows of width k as its ring
    holds it: the int8 rows, then their f32 scales."""
    return rows * (k + k // 8)


def q8_decode_all_split(h: int, qd: int, ffn: int, kh: int, vp: int,
                        blocks: int) -> MegaSplit:
    """K5's split of each layer matrix and the head over ``blocks``
    blocks: contiguous ranges of whole rows, gate row j with up row j
    (gate_up is split in pairs). Every row of a matrix has the same bytes,
    so an even split of rows (counts differ by at most one) is an even
    split of bytes. A pure function of the widths and the grid; the
    kernel's ring slots are sized to the largest slab they hold."""
    nq = qd + 2 * kh * MEGA_HEAD_DIM
    rows = (nq, h, ffn, h, vp)
    widths = (h, qd, h, ffn, h)
    b = torch.arange(blocks + 1, dtype=torch.int64)
    starts = torch.stack([b * n // blocks for n in rows]).to(torch.int32)
    most = (starts[:, 1:] - starts[:, :-1]).amax(1).tolist()
    slab_rows = [most[0], most[1], 2 * most[2], most[3]]
    size = [mega_slab_bytes(r, k) for r, k in zip(slab_rows, widths)]
    units = [r * -(-k // MEGA_UNIT_COLS) for r, k in zip(
        slab_rows + [MEGA_HEAD_TILE_ROWS], widths)]
    return MegaSplit(starts, widths, max(size[0], size[2]),
                     max(size[1], size[3]), max(units), MEGA_HEAD_TILE_ROWS)


_mega_plans = {}


def _mega_plan(dev, h, qd, ffn, kh, vp):
    """K5's split on the card's co-resident grid (two blocks an SM where
    the shared memory allows it, else one) and its table on the card,
    cached per (device, widths)."""
    from ..kernels import build
    key = (dev.index, h, qd, ffn, kh, vp)
    plan = _mega_plans.get(key)
    if plan is None:
        sms = build.sm_count(dev)
        for per_sm in (2, 1):
            split = q8_decode_all_split(h, qd, ffn, kh, vp, per_sm * sms)
            most = build.grid_blocks("q8_decode_all_grid", h, qd, ffn,
                                     split.slot0, split.slot1, split.red)
            if most >= split.blocks:
                break
        else:
            raise RuntimeError(f"q8_decode_all: no co-resident grid of one "
                               f"block an SM at h={h}, qd={qd}, f={ffn}")
        plan = _mega_plans[key] = (split, split.starts.to(dev))
    return plan


def q8_decode_all_grid(h: int, qd: int, ffn: int, kh: int, vp: int) -> int:
    """K5's grid (blocks) at these widths on the current card."""
    dev = torch.device("cuda", torch.cuda.current_device())
    return _mega_plan(dev, h, qd, ffn, kh, vp)[0].blocks


def q8_decode_all_stage_ms(*args):
    """K5's time by stage, read by its stage timer in one launch on CUDA
    (the arguments of :func:`q8_decode_all_fused`): ms summed over the
    layers for each of ``MEGA_STAGES`` (gate_up with the post norm, down
    with the next layer's input norm), each from the grid barrier before it
    to the one after it as block 0 sees it, so the slowest block's work
    plus the barrier; ``head``, block 0's share of the head after the last
    barrier; ``span``, block 0's whole run on the card's global timer, which
    the stages add up to. Returns (that dict, the launch's outputs)."""
    n_layers = args[9].shape[0]
    stamps = torch.zeros(5 * n_layers + 4, dtype=torch.int64,
                         device=args[0].device)
    out = _launch_mega(*args, stamps=stamps)
    st = stamps.cpu()
    span_ns = int(st[-1] - st[0])
    cycles = st[1:-1].diff().double()
    ms = cycles * (span_ns / 1e6 / float(cycles.sum()))
    stages = {name: float(ms[j:5 * n_layers:5].sum())
              for j, name in enumerate(MEGA_STAGES)}
    stages.update(head=float(ms[5 * n_layers]), span=span_ns / 1e6)
    return stages, out


def _launch_mega(x0, nhb0, post_lns, norms_next, q_norms, k_norms, cos, sin,
                 bias_row, kv_k, kv_v, qkv_w, o_w, gu_w, down_w, head_w, eps,
                 stamps=None):
    global mega_launches
    from ..kernels import build
    if x0.dim() != 2 or x0.shape[0] != 1:
        raise ValueError(f"q8_decode_all decodes one row (b = 1), got x0 "
                         f"{tuple(x0.shape)}")
    if kv_k.dim() != 4 or kv_v.shape != kv_k.shape:
        raise ValueError(f"q8_decode_all takes a head-major cache [L, kh, "
                         f"S, D], got {tuple(kv_k.shape)} and "
                         f"{tuple(kv_v.shape)}")
    if kv_k.dtype != torch.bfloat16 or kv_v.dtype != torch.bfloat16:
        raise TypeError(f"q8_decode_all takes a bf16 cache, got "
                        f"{kv_k.dtype} / {kv_v.dtype}")
    n_layers, kh, s_len, hd = kv_k.shape
    h = x0.shape[1]
    qd = o_w.q.shape[-1]
    ffn = down_w.q.shape[-1]
    vp = head_w.q.shape[0]
    nq = qd + 2 * kh * hd
    if hd != MEGA_HEAD_DIM or qd != 2 * kh * hd:
        raise ValueError(f"q8_decode_all takes head_dim {MEGA_HEAD_DIM} and "
                         f"a GQA group of 2, got head_dim {hd}, "
                         f"{qd // hd} query heads over {kh} kv heads")
    if h % MEGA_WIDTH_MULTIPLE or ffn % MEGA_WIDTH_MULTIPLE:
        raise ValueError(f"q8_decode_all streams rows whose f32 scales are "
                         f"whole 16-byte words: h and f must be multiples "
                         f"of {MEGA_WIDTH_MULTIPLE}, got h={h}, f={ffn}")
    weights = [(qkv_w, (n_layers, nq, h)), (o_w, (n_layers, h, qd)),
               (gu_w, (n_layers, 2 * ffn, h)), (down_w, (n_layers, h, ffn)),
               (head_w, (vp, h))]
    vecs = [(nhb0, (1, h), torch.bfloat16),
            (post_lns, (n_layers, h), torch.bfloat16),
            (norms_next, (n_layers, h), torch.bfloat16),
            (q_norms, (n_layers, hd), torch.bfloat16),
            (k_norms, (n_layers, hd), torch.bfloat16),
            (x0, (1, h), torch.float32), (cos, (1, hd), torch.float32),
            (sin, (1, hd), torch.float32),
            (bias_row, (1, s_len), torch.float32)]
    if (any(tuple(w.q.shape) != s or tuple(w.d.shape) != s[:-1] + (
            s[-1] // BLOCK,) for w, s in weights)
            or any(tuple(t.shape) != s for t, s, _ in vecs)
            or h % BLOCK or qd % BLOCK or ffn % BLOCK):
        raise ValueError(
            "q8_decode_all shapes: "
            f"weights {[(tuple(w.q.shape), tuple(w.d.shape)) for w, _ in weights]}"
            f", vectors {[tuple(t.shape) for t, _, _ in vecs]}, cache "
            f"{tuple(kv_k.shape)}")
    if not all(w.q.dtype == torch.int8 and w.d.dtype == torch.float32
               for w, _ in weights):
        raise TypeError("q8_decode_all takes int8 q and f32 d")
    if not all(t.dtype == dt for t, _, dt in vecs):
        raise TypeError("q8_decode_all takes an f32 x0, cos, sin and bias "
                        "and bf16 nhb0 and norm weights, got "
                        f"{[t.dtype for t, _, _ in vecs]}")
    tensors = ([kv_k, kv_v] + [t for t, _, _ in vecs]
               + [a for w, _ in weights for a in w])
    if not all(t.is_cuda and t.device == x0.device for t in tensors):
        raise ValueError("q8_decode_all: all inputs must be on one CUDA "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q8_decode_all takes contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("q8_decode_all needs 16-byte aligned inputs")
    dev = x0.device
    # scratch: qkv f32 [nq], res f32 [h], h1 f32 [h], xm bf16 [qd], act
    # bf16 [f]; every size is a multiple of 32 elements, so every part
    # starts 16-byte aligned
    sizes = [nq * 4, h * 4, h * 4, qd * 2, ffn * 2]
    scratch = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
    offs = [scratch.data_ptr()]
    for n in sizes[:-1]:
        offs.append(offs[-1] + n)
    qkv_s, res_s, h1_s, xm_s, act_s = (build.ctypes.c_void_p(o) for o in offs)
    logits = torch.empty((1, vp), dtype=torch.float32, device=dev)
    kv_new = torch.empty((2, n_layers, kh, hd), dtype=torch.float32,
                         device=dev)
    # the attention items' partials (m, l, acc of 2 query rows per chunk;
    # the kernel picks at most one chunk per 32 slots)
    att = torch.empty(kh * -(-s_len // 32) * 2 * (hd + 2),
                      dtype=torch.float32, device=dev)
    split, starts = _mega_plan(dev, h, qd, ffn, kh, vp)
    code = build.lib().q8_decode_all(
        *(build.ptr(t) for t in (x0, nhb0, post_lns, norms_next, q_norms,
                                 k_norms, cos, sin, bias_row, kv_k, kv_v)),
        *(build.ptr(a) for w, _ in weights for a in w),
        qkv_s, xm_s, res_s, h1_s, act_s, build.ptr(logits),
        build.ptr(kv_new[0]), build.ptr(kv_new[1]), build.ptr(att),
        build.ptr(build.tickets(dev, kh)),
        None if stamps is None else build.ptr(stamps), build.ptr(starts),
        n_layers, h, qd, ffn, kh, s_len, vp, float(eps), float(hd ** -0.5),
        split.blocks, split.slot0, split.slot1, split.red, split.head_rows,
        build.stream_ptr(dev))
    build.check(code, "q8_decode_all")
    mega_launches += 1
    return logits, kv_new[0], kv_new[1]


# ---------------------------------------------------------------------------
# K6 / K7: the int8-dot contract (JAX "megacall v3", :1286-1676)
# ---------------------------------------------------------------------------

Q8DOT_MAX_ROWS = 16   # JAX's decode / verify cut (matmul_any :1711,
                      # _logits_raw :1955): more rows take the dequant product


def _round_away(x):
    """Round half away from zero (JAX ``_round_away`` :1307, ggml's
    ``roundf``)."""
    return torch.sign(x) * torch.floor(x.abs() + 0.5)


def quantize_act_q8(x: torch.Tensor):
    """Activations to q8_0 rows (JAX ``quantize_act_q8`` :1340, ggml
    ``quantize_row_q8_0``): x [m, k] → (xq [m, k] int8, xs [m, k/32] f32),
    ``xs = amax / 127`` per 32-block and ``xq = round_away(x * (1 / xs))``
    (0 where a block is all zero): the multiply by the reciprocal, as JAX.

    The 127 is a tensor on x's device: PyTorch's CUDA division by a
    Python number multiplies by its reciprocal, which is not the IEEE
    quotient the kernels and JAX take."""
    m, k = x.shape
    xf = x.to(torch.float32).reshape(m, k // BLOCK, BLOCK)
    amax = xf.abs().amax(dim=-1)
    d = amax / amax.new_full((), 127.0)
    inv = torch.where(d == 0, 0.0, 1.0 / d)
    q = _round_away(xf * inv[..., None]).to(torch.int8)
    return q.reshape(m, k), d


def _block_dot(w, xq, xs):
    """The int8-dot product in JAX's columns (``_q8i_layer_ref.dot``
    :1560-1568, the ``_q8dot_ref`` :1410-1413 of the transposed rows):
    weight [n, k] × q8_0 activations xq [k, m] int8 / xs [k/32, m] f32 →
    [n, m] f32. The per-block partials are exact in f32 (|sum| < 2^24),
    then both block scales and the f32 sum over the blocks."""
    f32 = torch.float32
    n, k = w.q.shape
    nb = k // BLOCK
    z = torch.einsum("nbt,btm->nbm", w.q.reshape(n, nb, BLOCK).to(f32),
                     xq.reshape(nb, BLOCK, -1).to(f32))
    return torch.einsum("nbm,nb,bm->nm", z, w.d, xs)


def q8dot_matmul_plain(x: torch.Tensor, w) -> torch.Tensor:
    """Plain version of K6 (JAX ``_q8dot_ref`` :1399): x [m, k] → [m, n]
    f32 under the int8-dot contract."""
    xq, xs = quantize_act_q8(x)
    return _block_dot(w, xq.t(), xs.t()).t()


def q8dot_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x [m, k] × a 2-D :class:`Q8DotWeight` (or a layer view of one)
    → [m, n] f32, 1 <= m <= 16 on CUDA (K6, JAX ``q8dot_matmul``
    :1416). See :func:`q8dot_matmul_plain`."""
    if x.device.type == "cpu":
        return q8dot_matmul_plain(x, w)
    return _launch_q8dot(x, w)


def _check_q8(weights, dev, name):
    """int8 q / f32 d, contiguous, 16-byte aligned, on ``dev``."""
    if not all(w.q.dtype == torch.int8 and w.d.dtype == torch.float32
               for w in weights):
        raise TypeError(f"{name} takes int8 q and f32 d, got "
                        f"{[(w.q.dtype, w.d.dtype) for w in weights]}")
    tensors = [t for w in weights for t in w]
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous weights")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs 16-byte aligned weights")


def _launch_q8dot(x: torch.Tensor, w) -> torch.Tensor:
    global q8dot_launches
    from ..kernels import build
    if x.dim() != 2 or w.q.dim() != 2:
        raise ValueError(f"q8dot_matmul takes x [m, k] and q [n, k], got "
                         f"{tuple(x.shape)} and {tuple(w.q.shape)}")
    m, k = x.shape
    n = w.q.shape[0]
    if not 1 <= m <= Q8DOT_MAX_ROWS:
        raise ValueError(f"q8dot_matmul takes 1..{Q8DOT_MAX_ROWS} rows, got "
                         f"m={m}")
    if w.q.shape[1] != k or k % BLOCK or tuple(w.d.shape) != (n, k // BLOCK):
        raise ValueError(f"q8dot_matmul shape mismatch: x {tuple(x.shape)}, "
                         f"q {tuple(w.q.shape)}, d {tuple(w.d.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"q8dot_matmul takes float activations, got "
                        f"{x.dtype}")
    _check_q8([w], x.device, "q8dot_matmul")
    # bf16 rows (the decoder's) go in as they are, other floats as f32
    bf16 = x.dtype == torch.bfloat16
    xk = x.contiguous() if bf16 else x.to(torch.float32).contiguous()
    if xk.data_ptr() % 16:   # the kernel reads x by 8- or 16-byte words
        xk = xk.clone()
    _matvec_plan(x.device, n, k, m, q8i=True)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    entry = build.lib().q8dot_matmul_bf16 if bf16 else build.lib().q8dot_matmul
    code = entry(build.ptr(xk), build.ptr(w.q), build.ptr(w.d), build.ptr(y),
                 m, n, k, build.stream_ptr(x.device))
    build.check(code, "q8dot_matmul")
    q8dot_launches += 1
    return y


def _rms_col(x, w, eps):
    """Column RMSNorm (JAX ``_rms_col`` :1489): x [k, m] f32, w [k]."""
    var = (x * x).mean(dim=0, keepdim=True)
    return x * torch.rsqrt(var + eps) * w.to(torch.float32)[:, None]


def _quant_cols(x):
    """q8_0 columns (JAX ``_quant_cols`` :1495): x [k, m] f32 → (xq [k, m]
    int8, xs [k/32, m] f32), :func:`quantize_act_q8` of the rows."""
    xq, xs = quantize_act_q8(x.t())
    return xq.t(), xs.t()


def q8i_layer_fused_plain(attn_q, attn_s, resid_col, post_w, next_in_w,
                          o_w, gu_w, down_w, next_qkv_w, eps: float,
                          with_qkv: bool = True):
    """Plain version of K7 (JAX ``_q8i_layer_ref`` :1550), in JAX's column
    layout: every product under the int8-dot contract, every intermediate
    f32 → (out_col [h, m] f32, qkv_col [nq, m] f32 | None)."""
    h1 = _block_dot(o_w, attn_q, attn_s) + resid_col
    gu = _block_dot(gu_w, *_quant_cols(_rms_col(h1, post_w, eps)))
    f = gu.shape[0] // 2
    act = torch.nn.functional.silu(gu[:f]) * gu[f:]
    out = _block_dot(down_w, *_quant_cols(act)) + h1
    if not with_qkv:
        return out, None
    return out, _block_dot(next_qkv_w,
                           *_quant_cols(_rms_col(out, next_in_w, eps)))


def q8i_layer_fused(attn_q, attn_s, resid_col, post_w, next_in_w, o_w,
                    gu_w, down_w, next_qkv_w, eps: float,
                    with_qkv: bool = True):
    """One layer's post-attention half under the int8-dot contract (+ the
    next layer's input norm and qkv when ``with_qkv``), in one launch on
    CUDA (K7, JAX ``q8i_layer_fused`` :1586), with JAX's signature:
    ``attn_q [qd, m]`` int8 / ``attn_s [qd/32, m]`` f32 the merged
    attention output in q8_0 columns, ``resid_col [h, m]`` f32, ``post_w``
    / ``next_in_w [h]``; 2-D :class:`Q8DotWeight` s or layer views. Returns
    ``(out_col [h, m] f32, qkv_col [nq, m] f32 | None)``. On CUDA the
    columns may be transposed views of row-major [m, ·] tensors (no copy)
    and the results are such views. The decoder calls
    :func:`q8i_layer_fused_rows`, the same kernel with the quantization of
    the attention rows folded in. See :func:`q8i_layer_fused_plain`."""
    if attn_q.device.type == "cpu":
        return q8i_layer_fused_plain(attn_q, attn_s, resid_col, post_w,
                                     next_in_w, o_w, gu_w, down_w,
                                     next_qkv_w, eps, with_qkv)
    if with_qkv != (next_qkv_w is not None) or with_qkv != (
            next_in_w is not None):
        raise ValueError("q8i_layer_fused: with_qkv needs next_in_w and "
                         "next_qkv_w, and without it both are None")
    if attn_q.dim() != 2 or attn_s.dim() != 2 or resid_col.dim() != 2:
        raise ValueError(f"q8i_layer_fused takes attn_q [qd, m], attn_s "
                         f"[qd/32, m] and resid_col [h, m], got "
                         f"{tuple(attn_q.shape)}, {tuple(attn_s.shape)} and "
                         f"{tuple(resid_col.shape)}")
    if attn_q.dtype != torch.int8 or attn_s.dtype != torch.float32:
        raise TypeError(f"q8i_layer_fused takes int8 attn_q and f32 attn_s, "
                        f"got {attn_q.dtype}, {attn_s.dtype}")
    out, qkv = _launch_q8i((attn_q.t().contiguous(), attn_s.t().contiguous()),
                           resid_col.t().contiguous(), post_w, next_in_w,
                           o_w, gu_w, down_w, next_qkv_w, eps)
    return out.t(), (qkv.t() if with_qkv else None)


def q8i_layer_fused_rows_plain(attn, resid, post_w, next_in_w, o_w, gu_w,
                               down_w, next_qkv_w, eps: float):
    """Plain version of :func:`q8i_layer_fused_rows`: :func:`quantize_act_q8`
    of the attention rows, then :func:`q8i_layer_fused_plain`, in rows."""
    aq, as_ = quantize_act_q8(attn)
    out, qkv = q8i_layer_fused_plain(
        aq.t(), as_.t(), resid.to(torch.float32).t(), post_w, next_in_w,
        o_w, gu_w, down_w, next_qkv_w, eps, next_qkv_w is not None)
    return out.t(), (None if qkv is None else qkv.t())


def q8i_layer_fused_rows(attn, resid, post_w, next_in_w, o_w, gu_w, down_w,
                         next_qkv_w, eps: float):
    """K7 as the decoder calls it, in rows: ``attn [m, qd]`` the merged
    attention output (on CUDA bf16, the dtype K2 returns; the kernel
    quantizes it to q8_0 with :func:`quantize_act_q8`'s arithmetic; on the
    CPU any float dtype), ``resid [m, h]``
    f32; ``next_in_w`` / ``next_qkv_w`` None for the last layer. Returns
    ``(out [m, h] f32, qkv [m, nq] f32 | None)``, one launch on CUDA,
    outputs bit-equal to :func:`q8i_layer_fused` on the quantized rows. See
    :func:`q8i_layer_fused_rows_plain`."""
    if attn.device.type == "cpu":
        return q8i_layer_fused_rows_plain(attn, resid, post_w, next_in_w,
                                          o_w, gu_w, down_w, next_qkv_w, eps)
    if (next_in_w is None) != (next_qkv_w is None):
        raise ValueError("q8i_layer_fused_rows: the qkv stage needs both "
                         "next_in_w and next_qkv_w")
    return _launch_q8i(attn, resid, post_w, next_in_w, o_w, gu_w, down_w,
                       next_qkv_w, eps)


def q8i_layer_fused_stage_ms(attn, resid, post_w, next_in_w, o_w, gu_w,
                             down_w, next_qkv_w, eps):
    """K7's time by stage, read by its stage timer in one launch on CUDA
    (the arguments of :func:`q8i_layer_fused_rows`), as
    :func:`q8_layer_fused_stage_ms` reads K4's: ms of ``o``, ``gate_up``,
    ``down`` and ``qkv`` (with the qkv stage), each to its grid barrier as
    block 0 sees it, and ``span``. Returns (that dict, the launch's
    outputs)."""
    stamps = torch.zeros(K4_STAMPS, dtype=torch.int64, device=attn.device)
    out = _launch_q8i(attn, resid, post_w, next_in_w, o_w, gu_w, down_w,
                      next_qkv_w, eps, stamps=stamps)
    names = ["o", "gate_up", "down"] + (["qkv"] if next_qkv_w is not None
                                        else [])
    return _stages(stamps, names), out


def _launch_q8i(attn, resid, post_w, next_in_w, o_w, gu_w, down_w,
                next_qkv_w, eps, stamps=None):
    """K7's launch. ``attn``: the attention rows [m, qd] in bf16, or
    the pair (aq [m, qd] int8, as [m, qd/32] f32) of rows in q8_0."""
    global q8i_launches
    from ..kernels import build
    quantized = isinstance(attn, tuple)
    rows = attn[0] if quantized else attn
    if rows.dim() != 2 or resid.dim() != 2:
        raise ValueError(f"q8i_layer_fused takes attention rows [m, qd] and "
                         f"resid [m, h], got {tuple(rows.shape)} and "
                         f"{tuple(resid.shape)}")
    m, qd = rows.shape
    h = resid.shape[1]
    f = down_w.q.shape[-1]
    with_qkv = next_qkv_w is not None
    nq = next_qkv_w.q.shape[0] if with_qkv else 0
    if not 1 <= m <= Q8DOT_MAX_ROWS:
        raise ValueError(f"q8i_layer_fused takes 1..{Q8DOT_MAX_ROWS} rows, "
                         f"got m={m}")
    weights = [(o_w, (h, qd)), (gu_w, (2 * f, h)), (down_w, (h, f))]
    if with_qkv:
        weights.append((next_qkv_w, (nq, h)))
    norms = [post_w] + ([next_in_w] if with_qkv else [])
    acts = list(attn) if quantized else [attn]
    if ((quantized and tuple(attn[1].shape) != (m, qd // BLOCK))
            or tuple(resid.shape) != (m, h)
            or any(tuple(w.q.shape) != s
                   or tuple(w.d.shape) != (s[0], s[1] // BLOCK)
                   for w, s in weights)
            or any(tuple(n.shape) != (h,) for n in norms)
            or qd % BLOCK or h % BLOCK or f % BLOCK):
        raise ValueError(
            f"q8i_layer_fused shapes: attention {[tuple(a.shape) for a in acts]}"
            f", resid {tuple(resid.shape)}, norms "
            f"{[tuple(n.shape) for n in norms]}, weights "
            f"{[(tuple(w.q.shape), tuple(w.d.shape)) for w, _ in weights]}")
    if quantized:
        if attn[0].dtype != torch.int8 or attn[1].dtype != torch.float32:
            raise TypeError(f"q8i_layer_fused takes int8 rows and f32 "
                            f"scales, got {attn[0].dtype}, {attn[1].dtype}")
    elif attn.dtype != torch.bfloat16:
        raise TypeError(f"q8i_layer_fused takes bf16 attention rows, got "
                        f"{attn.dtype}")
    if resid.dtype != torch.float32:
        raise TypeError(f"q8i_layer_fused takes an f32 residual, got "
                        f"{resid.dtype}")
    if any(n.dtype != torch.bfloat16 for n in norms):
        raise TypeError(f"q8i_layer_fused kernel takes bf16 norm weights, "
                        f"got {[n.dtype for n in norms]}")
    dev = rows.device
    _check_q8([w for w, _ in weights], dev, "q8i_layer_fused")
    tensors = acts + [resid] + norms
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("q8i_layer_fused: all inputs must be on one CUDA "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q8i_layer_fused takes contiguous rows and norm "
                         "weights")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("q8i_layer_fused needs 16-byte aligned inputs")
    split, table = _k4_plan(dev, h, qd, f, nq, m, False, q8i=True)
    # one scratch allocation of f32 words: h1 [m, h], out [m, h], qkv
    # [m, nq], the gated rows (m = 1: f32 [m, f]; else int8 [m, f], f / 4
    # words a row, then f32 scales [m, f/32]); every part a multiple of 8
    # words (16-byte aligned)
    cols = (h, h, nq, f if m == 1 else f // 4 + f // BLOCK)
    buf = torch.empty(m * sum(cols), dtype=torch.float32, device=dev)
    h1, out, qkv, act = (t.view(m, c) for t, c in zip(
        torch.split(buf, [m * c for c in cols]), cols))
    null = build.ctypes.c_void_p(None)
    code = build.lib().q8i_layer_fused(
        null if quantized else build.ptr(attn),
        *((build.ptr(a) for a in attn) if quantized else (null, null)),
        build.ptr(resid), build.ptr(post_w),
        build.ptr(next_in_w) if with_qkv else null,
        *(build.ptr(a) for w, _ in weights[:3] for a in w),
        build.ptr(next_qkv_w.q) if with_qkv else null,
        build.ptr(next_qkv_w.d) if with_qkv else null,
        build.ptr(h1), build.ptr(act), build.ptr(out), build.ptr(qkv),
        null if stamps is None else build.ptr(stamps), build.ptr(table),
        m, qd, h, f, nq, float(eps), split.blocks, split.smem, build.stream_ptr(dev))
    build.check(code, "q8i_layer_fused")
    q8i_launches += 1
    return out, (qkv if with_qkv else None)


def matmul_any(x: torch.Tensor, w,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ w`` in f32 for a q8_0 (K1), int8-dot q8_0 (K6, or K1 above 16
    rows), per-channel int8 or dense weight, as ``out_dtype`` (the f32
    product cast; K1's prefill GEMM writes bf16 itself); leading batch
    dims on ``x`` are flattened (JAX ``matmul_any`` and ``_proj``'s
    ``Int8Weight`` branch, ``qwen3.py:425-431``).

    The int8 and dense products are plain PyTorch in f32: both operands
    upcast (int8 and bf16 values are exact in f32, so this is JAX's
    ``preferred_element_type=f32`` dot, without the bf16 rounding of the
    output that a bf16 ``torch.matmul`` on CUDA would add), then the int8
    weight's f32 per-channel scale."""
    if isinstance(w, Q8DotWeight):
        # JAX :1704-1724: decode / verify rows take the int8-dot product;
        # more rows the dequant product bf16(x) . bf16(q * d), which is
        # K1's contract on the same bytes
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        out = (q8dot_matmul(x2, w).to(out_dtype)
               if x2.shape[0] <= Q8DOT_MAX_ROWS
               else q8_matmul(x2, Q8Weight(*w), out_dtype))
        return out.reshape(*lead, out.shape[-1])
    if isinstance(w, Q8Weight):
        lead = x.shape[:-1]
        out = q8_matmul(x.reshape(-1, x.shape[-1]), w, out_dtype)
        return out.reshape(*lead, out.shape[-1])
    if isinstance(w, Int8Weight):
        return (torch.matmul(x.to(torch.float32), w.w8.to(torch.float32))
                * w.scale.to(torch.float32)).to(out_dtype)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(out_dtype)
