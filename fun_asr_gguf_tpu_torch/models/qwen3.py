"""Qwen3 decoder (dense qwen3 arch) in PyTorch.

Counterpart of the qwen3 path of ``fun_asr_gguf_tpu/models/qwen3.py``:
``rope_cos_sin`` :379 / ``apply_rope`` :399 (half-split rotation), qk
RMSNorm, ``init_kv_cache`` :361, ``qwen3_prefill`` :1309,
``qwen3_decode_step`` :1415, ``qwen3_verify_step`` :1630,
``_attend_cache`` :315, ``_logits`` :1935, ``quantize_lm_head`` :629,
``fuse_qwen3_params_q8`` :657, ``quantize_qwen3_params_int8`` :500,
``quantize_lm_head_per_channel`` :1898 and the int8 cache (``QuantKV``
:196, ``_kv_quantize`` :224). Sliding windows, MoE, MLA and softcaps are
not ported (other decoder families).

Weight formats: q8_0 projections and head go through K1
(``ops.quant_matmul``); per-channel int8 (:class:`Int8Weight`, the JAX
engine's default in bf16 compute) and dense weights take plain f32
products, as JAX leaves them to XLA. Decode and verify attention go
through K2 (``ops.flash_decode``), over a bf16 or an int8 cache. Prefill
attention is plain PyTorch, as the JAX package leaves it to XLA.

Params carrying the ``q8_fused`` marker (:func:`fuse_qwen3_params_q8`)
decode and verify through K4: JAX's "megacall v2" branch (:1574-1602,
:1769-1795), one launch per layer that runs o-proj → post norm → gate_up →
gate → down and the NEXT layer's input norm + qkv; only layer 0's qkv and
the head stay on K1. The TPU's perm space is not ported, so the fused tree
keeps every byte where the packed tree has it. With ``FUNASR_Q8_FUSED_HEAD``
set (JAX's knob, read at call time) the last layer's launch is K4c, which
also runs the final norm and the head (JAX ``_fused_head_call`` :1182).

Params carrying the ``q8_mega`` marker (:func:`fuse_qwen3_params_q8_mega`)
decode a b = 1 step in ONE launch, K5 (JAX :1511-1546), over the
head-major cache ``[n_layers, kv_heads, max_len, head_dim]`` that
``generate.prefill_init`` builds for them; the verify step does not take
that cache.

Params carrying the ``q8i_fused`` marker (:func:`fuse_qwen3_params_q8i`)
decode and verify under llama.cpp's q8_0 x q8_0 contract: JAX's "megacall
v3" branch (:1548-1573, :1743-1768), layer 0's qkv and the head through K6
and one K7 launch per layer (the chain of K4 with every product int8-dot
and every intermediate f32), the residual an f32 column across the
layers. Their prefill takes K1's dequant product on the same bytes, as
JAX's scanned prefill does.

KV cache: ``[n_layers, B, max_len, kv_heads, head_dim]`` (or head-major
for K5, above) in the compute dtype, or int8 values with one scale per
(slot, kv head) in the compute dtype (:class:`QuantKV`). The prompt
occupies slots ``[P - L, P)`` of a left-padded bucket of ``P``; generated
token ``t`` lives at slot ``P + t`` with rope position ``L + t``. Unlike
the JAX program (pure functions), the port updates the cache IN PLACE —
one [B, kh, hd] row per layer per step, no copy; an int8 cache quantizes
each new row as it is written.
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from ..formats.quant_np import q8_0_quantize
from ..ops.flash_decode import flash_decode_attention
from ..ops.quant_matmul import (Int8Weight, Q8DotWeight, Q8Weight, layer,
                                matmul_any, q8_decode_all_fused,
                                q8_layer_head_fused, q8_mlp_fused,
                                q8_mlp_qkv_fused, q8i_layer_fused_rows)
from .common import apply_rope, rms_norm

NEG_INF = -1e30
_HEAD_PAD = 1024          # lm_head rows padded to a multiple (152576)


class QuantKV(NamedTuple):
    """One half of an int8 cache: per-(layer, row, slot, kv head) absmax
    scales in the activation dtype (JAX ``QuantKV`` :196)."""
    q: torch.Tensor    # int8 [n_layers, B, S, kv_heads, head_dim]
    s: torch.Tensor    # activation dtype [n_layers, B, S, kv_heads, 1]


class KVCache(NamedTuple):
    k: Any    # [n_layers, B, S, kv_heads, head_dim] tensor — or QuantKV;
    v: Any    # or head-major [n_layers, kv_heads, S, head_dim] (K5)

    @property
    def head_major(self) -> bool:
        return not isinstance(self.k, QuantKV) and self.k.dim() == 4

    @property
    def max_len(self) -> int:
        """S: dim 2 of [L, B, S, kh, D] and of head-major [L, kh, S, D]."""
        return (self.k.q if isinstance(self.k, QuantKV) else self.k).shape[2]


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None, kv_int8: bool = False) -> KVCache:
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    if kv_int8:
        def half():     # k and v are distinct allocations
            return QuantKV(
                q=torch.zeros(shape, dtype=torch.int8, device=device),
                s=torch.zeros(shape[:-1] + (1,), dtype=dtype, device=device))
        return KVCache(k=half(), v=half())
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _kv_quantize(a):
    """[..., head_dim] activations → (int8 values, [..., 1] scales in a's
    dtype). The values are rounded against the scale AS STORED (after the
    cast to the activation dtype), half to even as ``jnp.round``."""
    af = a.to(torch.float32)
    s = (af.abs().amax(dim=-1, keepdim=True) / 127.0).to(a.dtype)
    sf = s.to(torch.float32)
    q = torch.round(af / torch.where(sf == 0, 1.0, sf))
    return q.clamp(-127, 127).to(torch.int8), s


def _kv_write(cache, l: int, index, new):
    """Store ``new`` at ``cache[l][index]`` in place; an int8 cache stores
    the quantized values and their scales. A tensor ``index`` is the
    decode step's slot, [1] on the device: ``new`` [B, 1, kh, D] goes to
    that slot of every row without the host reading it."""
    if isinstance(cache, QuantKV):
        q, s = _kv_quantize(new)
        pairs = ((cache.q[l], q), (cache.s[l], s))
    else:
        pairs = ((cache[l], new),)
    for dst, src in pairs:
        if isinstance(index, torch.Tensor):
            dst.index_copy_(1, index, src)
        else:
            dst[index] = src


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def quantize_lm_head(params, cfg):
    """Add the q8_0 output projection ``lm_head_q`` ([vocab_pad, hidden]).

    Built as ``quantize_lm_head`` builds it in JAX: from the tied
    embedding (or the untied head) AS LOADED in the compute dtype, vocab
    zero-padded to a multiple of 1024 (151936 → 152576), quantized with
    the ggml-exact ``q8_0_quantize`` (ties away from zero, f16 scale,
    subnormal scale → zero block). The padded rows are sliced off in
    :func:`_logits`."""
    if "lm_head_q" in params:
        return params
    src = params["embed"] if cfg.tie_embeddings else params["lm_head"].t()
    dev = src.device
    head = src.to(torch.float32).cpu().numpy()              # [vocab, hidden]
    pad = -head.shape[0] % _HEAD_PAD
    if pad:
        head = np.concatenate(
            [head, np.zeros((pad, head.shape[1]), np.float32)], axis=0)
    q, d = q8_0_quantize(head)
    out = dict(params)
    out["lm_head_q"] = Q8Weight(q=torch.from_numpy(q).to(dev),
                                d=torch.from_numpy(d.astype(np.float32)).to(dev))
    out.pop("lm_head", None)
    return out


def quantize_lm_head_per_channel(params, cfg):
    """Add the per-channel int8 output projection ``lm_head_i8 = (w
    [hidden, vocab] int8, scale [vocab] f32)``, as JAX ``qwen3.py:1898``
    builds it: from the tied embedding (or the untied head) as loaded,
    absmax / 127 per vocab column, no vocab padding."""
    if "lm_head_i8" in params or "lm_head_q" in params:
        return params
    head = _lm_head(params, cfg).to(torch.float32)       # [hidden, vocab]
    scale = head.abs().amax(dim=0) / 127.0
    w = torch.round(head / torch.where(scale == 0, 1.0, scale))
    out = dict(params)
    out["lm_head_i8"] = (w.to(torch.int8).contiguous(), scale)
    out.pop("lm_head", None)
    return out


_MATMUL_KEYS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w",
                "qkv_w", "gate_up_w")


def quantize_qwen3_params_int8(params):
    """Dense layer weights [L, k, n] → per-channel int8 (:class:`Int8Weight`,
    JAX ``qwen3.py:500``): per output channel absmax / 127, rounded half to
    even as ``jnp.round``, the scale stored in bf16; layer by layer, so the
    f32 transient is one layer's. q8_0 weights are left as they are."""
    layers = dict(params["layers"])
    for key in _MATMUL_KEYS:
        w = layers.get(key)
        if not isinstance(w, torch.Tensor):
            continue
        per = []
        for wl in w:
            wf = wl.to(torch.float32)
            s = wf.abs().amax(dim=-2, keepdim=True) / 127.0
            per.append(Int8Weight(
                w8=torch.round(wf / torch.where(s == 0, 1.0, s)).to(
                    torch.int8),
                scale=s.to(torch.bfloat16)))
        layers[key] = Int8Weight(w8=torch.stack([p.w8 for p in per]),
                                 scale=torch.stack([p.scale for p in per]))
    out = dict(params)
    out["layers"] = layers
    return out


def _concat_out(ws):
    """Stack weights along the output dim: q8_0 rows (``n`` is dim -2),
    int8 and dense columns (dim -1). Every output channel is independent,
    so packing changes no number."""
    if isinstance(ws[0], (Q8Weight, Int8Weight)):
        dim = -2 if isinstance(ws[0], Q8Weight) else -1
        return type(ws[0])(*(torch.cat(parts, dim=dim) for parts in zip(*ws)))
    return torch.cat(ws, dim=-1)


def pack_qwen3_params(params):
    """Fuse q/k/v and gate/up into one projection each (one product each;
    JAX ``qwen3.py:578``)."""
    layers = dict(params["layers"])
    if "qkv_w" in layers:
        return params
    layers["qkv_w"] = _concat_out([layers.pop(k) for k in ("q_w", "k_w",
                                                            "v_w")])
    layers["gate_up_w"] = _concat_out([layers.pop(k) for k in ("gate_w",
                                                               "up_w")])
    out = dict(params)
    out["layers"] = layers
    return out


def fuse_qwen3_params_q8(params):
    """Mark a packed q8_0 tree for the fused decode (K4). Moves no byte:
    the perm space the JAX fuse adopts (``qwen3.py:657``) exists only for
    the TPU's lane layout."""
    if "q8_fused" in params:
        return params
    layers = params["layers"]
    if "input_ln" not in layers:
        raise ValueError("fuse_qwen3_params_q8 needs pre-norm layers")
    for key in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        if not isinstance(layers.get(key), Q8Weight):
            raise ValueError(
                f"fuse_qwen3_params_q8 needs packed q8_0 params ({key})")
    out = dict(params)
    out["q8_fused"] = torch.zeros((0,), dtype=torch.int8)    # marker
    return out


def fuse_qwen3_params_q8_mega(params, cfg):
    """Mark a fused q8_0 tree for the all-layers decode kernel (K5; JAX
    ``qwen3.py:707``): adds ``norms_next`` (layer l's next input norm,
    ``input_ln[l + 1]``, and the final norm last) and the ``q8_mega``
    marker. Needs the ``q8_fused`` marker and a q8_0 ``lm_head_q``; where
    the arch is not one the kernel computes (no qk-norm, a GQA group other
    than 2, sliding windows, partial or scaled rope, a residual scale) the
    params come back unchanged, as in JAX.

    JAX also declines shapes its TPU stage plan cannot cut into VMEM
    chunks (``_mega_stage_plan``, :743-747; e.g. ``Qwen3Config.tiny()``).
    That plan is not ported, so the port marks those tiny shapes; the CUDA
    kernel then takes head_dim 128 only and raises on others, while the
    plain version computes any shape."""
    if "q8_mega" in params:
        return params
    layers = params["layers"]
    if (not isinstance(params.get("lm_head_q"), Q8Weight)
            or "q8_fused" not in params
            or "q_norm" not in layers
            or cfg.q_heads != 2 * cfg.kv_heads
            or cfg.sliding_pattern
            or (cfg.rope_dim and cfg.rope_dim != cfg.head_dim)
            or cfg.active_rope_factors
            or cfg.rope_attn_factor != 1.0
            or cfg.rope_global_scale != 1.0
            or cfg.residual_scale != 1.0):
        return params
    out = dict(params)
    out["norms_next"] = torch.cat([layers["input_ln"][1:],
                                   params["final_ln"][None]], dim=0)
    out["q8_mega"] = torch.zeros((0,), dtype=torch.int8)    # marker
    return out


def fuse_qwen3_params_q8i(params):
    """Mark a packed, unfused q8_0 tree for the int8-dot decode (K6 / K7;
    JAX ``qwen3.py:755``): the four layer weights become
    :class:`Q8DotWeight` and the head ``lm_head_qn`` (:func:`lm_head_q8dot`)
    — relabelled, the same tensors — and the ``q8i_fused`` marker is
    added. Raises where JAX raises: on a ``q8_fused`` tree, sandwich norms,
    post-norm-only layers, MoE layers, and weights that are not packed
    q8_0."""
    if "q8i_fused" in params:
        return params
    if "q8_fused" in params:
        raise ValueError("params already use the fused (q8_fused) "
                         "convention; build q8i from unfused packed params")
    layers = dict(params["layers"])
    if "attn_post_ln" in layers:
        raise ValueError("fuse_qwen3_params_q8i does not support "
                         "sandwich-norm archs (gemma); use the int8/bf16 "
                         "paths")
    if "input_ln" not in layers:
        raise ValueError("fuse_qwen3_params_q8i does not support "
                         "post-norm-only archs (olmo2); use the int8/bf16 "
                         "paths")
    if "router_w" in layers:
        raise ValueError("fuse_qwen3_params_q8i does not support MoE layers "
                         "— use the int8/bf16 paths for qwen3moe decoders")
    for key in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        w = layers.get(key)
        if isinstance(w, Q8Weight):
            layers[key] = Q8DotWeight(*w)
        elif not isinstance(w, Q8DotWeight):
            raise ValueError(
                f"fuse_qwen3_params_q8i needs packed q8_0 params ({key})")
    out = dict(params)
    out["layers"] = layers
    out["q8i_fused"] = torch.zeros((0,), dtype=torch.int8)    # marker
    return lm_head_q8dot(out)


def lm_head_q8dot(params):
    """The q8_0 head ``lm_head_q`` relabelled as ``lm_head_qn``, a
    :class:`Q8DotWeight` of the same tensors (JAX ``qwen3.py:1920``): the
    logits then take the int8-dot contract (:func:`_logits`)."""
    if "lm_head_qn" in params or "lm_head_q" not in params:
        return params
    out = dict(params)
    out["lm_head_qn"] = Q8DotWeight(*out.pop("lm_head_q"))
    return out


def _layer_params(layers, l: int):
    return {k: (layer(w, l) if isinstance(w, (Q8Weight, Q8DotWeight,
                                               Int8Weight)) else w[l])
            for k, w in layers.items()}


def _prefill_layer_params(layers, l: int):
    """Layer ``l`` for the prefill. JAX scans the prefill's layers, and a
    traced layer index sends every ``QuantTensorN`` product to the dequant
    branch at any row count (``quant_matmul.py:1711-1723``): a
    :class:`Q8DotWeight` becomes the :class:`Q8Weight` of the same
    tensors, whose product (K1) is that branch's."""
    return {k: Q8Weight(*w) if isinstance(w, Q8DotWeight) else w
            for k, w in _layer_params(layers, l).items()}


# ---------------------------------------------------------------------------
# RoPE (HF half-rotation)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions, head_dim: int, theta: float, dtype):
    """positions [...] → (cos, sin) each [..., head_dim]."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                             device=positions.device) / half))
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _proj(x, w):
    return matmul_any(x, w, x.dtype)


def _attn_scale(cfg) -> float:
    return cfg.attn_scale if cfg.attn_scale else cfg.head_dim ** -0.5


def _qkv(x, lp, cfg, cos, sin):
    """x [B, T, H] → q [B,T,qh,D], k/v [B,T,kh,D] (qk-norm + rope)."""
    if "qkv_w" in lp:
        qkv = _proj(x, lp["qkv_w"])
    else:
        qkv = torch.cat([_proj(x, lp[n]) for n in ("q_w", "k_w", "v_w")],
                        dim=-1)
    return _qkv_post(qkv, lp, cfg, cos, sin)


def _qkv_post(qkv, lp, cfg, cos, sin):
    """Raw packed qkv [B, T, n_qkv] → q [B,T,qh,D], k/v [B,T,kh,D]: split
    into heads, qk-norm and rope (JAX ``_qkv_post`` :799)."""
    b, t, _ = qkv.shape
    qd = cfg.q_heads * cfg.head_dim
    kd = cfg.kv_heads * cfg.head_dim
    q, k, v = qkv[..., :qd], qkv[..., qd:qd + kd], qkv[..., qd + kd:]
    q = q.reshape(b, t, cfg.q_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.kv_heads, cfg.head_dim)
    if "q_norm" in lp:
        q = rms_norm(q, lp["q_norm"], cfg.rms_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _merge_heads(heads, cfg):
    b, t = heads.shape[0], heads.shape[2]
    return heads.transpose(1, 2).reshape(b, t, cfg.q_heads * cfg.head_dim)


def _mlp(x, lp):
    if "gate_up_w" in lp:
        gu = _proj(x, lp["gate_up_w"])
        f = gu.shape[-1] // 2
        gate, up = gu[..., :f], gu[..., f:]
    else:
        gate, up = _proj(x, lp["gate_w"]), _proj(x, lp["up_w"])
    return _proj(torch.nn.functional.silu(gate) * up, lp["down_w"])


def _fused_mlp_qkv_call(heads, x, lp, lp_next, cfg):
    """K4 for layer ``lp`` plus the next layer's input norm and qkv (JAX
    ``_fused_mlp_qkv_call`` :1165): heads [B,qh,T,D], x [B,T,H] → (new
    residual [B,T,H], raw qkv [B,T,n_qkv]), both cast back to x's dtype."""
    b, t, h = x.shape
    out, qkv = q8_mlp_qkv_fused(
        _merge_heads(heads, cfg).reshape(b * t, -1).to(torch.bfloat16),
        x.reshape(b * t, h), lp["post_ln"], lp_next["input_ln"], lp["o_w"],
        lp["gate_up_w"], lp["down_w"], lp_next["qkv_w"], cfg.rms_eps)
    return (out.reshape(b, t, h).to(x.dtype),
            qkv.reshape(b, t, -1).to(x.dtype))


def _fused_head_call(heads, x, lp, params, cfg):
    """K4c for the last layer (JAX ``_fused_head_call`` :1182): the chain,
    the final norm and the q8_0 head in one launch → logits [B, T, vocab]
    f32 (padded rows sliced off), or None when the knob is off or the head
    is not q8_0."""
    if not isinstance(params.get("lm_head_q"), Q8Weight):
        return None
    b, t, h = x.shape
    res = q8_layer_head_fused(
        _merge_heads(heads, cfg).reshape(b * t, -1).to(torch.bfloat16),
        x.reshape(b * t, h), lp["post_ln"], params["final_ln"], lp["o_w"],
        lp["gate_up_w"], lp["down_w"], params["lm_head_q"], cfg.rms_eps)
    if res is None:
        return None
    return res[1].reshape(b, t, -1)[..., :cfg.vocab_size]


def _fused_mlp_call(heads, x, lp, cfg):
    """K4 without the next-layer stage, for the last layer (JAX
    ``_fused_mlp_call`` :1149)."""
    b, t, h = x.shape
    out = q8_mlp_fused(
        _merge_heads(heads, cfg).reshape(b * t, -1).to(torch.bfloat16),
        x.reshape(b * t, h), lp["post_ln"], lp["o_w"], lp["gate_up_w"],
        lp["down_w"], cfg.rms_eps)
    return out.reshape(b, t, h).to(x.dtype)


def _q8i_layer_call(heads, x_rows, lp, lp_next, cfg):
    """K7 for layer ``lp`` (JAX ``_q8i_layer_call`` :1211): the merged
    heads quantized to q8_0 (inside the kernel on CUDA), then the chain;
    with ``lp_next`` also that layer's input norm and qkv. ``x_rows``
    [B*T, H] f32 is the residual → (the new residual rows, qkv rows
    [B*T, n_qkv] | None)."""
    b, t = heads.shape[0], heads.shape[2]
    nxt = lp_next is not None
    return q8i_layer_fused_rows(
        _merge_heads(heads, cfg).reshape(b * t, -1), x_rows, lp["post_ln"],
        lp_next["input_ln"] if nxt else None, lp["o_w"], lp["gate_up_w"],
        lp["down_w"], lp_next["qkv_w"] if nxt else None, cfg.rms_eps)


def _gqa_scores(q, k, cfg):
    """q [B,T,qh,D], k [B,S,kh,D] → scores [B,qh,T,S] (f32, scaled)."""
    group = cfg.q_heads // cfg.kv_heads
    b, t = q.shape[:2]
    qg = q.reshape(b, t, cfg.kv_heads, group, cfg.head_dim)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.to(torch.float32),
                          k.to(torch.float32)) * _attn_scale(cfg)
    return scores.reshape(b, cfg.q_heads, t, k.shape[1])


def _gqa_mix(probs, v, cfg):
    """probs [B,qh,T,S] f32, v [B,S,kh,D] → [B,qh,T,D] in v's dtype."""
    group = cfg.q_heads // cfg.kv_heads
    b, _, t, s = probs.shape
    pg = probs.reshape(b, cfg.kv_heads, group, t, s).to(v.dtype)
    out = torch.einsum("bkgts,bskd->bkgtd", pg.to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, cfg.q_heads, t, cfg.head_dim).to(v.dtype)


def _attend_cache(q, kv: KVCache, l: int, bias, cfg):
    """q [B,T,qh,D] over layer ``l`` of the cache with bias [B,T,S]
    → [B,qh,T,D], through K2, or K2-i8 for an int8 cache (q pre-scaled in
    its own dtype, as the JAX flash path does)."""
    qs = (q.to(torch.float32) * _attn_scale(cfg)).to(q.dtype).contiguous()
    if isinstance(kv.k, QuantKV):
        return flash_decode_attention(qs, kv.k.q[l], kv.v.q[l], bias,
                                      kv.k.s[l], kv.v.s[l])
    return flash_decode_attention(qs, kv.k[l], kv.v[l], bias)


def _lm_head(params, cfg):
    """The dense output projection [hidden, vocab]."""
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def _logits(params, x, cfg):
    """x [..., hidden] → logits [..., vocab] f32 (JAX ``_logits_raw``
    :1945): the int8-dot head ``lm_head_qn`` through K6 (K1 above 16 rows)
    or the q8_0 head through K1 (padded vocab rows sliced off), the
    per-channel int8 head on bf16-rounded x with the f32 scale after the
    product, or the dense head."""
    if "lm_head_qn" in params:
        return matmul_any(x, params["lm_head_qn"])[..., :cfg.vocab_size]
    if "lm_head_q" in params:
        return matmul_any(x, params["lm_head_q"])[..., :cfg.vocab_size]
    if "lm_head_i8" in params:
        w, s = params["lm_head_i8"]
        return matmul_any(x.to(torch.bfloat16), w) * s
    return matmul_any(x, _lm_head(params, cfg))


def embed_tokens(params, token_ids):
    return params["embed"][token_ids]


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def qwen3_prefill(params, embeds, attn_mask, cfg, kv_max_len=None,
                  kv_int8: bool = False):
    """embeds [B, P, H] left-padded, attn_mask [B, P] (1 = valid) →
    (last-position logits [B, vocab] f32, KVCache with slots [0, P)
    written). Attention runs on the unquantized k/v; ``kv_int8`` stores
    the cache as int8 (:class:`QuantKV`)."""
    b, p, _ = embeds.shape
    dev = embeds.device
    kv = init_kv_cache(cfg, b, kv_max_len or p, embeds.dtype, dev, kv_int8)
    prompt_len = attn_mask.sum(dim=1).to(torch.int64)
    shift = p - prompt_len
    positions = (torch.arange(p, device=dev)[None, :] - shift[:, None])
    cos, sin = rope_cos_sin(positions.clamp_min(0), cfg.head_dim,
                            cfg.rope_theta, embeds.dtype)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    i = torch.arange(p, device=dev)
    causal = (i[None, :] <= i[:, None])[None, None]
    pad = (attn_mask > 0)[:, None, None, :]
    bias = torch.where(causal & pad, 0.0, NEG_INF).to(torch.float32)

    x = embeds
    layers = params["layers"]
    for l in range(cfg.n_layers):
        lp = _prefill_layer_params(layers, l)
        q, k, v = _qkv(rms_norm(x, lp["input_ln"], cfg.rms_eps), lp, cfg,
                       cos, sin)
        _kv_write(kv.k, l, (slice(None), slice(None, p)), k)
        _kv_write(kv.v, l, (slice(None), slice(None, p)), v)
        probs = torch.softmax(_gqa_scores(q, k, cfg) + bias, dim=-1)
        attn = _proj(_merge_heads(_gqa_mix(probs, v, cfg), cfg), lp["o_w"])
        x = x + attn
        x = x + _mlp(rms_norm(x, lp["post_ln"], cfg.rms_eps), lp)
    x = rms_norm(x, params["final_ln"], cfg.rms_eps)
    return _logits(params, x[:, -1, :], cfg), kv


def decode_bias(kv: KVCache, slot, valid_from):
    """[B, 1, S] f32: 0 on slots [valid_from, slot], -1e30 elsewhere;
    ``slot`` [1] on the device."""
    j = torch.arange(kv.max_len, device=valid_from.device)[None, :]
    visible = (j >= valid_from[:, None]) & (j <= slot)
    return torch.where(visible, 0.0, NEG_INF).to(torch.float32)[:, None, :]


def verify_bias(kv: KVCache, slots, t: int, valid_from):
    """[B, T, S] f32: query row i of batch row b sees slots
    [valid_from[b], slots[b] + i] (JAX ``qwen3_verify_step`` :1662)."""
    dev = valid_from.device
    j = torch.arange(kv.max_len, device=dev)[None, None, :]
    i = torch.arange(t, device=dev)[None, :, None]
    visible = (j >= valid_from[:, None, None]) & \
        (j <= slots[:, None, None] + i)
    return torch.where(visible, 0.0, NEG_INF).to(torch.float32)


def _layer_stack(params, kv: KVCache, x, cos, sin, bias, index, cfg):
    """The decoder layers over x [B, T, H] → logits [B, T, vocab] f32.
    Layer l's T new k/v rows go to ``cache[l][index]`` BEFORE it attends,
    so each token sees itself."""
    if kv.head_major:
        raise ValueError(
            "a head-major [L, kv_heads, S, D] cache is the all-layers "
            "kernel's (q8_mega params, b = 1 decode steps); this step needs "
            "the [L, B, S, kv_heads, D] cache")
    layers = params["layers"]
    if "q8i_fused" in params:
        # JAX's megacall v3 branch: layer l's K7 call also emits layer
        # l+1's qkv, so a layer costs K2 + K7; layer 0's qkv and the head
        # are the only K6 launches. The residual stays f32 rows [B*T, H]
        b, t, h = x.shape
        lp = _layer_params(layers, 0)
        qkv = _proj(rms_norm(x, lp["input_ln"], cfg.rms_eps), lp["qkv_w"])
        x_rows = x.reshape(b * t, h).to(torch.float32)
        for l in range(cfg.n_layers):
            q, k, v = _qkv_post(qkv.to(x.dtype), lp, cfg, cos, sin)
            _kv_write(kv.k, l, index, k)
            _kv_write(kv.v, l, index, v)
            heads = _attend_cache(q, kv, l, bias, cfg)
            lp_next = (_layer_params(layers, l + 1)
                       if l + 1 < cfg.n_layers else None)
            x_rows, qkv_rows = _q8i_layer_call(heads, x_rows, lp, lp_next,
                                               cfg)
            if lp_next is not None:
                qkv = qkv_rows.reshape(b, t, -1)
                lp = lp_next
        x = x_rows.reshape(b, t, h).to(x.dtype)
    elif "q8_fused" in params:
        # JAX's megacall v2 branch: layer l's K4 call also emits layer
        # l+1's qkv, so a layer costs K2 + K4; layer 0's qkv and the head
        # are the only K1 launches
        lp = _layer_params(layers, 0)
        qkv = _proj(rms_norm(x, lp["input_ln"], cfg.rms_eps), lp["qkv_w"])
        for l in range(cfg.n_layers):
            q, k, v = _qkv_post(qkv, lp, cfg, cos, sin)
            _kv_write(kv.k, l, index, k)
            _kv_write(kv.v, l, index, v)
            heads = _attend_cache(q, kv, l, bias, cfg)
            if l + 1 < cfg.n_layers:
                lp_next = _layer_params(layers, l + 1)
                x, qkv = _fused_mlp_qkv_call(heads, x, lp, lp_next, cfg)
                lp = lp_next
            else:
                logits = _fused_head_call(heads, x, lp, params, cfg)
                if logits is not None:
                    return logits
                x = _fused_mlp_call(heads, x, lp, cfg)
    else:
        for l in range(cfg.n_layers):
            lp = _layer_params(layers, l)
            q, k, v = _qkv(rms_norm(x, lp["input_ln"], cfg.rms_eps), lp, cfg,
                           cos, sin)
            _kv_write(kv.k, l, index, k)
            _kv_write(kv.v, l, index, v)
            heads = _attend_cache(q, kv, l, bias, cfg)
            x = x + _proj(_merge_heads(heads, cfg), lp["o_w"])
            x = x + _mlp(rms_norm(x, lp["post_ln"], cfg.rms_eps), lp)
    return _logits(params, rms_norm(x, params["final_ln"], cfg.rms_eps), cfg)


def _rope(positions, cfg, dtype):
    """positions [B, T] → (cos, sin) each [B, T, 1, D]."""
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, dtype)
    return cos[:, :, None, :], sin[:, :, None, :]


def qwen3_decode_step(params, kv: KVCache, token_embed, slot, position,
                      valid_from, cfg):
    """One generation step.

    token_embed [B, H]; ``slot`` is the cache slot written, the same for
    every row: [1] int64 on the device, or an int, which becomes one;
    position [B] the rope position; valid_from [B] the first valid slot.
    Returns (logits [B, vocab] f32, the same cache updated in place).
    Nothing here reads a device value on the host, so a CUDA graph can
    capture the step (``.decode_graph``)."""
    if isinstance(slot, int):
        slot = torch.full((1,), slot, dtype=torch.int64,
                          device=token_embed.device)
    if "q8_mega" in params and token_embed.shape[0] == 1 and kv.head_major:
        return _mega_decode_step(params, kv, token_embed, slot, position,
                                 valid_from, cfg), kv
    x = token_embed[:, None, :]
    cos, sin = _rope(position[:, None], cfg, x.dtype)
    logits = _layer_stack(params, kv, x, cos, sin,
                          decode_bias(kv, slot, valid_from), slot, cfg)
    return logits[:, 0], kv


def _mega_decode_step(params, kv: KVCache, token_embed, slot, position,
                      valid_from, cfg):
    """The b = 1 step through K5 (JAX :1511-1546): the kernel attends the
    current token in registers and returns its k/v rows, written here at
    ``slot`` ([1] on the device) in the cache's dtype. The bias hides the
    slot itself (``valid_from <= j < slot``)."""
    layers = params["layers"]
    x0 = token_embed.to(torch.float32)
    nhb0 = rms_norm(x0, layers["input_ln"][0], cfg.rms_eps).to(torch.bfloat16)
    cos, sin = rope_cos_sin(position, cfg.head_dim, cfg.rope_theta,
                            torch.float32)
    j = torch.arange(kv.max_len, device=x0.device)
    bias = torch.where((j >= valid_from[0]) & (j < slot), 0.0, NEG_INF).to(
        torch.float32)[None]
    logits, k_new, v_new = q8_decode_all_fused(
        x0, nhb0, layers["post_ln"], params["norms_next"], layers["q_norm"],
        layers["k_norm"], cos, sin, bias, kv.k, kv.v, layers["qkv_w"],
        layers["o_w"], layers["gate_up_w"], layers["down_w"],
        params["lm_head_q"], cfg.rms_eps)
    kv.k.index_copy_(2, slot, k_new[:, :, None].to(kv.k.dtype))
    kv.v.index_copy_(2, slot, v_new[:, :, None].to(kv.v.dtype))
    return logits[:, :cfg.vocab_size]


def qwen3_verify_step(params, kv: KVCache, token_embeds, slots, positions,
                      valid_from, cfg):
    """T tokens at once against the cache (the speculative verify pass):
    the same weight traffic as one decode step, T logits back.

    token_embeds [B, T, H]; slots [B] — token i of row b is written at
    ``slots[b] + i``; positions [B, T] the rope positions; valid_from [B].
    Returns (logits [B, T, vocab] f32, the same cache updated in place).
    Rejected drafts leave stale rows above the accepted point; every mask
    only exposes slots ``<= slots[b] + i``, so they stay invisible until
    overwritten."""
    b, t, _ = token_embeds.shape
    cos, sin = _rope(positions, cfg, token_embeds.dtype)
    rows = torch.arange(b, device=slots.device)[:, None]
    cols = slots[:, None] + torch.arange(t, device=slots.device)[None, :]
    return _layer_stack(params, kv, token_embeds, cos, sin,
                        verify_bias(kv, slots, t, valid_from), (rows, cols),
                        cfg), kv
