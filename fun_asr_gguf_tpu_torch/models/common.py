"""Shared functional building blocks (``fun_asr_gguf_tpu/models/common.py``).

Parameters are plain dicts of tensors with the JAX package's layout:
linear weights are ``[in, out]`` so the forward is ``x @ w + b``; stacked
layers carry a leading layer dim. Norms and softmax run in float32;
matmuls run in the parameter dtype and the result is cast back to the
activation dtype.
"""

import torch


def layer_norm(x, p, eps):
    """LayerNorm over the last axis (affine), in f32."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def rms_norm(x, scale, eps):
    """RMSNorm over the last axis, in f32."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def apply_rope(x, cos, sin):
    """Half-split rotary embedding of x [..., D] (JAX ``qwen3.apply_rope``
    :399); cos / sin broadcast against x."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def linear(x, p):
    """``x @ w (+ b)`` in the activation dtype (f32 accumulation)."""
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y.to(torch.float32) + p["b"].to(torch.float32)
    return y.to(x.dtype)


def additive_mask_bias(mask):
    """(mask - 1) * 10000 over keys: mask [B, T] → bias [B, 1, 1, T]."""
    return ((mask - 1.0) * 10000.0)[:, None, None, :]


def softmax_f32(scores):
    return torch.softmax(scores.to(torch.float32), dim=-1)


def split_heads(x, n_heads):
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x):
    b, h, t, dk = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dk)


def layer_slice(tree, i):
    """Layer ``i`` of a stacked parameter dict (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def n_stacked(tree) -> int:
    """Leading (layer) dim of a stacked parameter dict."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(tree.shape[0])
