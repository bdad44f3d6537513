"""Convert the JAX package's parameter trees into the port's.

Input is the JAX trees as NUMPY (``jax.tree_util.tree_map(np.asarray,
tree)`` on the caller's side), so this module never sees a jax type.
Dense leaves become tensors in the compute dtype (integer leaves keep
their dtype). A q8_0 ``QuantTensor`` arrives as a ``(q, d)`` pair whose
``q`` is int8 in the TPU kernel's BLOCK-PERMUTED k order
(``fun_asr_gguf_tpu/ops/quant_matmul.py:45-56``: natural ``b*32+t`` lives
at ``t*(k/32)+b``); it is un-permuted here, in numpy, into the natural
``[..., n, k]`` int8 + ``[..., n, k/32]`` f32 :class:`Q8Weight` the CUDA
kernel reads.

A JAX ``Int8Weight`` (``w8``, ``scale``) becomes the port's
:class:`Int8Weight` unchanged, the per-channel head ``lm_head_i8`` a pair
of tensors, and a JAX ``KVCache`` (bf16, or ``QuantKV`` halves) the port's
(:func:`kv_from_jax`).

A tree that went through the JAX ``fuse_qwen3_params_q8`` (``qwen3.py:657``)
also lives in the TPU's perm space: o / gate_up (each half) / down have
block-permuted OUTPUT channels and the norm weights are block-permuted.
:func:`q8_fused_from_jax` undoes both and gives the port's fused tree.
"""

import numpy as np
import torch

from ..ops.quant_matmul import BLOCK, Int8Weight, Q8Weight


def block_unpermute(a: np.ndarray) -> np.ndarray:
    """[..., k] block-permuted (t*(k/32)+b) → natural (b*32+t) order."""
    k = a.shape[-1]
    return (a.reshape(*a.shape[:-1], BLOCK, k // BLOCK)
            .swapaxes(-1, -2).reshape(a.shape))


def _unpermute_axis(a: np.ndarray, axis: int) -> np.ndarray:
    return np.moveaxis(block_unpermute(np.moveaxis(a, axis, -1)), -1, axis)


def unpermute_out_channels(pair, halves: int = 1):
    """Inverse of JAX ``permute_out_channels`` (``quant_matmul.py:542``) on a
    numpy (q, d) pair: natural order along the n axis, each half apart."""
    def undo(a):
        parts = np.split(a, halves, axis=-2)
        return np.concatenate([_unpermute_axis(p, -2) for p in parts],
                              axis=-2)
    return tuple(undo(np.asarray(a)) for a in pair)


def q8_fused_from_jax(tree, device=None, dtype=torch.float32):
    """A JAX ``fuse_qwen3_params_q8`` tree (as numpy) → the port's fused
    tree: output channels of o / gate_up / down and the input / post /
    final norm weights back in natural order, then the ``q8_fused``
    marker (:func:`..qwen3.fuse_qwen3_params_q8`)."""
    from .qwen3 import fuse_qwen3_params_q8
    layers = dict(tree["layers"])
    for key, halves in (("o_w", 1), ("gate_up_w", 2), ("down_w", 1)):
        layers[key] = unpermute_out_channels(layers[key], halves)
    for key in ("input_ln", "post_ln"):
        layers[key] = block_unpermute(np.asarray(layers[key]))
    out = {k: v for k, v in tree.items() if k != "q8_fused"}
    out["layers"] = layers
    out["final_ln"] = block_unpermute(np.asarray(tree["final_ln"]))
    return fuse_qwen3_params_q8(to_torch(out, device, dtype))


def _fields(x):
    """Field names of a NamedTuple leaf (``QuantTensor`` has q, d;
    ``Int8Weight`` w8, scale); None for anything else."""
    return getattr(type(x), "_fields", None)


def _is_quant_pair(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], np.ndarray) and x[0].dtype == np.int8)


def q8_from_jax(pair, device=None) -> Q8Weight:
    """A JAX ``QuantTensor`` (as a numpy (q, d) pair) → natural Q8Weight."""
    q, d = pair
    return Q8Weight(
        q=torch.from_numpy(np.array(block_unpermute(q))).to(device),
        d=torch.from_numpy(np.array(d, dtype=np.float32)).to(device))


def to_torch(tree, device=None, dtype=torch.float32):
    """Numpy parameter tree → tensors (floats in ``dtype``); q8_0 pairs →
    :class:`Q8Weight`; ``Int8Weight`` → :class:`Int8Weight` (its bf16
    scales kept in bf16); ``lm_head_i8`` → (int8, f32) tensors."""
    if _fields(tree) == ("w8", "scale"):
        return Int8Weight(w8=to_torch(tree.w8, device),
                          scale=to_torch(tree.scale, device, torch.bfloat16))
    if _is_quant_pair(tree):
        return q8_from_jax(tree, device)
    if isinstance(tree, dict):
        return {k: (tuple(to_torch(a, device) for a in v)
                    if k == "lm_head_i8" else to_torch(v, device, dtype))
                for k, v in tree.items()}
    a = np.array(tree)
    if a.dtype.name == "bfloat16":        # ml_dtypes: exact through f32
        a = a.astype(np.float32)
    t = torch.from_numpy(a)
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def kv_from_jax(kv, device=None, dtype=torch.float32):
    """A JAX ``KVCache`` (as numpy) → the port's: bf16 arrays become
    tensors in ``dtype``; ``QuantKV`` halves keep their int8 values and
    get their scales in ``dtype``."""
    from .qwen3 import KVCache, QuantKV

    def half(a):
        if _fields(a) == ("q", "s"):
            return QuantKV(q=to_torch(a.q, device),
                           s=to_torch(a.s, device, dtype))
        return to_torch(a, device, dtype)
    return KVCache(k=half(kv.k), v=half(kv.v))
