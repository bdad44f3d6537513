"""Qwen3 (llama.cpp's GGUF arch ``qwen3``), the decoder of Fun-ASR-Nano-2512.

Its tensors as the checkpoint writer draws them (the seven layer
matrices stacked ``[n_layers, out, in]``, then the tied embedding
``[vocab, hidden]``), its GGUF (q8_0 matmul weights and embedding, f32
norm scales 1), the plain decoder, the bytes and operations of a decode
step, and the CPU rehearsal's shapes (``HybridConfig.tiny()``).

The plain decoder: RMSNorm, per-head q/k norms, half-split rope,
grouped-query causal attention, SwiGLU, the tied head; the draw's norm
scales are 1. Its weights are in the configuration's stated format: the
q8_0 values as stored; for ``int8``, per-output-channel int8 quantized
from the bf16-loaded weights (bf16 scale) and a per-vocab int8 head (f32
scale); for ``q8_0`` the head re-quantized to q8_0 from the bf16-loaded
embedding. Every layer is dequantized to float32 once, when it is built.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch import reference, roofline, weights


def _layer_shapes(llm):
    """GGUF name template -> [out, in] of the q8_0 layer matrices."""
    h = llm["hidden"]
    qd = llm["q_heads"] * llm["head_dim"]
    kd = llm["kv_heads"] * llm["head_dim"]
    return {"attn_q": (qd, h), "attn_k": (kd, h), "attn_v": (kd, h),
            "attn_output": (h, qd), "ffn_gate": (llm["ffn_dim"], h),
            "ffn_up": (llm["ffn_dim"], h), "ffn_down": (h, llm["ffn_dim"])}


def layer_mats(llm):
    """(out, in) of the packed products of one decoder layer (K4's)."""
    h, f = llm["hidden"], llm["ffn_dim"]
    qd = llm["q_heads"] * llm["head_dim"]
    kd = llm["kv_heads"] * llm["head_dim"]
    return {"qkv": (qd + 2 * kd, h), "o": (h, qd), "gate_up": (2 * f, h),
            "down": (h, f)}


def decoder_tensors(llm):
    """The drawn tensors in draw order: the layer matrices stacked, then
    ``token_embd``."""
    n_l = llm["n_layers"]
    mats = {name: (n_l, o, i) for name, (o, i) in _layer_shapes(llm).items()}
    mats["token_embd"] = (llm["vocab_size"], llm["hidden"])
    return mats


def write_gguf(path, llm, dec):
    """A llama.cpp qwen3 GGUF v3: tied embedding, q8_0 matmul weights."""
    h, n_l = llm["hidden"], llm["n_layers"]
    kvs = [("general.architecture", "qwen3"),
           ("qwen3.embedding_length", h), ("qwen3.block_count", n_l),
           ("qwen3.attention.head_count", llm["q_heads"]),
           ("qwen3.attention.head_count_kv", llm["kv_heads"]),
           ("qwen3.attention.key_length", llm["head_dim"]),
           ("qwen3.attention.value_length", llm["head_dim"]),
           ("qwen3.feed_forward_length", llm["ffn_dim"]),
           ("qwen3.rope.freq_base", float(llm["rope_theta"])),
           ("qwen3.attention.layer_norm_rms_epsilon", float(llm["rms_eps"])),
           ("qwen3.context_length", llm["max_position"])]
    ones_h = np.ones(h, np.float32).tobytes()
    ones_d = np.ones(llm["head_dim"], np.float32).tobytes()
    tensors = [("token_embd.weight", 8, dec["token_embd"][0].shape,
                lambda: weights.q8_0_bytes(*dec["token_embd"])),
               ("output_norm.weight", 0, (h,), lambda: ones_h)]
    for i in range(n_l):
        tensors += [(f"blk.{i}.attn_norm.weight", 0, (h,), lambda: ones_h),
                    (f"blk.{i}.ffn_norm.weight", 0, (h,), lambda: ones_h)]
        if llm["qk_norm"]:
            tensors += [(f"blk.{i}.attn_q_norm.weight", 0,
                         (llm["head_dim"],), lambda: ones_d),
                        (f"blk.{i}.attn_k_norm.weight", 0,
                         (llm["head_dim"],), lambda: ones_d)]
        for name in _layer_shapes(llm):
            q, d = dec[name]
            tensors.append((f"blk.{i}.{name}.weight", 8, q.shape[1:],
                            lambda q=q[i], d=d[i]: weights.q8_0_bytes(q, d)))
    weights.write_gguf_v3(path, kvs, tensors)


def _dmm(x, w, act):
    """x [..., k] @ w[n, k]^T."""
    if act == "fp8":
        return reference.fp8(reference.fp8(x) @ w.t())
    return x @ w.t()


class Decoder:
    """The plain decoder of the drawn q8_0 pairs ``dec`` on ``device``."""

    def __init__(self, cfg, dec, device):
        self.llm, self.dev = cfg["model"]["llm"], device
        fmt = cfg["decoder_weights"]
        self.layers = []
        for i in range(self.llm["n_layers"]):
            lay = {}
            for name in _layer_shapes(self.llm):
                w = reference.q8_0_dequant(dec[name][0][i], dec[name][1][i])
                if fmt == "int8":
                    w = reference.int8_rows(w.bfloat16().float(),
                                            torch.bfloat16)
                lay[name] = w
            self.layers.append(lay)
        self.embed = reference.q8_0_dequant(*dec["token_embd"])
        loaded = self.embed.bfloat16().float()
        self.head = (reference.q8_0_requant(loaded) if fmt == "q8_0"
                     else reference.int8_rows(loaded, torch.float32))

    def logits(self, prompt, tokens, act=None, routes=None):
        """The next-token logits after ``prompt`` [P, h] and each prefix of
        ``tokens`` [n]: rows P-1 ... P+n-1 of one causal pass → ([n + 1,
        vocab], {}); row i predicts token i. A dense decoder has no
        ``routes`` to follow."""
        if routes is not None:
            raise ValueError("qwen3 is dense: it has no routes to follow")
        llm = self.llm
        eps, hd = llm["rms_eps"], llm["head_dim"]
        qh, kh = llm["q_heads"], llm["kv_heads"]
        x = torch.cat([prompt, self.embed[tokens]])
        t = x.shape[0]
        pos = torch.arange(t, dtype=torch.float32, device=self.dev)
        inv = 1.0 / (llm["rope_theta"] ** (torch.arange(
            hd // 2, dtype=torch.float32, device=self.dev) / (hd // 2)))
        ang = torch.cat([pos[:, None] * inv] * 2, dim=-1)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        causal = torch.full((t, t), float("-inf"), device=self.dev).triu(1)

        def rms(a):
            return a * torch.rsqrt(a.square().mean(-1, keepdim=True) + eps)

        def rope(a):
            half = hd // 2
            return a * cos + torch.cat([-a[..., half:], a[..., :half]],
                                       -1) * sin
        for lay in self.layers:
            h = rms(x)
            q = rope(rms(_dmm(h, lay["attn_q"], act).reshape(t, qh, hd)))
            k = rope(rms(_dmm(h, lay["attn_k"], act).reshape(t, kh, hd)))
            v = _dmm(h, lay["attn_v"], act).reshape(t, kh, hd)
            k = k.repeat_interleave(qh // kh, dim=1)
            v = v.repeat_interleave(qh // kh, dim=1)
            s = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5 + causal
            o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
            x = x + _dmm(o.reshape(t, qh * hd), lay["attn_output"], act)
            h = rms(x)
            x = x + _dmm(F.silu(_dmm(h, lay["ffn_gate"], act))
                         * _dmm(h, lay["ffn_up"], act),
                         lay["ffn_down"], act)
        rows = rms(x[prompt.shape[0] - 1:])
        return _dmm(rows, self.head, act), {}


def decode_token(llm, fmt, visible):
    """(bytes, operations) one decode step must move and compute at batch
    1 with ``visible`` cache slots: every decoder weight in the format, the
    head (q8_0: padded vocab; int8: per-vocab f32 scales; tied), the norm
    scales, the embedding row, and the visible bf16 K and V of every
    layer."""
    n_l, h = llm["n_layers"], llm["hidden"]
    mats = layer_mats(llm)
    w = n_l * sum(roofline.weight_bytes(o, i, fmt) for o, i in mats.values())
    vocab = llm["vocab_size"]
    if fmt == "q8_0":
        head = math.ceil(vocab / roofline.HEAD_PAD) * roofline.HEAD_PAD * h \
            * roofline.Q8_BYTES_PER_WEIGHT
    elif fmt == "int8":
        head = vocab * h + vocab * 4
    else:
        head = vocab * h * roofline.BF16
    norms = (n_l * (2 * h + 2 * llm["head_dim"]) + h) * roofline.BF16
    kv_row = 2 * n_l * llm["kv_heads"] * llm["head_dim"] * roofline.BF16
    n_bytes = w + head + norms + h * roofline.BF16 + visible * kv_row
    params = n_l * sum(o * i for o, i in mats.values()) + vocab * h
    attn = 4 * n_l * llm["q_heads"] * llm["head_dim"] * visible
    return n_bytes, 2 * params + attn


def tiny_llm():
    """The LLM of ``HybridConfig.tiny()``, the CPU rehearsal's."""
    return {"hidden": 64, "n_layers": 2, "q_heads": 4, "kv_heads": 2,
            "head_dim": 16, "ffn_dim": 128, "vocab_size": 512,
            "rope_theta": 10000.0, "rms_eps": 1e-06, "tie_embeddings": True,
            "max_position": 40960, "arch": "qwen3", "qk_norm": True}
