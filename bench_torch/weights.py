"""Random weights from the seed, made on the device, and the checkpoint.

The same seed gives the same tensors (a ``torch.Generator`` on the
device, a few large draws), so the harness makes them once to write the
checkpoint directory the program loads, and again after the window for
the plain reference. The checkpoint is what ``create_asr_engine`` reads:
``config.json``, ``encoder.safetensors`` (bf16, the encoder's served
type), ``decoder.gguf`` (the GGUF of the configuration's decoder
architecture, written by ``arch/<arch>.py`` on this module's GGUF v3
layout) and ``tokens.txt``. The writers are the formats' own, written
here: nothing of the program makes the weights.

Draws (the checkpoint writer's): encoder, adaptor and CTC leaves uniform
+-0.05 in bf16 but the LayerNorm scales, which are 1; then the
decoder's tensors (``decoder_tensors`` of its architecture, in order) in
q8_0: int8 values uniform over [-128, 127] with f16 block scales
uniform in [2e-4, 3.5e-4].
"""

import base64
import json
import os
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from . import arch

QK = 32                 # q8_0 block
GGUF_ALIGN = 32


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def _lin(i, o):
    return {"w": (i, o), "b": (o,)}


def _ln(d):
    return {"scale": (d,), "bias": (d,)}


def _stack(tree, n):
    return {k: _stack(v, n) if isinstance(v, dict) else (n, *v)
            for k, v in tree.items()}


def _sanm(i, d, ffn, kernel, with_ffn=True):
    p = {"norm1": _ln(i), "attn": {"qkv": _lin(i, 3 * d), "out": _lin(d, d),
                                   "fsmn_w": (kernel, d)}}
    if with_ffn:
        p["norm2"] = _ln(d)
        p["ffn"] = {"w1": _lin(d, ffn), "w2": _lin(ffn, d)}
    return p


def _adaptor(a):
    p = {"linear1": _lin(a["in_dim"] * a["downsample"], a["ffn_dim"]),
         "linear2": _lin(a["ffn_dim"], a["out_dim"])}
    if a["n_layers"]:
        d = a["out_dim"]
        p["blocks"] = _stack({
            "norm1": _ln(d), "norm2": _ln(d),
            "attn": {n: _lin(d, d) for n in ("q", "k", "v", "out")},
            "ffn": {"w1": _lin(d, d // 4), "w2": _lin(d // 4, d)}},
            a["n_layers"])
    return p


def encoder_shapes(model) -> Dict[str, Tuple[int, ...]]:
    """Flat ``group.path.leaf`` -> shape of the encoder, adaptor and CTC
    trees (linear weights ``[in, out]``, stacked layers first)."""
    e = model["encoder"]
    tree = {
        "encoder": {
            "encoder0": _sanm(e["input_size"], e["d_model"], e["ffn_dim"],
                              e["kernel_size"], with_ffn=False),
            "encoders": _stack(_sanm(e["d_model"], e["d_model"], e["ffn_dim"],
                                     e["kernel_size"]), e["num_blocks"] - 1),
            "tp_encoders": _stack(_sanm(e["d_model"], e["d_model"],
                                        e["ffn_dim"], e["kernel_size"]),
                                  e["tp_blocks"]),
            "after_norm": _ln(e["d_model"]), "tp_norm": _ln(e["d_model"])},
        "adaptor": _adaptor(model["adaptor"]),
        "ctc": {"decoder": _adaptor(model["ctc"]["adaptor"]),
                "proj": _lin(model["ctc"]["adaptor"]["out_dim"],
                             model["ctc"]["vocab_size"])}}
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = v
    walk(tree, "")
    return dict(sorted(flat.items()))


# ---------------------------------------------------------------------------
# the draw
# ---------------------------------------------------------------------------

def draw(model, seed: int, device):
    """All weights of the seed on ``device``: (encoder leaves bf16 by flat
    name, decoder q8_0 pairs ``{name: (q int8 [*shape], d f16 [*shape[:-1],
    shape[-1] / 32])}`` of the architecture's ``decoder_tensors``)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    shapes = encoder_shapes(model)
    sizes = {k: int(np.prod(s)) for k, s in shapes.items()
             if not k.endswith(".scale")}
    flat = torch.empty(sum(sizes.values()), dtype=torch.bfloat16,
                       device=device).uniform_(-0.05, 0.05, generator=g)
    enc, off = {}, 0
    for k, s in shapes.items():
        if k.endswith(".scale"):
            enc[k] = torch.ones(s, dtype=torch.bfloat16, device=device)
        else:
            enc[k] = flat[off:off + sizes[k]].view(s)
            off += sizes[k]
    mats = arch.of(model["llm"]).decoder_tensors(model["llm"])
    n_w = sum(int(np.prod(s)) for s in mats.values())
    q_all = torch.randint(-128, 128, (n_w,), dtype=torch.int8, device=device,
                          generator=g)
    d_all = torch.empty(n_w // QK, dtype=torch.float32, device=device
                        ).uniform_(2e-4, 3.5e-4, generator=g).half()
    dec, off = {}, 0
    for name, s in mats.items():
        n = int(np.prod(s))
        dec[name] = (q_all[off:off + n].view(s),
                     d_all[off // QK:(off + n) // QK].view(*s[:-1],
                                                           s[-1] // QK))
        off += n
    return enc, dec


# ---------------------------------------------------------------------------
# the checkpoint directory
# ---------------------------------------------------------------------------

def _port_config(model):
    """config.json: the fields of the program's config dataclasses."""
    ctc = dict(model["ctc"])
    return {"encoder": model["encoder"], "adaptor": model["adaptor"],
            "ctc": ctc, "llm": model["llm"]}


def write_safetensors_bf16(path, tensors):
    header, off = {}, 0
    for k, t in tensors.items():
        n = t.numel() * 2
        header[k] = {"dtype": "BF16", "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.int16).cpu().numpy().tobytes())


def _kv(key, value):
    k = key.encode()
    out = struct.pack("<Q", len(k)) + k
    if isinstance(value, str):
        v = value.encode()
        return out + struct.pack("<IQ", 8, len(v)) + v
    if isinstance(value, bool):
        return out + struct.pack("<IB", 7, value)
    if isinstance(value, float):
        return out + struct.pack("<If", 6, value)
    return out + struct.pack("<II", 4, int(value))


def q8_0_bytes(q, d):
    """ggml block_q8_0 rows: per 32 values an f16 scale, then the int8s."""
    rows = q.reshape(-1, q.shape[-1] // QK, QK).view(torch.uint8)
    scales = d.reshape(-1, q.shape[-1] // QK, 1).contiguous().view(
        torch.uint8)
    return torch.cat([scales, rows], dim=-1).cpu().numpy().tobytes()


def write_gguf_v3(path, kvs, tensors):
    """A GGUF v3 file: the metadata ``kvs`` [(key, str | bool | float |
    int)] and then ``general.alignment``; ``tensors`` [(name, ggml type (0
    f32, 8 q8_0), shape in torch's order, a thunk of its bytes)], each
    aligned to ``GGUF_ALIGN``."""
    kvs = list(kvs) + [("general.alignment", GGUF_ALIGN)]

    def nbytes(gtype, shape):
        n = int(np.prod(shape))
        return n * 34 // QK if gtype == 8 else 4 * n
    infos, off = [], 0
    for name, gtype, shape, _ in tensors:
        b = name.encode()
        info = struct.pack("<Q", len(b)) + b + struct.pack("<I", len(shape))
        info += b"".join(struct.pack("<Q", n) for n in reversed(shape))
        infos.append(info + struct.pack("<IQ", gtype, off))
        off += nbytes(gtype, shape)
        off += -off % GGUF_ALIGN
    with open(path, "wb") as f:
        f.write(struct.pack("<IIQQ", 0x46554747, 3, len(tensors), len(kvs)))
        f.write(b"".join(_kv(k, v) for k, v in kvs))
        f.write(b"".join(infos))
        f.write(b"\0" * (-f.tell() % GGUF_ALIGN))
        for name, gtype, shape, data in tensors:
            raw = data()
            if len(raw) != nbytes(gtype, shape):
                raise ValueError(f"{name}: {len(raw)} bytes")
            f.write(raw)
            f.write(b"\0" * (-len(raw) % GGUF_ALIGN))


def write_checkpoint(root, model, seed: int, device) -> str:
    """The checkpoint directory of the seed under ``root``."""
    ckpt = os.path.join(root, "ckpt")
    os.makedirs(ckpt)
    enc, dec = draw(model, seed, device)
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(_port_config(model), f)
    write_safetensors_bf16(os.path.join(ckpt, "encoder.safetensors"), enc)
    arch.of(model["llm"]).write_gguf(os.path.join(ckpt, "decoder.gguf"),
                                     model["llm"], dec)
    n = model["ctc"]["vocab_size"]
    with open(os.path.join(ckpt, "tokens.txt"), "w", encoding="utf-8") as f:
        for i in range(n):
            ch = chr(0x4E00 + i % 20000) if i < n - 1 else "<blk>"
            f.write(f"{base64.b64encode(ch.encode()).decode()} {i}\n")
    return ckpt


def drop_weight_files(ckpt: str) -> None:
    """Delete the checkpoint's weight files (the small ones stay: the
    engine watches its hotword file there)."""
    for name in ("encoder.safetensors", "decoder.gguf"):
        os.unlink(os.path.join(ckpt, name))
