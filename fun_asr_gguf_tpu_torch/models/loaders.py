"""Checkpoint directory → port parameters, and a numpy random-checkpoint writer.

Counterpart of the checkpoint half of ``fun_asr_gguf_tpu/models/loaders.py``
(``load_checkpoint`` :1312, ``load_qwen3_from_gguf`` :386,
``qwen3_config_from_gguf`` :98, ``create_random_checkpoint(fast_q8=True)``
:1430). The directory layout is the JAX package's:

* ``config.json`` — encoder / adaptor / ctc / llm dataclass fields;
* ``encoder.safetensors`` — encoder, adaptor and CTC trees flattened with
  ``.`` keys (``encoder.encoders.attn.qkv.w`` …, stacked layers keep their
  leading layer dim);
* ``decoder.gguf`` — a llama.cpp qwen3 GGUF whose matmul weights are q8_0.

Only the qwen3 arch is read here; other GGUF families raise
``NotImplementedError``. The decoder's matmul weights load either as q8_0
(``keep_quantized``, the q8_0 GGUF bytes) or dense in the compute dtype
(JAX ``load_qwen3_from_gguf(keep_quantized=False)``), from which the
int8 format is quantized. The safetensors
format (8-byte header length, JSON header, raw little-endian bytes) is
read and written with numpy alone.
"""

import json
import os
import struct
from dataclasses import asdict
from typing import Dict

import numpy as np
import torch

from ..formats.gguf import GGMLType, GGUFReader, GGUFWriter
from ..ops.quant_matmul import Q8Weight
from .config import (AdaptorConfig, CTCHeadConfig, EncoderConfig,
                     HybridConfig, Qwen3Config)

CONFIG_FILE = "config.json"
ENCODER_FILE = "encoder.safetensors"
DECODER_GGUF = "decoder.gguf"

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """All tensors of a safetensors file (BF16 is widened to f32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = np.fromfile(f, dtype=np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        a, b = info["data_offsets"]
        raw = data[a:b]
        if info["dtype"] == "BF16":
            arr = (raw.view(np.uint16).astype(np.uint32) << 16).view(
                np.float32)
        else:
            arr = raw.view(_ST_DTYPES[info["dtype"]])
        out[name] = arr.reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Dict[str, np.ndarray]):
    """Write tensors contiguously in key order (header padded to 8 B)."""
    header, offset, blobs = {}, 0, []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        raw = arr.tobytes()
        header[name] = {"dtype": _ST_NAMES[arr.dtype],
                        "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict = {}
    for key, value in flat.items():
        node = root
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return root


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tree_to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree))
    return (t.to(dtype) if t.is_floating_point() else t).to(device)


# ---------------------------------------------------------------------------
# GGUF → qwen3 decoder
# ---------------------------------------------------------------------------

_UNSUPPORTED_ARCH = ("ROADMAP.md, Queue 1: 'Other decoder families'")


def qwen3_config_from_gguf(reader: GGUFReader) -> Qwen3Config:
    """Hyperparameters of a qwen3 GGUF (the only arch ported so far)."""
    f = reader.fields
    arch = str(f.get("general.architecture", "qwen3"))
    names = set(reader.tensor_names())
    if arch != "qwen3" or "blk.0.attn_q.bias" in names \
            or int(f.get(f"{arch}.expert_count", 0)):
        raise NotImplementedError(
            f"GGUF architecture {arch!r}: only dense qwen3 is ported "
            f"({_UNSUPPORTED_ARCH})")

    def g(key, default):
        return f.get(f"{arch}.{key}", default)
    vocab, hidden = reader.tensor_info("token_embd.weight").shape
    q_heads = int(g("attention.head_count", 16))
    hidden = int(g("embedding_length", hidden))
    return Qwen3Config(
        hidden=hidden,
        n_layers=int(g("block_count", 28)),
        q_heads=q_heads,
        kv_heads=int(g("attention.head_count_kv", 8)),
        head_dim=int(g("attention.key_length", hidden // q_heads)),
        ffn_dim=int(g("feed_forward_length", 3072)),
        vocab_size=int(vocab),
        rope_theta=float(g("rope.freq_base", 1e6)),
        rms_eps=float(g("attention.layer_norm_rms_epsilon", 1e-6)),
        tie_embeddings="output.weight" not in names,
        max_position=int(g("context_length", 40960)),
        arch=arch,
        qk_norm="blk.0.attn_q_norm.weight" in names,
        attn_bias=False)


def load_qwen3_from_gguf(path: str, device=None, dtype=torch.bfloat16,
                         keep_quantized: bool = True):
    """Load a qwen3 GGUF → (params, config, host f32 embedding table).

    With ``keep_quantized`` the matmul weights stay int8 + scales
    (:class:`Q8Weight`, natural k order, stacked ``[L, n, k]``; a tensor
    that is not q8_0 raises). Without it every matmul weight is
    dequantized to f32, transposed to ``[in, out]`` and cast to ``dtype``
    (stacked ``[L, in, out]``), as JAX's dense route does: the int8
    quantizer then sees the same ``dtype``-rounded values as JAX's. Norms
    and the device embedding table are in ``dtype``. An untied
    ``output.weight`` is kept dense under ``lm_head`` (``[hidden, vocab]``)
    for the head quantizers of :mod:`..qwen3`.
    """
    r = GGUFReader(path)
    cfg = qwen3_config_from_gguf(r)

    def q8(name):
        info = r.tensor_info(name)
        if info.ggml_type != GGMLType.Q8_0:
            raise NotImplementedError(
                f"{name} is {info.ggml_type.name}: llm_weight_format='q8_0' "
                "takes q8_0 decoder weights; load this GGUF with 'bf16' or "
                "'int8'")
        return r.tensor_q8_0(name)

    def stack_q8(fmt):
        pairs = [q8(fmt.format(i)) for i in range(cfg.n_layers)]
        q = torch.from_numpy(np.stack([p[0] for p in pairs]))
        d = torch.from_numpy(np.stack([p[1] for p in pairs]).astype(
            np.float32))
        return Q8Weight(q=q.to(device), d=d.to(device))

    def stack_dense(fmt):
        return torch.from_numpy(np.stack([
            np.ascontiguousarray(r.tensor(fmt.format(i)).astype(np.float32).T)
            for i in range(cfg.n_layers)])).to(device=device, dtype=dtype)

    mat = stack_q8 if keep_quantized else stack_dense

    def vstack(fmt):
        return torch.from_numpy(np.stack(
            [r.tensor(fmt.format(i)).astype(np.float32)
             for i in range(cfg.n_layers)])).to(device=device, dtype=dtype)

    embed = r.tensor("token_embd.weight").astype(np.float32)   # [vocab, h]
    layers = {
        "input_ln": vstack("blk.{}.attn_norm.weight"),
        "post_ln": vstack("blk.{}.ffn_norm.weight"),
        "q_w": mat("blk.{}.attn_q.weight"),
        "k_w": mat("blk.{}.attn_k.weight"),
        "v_w": mat("blk.{}.attn_v.weight"),
        "o_w": mat("blk.{}.attn_output.weight"),
        "gate_w": mat("blk.{}.ffn_gate.weight"),
        "up_w": mat("blk.{}.ffn_up.weight"),
        "down_w": mat("blk.{}.ffn_down.weight"),
    }
    if cfg.qk_norm:
        layers["q_norm"] = vstack("blk.{}.attn_q_norm.weight")
        layers["k_norm"] = vstack("blk.{}.attn_k_norm.weight")
    params = {
        "layers": layers,
        "final_ln": torch.from_numpy(
            r.tensor("output_norm.weight").astype(np.float32)).to(
                device=device, dtype=dtype),
        "embed": torch.from_numpy(embed).to(device=device, dtype=dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.from_numpy(np.ascontiguousarray(
            r.tensor("output.weight").astype(np.float32).T)).to(
                device=device, dtype=dtype)
    return params, cfg, embed


# ---------------------------------------------------------------------------
# checkpoint directory
# ---------------------------------------------------------------------------

def _cfg_from_dict(d) -> HybridConfig:
    ctc = dict(d["ctc"])
    ad = ctc.pop("adaptor")
    return HybridConfig(encoder=EncoderConfig(**d["encoder"]),
                        adaptor=AdaptorConfig(**d["adaptor"]),
                        ctc=CTCHeadConfig(adaptor=AdaptorConfig(**ad), **ctc),
                        llm=Qwen3Config(**d["llm"]))


def load_checkpoint(ckpt_dir: str, device=None, dtype=torch.float32,
                    llm_keep_quantized: bool = True):
    """Load a checkpoint directory → (cfg, encoder, adaptor, ctc, llm,
    host f32 embedding table). Every float tensor is in ``dtype``; the
    decoder's matmul weights stay q8_0 with ``llm_keep_quantized``, else
    they are dense (:func:`load_qwen3_from_gguf`)."""
    with open(os.path.join(ckpt_dir, CONFIG_FILE)) as f:
        cfg = _cfg_from_dict(json.load(f))
    groups: Dict[str, Dict[str, np.ndarray]] = {
        "encoder": {}, "adaptor": {}, "ctc": {}}
    for k, v in read_safetensors(os.path.join(ckpt_dir, ENCODER_FILE)).items():
        head, rest = k.split(".", 1)
        groups[head][rest] = v
    enc, ada, ctc = (_tree_to_torch(_unflatten(groups[g]), device, dtype)
                     for g in ("encoder", "adaptor", "ctc"))
    llm, llm_cfg, embed = load_qwen3_from_gguf(
        os.path.join(ckpt_dir, DECODER_GGUF), device=device, dtype=dtype,
        keep_quantized=llm_keep_quantized)
    cfg = HybridConfig(encoder=cfg.encoder, adaptor=cfg.adaptor, ctc=cfg.ctc,
                       llm=llm_cfg)
    return cfg, enc, ada, ctc, llm, embed


# ---------------------------------------------------------------------------
# random checkpoint (numpy only)
# ---------------------------------------------------------------------------

def _ln(d):
    return {"scale": (d,), "bias": (d,)}


def _lin(i, o):
    return {"w": (i, o), "b": (o,)}


def _sanm_shapes(in_size, size, ffn, kernel, with_ffn=True):
    p = {"norm1": _ln(in_size),
         "attn": {"qkv": _lin(in_size, 3 * size), "out": _lin(size, size),
                  "fsmn_w": (kernel, size)}}
    if with_ffn:
        p["norm2"] = _ln(size)
        p["ffn"] = {"w1": _lin(size, ffn), "w2": _lin(ffn, size)}
    return p


def _stacked(shapes, n):
    return {k: _stacked(v, n) if isinstance(v, dict) else (n, *v)
            for k, v in shapes.items()}


def _adaptor_shapes(c: AdaptorConfig):
    p = {"linear1": _lin(c.in_dim * c.downsample, c.ffn_dim),
         "linear2": _lin(c.ffn_dim, c.out_dim)}
    if c.n_layers > 0:
        d = c.out_dim
        p["blocks"] = _stacked({
            "norm1": _ln(d), "norm2": _ln(d),
            "attn": {n: _lin(d, d) for n in ("q", "k", "v", "out")},
            "ffn": {"w1": _lin(d, c.block_ffn_dim),
                    "w2": _lin(c.block_ffn_dim, d)}}, c.n_layers)
    return p


def encoder_param_shapes(cfg: HybridConfig):
    """Shapes of the encoder / adaptor / ctc trees (``init_*_params``)."""
    e = cfg.encoder
    enc = {
        "encoder0": _sanm_shapes(e.input_size, e.d_model, e.ffn_dim,
                                 e.kernel_size, with_ffn=False),
        "encoders": _stacked(_sanm_shapes(e.d_model, e.d_model, e.ffn_dim,
                                          e.kernel_size), e.num_blocks - 1),
        "tp_encoders": _stacked(_sanm_shapes(e.d_model, e.d_model, e.ffn_dim,
                                             e.kernel_size), e.tp_blocks),
        "after_norm": _ln(e.d_model), "tp_norm": _ln(e.d_model)}
    ctc = {"decoder": _adaptor_shapes(cfg.ctc.adaptor),
           "proj": _lin(cfg.ctc.adaptor.out_dim, cfg.ctc.vocab_size)}
    return {"encoder": enc, "adaptor": _adaptor_shapes(cfg.adaptor),
            "ctc": ctc}


def _random_q8(rng, out_dim, in_dim):
    """Random q8_0 matrix generated directly as int8 + f16 scales (weights
    of std ~0.02, like ``_random_q8_llm_tree``)."""
    q = np.frombuffer(rng.bytes(out_dim * in_dim), np.int8).reshape(
        out_dim, in_dim)
    d = rng.uniform(2e-4, 3.5e-4, size=(out_dim, in_dim // 32)).astype(
        np.float16)
    return q, d


def write_random_checkpoint(ckpt_dir: str, cfg: HybridConfig = None,
                            seed: int = 0) -> HybridConfig:
    """Write a full checkpoint directory of random weights, numpy only.

    Mirrors ``create_random_checkpoint(fast_q8=True)``: the encoder,
    adaptor and CTC trees are f32 (scales of norms 1, everything else
    uniform ±0.05); the decoder is a qwen3 GGUF whose matmul weights and
    embedding are drawn directly in q8_0 space (norms 1)."""
    cfg = cfg or HybridConfig.tiny()
    llm = cfg.llm
    if llm.arch != "qwen3" or llm.is_moe or not llm.tie_embeddings:
        raise NotImplementedError(f"random checkpoints are written for the "
                                  f"tied dense qwen3 decoder only "
                                  f"({_UNSUPPORTED_ARCH})")
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, CONFIG_FILE), "w") as f:
        json.dump({"encoder": asdict(cfg.encoder),
                   "adaptor": asdict(cfg.adaptor),
                   "ctc": asdict(cfg.ctc), "llm": asdict(llm)}, f, indent=1)

    rng = np.random.default_rng(seed + 1)
    flat = {}
    for key, shape in sorted(_flatten(encoder_param_shapes(cfg)).items()):
        leaf = key.rsplit(".", 1)[-1]
        if "norm" in leaf or "scale" in leaf or "ln" in leaf:
            flat[key] = np.ones(shape, np.float32)
        else:
            flat[key] = rng.uniform(-0.05, 0.05, shape).astype(np.float32)
    write_safetensors(os.path.join(ckpt_dir, ENCODER_FILE), flat)

    rng = np.random.default_rng(seed)
    h, n = llm.hidden, llm.n_layers
    qd, kd = llm.q_heads * llm.head_dim, llm.kv_heads * llm.head_dim
    w = GGUFWriter(os.path.join(ckpt_dir, DECODER_GGUF), arch="qwen3")
    for key, val in (("embedding_length", h), ("block_count", n),
                     ("attention.head_count", llm.q_heads),
                     ("attention.head_count_kv", llm.kv_heads),
                     ("attention.key_length", llm.head_dim),
                     ("attention.value_length", llm.head_dim),
                     ("feed_forward_length", llm.ffn_dim),
                     ("rope.freq_base", float(llm.rope_theta)),
                     ("attention.layer_norm_rms_epsilon", float(llm.rms_eps)),
                     ("context_length", llm.max_position)):
        w.add_kv(f"qwen3.{key}", val)
    w.add_tensor_q8_0("token_embd.weight", *_random_q8(rng, llm.vocab_size, h))
    w.add_tensor("output_norm.weight", np.ones(h, np.float32))
    ones = np.ones(h, np.float32)
    for i in range(n):
        w.add_tensor(f"blk.{i}.attn_norm.weight", ones)
        w.add_tensor(f"blk.{i}.ffn_norm.weight", ones)
        if llm.qk_norm:
            w.add_tensor(f"blk.{i}.attn_q_norm.weight",
                         np.ones(llm.head_dim, np.float32))
            w.add_tensor(f"blk.{i}.attn_k_norm.weight",
                         np.ones(llm.head_dim, np.float32))
        for name, o, k in (("attn_q", qd, h), ("attn_k", kd, h),
                           ("attn_v", kd, h), ("attn_output", h, qd),
                           ("ffn_gate", llm.ffn_dim, h),
                           ("ffn_up", llm.ffn_dim, h),
                           ("ffn_down", h, llm.ffn_dim)):
            w.add_tensor_q8_0(f"blk.{i}.{name}.weight", *_random_q8(rng, o, k))
    w.write()
    return cfg
