"""Peaks of the card and the operations and bytes of the measured work.

Every count comes from a configuration file's shapes (``model``) and its
decoder weight format, never from the program. Bytes are what the work
must move: each input read once and each output written once, weights
as they lie in the card's memory (q8_0: 32 int8 + an f32 scale per 32
weights, the program's layout; per-channel int8: 1 byte a weight and a
bf16 scale a channel, the head's scale f32; bf16 2 bytes).

    python3 -m bench_torch.roofline      # prints every configuration's counts
"""

from . import arch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

Q8_BYTES_PER_WEIGHT = 36 / 32
BF16 = 2
HEAD_PAD = 1024       # the q8_0 head's vocab rows are padded to this


def bound_s(n_bytes, n_ops, kind="bf16"):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[kind])


def bound(n_bytes, n_ops, kind="bf16"):
    """:func:`bound_s` in ms, with what bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[kind]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def weight_bytes(out, inp, fmt):
    if fmt == "q8_0":
        return out * inp * Q8_BYTES_PER_WEIGHT
    if fmt == "int8":
        return out * inp + out * BF16
    return out * inp * BF16


def k4_bytes(llm, with_qkv=True, m=1):
    """K4, the fused per-layer q8_0 chain, at ``m`` rows: o, gate_up and
    down (and the next layer's qkv, K4a) in q8_0, the attention rows, the
    residual rows and the norm scales in, the residual (and qkv) rows out,
    all bf16 (PERF.md section 6: 17.69 / 12.98 MB of weights at m = 1).
    The layer's packed products are its architecture's ``layer_mats``."""
    mats = arch.of(llm).layer_mats(llm)
    names = ["o", "gate_up", "down"] + (["qkv"] if with_qkv else [])
    w = sum(weight_bytes(*mats[n], "q8_0") for n in names)
    h, qd = llm["hidden"], llm["q_heads"] * llm["head_dim"]
    act_in = m * (qd + h) * BF16 + h * 4 * (2 if with_qkv else 1)
    act_out = m * (h + (mats["qkv"][0] if with_qkv else 0)) * BF16
    return w + act_in + act_out


def k4_ops(llm, with_qkv=True, m=1):
    mats = arch.of(llm).layer_mats(llm)
    names = ["o", "gate_up", "down"] + (["qkv"] if with_qkv else [])
    return sum(2 * m * o * i for o, i in (mats[n] for n in names))


def decode_token(llm, fmt, visible):
    """(bytes, operations) one decode step must move and compute at batch
    1 with ``visible`` cache slots, as the decoder's architecture counts
    them (``arch/<arch>.py``)."""
    return arch.of(llm).decode_token(llm, fmt, visible)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def lfr_frames(n_samples, hop=160, lfr_n=6):
    """LFR frames of ``n_samples`` of 16 kHz audio."""
    return (n_samples // hop + 1 + lfr_n - 1) // lfr_n


def k3_count(model, t):
    """K3 (encoder attention) at ``t`` frames: (bytes, operations) of one
    call over all heads: q, k, v in and out in bf16, the f32 key bias."""
    e = model["encoder"]
    d = e["d_model"]
    return 4 * t * d * BF16 + t * 4, 4 * t * t * d


def _sanm(t, d_in, d, ffn, kernel, with_ffn=True):
    ops = 2 * t * d_in * 3 * d + 2 * t * d * d + 4 * t * t * d \
        + 2 * t * d * kernel
    w = d_in * 3 * d + 3 * d + d * d + d + kernel * d + 2 * d_in
    if with_ffn:
        ops += 4 * t * d * ffn
        w += 2 * d * ffn + ffn + d + 2 * d
    return w * BF16, ops


def _adaptor(t, a):
    d = a["out_dim"]
    ops = 2 * t * a["in_dim"] * a["ffn_dim"] + 2 * t * a["ffn_dim"] * d
    w = a["in_dim"] * a["ffn_dim"] + a["ffn_dim"] + a["ffn_dim"] * d + d
    for _ in range(a["n_layers"]):
        ops += 8 * t * d * d + 4 * t * t * d + 4 * t * d * (d // 4)
        w += 4 * (d * d + d) + 2 * d * (d // 4) + d // 4 + d + 4 * d
    return w * BF16, ops


def encode_count(model, n_samples, n_fft=400, n_mels=80):
    """(bytes, operations) of one encode (frontend, SANM stack, adaptor) of
    a clip of ``n_samples`` counted at its real length: the padding of the
    60 s window is work the clip does not need."""
    e = model["encoder"]
    t = lfr_frames(n_samples)
    frames = n_samples // 160 + 1
    n_freq = n_fft // 2 + 1
    ops = 2 * 2 * frames * n_fft * n_freq + 2 * frames * n_freq * n_mels
    n_bytes = (2 * n_fft * n_freq + n_mels * n_freq) * 4 + n_samples * 4
    w, o = _sanm(t, e["input_size"], e["d_model"], e["ffn_dim"],
                 e["kernel_size"], with_ffn=False)
    n_bytes, ops = n_bytes + w, ops + o
    for _ in range(e["num_blocks"] - 1 + e["tp_blocks"]):
        w, o = _sanm(t, e["d_model"], e["d_model"], e["ffn_dim"],
                     e["kernel_size"])
        n_bytes, ops = n_bytes + w, ops + o
    w, o = _adaptor(t, model["adaptor"])
    out = t * model["adaptor"]["out_dim"] * 4
    return n_bytes + w + out, ops + o


def main():
    import json
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    for name in sorted(os.listdir(os.path.join(here, "configs"))):
        with open(os.path.join(here, "configs", name)) as f:
            cfg = json.load(f)
        model, llm = cfg["model"], cfg["model"]["llm"]
        fmt = cfg["decoder_weights"]
        print(f"{cfg['name']}:")
        # K4's counts where the configuration's route launches it
        k4 = "quant_matmul.fused_launches" in cfg["route"]["launched"]
        for qkv, label in ((True, "K4a"), (False, "K4b")) if k4 else ():
            mats = arch.of(llm).layer_mats(llm)
            w = sum(weight_bytes(*mats[n], "q8_0") for n in
                    ["o", "gate_up", "down"] + (["qkv"] if qkv else []))
            print(f"  {label} m=1: {k4_bytes(llm, qkv) / 1e6:.2f} MB "
                  f"({w / 1e6:.2f} MB of weights), "
                  f"{k4_ops(llm, qkv) / 1e6:.1f} MFLOP, "
                  f"{bound(k4_bytes(llm, qkv), k4_ops(llm, qkv))}")
        t = lfr_frames(60 * 16000)
        b, o = k3_count(model, t)
        print(f"  K3 T={t}: {o / 1e9:.3f} GFLOP, {b / 1e6:.2f} MB, "
              f"{bound(b, o)}")
        for s in (5.0, 60.0):
            b, o = encode_count(model, int(s * 16000))
            print(f"  encode {s:.0f} s at its real length: {b / 1e9:.3f} GB, "
                  f"{o / 1e9:.2f} GFLOP, {bound(b, o)}")
        for vis in (200, 450):
            b, o = decode_token(llm, fmt, vis)
            print(f"  decode token ({fmt}), {vis} visible: {b / 1e6:.1f} MB, "
                  f"{o / 1e9:.3f} GFLOP, {bound(b, o)}")


if __name__ == "__main__":
    main()
