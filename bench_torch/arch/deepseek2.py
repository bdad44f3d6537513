"""DeepSeek-V3's decoder as Moonlight-16B-A3B ships it (llama.cpp's GGUF
arch ``deepseek2``; HF ``model_type`` ``deepseek_v3``).

Latent attention (MLA) with no q LoRA: ``q = x W_q`` per head, split into
``qk_nope_dim`` and ``qk_rope_dim``; ``[c_kv, k_rope] = x W_kv_a``,
``c_kv`` RMS-normed; ``[k_nope, v]`` per head ``= c_kv W_kv_b``; rope on
interleaved pairs (HF's ``rope_interleave``, llama.cpp's NORM rope) of q's
and the one shared k's rope part; softmax scale
``(qk_nope_dim + qk_rope_dim)^-1/2``. The first ``moe_first_dense``
layers have a dense SwiGLU of ``ffn_dim``; every later one routes: scores
``s = sigmoid(x W_r)`` over ``n_experts``, the ``n_experts_per_tok`` best
by ``s + b`` (``b`` the correction bias) chosen, weighted by ``s_sel /
(sum s_sel + 1e-20) * routed_scaling_factor`` (HF's DeepseekV3TopkRouter),
each a SwiGLU of ``moe_ffn_dim``, plus ``n_shared_experts`` shared experts
run as one SwiGLU of ``n_shared_experts * moe_ffn_dim``. RMSNorm with
``rms_eps``, an untied head.

Departures from the published model, all of the harness's draw: every
norm scale is 1; the router and the correction bias are drawn in q8_0
space like every other tensor and written to the GGUF in f32 as their
dequantized values (llama.cpp keeps ``ffn_gate_inp`` unquantized);
the bias is a draw of ±0.045, not a trained balance. The latent norm
takes the GGUF's one epsilon, ``rms_eps``, as llama.cpp and the JAX
package apply it; the published modelling code leaves its
``kv_a_layernorm`` at the default 1e-6. Group-limited
routing is left out: Moonlight's ``n_group`` and ``topk_group`` are 1,
where it selects nothing, and a configuration with more groups is
refused. No rope scaling (Moonlight has none). A configuration that
states anything else this module does not compute (a q LoRA, softmax
scoring, no correction bias, tied embeddings, rope on halves, a q/k norm,
a head or rope width other than the MLA parts') is refused, not run as
Moonlight. Only the ``q8_0`` format:
the decoder's values as stored.

The plain decoder keeps the drawn q8_0 pairs and dequantizes one layer's
matrices, and one routed expert at a time, on each pass: Moonlight's
16 B weights are ~64 GB in float32. It runs the unabsorbed MLA as
published, in float32 with TF32 off.

Routing is the program's to record (``ROUTED``, the contract in
``arch/__init__.py``): ``Decoder.logits(..., routes)`` follows the
program's experts where it ran and scores them.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch import arch, reference, roofline, weights

ROUTED = True


def _attn_shapes(llm):
    """GGUF name template -> [out, in] of a layer's attention matrices."""
    h, n_h = llm["hidden"], llm["q_heads"]
    qk = llm["qk_nope_dim"] + llm["qk_rope_dim"]
    kv_a = llm["kv_lora_rank"] + llm["qk_rope_dim"]
    kv_b = n_h * (llm["qk_nope_dim"] + llm["v_head_dim"])
    return {"attn_q": (n_h * qk, h), "attn_kv_a_mqa": (kv_a, h),
            "attn_kv_b": (kv_b, llm["kv_lora_rank"]),
            "attn_output": (h, n_h * llm["v_head_dim"])}


def _swiglu_shapes(h, f, suffix=""):
    return {"ffn_gate" + suffix: (f, h), "ffn_up" + suffix: (f, h),
            "ffn_down" + suffix: (h, f)}


# what this module computes: a key of the configuration, where it is
# given, takes one of these values
MODELLED = {"q_lora_rank": (0, None), "n_group": (1,), "topk_group": (1,),
            "rope_yarn_factor": (0, None), "router_scoring": ("sigmoid",),
            "router_bias": (True,), "tie_embeddings": (False,),
            "rope_interleaved": (True,), "qk_norm": (False,)}


def _check(llm):
    modelled = dict(MODELLED, head_dim=(llm["qk_nope_dim"]
                                        + llm["qk_rope_dim"],),
                    rope_dim=(llm["qk_rope_dim"],))
    wrong = {k: f"{llm[k]!r}, not one of {ok}" for k, ok in modelled.items()
             if k in llm and llm[k] not in ok}
    if wrong:
        raise ValueError(f"deepseek2 here does not compute {wrong}")


def decoder_tensors(llm):
    """The drawn tensors in draw order: attention of every layer, the
    dense layers' SwiGLU, then of the routed layers the router, the
    correction bias, the experts ``[layers, experts, out, in]`` and the
    shared experts; then the head ``output`` and ``token_embd``."""
    _check(llm)
    n_l, k0, h = llm["n_layers"], llm["moe_first_dense"], llm["hidden"]
    n_r, e, f = n_l - k0, llm["n_experts"], llm["moe_ffn_dim"]
    mats = {name: (n_l, o, i) for name, (o, i) in _attn_shapes(llm).items()}
    mats.update({name: (k0, o, i) for name, (o, i) in
                 _swiglu_shapes(h, llm["ffn_dim"]).items()})
    mats["ffn_gate_inp"] = (n_r, e, h)
    mats["exp_probs_b.bias"] = (n_r, e)
    mats.update({name: (n_r, e, o, i) for name, (o, i) in
                 _swiglu_shapes(h, f, "_exps").items()})
    mats.update({name: (n_r, o, i) for name, (o, i) in _swiglu_shapes(
        h, llm["n_shared_experts"] * f, "_shexp").items()})
    mats["output"] = (llm["vocab_size"], h)
    mats["token_embd"] = (llm["vocab_size"], h)
    return mats


def write_gguf(path, llm, dec):
    """A llama.cpp deepseek2 GGUF v3 with the keys the JAX package's
    loader reads: q8_0 matrices, f32 router, bias and norm scales."""
    _check(llm)
    h, n_l, k0 = llm["hidden"], llm["n_layers"], llm["moe_first_dense"]
    a = "deepseek2"
    kvs = [("general.architecture", a),
           (f"{a}.context_length", llm["max_position"]),
           (f"{a}.embedding_length", h), (f"{a}.block_count", n_l),
           (f"{a}.feed_forward_length", llm["ffn_dim"]),
           (f"{a}.attention.head_count", llm["q_heads"]),
           (f"{a}.attention.head_count_kv", llm["kv_heads"]),
           (f"{a}.rope.freq_base", float(llm["rope_theta"])),
           (f"{a}.attention.layer_norm_rms_epsilon", float(llm["rms_eps"])),
           (f"{a}.attention.key_length",
            llm["qk_nope_dim"] + llm["qk_rope_dim"]),
           (f"{a}.attention.value_length", llm["v_head_dim"]),
           (f"{a}.attention.kv_lora_rank", llm["kv_lora_rank"]),
           (f"{a}.rope.dimension_count", llm["qk_rope_dim"]),
           (f"{a}.leading_dense_block_count", k0),
           (f"{a}.expert_count", llm["n_experts"]),
           (f"{a}.expert_used_count", llm["n_experts_per_tok"]),
           (f"{a}.expert_shared_count", llm["n_shared_experts"]),
           (f"{a}.expert_feed_forward_length", llm["moe_ffn_dim"]),
           (f"{a}.expert_weights_scale",
            float(llm["routed_scaling_factor"])),
           (f"{a}.expert_weights_norm", bool(llm["norm_topk_prob"])),
           (f"{a}.expert_gating_func", 2)]     # 2: sigmoid

    def ones(n):
        return lambda: np.ones(n, np.float32).tobytes()

    def q8(name, i):
        q, d = dec[name]
        return (8, q.shape[1:],
                lambda q=q[i], d=d[i]: weights.q8_0_bytes(q, d))

    def f32(name, i):
        q, d = dec[name]
        return (0, q.shape[1:], lambda q=q[i], d=d[i]: reference.q8_0_dequant(
            q, d).cpu().numpy().tobytes())
    tensors = []
    for i in range(n_l):
        tensors += [(f"blk.{i}.attn_norm.weight", 0, (h,), ones(h)),
                    (f"blk.{i}.attn_kv_a_norm.weight", 0,
                     (llm["kv_lora_rank"],), ones(llm["kv_lora_rank"])),
                    (f"blk.{i}.ffn_norm.weight", 0, (h,), ones(h))]
        tensors += [(f"blk.{i}.{n}.weight", *q8(n, i))
                    for n in _attn_shapes(llm)]
        if i < k0:
            tensors += [(f"blk.{i}.{n}.weight", *q8(n, i))
                        for n in _swiglu_shapes(h, 1)]
            continue
        j = i - k0
        tensors += [(f"blk.{i}.ffn_gate_inp.weight", *f32("ffn_gate_inp", j)),
                    (f"blk.{i}.exp_probs_b.bias",
                     *f32("exp_probs_b.bias", j))]
        tensors += [(f"blk.{i}.{n}.weight", *q8(n, j)) for suffix in
                    ("_exps", "_shexp") for n in _swiglu_shapes(h, 1, suffix)]
    tensors.append(("output_norm.weight", 0, (h,), ones(h)))
    for name in ("output", "token_embd"):
        q, d = dec[name]
        tensors.append((f"{name}.weight", 8, q.shape,
                        lambda q=q, d=d: weights.q8_0_bytes(q, d)))
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
        _check(self.llm)
        if cfg["decoder_weights"] != "q8_0":
            raise ValueError("deepseek2's plain decoder models q8_0 only, "
                             f"not {cfg['decoder_weights']!r}")
        self.dec = dec
        self.n_experts = self.llm["n_experts"]
        self.route_dims = (self.llm["n_layers"] - self.llm["moe_first_dense"],
                           self.llm["n_experts_per_tok"])
        self.embed = reference.q8_0_dequant(*dec["token_embd"])
        self.head = reference.q8_0_dequant(*dec["output"])
        self.router = reference.q8_0_dequant(*dec["ffn_gate_inp"])
        self.bias = reference.q8_0_dequant(*dec["exp_probs_b.bias"])

    def _w(self, name, *index):
        q, d = self.dec[name]
        return reference.q8_0_dequant(q[index], d[index])

    def covers(self, routes, t):
        """Whether ``routes`` hold k ids of every routed layer at each of
        ``t`` positions."""
        n_r, k = self.route_dims
        return routes is not None and tuple(routes.shape) == (n_r, t, k)

    def logits(self, prompt, tokens, act=None, routes=None):
        """The next-token logits after ``prompt`` [P, h] and each prefix of
        ``tokens`` [n]: rows P-1 ... P+n-1 of one causal pass → [n + 1,
        vocab]; row i predicts token i. With ``routes`` [routed layers,
        R, k] (R ≤ P + n), positions below R use those experts, weighted
        by this pass's own scores; the others choose their own. Returns
        (logits, {"routes": the experts each routed layer used at each
        position [routed layers, P + n, k], ascending; "gap": for each
        followed decision [routed layers, R], this pass's k-th best
        selection score less its score of the lowest-scored expert
        followed, floored at 0, and ``arch.BROKEN_GAP`` where the
        decision is not k distinct ids in [0, E); "differs": [routed
        layers, R], whether the followed set is not this pass's own top
        k; "fault_gap": [routed layers, P + n], the gap of
        ``arch.route_fault`` of this pass's own choice})."""
        llm = self.llm
        eps, n_h = llm["rms_eps"], llm["q_heads"]
        nope, rope_d, v_d = (llm["qk_nope_dim"], llm["qk_rope_dim"],
                             llm["v_head_dim"])
        kv_r, k0, top = (llm["kv_lora_rank"], llm["moe_first_dense"],
                         llm["n_experts_per_tok"])
        x = torch.cat([prompt, self.embed[tokens]])
        t = x.shape[0]
        n_run = 0 if routes is None else routes.shape[1]
        if routes is not None and not self.covers(routes[:, :t], n_run):
            raise ValueError(f"routes {tuple(routes.shape)} are not "
                             f"{self.route_dims} at {t} positions or fewer")
        if routes is not None:
            routes = routes.to(self.dev, torch.int64).sort(-1).values
            # a decision naming an expert twice or one that does not
            # exist is followed as far as it can be, and reads BROKEN_GAP
            broken = ((routes < 0) | (routes >= self.n_experts)).any(-1) \
                | (routes[..., 1:] == routes[..., :-1]).any(-1)
            routes = routes.clamp(0, self.n_experts - 1)
        pos = torch.arange(t, dtype=torch.float32, device=self.dev)
        inv = 1.0 / (llm["rope_theta"] ** (torch.arange(
            0, rope_d, 2, dtype=torch.float32, device=self.dev) / rope_d))
        ang = pos[:, None] * inv
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        causal = torch.full((t, t), float("-inf"), device=self.dev).triu(1)

        def rms(a):
            return a * torch.rsqrt(a.square().mean(-1, keepdim=True) + eps)

        def rope(a):
            """Rotate interleaved pairs (a[2i], a[2i+1]) of a [t, heads,
            rope_d] by position × frequency i."""
            a0, a1 = a[..., 0::2], a[..., 1::2]
            return torch.stack([a0 * cos - a1 * sin, a1 * cos + a0 * sin],
                               -1).flatten(-2)

        def swiglu(a, gate, up, down):
            return _dmm(F.silu(_dmm(a, gate, act)) * _dmm(a, up, act), down,
                        act)
        used, gaps, differs, faults = [], [], [], []
        for i in range(llm["n_layers"]):
            h = rms(x)
            q = _dmm(h, self._w("attn_q", i), act).reshape(t, n_h,
                                                           nope + rope_d)
            c, k_rope = _dmm(h, self._w("attn_kv_a_mqa", i), act).split(
                [kv_r, rope_d], -1)
            kv = _dmm(rms(c), self._w("attn_kv_b", i), act).reshape(
                t, n_h, nope + v_d)
            k = torch.cat([kv[..., :nope], rope(k_rope[:, None]).expand(
                t, n_h, rope_d)], -1)
            q = torch.cat([q[..., :nope], rope(q[..., nope:])], -1)
            s = torch.einsum("qhd,khd->hqk", q, k) \
                * (nope + rope_d) ** -0.5 + causal
            o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                             kv[..., nope:])
            x = x + _dmm(o.reshape(t, n_h * v_d), self._w("attn_output", i),
                         act)
            h = rms(x)
            if i < k0:
                x = x + swiglu(h, *(self._w(n, i) for n in
                                    ("ffn_gate", "ffn_up", "ffn_down")))
                continue
            j = i - k0
            score = torch.sigmoid(_dmm(h, self.router[j], act))
            pick = score + self.bias[j]
            best = pick.topk(top, dim=-1)
            own = best.indices.sort(-1).values

            def gap(ids):
                low = pick[:len(ids)].gather(-1, ids).min(-1).values
                return (best.values[:len(ids), -1] - low).clamp_min(0)
            faults.append(gap(arch.route_fault(own, self.n_experts)))
            use = own.clone()
            if n_run:
                use[:n_run] = routes[j]
                gaps.append(gap(routes[j]).masked_fill(broken[j],
                                                       arch.BROKEN_GAP))
                differs.append((routes[j] != own[:n_run]).any(-1))
            used.append(use)
            wt = score.gather(-1, use)
            if llm["norm_topk_prob"]:
                wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
            wt = wt * llm["routed_scaling_factor"]
            y = swiglu(h, *(self._w(n, j) for n in
                            ("ffn_gate_shexp", "ffn_up_shexp",
                             "ffn_down_shexp")))
            for e in range(self.n_experts):
                rows, slot = (use == e).nonzero(as_tuple=True)
                if rows.numel():
                    out = swiglu(h[rows], *(self._w(n, j, e) for n in (
                        "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")))
                    y = y.index_add(0, rows, out * wt[rows, slot, None])
            x = x + y
        rows = rms(x[prompt.shape[0] - 1:])
        empty = torch.zeros(len(used), 0, device=self.dev)
        return _dmm(rows, self.head, act), {
            "routes": torch.stack(used),
            "gap": torch.stack(gaps) if gaps else empty,
            "differs": torch.stack(differs) if differs else empty.bool(),
            "fault_gap": torch.stack(faults)}


def decode_token(llm, fmt, visible):
    """(bytes, operations) one decode step must move and compute at batch
    1 with ``visible`` cache slots: every attention and dense-layer weight
    in the format, of each routed layer the ``n_experts_per_tok`` routed
    experts it uses and the shared ones (not all of them), the f32 router
    and bias, the head (q8_0: padded vocab), the norm scales, the
    embedding row, and the visible latent cache rows (``kv_lora_rank +
    qk_rope_dim`` in bf16 a layer; attention over the latent, as the
    absorbed form reads it: per head and slot ``2 (kv_lora_rank +
    qk_rope_dim)`` for the score and ``2 kv_lora_rank`` for the value)."""
    n_l, k0, h = llm["n_layers"], llm["moe_first_dense"], llm["hidden"]
    n_r, f = n_l - k0, llm["moe_ffn_dim"]
    active = llm["n_experts_per_tok"] + llm["n_shared_experts"]
    attn = list(_attn_shapes(llm).values())
    dense = list(_swiglu_shapes(h, llm["ffn_dim"]).values())
    expert = list(_swiglu_shapes(h, f).values())
    w = n_l * sum(roofline.weight_bytes(o, i, fmt) for o, i in attn) \
        + k0 * sum(roofline.weight_bytes(o, i, fmt) for o, i in dense) \
        + n_r * active * sum(roofline.weight_bytes(o, i, fmt)
                             for o, i in expert)
    router = n_r * (llm["n_experts"] * h + llm["n_experts"]) * 4
    vocab = llm["vocab_size"]
    if fmt == "q8_0":
        head = math.ceil(vocab / roofline.HEAD_PAD) * roofline.HEAD_PAD * h \
            * roofline.Q8_BYTES_PER_WEIGHT
    else:
        head = roofline.weight_bytes(vocab, h, fmt)
    norms = (n_l * (2 * h + llm["kv_lora_rank"]) + h) * roofline.BF16
    latent = llm["kv_lora_rank"] + llm["qk_rope_dim"]
    n_bytes = w + router + head + norms + h * roofline.BF16 \
        + visible * n_l * latent * roofline.BF16
    params = n_l * sum(o * i for o, i in attn) \
        + k0 * sum(o * i for o, i in dense) \
        + n_r * (active * sum(o * i for o, i in expert)
                 + llm["n_experts"] * h) + vocab * h
    attn_ops = n_l * llm["q_heads"] * visible * 2 * (
        latent + llm["kv_lora_rank"])
    return n_bytes, 2 * params + attn_ops


def tiny_llm():
    """The CPU rehearsal's deepseek2 decoder: hidden 64, as ``harness.TINY``'s
    adaptor gives, one dense layer then two routed ones of 32 experts
    (widths multiples of the q8_0 block of 32)."""
    return {"arch": "deepseek2", "hidden": 64, "n_layers": 3, "q_heads": 4,
            "kv_heads": 4, "head_dim": 24, "qk_nope_dim": 16,
            "qk_rope_dim": 8, "rope_dim": 8, "v_head_dim": 16,
            "kv_lora_rank": 32, "q_lora_rank": 0, "ffn_dim": 128,
            "moe_first_dense": 1, "n_experts": 32, "n_experts_per_tok": 4,
            "moe_ffn_dim": 32, "n_shared_experts": 2,
            "routed_scaling_factor": 2.446, "norm_topk_prob": True,
            "router_scoring": "sigmoid", "router_bias": True, "n_group": 1,
            "topk_group": 1, "rope_interleaved": True, "qk_norm": False,
            "vocab_size": 512, "rope_theta": 50000.0, "rms_eps": 1e-05,
            "tie_embeddings": False, "max_position": 8192}
