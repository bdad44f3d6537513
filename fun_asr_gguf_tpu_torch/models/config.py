"""Model architecture configs.

Shapes are taken from the reference model definitions (see
``fun_asr_gguf/model_definition.py:191-229`` for the encoder stack and
``03-Export-Decoder-GGUF.py`` + HF Qwen3-0.6B for the decoder); every config
has a ``tiny()`` constructor so the full pipeline is testable on CPU without
model artifacts.
"""

from dataclasses import dataclass, field


def yarn_rope_params(head_dim: int, rope_theta: float, factor: float,
                     orig_max_position: int, beta_fast: float = 32.0,
                     beta_slow: float = 1.0, rope_dim: int = 0,
                     truncate: bool = True, attention_factor=None):
    """YaRN inverse-frequency correction expressed as per-frequency
    divisors of the plain rope (NTK-by-parts interpolation: HF
    ``modeling_rope_utils._compute_yarn_parameters``; llama.cpp's
    runtime yarn). Returns ``(factors, attn_factor)`` where
    ``inv_freq_yarn = inv_freq_plain / factors`` — the exact
    representation ``Qwen3Config.rope_factors_*`` carries, so YaRN
    rides the longrope machinery unchanged."""
    import math

    import numpy as np

    dim = rope_dim or head_dim

    def correction_dim(num_rot):
        return (dim * math.log(orig_max_position / (num_rot * 2 * math.pi))
                ) / (2 * math.log(rope_theta))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low)
                   / (high - low), 0.0, 1.0)
    extrapolation = 1.0 - ramp            # 1 where plain rope survives
    # inv_plain/inv_yarn with inv_yarn = interp*(1-ext) + plain*ext and
    # interp = plain/factor  =>  divisor = factor/(1+(factor-1)*ext)
    factors = factor / (1.0 + (factor - 1.0) * extrapolation)
    if attention_factor is None:
        attention_factor = (0.1 * math.log(factor) + 1.0
                            if factor > 1.0 else 1.0)
    return (tuple(float(f) for f in factors), float(attention_factor))


def llama3_rope_factors(head_dim: int, rope_theta: float, factor: float,
                        low_freq_factor: float, high_freq_factor: float,
                        orig_max_position: int) -> tuple:
    """Llama-3.1 rope scaling as per-frequency divisors of inv_freq.

    Mirrors HF ``_compute_llama3_parameters`` / the reference
    converter's ``generate_extra_tensors`` (LlamaModel, llama3 branch —
    the ``rope_freqs.weight`` tensor llama.cpp consumes): wavelengths
    shorter than the high-freq threshold keep plain rope (divisor 1),
    longer than the low-freq threshold divide by ``factor``, and the
    band between interpolates smoothly. Rides the same
    ``rope_factors_*`` machinery as longrope/YaRN.
    """
    import math

    import numpy as np

    dim = head_dim
    inv = 1.0 / (rope_theta ** (np.arange(0, dim, 2, dtype=np.float64)
                                / dim))
    wavelen = 2.0 * math.pi / inv
    low_wl = orig_max_position / low_freq_factor
    high_wl = orig_max_position / high_freq_factor
    smooth = ((orig_max_position / wavelen - low_freq_factor)
              / (high_freq_factor - low_freq_factor))
    mid = 1.0 / ((1.0 - smooth) / factor + smooth)
    out = np.where(wavelen < high_wl, 1.0,
                   np.where(wavelen > low_wl, factor, mid))
    return tuple(float(x) for x in out)


@dataclass(frozen=True)
class EncoderConfig:
    """SenseVoiceEncoderSmall (``model_definition.py:191-214``)."""
    input_size: int = 560
    d_model: int = 512
    heads: int = 4
    ffn_dim: int = 2048
    num_blocks: int = 50        # 1 input block (560->512) + 49 at 512
    tp_blocks: int = 20
    kernel_size: int = 11
    ln_eps: float = 1e-5
    # Pallas online-softmax attention: None = auto (on TPU for batch ≥ 2,
    # where XLA's materialized [B,H,T,T] scores thrash HBM — measured
    # 113 → 52 ms for the batch-8 60 s encode on v5e — while at B=1 XLA's
    # fused attention still wins, 7.2 vs 10.0 ms: isolated per-layer
    # attention time is EQUAL, the gap is ~70 scanned Pallas call
    # overheads that only pay for themselves once score traffic
    # dominates); True/False force it.
    use_flash_attention: "bool | None" = None

    @staticmethod
    def tiny(input_size: int = 560):
        return EncoderConfig(input_size=input_size, d_model=64, heads=4,
                             ffn_dim=128, num_blocks=2, tp_blocks=1,
                             kernel_size=11)


@dataclass(frozen=True)
class AdaptorConfig:
    """CorrectTransformerAdaptor (``model_definition.py:165-185``)."""
    in_dim: int = 512
    out_dim: int = 1024
    ffn_dim: int = 2048         # projection hidden
    n_layers: int = 2
    heads: int = 8
    downsample: int = 1
    ln_eps: float = 1e-12

    @property
    def block_ffn_dim(self) -> int:
        # PositionwiseFeedForward(llm_dim, llm_dim // 4) in the blocks
        return self.out_dim // 4

    @staticmethod
    def tiny(in_dim: int = 64, out_dim: int = 96):
        return AdaptorConfig(in_dim=in_dim, out_dim=out_dim, ffn_dim=128,
                             n_layers=1, heads=4)


@dataclass(frozen=True)
class CTCHeadConfig:
    """ctc_decoder adaptor (512->512, 5 layers) + linear to vocab
    (``model_definition.py:216-229``)."""
    adaptor: AdaptorConfig = field(default_factory=lambda: AdaptorConfig(
        in_dim=512, out_dim=512, ffn_dim=2048, n_layers=5, heads=8))
    vocab_size: int = 60515

    @staticmethod
    def tiny(d: int = 64, vocab_size: int = 101):
        return CTCHeadConfig(
            adaptor=AdaptorConfig(in_dim=d, out_dim=d, ffn_dim=128,
                                  n_layers=1, heads=4),
            vocab_size=vocab_size)


@dataclass(frozen=True)
class Qwen3Config:
    """Llama-family decoder config; defaults are Qwen3-0.6B (HF config
    referenced by ``03-Export…py:14``).

    The same dataclass describes the whole GGUF "llama-class" family the
    reference's llama.dll can load (``llama.py:417`` loads any arch):
    ``arch``/``qk_norm``/``attn_bias`` select the per-arch differences —
    qwen3 (qk-RMSNorm, no biases), qwen2 (q/k/v biases, no qk-norm),
    llama/mistral (neither).
    """
    hidden: int = 1024
    n_layers: int = 28
    q_heads: int = 16
    kv_heads: int = 8
    head_dim: int = 128
    ffn_dim: int = 3072
    vocab_size: int = 151936
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    tie_embeddings: bool = True
    max_position: int = 40960
    arch: str = "qwen3"          # GGUF general.architecture on export
    qk_norm: bool = True         # per-head RMSNorm on q/k (qwen3, gemma-like)
    attn_bias: bool = False      # q/k/v projection biases (qwen2 family)
    # -- OLMo2 family (reference converter registers Olmo2Model at
    # convert_hf_to_gguf.py:7042): post-norm-only layers
    # (x = x + norm(f(x)); no input norms at all) and a full-width
    # qk-RMSNorm applied to the whole projected vector BEFORE the head
    # reshape (HF ``Olmo2Attention``). --
    pre_norms: bool = True        # False: no input_ln/pre-ffn norm
    qk_norm_full: bool = False    # qk-norm over q_heads*head_dim, not per-head
    # -- Granite family (reference converter registers GraniteModel at
    # convert_hf_to_gguf.py:8851): llama structure + scalar multipliers.
    # attention_multiplier rides attn_scale and embedding_multiplier
    # rides embed_scale; logits_scaling (a DIVISOR in HF) is folded
    # into final_ln at load — output_norm only feeds the lm head, so
    # (h * g/s) @ W == ((h * g) @ W) / s exactly — and unfolded on
    # export (logit_scale below is export bookkeeping). --
    residual_scale: float = 1.0   # multiplies each block's residual branch
    logit_scale: float = 1.0      # HF logits divisor (folded into final_ln)
    # -- sparse MoE MLP (Qwen3-MoE family; reference converter registers
    # Qwen3MoeForCausalLM at convert_hf_to_gguf.py:4328) --
    n_experts: int = 0           # 0 = dense MLP
    n_experts_per_tok: int = 0   # router top-k
    moe_ffn_dim: int = 0         # per-expert intermediate size
    norm_topk_prob: bool = True  # renormalize the top-k routing probs
    # -- Gemma family (gemma3 text; reference converter registers
    # Gemma3Model at convert_hf_to_gguf.py:5896). Norm weights are
    # stored SHIFTED (+1, the llama.cpp GGUF convention), so rms_norm
    # stays the plain multiply everywhere. --
    post_norms: bool = False      # sandwich norms (post-attn + post-ffn)
    act: str = "silu"             # MLP gate activation; gemma: gelu_tanh
    embed_scale: float = 1.0      # gemma scales embeddings by sqrt(hidden)
    attn_scale: float = 0.0       # 0 → head_dim**-0.5; gemma3:
    #                               query_pre_attn_scalar**-0.5
    sliding_window: int = 0       # 0 = all layers attend globally
    sliding_pattern: int = 0      # every Nth layer is global (gemma3: 6;
    #                               phi3: n_layers+1 — no global layers)
    rope_local_theta: float = 1e4  # sliding layers' rope base
    rope_global_scale: float = 1.0  # linear position scale, global layers
    final_softcap: float = 0.0    # cap·tanh(logits/cap) when > 0
    attn_softcap: float = 0.0     # gemma2: cap·tanh(scores/cap) on the
    #                               scaled attention logits, pre-mask
    # -- Phi-3 family (reference converter registers Phi3MiniModel at
    # convert_hf_to_gguf.py:4651): longrope scaling + partial rotary.
    # Factor tuples are per-frequency divisors of inv_freq (HF
    # modeling_rope_utils._compute_longrope_parameters; llama.cpp
    # rope_factors_short/long.weight tensors), len rope_dim/2. --
    rope_dim: int = 0             # rotary dims per head (0 = head_dim)
    rope_orig_max_position: int = 0   # longrope original context (0 = off)
    rope_factors_short: tuple = ()
    rope_factors_long: tuple = ()
    rope_long_active: bool = False    # llama.cpp: long when n_ctx > orig
    rope_attn_factor: float = 1.0     # cos/sin magnitude scale
    # -- GPT-OSS family (reference converter registers GptOssModel at
    # convert_hf_to_gguf.py:10123): attention sinks, biased projections
    # and router, clamped SwiGLU experts, YaRN rope (expressed through
    # the rope_factors_* machinery above — see yarn_rope_params). --
    attn_sinks: bool = False      # per-head learned sink logits
    attn_out_bias: bool = False   # o_proj bias
    router_bias: bool = False     # router logit bias
    router_scoring: str = "softmax_topk"  # "topk_softmax" (gpt-oss) or
    #                               "sigmoid" (deepseek3)
    moe_bias: bool = False        # per-expert gate/up/down biases
    swiglu_limit: float = 7.0     # clamp for act="swiglu_oai"
    rope_yarn_factor: float = 0.0  # YaRN context factor (0 = off)
    # -- DeepSeek family (deepseek2/3; reference converter registers
    # DeepseekV2Model / DeepseekV3 variants in convert_hf_to_gguf.py).
    # MLA attention: low-rank compressed kv (+ optionally q), per-head
    # keys split into a content part (qk_nope_dim) and a SHARED rotary
    # part (qk_rope_dim); head_dim must equal qk_nope_dim + qk_rope_dim
    # and rope_dim equals qk_rope_dim. v_head_dim may differ from
    # head_dim (the cache pads v up to head_dim). --
    q_lora_rank: int = 0          # 0 = dense q projection (V2-Lite)
    kv_lora_rank: int = 0         # >0 switches attention to MLA
    qk_nope_dim: int = 0          # per-head non-rotary key/query dims
    qk_rope_dim: int = 0          # per-head rotary dims (shared k_pe)
    v_head_dim: int = 0           # 0 = head_dim
    rope_interleaved: bool = False  # deepseek ckpts store rope pairs
    #                                 interleaved; deinterleave pre-rope
    # MoE structure extras:
    moe_first_dense: int = 0      # first k layers use a dense MLP
    n_shared_experts: int = 0     # always-on experts (x moe_ffn_dim)
    # -- Qwen2-MoE family (reference converter registers
    # Qwen2MoeForCausalLM in convert_hf_to_gguf.py): one shared expert
    # with its OWN intermediate size, output gated by
    # sigmoid(x @ shared_expert_gate) (HF Qwen2MoeSparseMoeBlock). --
    shared_ffn_dim: int = 0       # shared-expert intermediate size
    #                               (0 → n_shared_experts·moe_ffn_dim)
    shared_expert_gate: bool = False  # sigmoid-gate the shared output
    routed_scaling_factor: float = 1.0   # multiplies routing weights
    # group-limited routing (deepseek3): pick topk_group groups by the
    # sum of each group's top-2 scores, then top-k inside the survivors
    n_group: int = 0
    topk_group: int = 0

    def __post_init__(self):
        # JSON checkpoint round-trips turn tuples into lists; coerce back
        # so the (frozen) config stays hashable for jit static closure
        for f in ("rope_factors_short", "rope_factors_long"):
            v = getattr(self, f)
            if isinstance(v, list):
                object.__setattr__(self, f, tuple(float(x) for x in v))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def active_rope_factors(self) -> tuple:
        """The longrope factor set in effect (llama.cpp picks long when
        the serving context exceeds the original training context)."""
        if self.rope_long_active and self.rope_factors_long:
            return self.rope_factors_long
        return self.rope_factors_short

    @staticmethod
    def tiny(vocab_size: int = 512):
        return Qwen3Config(hidden=64, n_layers=2, q_heads=4, kv_heads=2,
                           head_dim=16, ffn_dim=128, vocab_size=vocab_size,
                           rope_theta=1e4)

    @staticmethod
    def tiny_moe(vocab_size: int = 512, n_experts: int = 8,
                 n_experts_per_tok: int = 2):
        """Qwen3-MoE-shaped tiny config (softmax top-k router, no shared
        expert, qk-norm like dense qwen3)."""
        return Qwen3Config(hidden=64, n_layers=2, q_heads=4, kv_heads=2,
                           head_dim=16, ffn_dim=128, vocab_size=vocab_size,
                           rope_theta=1e4, arch="qwen3moe",
                           n_experts=n_experts,
                           n_experts_per_tok=n_experts_per_tok,
                           moe_ffn_dim=96)

    @staticmethod
    def tiny_qwen2moe(vocab_size: int = 512, n_experts: int = 8,
                      n_experts_per_tok: int = 2):
        """Qwen2-MoE-shaped tiny config: attention biases, no qk-norm,
        NO top-k renormalization, one sigmoid-gated shared expert with
        its own intermediate size (HF Qwen2MoeSparseMoeBlock)."""
        return Qwen3Config(hidden=64, n_layers=2, q_heads=4, kv_heads=2,
                           head_dim=16, ffn_dim=128, vocab_size=vocab_size,
                           rope_theta=1e4, arch="qwen2moe",
                           attn_bias=True, qk_norm=False,
                           n_experts=n_experts,
                           n_experts_per_tok=n_experts_per_tok,
                           moe_ffn_dim=96, norm_topk_prob=False,
                           n_shared_experts=1, shared_ffn_dim=160,
                           shared_expert_gate=True)

    @staticmethod
    def tiny_granite(vocab_size: int = 512):
        """Granite-3-shaped tiny config: llama structure + the four
        scalar multipliers (attention/embedding/residual/logits)."""
        return Qwen3Config(hidden=64, n_layers=2, q_heads=4, kv_heads=2,
                           head_dim=16, ffn_dim=128, vocab_size=vocab_size,
                           rope_theta=1e4, arch="granite", qk_norm=False,
                           attn_bias=False, tie_embeddings=True,
                           attn_scale=0.0078125,       # 1/128
                           embed_scale=12.0, residual_scale=0.22,
                           logit_scale=8.0)

    @staticmethod
    def tiny_glm4(vocab_size: int = 512):
        """GLM-4-0414-shaped tiny config: sandwich norms (glm names),
        partial interleaved rotary (rope_dim = head_dim/2; weights are
        neox-permuted at load), qkv biases, fused gate_up MLP."""
        return Qwen3Config(hidden=64, n_layers=2, q_heads=4, kv_heads=2,
                           head_dim=16, ffn_dim=128, vocab_size=vocab_size,
                           rope_theta=1e4, arch="glm4", qk_norm=False,
                           attn_bias=True, post_norms=True, rope_dim=8,
                           tie_embeddings=False)

    @staticmethod
    def tiny_olmo2(vocab_size: int = 512):
        """OLMo2-shaped tiny config: post-norm-only layers, full-width
        qk-norm, untied embeddings."""
        return Qwen3Config(hidden=64, n_layers=2, q_heads=4, kv_heads=2,
                           head_dim=16, ffn_dim=128, vocab_size=vocab_size,
                           rope_theta=1e4, arch="olmo2", qk_norm=True,
                           qk_norm_full=True, pre_norms=False,
                           post_norms=True, tie_embeddings=False,
                           rms_eps=1e-6)

    @staticmethod
    def tiny_mixtral(vocab_size: int = 512, n_experts: int = 8,
                     n_experts_per_tok: int = 2):
        """Mixtral-shaped tiny config: arch "llama" (no qk-norm, no
        biases) with every layer sparse; intermediate_size is the expert
        width and the top-k routing probs renormalize unconditionally
        (HF ``MixtralSparseMoeBlock``)."""
        return Qwen3Config(hidden=64, n_layers=2, q_heads=4, kv_heads=2,
                           head_dim=16, ffn_dim=96, vocab_size=vocab_size,
                           rope_theta=1e4, arch="llama", qk_norm=False,
                           attn_bias=False, tie_embeddings=False,
                           n_experts=n_experts,
                           n_experts_per_tok=n_experts_per_tok,
                           moe_ffn_dim=96, norm_topk_prob=True)

    @staticmethod
    def tiny_qwen2(vocab_size: int = 512):
        """Qwen2/Qwen2.5-shaped tiny config (biases, no qk-norm)."""
        return Qwen3Config(hidden=64, n_layers=2, q_heads=4, kv_heads=2,
                           head_dim=16, ffn_dim=128, vocab_size=vocab_size,
                           rope_theta=1e4, arch="qwen2", qk_norm=False,
                           attn_bias=True)

    @staticmethod
    def tiny_llama(vocab_size: int = 512):
        """Llama/Mistral-shaped tiny config (no biases, no qk-norm)."""
        return Qwen3Config(hidden=64, n_layers=2, q_heads=4, kv_heads=2,
                           head_dim=16, ffn_dim=128, vocab_size=vocab_size,
                           rope_theta=1e4, arch="llama", qk_norm=False,
                           attn_bias=False)

    @staticmethod
    def tiny_gptoss(vocab_size: int = 512, n_experts: int = 4,
                    n_experts_per_tok: int = 2, yarn_factor: float = 4.0,
                    orig_max: int = 64):
        """GPT-OSS-shaped tiny config: attention sinks, full projection
        biases, biased topk-softmax router, clamped-SwiGLU experts,
        alternating sliding/global layers, YaRN rope."""
        factors, af = yarn_rope_params(16, 1e4, yarn_factor, orig_max)
        return Qwen3Config(hidden=64, n_layers=4, q_heads=4, kv_heads=2,
                           head_dim=16, ffn_dim=96, vocab_size=vocab_size,
                           rope_theta=1e4, arch="gpt-oss", qk_norm=False,
                           attn_bias=True, attn_out_bias=True,
                           attn_sinks=True, tie_embeddings=False,
                           n_experts=n_experts,
                           n_experts_per_tok=n_experts_per_tok,
                           moe_ffn_dim=96, router_bias=True,
                           router_scoring="topk_softmax", moe_bias=True,
                           act="swiglu_oai",
                           sliding_window=8, sliding_pattern=2,
                           rope_local_theta=1e4,
                           max_position=int(orig_max * yarn_factor),
                           rope_orig_max_position=orig_max,
                           rope_factors_short=factors,
                           rope_attn_factor=af,
                           rope_yarn_factor=yarn_factor)

    @staticmethod
    def tiny_deepseek_v2(vocab_size: int = 97):
        """DeepSeek-V2-Lite-shaped tiny config: MLA without q
        compression, softmax routing, one shared expert, first layer
        dense."""
        return Qwen3Config(
            hidden=64, n_layers=3, q_heads=4, kv_heads=4,
            head_dim=24, ffn_dim=96, vocab_size=vocab_size,
            rope_theta=1e4, arch="deepseek2", qk_norm=False,
            rope_dim=8, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
            v_head_dim=16, rope_interleaved=True,
            n_experts=4, n_experts_per_tok=2, moe_ffn_dim=48,
            norm_topk_prob=False, moe_first_dense=1, n_shared_experts=1,
            routed_scaling_factor=1.0)

    @staticmethod
    def tiny_deepseek_v3(vocab_size: int = 97):
        """DeepSeek-V3-shaped tiny config: q compression, sigmoid
        scoring with a selection-bias router and group-limited top-k."""
        return Qwen3Config(
            hidden=64, n_layers=3, q_heads=4, kv_heads=4,
            head_dim=24, ffn_dim=96, vocab_size=vocab_size,
            rope_theta=1e4, arch="deepseek2", qk_norm=False,
            rope_dim=8, q_lora_rank=24, kv_lora_rank=32,
            qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
            rope_interleaved=True,
            n_experts=8, n_experts_per_tok=2, moe_ffn_dim=48,
            norm_topk_prob=True, moe_first_dense=1, n_shared_experts=1,
            router_scoring="sigmoid", router_bias=True,
            routed_scaling_factor=2.5, n_group=4, topk_group=2)

    # -- stretch decoder presets (BASELINE.json configs[4]: larger
    # Qwen-class audio-LLM decoders with int8 TP across a TPU mesh) --

    @staticmethod
    def qwen3_1_7b():
        return Qwen3Config(hidden=2048, n_layers=28, q_heads=16, kv_heads=8,
                           head_dim=128, ffn_dim=6144, vocab_size=151936)

    @staticmethod
    def qwen3_4b():
        return Qwen3Config(hidden=2560, n_layers=36, q_heads=32, kv_heads=8,
                           head_dim=128, ffn_dim=9728, vocab_size=151936)

    @staticmethod
    def qwen3_30b_a3b():
        """Qwen3-30B-A3B MoE decoder (128 experts, top-8, 3B active) —
        the expert-parallel stretch config."""
        return Qwen3Config(hidden=2048, n_layers=48, q_heads=32, kv_heads=4,
                           head_dim=128, ffn_dim=6144, vocab_size=151936,
                           arch="qwen3moe", n_experts=128,
                           n_experts_per_tok=8, moe_ffn_dim=768)

    @staticmethod
    def deepseek_v2_lite():
        """DeepSeek-V2-Lite (HF deepseek-ai/DeepSeek-V2-Lite hparams):
        MLA without q compression, 64 routed + 2 shared experts, first
        layer dense, 40x YaRN."""
        factors, _ = yarn_rope_params(64, 1e4, 40.0, 4096)
        # the checkpoint's mscale == mscale_all_dim (0.707), so the HF
        # yarn attention-factor pair cancels to exactly 1.0
        af = 1.0
        return Qwen3Config(
            hidden=2048, n_layers=27, q_heads=16, kv_heads=16,
            head_dim=192, ffn_dim=10944, vocab_size=102400,
            rope_theta=1e4, max_position=163840, arch="deepseek2",
            qk_norm=False, tie_embeddings=False,
            rope_dim=64, kv_lora_rank=512, qk_nope_dim=128,
            qk_rope_dim=64, v_head_dim=128, rope_interleaved=True,
            n_experts=64, n_experts_per_tok=6, moe_ffn_dim=1408,
            norm_topk_prob=False, moe_first_dense=1, n_shared_experts=2,
            routed_scaling_factor=1.0,
            rope_orig_max_position=4096, rope_factors_short=factors,
            rope_attn_factor=af, rope_yarn_factor=40.0)

    @staticmethod
    def gemma3_1b():
        """Gemma3-1B text decoder (HF google/gemma-3-1b-pt hparams)."""
        return Qwen3Config(
            hidden=1152, n_layers=26, q_heads=4, kv_heads=1, head_dim=256,
            ffn_dim=6912, vocab_size=262144, rope_theta=1e6,
            max_position=32768, arch="gemma3", qk_norm=True,
            post_norms=True, act="gelu_tanh", embed_scale=1152.0 ** 0.5,
            attn_scale=256.0 ** -0.5, sliding_window=512,
            sliding_pattern=6, rope_local_theta=1e4)

    @staticmethod
    def gemma3_4b():
        """Gemma3-4B text decoder (HF google/gemma-3-4b-pt text tower;
        global layers use 8x linear rope scaling)."""
        return Qwen3Config(
            hidden=2560, n_layers=34, q_heads=8, kv_heads=4, head_dim=256,
            ffn_dim=10240, vocab_size=262208, rope_theta=1e6,
            max_position=131072, arch="gemma3", qk_norm=True,
            post_norms=True, act="gelu_tanh", embed_scale=2560.0 ** 0.5,
            attn_scale=256.0 ** -0.5, sliding_window=1024,
            sliding_pattern=6, rope_local_theta=1e4,
            rope_global_scale=8.0)


@dataclass(frozen=True)
class HybridConfig:
    """Full Fun-ASR-Nano stack (``model_definition.py:223-229``)."""
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    adaptor: AdaptorConfig = field(default_factory=AdaptorConfig)
    ctc: CTCHeadConfig = field(default_factory=CTCHeadConfig)
    llm: Qwen3Config = field(default_factory=Qwen3Config)

    @staticmethod
    def tiny(ctc_vocab: int = 101, llm_vocab: int = 512):
        enc = EncoderConfig.tiny()
        llm = Qwen3Config.tiny(vocab_size=llm_vocab)
        return HybridConfig(
            encoder=enc,
            # adaptor output dim must match the LLM embedding width
            adaptor=AdaptorConfig.tiny(in_dim=enc.d_model, out_dim=llm.hidden),
            ctc=CTCHeadConfig.tiny(d=enc.d_model, vocab_size=ctc_vocab),
            llm=llm)
