"""Resource manager: checkpoint loading, device programs and host resources.

Counterpart of ``fun_asr_gguf_tpu/core/model_manager.py``. The init stages:

1. checkpoint → port parameters on the device, in the weight format that
   JAX's resolution picks (:124-179: ``auto`` is per-channel int8 in bf16
   compute and dense in float32). q8_0 keeps the GGUF bytes with the q8_0
   lm_head built from the embedding as loaded; int8 and bf16 load dense,
   with the per-channel int8 head in bf16 compute (``int8_lm_head``).
   ``fuse_projections`` packs qkv / gate_up and, for q8_0 only, adds the
   ``q8_fused`` marker that routes decode and verify through K4 (JAX
   :151-166). int8 quantizes the packed dense weights last;
2. tokenizer (stop ids);
3. CTC vocab + prompt builder over the host f32 embedding table;
4. warm-up: one encode, one CTC pass, one prefill + generate chunk per
   sampling mode (in the smallest bucket, or every bucket with
   ``warmup_all_buckets``), and with ``speculative`` one speculative chunk and the
   plain chunk that follows ``spec_to_gen``, on the configured cache
   (``kv_cache_dtype``; builds the CUDA kernels on first use);
5. hotword manager (+ the opt-in rule corrector and correction RAG).
"""

import logging
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..datatypes import ASREngineConfig
from ..formats.ctc_vocab import load_ctc_tokens
from ..formats.tokenizer import load_tokenizer
from ..frontend import audio_token_length, frontend_constants
from ..hotword.manager import get_hotword_manager
from ..models.adaptor import ctc_head_forward
from ..models.audio_encoder import AudioEncoderConfig, audio_encoder_forward
from ..models.generate import generate_chunk, prefill_init
from ..models.loaders import load_checkpoint
from ..models.qwen3 import (fuse_qwen3_params_q8, pack_qwen3_params,
                            quantize_lm_head, quantize_lm_head_per_channel,
                            quantize_qwen3_params_int8)
from ..models.speculative import (spec_generate_chunk, spec_init,
                                  spec_to_gen)
from ..profiling import count
from ..prompt_utils import PromptBuilder
from ..utils import vprint

logger = logging.getLogger("fun_asr_gguf_tpu_torch.core")


class ModelManager:
    """Owns parameters, device placement and host-side resources."""

    def __init__(self, config: ASREngineConfig, device: torch.device):
        self.config = config
        self.device = device
        self.hybrid_cfg = None
        self.audio_cfg: Optional[AudioEncoderConfig] = None
        self.frontend_consts = None
        self.encoder_params = None
        self.adaptor_params = None
        self.ctc_params = None
        self.llm_params = None
        self.embedding_table: Optional[np.ndarray] = None
        self.tokenizer = None
        self.eos_token = None
        self.stop_tokens = (151643, 151645)
        self.ctc_id2token: Optional[Dict[int, str]] = None
        self.prompt_builder: Optional[PromptBuilder] = None
        self.hotword_manager = None
        self.corrector = None
        self.rule_corrector = None
        self._rules_watcher = None
        self.rectification = None
        self._rectify_watcher = None
        self._compute_dtype = (torch.bfloat16
                               if config.compute_dtype == "bfloat16"
                               else torch.float32)
        self._initialized = False

    @property
    def weight_format(self) -> str:
        """The decoder's weight format: ``auto`` resolves as in JAX (int8
        in bf16 compute, bf16 — dense in the compute dtype — in float32)."""
        fmt = self.config.llm_weight_format
        if fmt == "auto":
            return "int8" if self._compute_dtype == torch.bfloat16 else "bf16"
        return fmt

    # -- static-shape policy (kept: the same buckets bound the KV cache) ----

    def pad_window_samples(self, n_samples: int) -> int:
        base = int(self.config.segment_pad_seconds * self.config.sample_rate)
        if n_samples <= base:
            return base
        return -(-n_samples // self.config.sample_rate) * \
            self.config.sample_rate

    def prompt_bucket(self, prompt_len: int) -> int:
        for b in sorted(self.config.prefill_buckets):
            if prompt_len <= b:
                return b
        return -(-prompt_len // 128) * 128

    # -- initialization ------------------------------------------------------

    def initialize(self, verbose: bool = True) -> bool:
        if self._initialized:
            return True
        try:
            t_start = time.perf_counter()
            if self.device.type == "cuda":
                # plain fp32 matmuls/convs must not silently run in TF32
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False

            vprint("[1/5] 加载模型权重 (checkpoint)...", verbose)
            ckpt = self.config.checkpoint_dir
            fmt = self.weight_format
            (self.hybrid_cfg, self.encoder_params, self.adaptor_params,
             self.ctc_params, self.llm_params,
             self.embedding_table) = load_checkpoint(
                ckpt, device=self.device, dtype=self._compute_dtype,
                llm_keep_quantized=(fmt == "q8_0"))
            llm = self.llm_params
            if fmt == "q8_0":
                llm = quantize_lm_head(llm, self.hybrid_cfg.llm)
            elif (self.config.int8_lm_head
                  and self._compute_dtype == torch.bfloat16):
                llm = quantize_lm_head_per_channel(llm, self.hybrid_cfg.llm)
            if self.config.fuse_projections:
                llm = pack_qwen3_params(llm)
                if fmt == "q8_0":
                    llm = fuse_qwen3_params_q8(llm)
            if fmt == "int8":
                llm = quantize_qwen3_params_int8(llm)
            self.llm_params = llm
            self.audio_cfg = AudioEncoderConfig(
                encoder=self.hybrid_cfg.encoder,
                adaptor=self.hybrid_cfg.adaptor)
            self.frontend_consts = frontend_constants(self.audio_cfg.frontend,
                                                      self.device)

            vprint("[2/5] 加载 Tokenizer...", verbose)
            self.tokenizer = load_tokenizer(self.config.tokenizer_path or ckpt)
            self.eos_token = self.tokenizer.eos_token
            stop = set(self.tokenizer.stop_tokens) | {self.eos_token}
            self.stop_tokens = tuple(sorted(
                t for t in stop if t < self.hybrid_cfg.llm.vocab_size))

            vprint("[3/5] 加载 CTC 词表与 Prompt 构建器...", verbose)
            tokens_path = self.config.tokens_path or str(
                Path(ckpt) / "tokens.txt")
            self.ctc_id2token = load_ctc_tokens(tokens_path)
            probe = self.tokenizer.encode("语音转写：<|im_end|>")
            if probe and max(probe) >= self.embedding_table.shape[0]:
                raise ValueError(
                    f"tokenizer emits ids up to {max(probe)} but the decoder "
                    f"embedding table has only {self.embedding_table.shape[0]}"
                    " rows — the checkpoint is missing a matching "
                    "tokenizer.json")
            self.prompt_builder = PromptBuilder(self.tokenizer,
                                                self.embedding_table)

            if self.config.warmup:
                vprint("[4/5] 预热 (warm-up)...", verbose)
                self._warmup()

            vprint("[5/5] 初始化热词管理器...", verbose)
            self._init_hotwords()
            self._initialized = True
            vprint(f"✓ 模型加载完成 (耗时: "
                   f"{time.perf_counter() - t_start:.2f}s)", verbose)
            return True
        except Exception as e:
            logger.exception("initialization failed")
            vprint(f"✗ 初始化失败: {e}", verbose)
            self._stop_private_watchers()
            return False

    def _init_hotwords(self):
        from ..hotword.manager import PollingWatcher, read_or_create_text
        hw_path = self.config.hotwords_path or str(
            Path(self.config.checkpoint_dir) / "hot.txt")
        self.hotword_manager = get_hotword_manager(
            hotword_file=Path(hw_path), threshold=1.0,
            similar_threshold=self.config.similar_threshold)
        self.hotword_manager.load()
        self.hotword_manager.start_file_watcher()
        self.corrector = self.hotword_manager.get_corrector()
        self.corrector.correct("热个身")
        if self.config.rules_path:
            from ..hotword.hot_rule import RuleCorrector
            rules_file = Path(self.config.rules_path)
            self.rule_corrector = RuleCorrector()

            def _load_rules():
                content = read_or_create_text(
                    rules_file, "# 每行一条规则: pattern = replacement\n")
                if content is not None:
                    self.rule_corrector.update_rules(content)

            _load_rules()
            self._rules_watcher = PollingWatcher(rules_file, _load_rules)
            self._rules_watcher.start()
        if self.config.rectify_path:
            from ..hotword.hot_rectification import RectificationRAG
            self.rectification = RectificationRAG(self.config.rectify_path)
            self._rectify_watcher = PollingWatcher(
                Path(self.config.rectify_path),
                self.rectification.load_history)
            self._rectify_watcher.start()

    # -- device entry points -------------------------------------------------

    @torch.inference_mode()
    def encode_audio(self, audio: np.ndarray):
        """audio [n] → (audio_embd [T_llm, llm_dim] f32 host array,
        enc_output [1, T_lfr, d] device tensor), trimmed to the valid
        LLM token length."""
        n = len(audio)
        buf = np.zeros(self.pad_window_samples(n), dtype=np.float32)
        buf[:n] = audio
        enc, embd, _mask = audio_encoder_forward(
            {"encoder": self.encoder_params, "adaptor": self.adaptor_params},
            self.frontend_consts,
            torch.from_numpy(buf[None]).to(self.device),
            torch.tensor([n], dtype=torch.int64, device=self.device),
            self.audio_cfg, compute_dtype=self._compute_dtype)
        target_len = audio_token_length(n, self.audio_cfg.frontend)
        count("host.syncs")
        return embd[0, :target_len].cpu().numpy(), enc

    @torch.inference_mode()
    def ctc_indices(self, enc_output) -> np.ndarray:
        """enc_output [1, T, d] → argmax ids [T] (only ids reach the host)."""
        idx = ctc_head_forward(self.ctc_params,
                               enc_output.to(self._compute_dtype),
                               self.hybrid_cfg.ctc)
        count("host.syncs")
        return idx[0].cpu().numpy()

    @torch.inference_mode()
    def prefill(self, full_embd: np.ndarray, rng_seed: int):
        """Left-pad the prompt into its bucket and run the prefill."""
        p_len, llm_dim = full_embd.shape
        bucket = self.prompt_bucket(p_len)
        buf = np.zeros((1, bucket, llm_dim), dtype=np.float32)
        buf[0, bucket - p_len:] = full_embd
        mask = np.zeros((1, bucket), dtype=np.float32)
        mask[0, bucket - p_len:] = 1.0
        gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        max_len = bucket + self.config.n_predict
        if self.config.speculative:
            # a verify round writes spec_k + 1 rows from the next free slot;
            # the rejected ones need room to land in
            max_len += self.config.spec_k + 1
        return prefill_init(
            self.llm_params,
            torch.from_numpy(buf).to(self.device, self._compute_dtype),
            torch.from_numpy(mask).to(self.device), gen,
            self.hybrid_cfg.llm, max_len=max_len,
            kv_int8=(self.config.kv_cache_dtype == "int8"))

    @torch.inference_mode()
    def generate(self, state, temperature: float, top_p: float, top_k: int,
                 chunk_len: int, limit: Optional[int] = None):
        return generate_chunk(self.llm_params, state, self.hybrid_cfg.llm,
                              temperature, top_p, top_k, chunk_len=chunk_len,
                              stop_tokens=self.stop_tokens, limit=limit)

    def make_draft_ids(self, draft_text: str) -> Optional[torch.Tensor]:
        """Tokenize a CTC transcript into the [1, spec_draft_len] draft
        buffer on the device (-1 padded)."""
        if not draft_text or self.tokenizer is None:
            return None
        ids = self.tokenizer.encode(draft_text)[:self.config.spec_draft_len]
        buf = torch.full((1, self.config.spec_draft_len), -1,
                         dtype=torch.int64)
        buf[0, :len(ids)] = torch.tensor(ids, dtype=torch.int64)
        return buf.to(self.device)

    def spec_prepare(self, state):
        """GenState (from :meth:`prefill`) → speculative carry."""
        return spec_init(state)

    @torch.inference_mode()
    def spec_generate(self, state, draft_ids, temperature: float,
                      top_p: float, top_k: int, chunk_len: int,
                      limit: Optional[int] = None):
        return spec_generate_chunk(
            self.llm_params, state, draft_ids, self.hybrid_cfg.llm,
            temperature, top_p, top_k, spec_k=self.config.spec_k,
            chunk_len=chunk_len, stop_tokens=self.stop_tokens, limit=limit)

    def _warmup(self):
        sr = self.config.sample_rate
        _embd, enc = self.encode_audio(np.zeros(sr, dtype=np.float32))
        if self.config.enable_ctc:
            self.ctc_indices(enc)
        buckets = sorted(self.config.prefill_buckets)
        if not self.config.warmup_all_buckets:
            buckets = buckets[:1]       # the others warm on first use
        chunk = self._default_chunk_len()
        for bucket in buckets:
            fake = np.zeros((bucket, self.hybrid_cfg.llm.hidden), np.float32)
            for temp in (0.0, 0.4):
                state = self.prefill(fake, rng_seed=0)
                if self.config.speculative and self.config.enable_ctc:
                    # the speculative chunk, and the plain chunk that
                    # continues a state the guardrail converted
                    draft = torch.full((1, self.config.spec_draft_len), -1,
                                       dtype=torch.int64, device=self.device)
                    sstate = self.spec_prepare(state)
                    self.spec_generate(sstate, draft, temperature=temp,
                                       top_p=1.0, top_k=50, chunk_len=chunk,
                                       limit=1)
                    state = spec_to_gen(sstate)
                self.generate(state, temperature=temp, top_p=1.0, top_k=50,
                              chunk_len=chunk, limit=2)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _default_chunk_len(self) -> int:
        return min(64, self.config.n_predict)

    # -- host-side hooks -----------------------------------------------------

    def augment_context(self, context, draft_text):
        if self.rectification is None or not draft_text:
            return context
        block = self.rectification.format_prompt(draft_text)
        if not block:
            return context
        return f"{context}\n{block}" if context else block

    def apply_rules(self, text: str) -> str:
        if self.rule_corrector is None:
            return text
        return self.rule_corrector.substitute(text)

    def _stop_private_watchers(self):
        for name in ("_rules_watcher", "_rectify_watcher"):
            watcher = getattr(self, name)
            if watcher:
                watcher.stop()
                setattr(self, name, None)

    def cleanup(self):
        if self.hotword_manager:
            self.hotword_manager.stop_file_watcher()
        self._stop_private_watchers()
        self.encoder_params = self.adaptor_params = None
        self.ctc_params = self.llm_params = None
        self._initialized = False
