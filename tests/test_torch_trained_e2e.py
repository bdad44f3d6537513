# coding: utf-8
"""The port's facade against the JAX facade on a TRAINED checkpoint.

The North star asks for identical greedy text and timestamps, and allows
that comparison only where the weights make the answer well defined: on
the tiny checkpoint ``tests/test_trained_e2e.py`` trains (a SANM encoder,
CTC head and Qwen3-shaped decoder that read 8 pure tones as the letters
a–h, four per utterance). This test trains it the same way, with JAX in
the test process, writes it with ``save_checkpoint``, and transcribes the
held-out clips at T = 0 on the CPU with both facades, in float32, for the
``auto`` and ``bf16`` weight formats: ``text``, ``ctc_text`` and
``segments`` (the CTC timestamps) must be equal.
"""

import base64
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fun_asr_gguf_tpu.audio import write_wav
from fun_asr_gguf_tpu.formats.tokenizer import ByteTokenizer
from fun_asr_gguf_tpu.frontend import FrontendConfig, audio_token_length
from fun_asr_gguf_tpu.hotword.manager import \
    reset_hotword_manager as jax_reset_hotwords
from fun_asr_gguf_tpu.models.audio_encoder import (AudioEncoderConfig,
                                                   audio_encoder_forward,
                                                   make_frontend_constants)
from fun_asr_gguf_tpu.models.config import HybridConfig
from fun_asr_gguf_tpu.models.loaders import save_checkpoint
from fun_asr_gguf_tpu.parallel.training import (init_train_state,
                                                make_optimizer,
                                                make_prompted_train_step)
from fun_asr_gguf_tpu.prompt_utils import PromptBuilder
from fun_asr_gguf_tpu_torch.hotword.manager import reset_hotword_manager
# the reference test's task: its tones, utterances and held-out set
from test_trained_e2e import (CHARS, HELD_OUT, N_CHARS, N_SAMP, SR,
                              _flash_off, _synth)

torch.set_num_threads(2)

ENGINE_KW = dict(verbose=False, compute_dtype="float32",
                 segment_pad_seconds=4.0, n_predict=8, prefill_buckets=(128,))


def _train(ckpt):
    """``tests/test_trained_e2e.py``'s training (inline in its test, so
    copied here), to the same convergence test; the checkpoint goes to
    ``ckpt`` with its vocab files."""
    cfg = _flash_off(HybridConfig.tiny())
    acfg = AudioEncoderConfig(frontend=FrontendConfig(),
                              encoder=cfg.encoder, adaptor=cfg.adaptor)
    consts = jax.tree_util.tree_map(jnp.asarray,
                                    make_frontend_constants(acfg))
    n_audio = audio_token_length(N_SAMP)
    tok = ByteTokenizer()
    pb = PromptBuilder(tok, np.arange(cfg.llm.vocab_size,
                                      dtype=np.float32)[:, None])
    pre_e, suf_e, _, _, _ = pb.build_prompt(None, None, None)
    prefix_ids = pre_e[:, 0].astype(np.int32)
    suffix_ids = suf_e[:, 0].astype(np.int32)
    eos = tok.eos_token
    rng = np.random.default_rng(0)

    def make_batch(texts):
        b = len(texts)
        audio = np.stack([_synth(t, rng) for t in texts])
        toks = np.zeros((b, N_CHARS + 1), np.int32)
        ctc = np.zeros((b, N_CHARS), np.int32)
        for i, t in enumerate(texts):
            toks[i] = tok.encode(t) + [eos]
            ctc[i] = [CHARS.index(c) for c in t]
        return {
            "audio": jnp.asarray(audio),
            "ilens": jnp.full((b,), N_SAMP, jnp.int32),
            "prefix_ids": jnp.asarray(prefix_ids),
            "suffix_ids": jnp.asarray(suffix_ids),
            "ctc_labels": jnp.asarray(ctc),
            "ctc_label_pad": jnp.zeros((b, N_CHARS), jnp.float32),
            "tokens": jnp.asarray(toks),
            "token_mask": jnp.ones((b, N_CHARS + 1), jnp.float32),
        }

    def rand_text():
        while True:
            t = "".join(rng.choice(list(CHARS), N_CHARS))
            if t not in HELD_OUT:
                return t

    def greedy_inline(params, text) -> str:
        from fun_asr_gguf_tpu.models.qwen3 import (qwen3_decode_step,
                                                   qwen3_prefill)
        audio = _synth(text, np.random.default_rng(99))[None]
        _, embd, _ = audio_encoder_forward(
            {"encoder": params["encoder"], "adaptor": params["adaptor"]},
            consts, jnp.asarray(audio), jnp.asarray([N_SAMP], jnp.int32),
            cfg=acfg, compute_dtype=jnp.float32)
        embed = np.asarray(params["llm"]["embed"], np.float32)
        full = np.concatenate([embed[prefix_ids],
                               np.asarray(embd)[0, :n_audio],
                               embed[suffix_ids]], axis=0)
        p = full.shape[0]
        logits, kv = qwen3_prefill(
            params["llm"], jnp.asarray(full[None], jnp.float32),
            jnp.ones((1, p), jnp.float32), cfg.llm, kv_max_len=p + 8)
        out = []
        for t in range(8):
            nxt = int(jnp.argmax(logits[0]))
            if nxt in tok.stop_tokens:
                break
            out.append(nxt)
            logits, kv = qwen3_decode_step(
                params["llm"], kv, jnp.asarray(embed[[nxt]], jnp.float32),
                jnp.asarray(p + t, jnp.int32),
                jnp.asarray([p + t], jnp.int32),
                jnp.asarray([0], jnp.int32), cfg.llm)
        return tok.decode(out)

    opt = make_optimizer(lr=3e-3)
    step_fn = make_prompted_train_step(cfg, opt, n_audio)
    state = init_train_state(jax.random.PRNGKey(0), cfg, opt)
    converged = False
    for step in range(2600):
        state, metrics = step_fn(state, consts, make_batch(
            [rand_text() for _ in range(32)]))
        if step >= 750 and step % 250 == 0:
            if all(greedy_inline(state.params, t) == t for t in HELD_OUT):
                converged = True
                break
    assert converged or float(metrics["lm_loss"]) < 0.05, (
        f"training did not converge: {metrics}")
    params = state.params
    save_checkpoint(ckpt, cfg, params["encoder"], params["adaptor"],
                    params["ctc"], params["llm"], quantize_q8_0=False)
    rows = []
    for i in range(cfg.ctc.vocab_size):
        ch = CHARS[i] if i < len(CHARS) else (
            "<blk>" if i == cfg.ctc.vocab_size - 1 else f"<u{i}>")
        rows.append(f"{base64.b64encode(ch.encode()).decode()} {i}")
    with open(os.path.join(ckpt, "tokens.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(ckpt, "hot.txt"), "w") as f:
        f.write("# none\n")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("trained")
    ckpt = str(root / "ckpt")
    _train(ckpt)
    wavs = []
    for text in HELD_OUT:
        wav = str(root / f"{text}.wav")
        write_wav(wav, _synth(text, np.random.default_rng(7)), SR)
        wavs.append(wav)
    return ckpt, wavs


def _transcribe(create, reset, ckpt, wavs, **kw):
    reset()
    eng = create(ckpt, **ENGINE_KW, **kw)
    try:
        return [eng.transcribe(w, verbose=False, temperature=0.0)
                for w in wavs]
    finally:
        eng.cleanup()
        reset()


@pytest.mark.parametrize("fmt", ["auto", "bf16"])
def test_port_transcribes_the_trained_checkpoint_as_jax(trained, fmt):
    from fun_asr_gguf_tpu import create_asr_engine as jax_engine
    from fun_asr_gguf_tpu_torch import create_asr_engine as port_engine
    ckpt, wavs = trained
    want = _transcribe(jax_engine, jax_reset_hotwords, ckpt, wavs,
                       llm_weight_format=fmt)
    got = _transcribe(port_engine, reset_hotword_manager, ckpt, wavs,
                      llm_weight_format=fmt, device="cpu")
    for g, w in zip(got, want):
        assert g.text == w.text
        assert g.ctc_text == w.ctc_text
        assert g.segments == w.segments
