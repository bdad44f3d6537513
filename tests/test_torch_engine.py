"""Port loaders and engine against the JAX package, on the CPU.

* A tiny checkpoint written by JAX ``create_random_checkpoint`` loads in the
  port exactly as ``models.weights`` converts the JAX loader's trees; one
  written by the port's numpy writer loads in JAX ``load_checkpoint``.
* The port's ``transcribe()`` returns the ``TranscriptionResult``
  structure, and its CTC text equals the JAX engine's on the same
  checkpoint and WAV (float32 compute on both).
* Settings outside the ported slices raise ``NotImplementedError``; an
  engine without ``device`` targets the card.
* A subprocess runs a tiny port transcription with the default decode
  (CTC-draft speculation) and an int8 KV cache without importing jax or
  any module of the JAX package; a static scan finds no import of it in
  the port, ``chip_smoke.py`` or ``chip_profile.py``.
"""

import ast
import base64
import glob
import os
import subprocess
import sys
from dataclasses import asdict

import numpy as np
import pytest
import torch

import jax

from fun_asr_gguf_tpu.audio import write_wav
from fun_asr_gguf_tpu.hotword.manager import \
    reset_hotword_manager as jax_reset_hotwords
from fun_asr_gguf_tpu.models.config import HybridConfig
from fun_asr_gguf_tpu.models.loaders import (create_random_checkpoint,
                                             load_checkpoint)
from fun_asr_gguf_tpu_torch.datatypes import TranscriptionResult
from fun_asr_gguf_tpu_torch.hotword.manager import reset_hotword_manager
from fun_asr_gguf_tpu_torch.models import loaders as tload
from fun_asr_gguf_tpu_torch.models.config import \
    HybridConfig as PortHybridConfig
from fun_asr_gguf_tpu_torch.models.weights import to_torch
from fun_asr_gguf_tpu_torch.ops.quant_matmul import Q8Weight

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = dict(verbose=False, compute_dtype="float32",
                 segment_pad_seconds=2.0, n_predict=4, prefill_buckets=(64,),
                 warmup=False)
PORT_KW = dict(ENGINE_KW, device="cpu")


def _add_vocab_files(ckpt, cfg):
    lines = []
    for i in range(cfg.ctc.vocab_size):
        ch = chr(ord("一") + i) if i < cfg.ctc.vocab_size - 1 else "<blk>"
        lines.append(f"{base64.b64encode(ch.encode()).decode()} {i}")
    with open(os.path.join(ckpt, "tokens.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(ckpt, "hot.txt"), "w", encoding="utf-8") as f:
        f.write("# test hotwords\n测试\n")


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt") / "model")
    cfg = create_random_checkpoint(ckpt, HybridConfig.tiny(), seed=0)
    _add_vocab_files(ckpt, cfg)
    return ckpt, cfg


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("wav") / "a.wav")
    write_wav(path, np.random.default_rng(0).normal(size=24000) * 0.05, 16000)
    return path


def assert_trees_equal(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, Q8Weight):
        assert isinstance(got, Q8Weight), path
        assert torch.equal(got.q, want.q) and torch.equal(got.d, want.d), path
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


def _jax_load_as_port(ckpt):
    cfg, enc, ada, ctc, llm, embed = load_checkpoint(
        ckpt, llm_dtype=jax.numpy.float32, llm_keep_quantized=True)
    trees = [to_torch(jax.tree_util.tree_map(np.array, jax.device_get(t)))
             for t in (enc, ada, ctc, llm)]
    return cfg, trees, embed


def test_jax_checkpoint_loads_equal_to_converted_params(jax_ckpt):
    ckpt, _ = jax_ckpt
    jcfg, want, jembed = _jax_load_as_port(ckpt)
    cfg, *got, embed = tload.load_checkpoint(ckpt, dtype=torch.float32)
    assert asdict(cfg) == asdict(jcfg)
    for g, w in zip(got, want):
        assert_trees_equal(g, w)
    np.testing.assert_array_equal(embed, jembed)


def test_port_written_checkpoint_loads_in_jax(tmp_path):
    ckpt = str(tmp_path / "model")
    cfg = tload.write_random_checkpoint(ckpt, PortHybridConfig.tiny(), seed=3)
    jcfg, want, jembed = _jax_load_as_port(ckpt)
    tcfg, *got, embed = tload.load_checkpoint(ckpt, dtype=torch.float32)
    # the GGUF stores rms_eps as f32, so compare the two loaded configs
    assert asdict(tcfg) == asdict(jcfg) and tcfg.encoder == cfg.encoder
    assert tcfg.llm.hidden == cfg.llm.hidden
    for g, w in zip(got, want):
        assert_trees_equal(g, w)
    np.testing.assert_array_equal(embed, jembed)


def test_safetensors_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"a.b": rng.normal(size=(3, 5)).astype(np.float32),
               "c": np.arange(7, dtype=np.int8),
               "d": rng.normal(size=(2,)).astype(np.float16)}
    path = str(tmp_path / "t.safetensors")
    tload.write_safetensors(path, tensors)
    from safetensors.numpy import load_file
    for got in (tload.read_safetensors(path), load_file(path)):
        for k, v in tensors.items():
            np.testing.assert_array_equal(got[k], v)


def test_transcribe_structure_and_ctc_text_match_jax(jax_ckpt, wav):
    ckpt, _ = jax_ckpt
    from fun_asr_gguf_tpu import create_asr_engine as jax_engine
    from fun_asr_gguf_tpu_torch import create_asr_engine as port_engine
    jax_reset_hotwords()
    long_kw = dict(verbose=False, temperature=0.0, segment_size=0.5,
                   overlap=0.1)          # 1.5 s clip → the windowed long path
    jeng = jax_engine(checkpoint_dir=ckpt, speculative=False, **ENGINE_KW)
    try:
        ref = jeng.transcribe(wav, verbose=False, temperature=0.0)
        ref_long = jeng.transcribe(wav, **long_kw)
    finally:
        jeng.cleanup()
        jax_reset_hotwords()
    reset_hotword_manager()
    teng = port_engine(ckpt, llm_weight_format="q8_0", **PORT_KW)
    try:
        res = teng.transcribe(wav, verbose=False, temperature=0.0)
        sampled = teng.transcribe(wav, verbose=False)
        res_long = teng.transcribe(wav, **long_kw)
    finally:
        teng.cleanup()
        reset_hotword_manager()
    assert res_long.ctc_text and res_long.ctc_text == ref_long.ctc_text
    starts = [seg["start"] for seg in res_long.segments]
    assert starts == sorted(starts)
    assert isinstance(res, TranscriptionResult)
    assert isinstance(res.text, str) and isinstance(sampled.text, str)
    assert res.ctc_text and res.ctc_text == ref.ctc_text
    assert abs(res.audio_seconds - 1.5) < 1e-9
    for seg in res.segments:
        assert set(seg) == {"char", "start"}
    t = res.timings
    assert min(t.encode, t.ctc, t.inject, t.llm_generate, t.total) > 0


@pytest.mark.parametrize("kwargs", [
    dict(llm_weight_format="int4"),
    dict(compute_dtype="float32", device="cuda"),
    dict(mesh_shape={"dp": 1, "tp": 2}), dict(ctc_beam_size=4)])
def test_settings_outside_the_slice_raise(kwargs):
    from fun_asr_gguf_tpu_torch import FunASREngine
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FunASREngine("unused", **{"device": "cpu", **kwargs})


@pytest.mark.parametrize("kwargs", [dict(llm_weight_format="int16"),
                                    dict(kv_cache_dtype="f8")])
def test_unknown_formats_are_refused(kwargs):
    from fun_asr_gguf_tpu_torch import FunASREngine
    with pytest.raises(ValueError, match="must be"):
        FunASREngine("unused", device="cpu", **kwargs)


def test_engine_without_device_targets_the_card():
    from fun_asr_gguf_tpu_torch import FunASREngine
    if torch.cuda.is_available():
        assert FunASREngine("unused").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FunASREngine("unused")


def test_batched_and_streaming_entry_points_raise(jax_ckpt, wav):
    from fun_asr_gguf_tpu_torch import FunASREngine
    eng = FunASREngine(jax_ckpt[0], device="cpu", compute_dtype="float32")
    for call in (lambda: eng.transcribe(wav, parallel_segments=True),
                 lambda: eng.transcribe_batch([wav]),
                 lambda: eng.decode_streams([]),
                 lambda: eng.create_streaming_session()):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


NO_JAX_SCRIPT = r"""
import base64, os, sys
import numpy as np
from fun_asr_gguf_tpu_torch import create_asr_engine
from fun_asr_gguf_tpu_torch.audio import write_wav
from fun_asr_gguf_tpu_torch.models.config import HybridConfig
from fun_asr_gguf_tpu_torch.models.loaders import write_random_checkpoint
root = sys.argv[1]
ckpt = os.path.join(root, "model")
cfg = write_random_checkpoint(ckpt, HybridConfig.tiny(), seed=1)
with open(os.path.join(ckpt, "tokens.txt"), "w", encoding="utf-8") as f:
    for i in range(cfg.ctc.vocab_size):
        f.write(base64.b64encode(chr(0x4E00 + i).encode()).decode()
                + f" {i}\n")
wav = os.path.join(root, "a.wav")
write_wav(wav, np.random.default_rng(0).normal(size=16000) * 0.05, 16000)
eng = create_asr_engine(ckpt, verbose=False, compute_dtype="float32",
                        device="cpu", segment_pad_seconds=2.0, n_predict=4,
                        prefill_buckets=(64,), kv_cache_dtype="int8",
                        hotwords_path=os.path.join(root, "hot.txt"))
spec_generate, states = eng.models.spec_generate, []
def recording(state, *args, **kw):            # the default decode speculates
    states.append(state)
    return spec_generate(state, *args, **kw)
eng.models.spec_generate = recording
res = eng.transcribe(wav, verbose=False, temperature=0.0)
rounds = int(states[-1].rounds[0]) if states else 0
eng.cleanup()
assert isinstance(res.text, str) and res.ctc_text and rounds > 0
assert "fun_asr_gguf_tpu_torch.models.speculative" in sys.modules
assert "fun_asr_gguf_tpu_torch.hotword.manager" in sys.modules
print("JAX_LOADED", "jax" in sys.modules)
print("JAX_PACKAGE", sorted(m for m in sys.modules if m == "fun_asr_gguf_tpu"
                            or m.startswith("fun_asr_gguf_tpu.")))
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT,
                           str(tmp_path)], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "JAX_LOADED False" in proc.stdout
    assert "JAX_PACKAGE []" in proc.stdout


def _imported_modules(path):
    """Every module name an ``import`` / ``from ... import`` of the file
    names (relative imports resolved against the file's package)."""
    rel = os.path.relpath(path, REPO)
    package = os.path.dirname(rel).replace(os.sep, ".")
    names = []
    for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".") if package else []
            if node.level:
                base = base[:len(base) - node.level + 1]
            else:
                base = []
            mod = ".".join(base + ([node.module] if node.module else []))
            names += [mod] + [f"{mod}.{a.name}" for a in node.names]
    return names


def test_port_imports_nothing_of_the_jax_package():
    files = sorted(glob.glob(os.path.join(REPO, "fun_asr_gguf_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files += [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "chip_profile.py")]
    assert len(files) > 40
    bad = {os.path.relpath(f, REPO): m for f in files
           for m in _imported_modules(f)
           if m == "jax" or m.startswith("jax.") or m == "fun_asr_gguf_tpu"
           or m.startswith("fun_asr_gguf_tpu.")}
    assert not bad, bad
