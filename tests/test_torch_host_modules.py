"""The port's own copies of the JAX package's host modules give the JAX
package's outputs, on seeded inputs.

The port imports nothing of ``fun_asr_gguf_tpu``: it carries copies of the
numpy / C++ host modules it runs (CTC collapse and alignment, the overlap
merge, the GGUF reader and writer, q8_0 quantization, the tokenizers,
hotwords). Each copy is held here against the original on the same
inputs.
"""

import numpy as np
import pytest

from fun_asr_gguf_tpu import ctc as jctc
from fun_asr_gguf_tpu import text_merge as jmerge
from fun_asr_gguf_tpu.formats import gguf as jgguf
from fun_asr_gguf_tpu.formats import quant_np as jquant
from fun_asr_gguf_tpu.formats import tokenizer as jtok
from fun_asr_gguf_tpu.hotword import hot_phoneme as jphon
from fun_asr_gguf_tpu_torch import ctc as tctc
from fun_asr_gguf_tpu_torch import text_merge as tmerge
from fun_asr_gguf_tpu_torch.formats import gguf as tgguf
from fun_asr_gguf_tpu_torch.formats import quant_np as tquant
from fun_asr_gguf_tpu_torch.formats import tokenizer as ttok
from fun_asr_gguf_tpu_torch.hotword import hot_phoneme as tphon

VOCAB = {i: chr(0x4E00 + i) for i in range(40)}
VOCAB[40] = "<blk>"                  # the highest id is the blank


def _ids(seed, n=120):
    rng = np.random.default_rng(seed)
    return np.repeat(rng.integers(0, 41, size=n // 3), 3)[:n]


@pytest.mark.parametrize("seed", range(3))
def test_decode_ctc_and_align_timestamps_match(seed):
    ids = _ids(seed)
    jtext, jtoks, _ = jctc.decode_ctc(ids, VOCAB)
    ttext, ttoks, _ = tctc.decode_ctc(ids, VOCAB)
    assert ttext == jtext and len(jtext) > 5
    assert [(t.text, t.start) for t in ttoks] == \
        [(t.text, t.start) for t in jtoks]
    rng = np.random.default_rng(seed + 10)
    chars = list(jtext)
    rng.shuffle(chars[: len(chars) // 3])
    llm = "".join(chars[: len(chars) - 2]) + "乙丙"
    assert tctc.align_timestamps(ttoks, llm) == \
        jctc.align_timestamps(jtoks, llm)


def test_merge_transcription_results_match():
    rng = np.random.default_rng(4)
    results, offsets = [], []
    for i in range(3):
        text = "".join(chr(0x4E00 + c) for c in rng.integers(0, 30, 12))
        segs = [{"char": ch, "start": round(0.25 * j, 3)}
                for j, ch in enumerate(text)]
        results.append({"text": text, "segments": segs})
        offsets.append(2.5 * i)
    assert tmerge.merge_transcription_results(results, offsets, 0.5) == \
        jmerge.merge_transcription_results(results, offsets, 0.5)


def test_q8_0_quantize_and_gguf_roundtrip_match(tmp_path):
    x = (np.random.default_rng(5).normal(size=(48, 96)) * 0.1).astype(
        np.float32)
    x[3, :32] = 0.0                               # an all-zero block
    jq, jd = jquant.q8_0_quantize(x)
    tq, td = tquant.q8_0_quantize(x)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(td, jd)
    path = str(tmp_path / "t.gguf")
    w = tgguf.GGUFWriter(path, arch="qwen3")
    w.add_kv("qwen3.block_count", 2)
    w.add_tensor_q8_0("w.weight", tq, td)
    w.add_tensor("n.weight", x[0])
    w.write()
    jr, tr = jgguf.GGUFReader(path), tgguf.GGUFReader(path)
    for got, want in zip(tr.tensor_q8_0("w.weight"),
                         jr.tensor_q8_0("w.weight")):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tr.tensor("w.weight"),
                                  jr.tensor("w.weight"))
    np.testing.assert_array_equal(tr.tensor("n.weight"), x[0])
    assert int(tr.fields["qwen3.block_count"]) == 2


def test_tokenizer_ids_match(tmp_path):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    b2u = ttok._bytes_to_unicode()
    vocab = {ch: i for i, (b, ch) in enumerate(sorted(b2u.items()))}
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens(["<|endoftext|>", "<|im_start|>", "<|im_end|>"])
    tok.save(str(tmp_path / "tokenizer.json"))
    text = "<|im_start|>语音转写：你好 world<|im_end|>"
    jt, tt = jtok.load_tokenizer(str(tmp_path)), ttok.load_tokenizer(
        str(tmp_path))
    assert tt.encode(text) == jt.encode(text)
    assert tt.eos_token == jt.eos_token and tt.stop_tokens == jt.stop_tokens
    byte_text = "字节 tokenizer"
    assert ttok.ByteTokenizer().encode(byte_text) == \
        jtok.ByteTokenizer().encode(byte_text)


def test_hotword_corrector_matches():
    words = ["语音识别", "热词", "深度学习"]
    jc, tc = jphon.PhonemeCorrector(), tphon.PhonemeCorrector()
    jc.update_hotwords("\n".join(words))
    tc.update_hotwords("\n".join(words))
    text = "我们在做预音识别和深度雪习"
    jr, tr = jc.correct(text), tc.correct(text)
    assert tr.text == jr.text == "我们在做语音识别和深度学习"
    assert tr.matchs == jr.matchs and tr.similars == jr.similars
