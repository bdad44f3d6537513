"""The decoder architectures (``bench_torch/arch/``): the harness reaches a
decoder only through its configuration's ``model.llm.arch``, and qwen3's
file reads as the harness did before the decoder moved into it.

The recorded values were taken on the harness before the move (seed 0,
the CPU rehearsal's shapes): the decode step's and K4's counts at full
size, and, in ``qwen3_recorded.json`` by torch release, the checkpoint
files' SHA-256 and a sample of the reference's and the control's logits
(every 16th decoder logit of each row, every 100th CTC frame's every
10th logit). torch's CPU draw of bfloat16 uniforms differs between its
releases (2.11 and 2.13 draw other encoder weights from one seed), so a
release with no record skips those two tests. ``deepseek2_recorded.json``
holds the same of ``arch/deepseek2.py`` at its ``tiny_llm()``, as it was
written; and a deepseek2 decode step counts the experts it routes to,
not all of them.

    python -m pytest bench_torch/tests/test_arch.py -q
"""

import hashlib
import json
import math
import os

import pytest
import torch

from bench_torch import arch, harness, reference, roofline, weights

CONFIGS = ["funasr-nano-2512.int8", "funasr-nano-2512.q8_0"]
HERE = os.path.dirname(os.path.abspath(__file__))

# (bytes, operations) of one decode step at 200 and 450 visible slots
DECODE_TOKEN = {
    ("funasr-nano-2512.int8", 200): (620350976, 1237843968),
    ("funasr-nano-2512.int8", 450): (649022976, 1295187968),
    ("funasr-nano-2512.q8_0", 200): (694290432.0, 1237843968),
    ("funasr-nano-2512.q8_0", 450): (722962432.0, 1295187968),
}
# K4's (bytes, operations) a call of the q8_0 configuration, by (the next
# layer's qkv stage, rows)
K4_COUNTS = {
    (True, 1): (17719296.0, 31457280), (True, 9): (17850368.0, 283115520),
    (False, 1): (12988416.0, 23068672), (False, 9): (13053952.0, 207618048),
}
# the callers of the architecture modules: none names a decoder tensor
CALLERS = ["weights.py", "reference.py", "correct.py", "harness.py",
           "roofline.py"]
QWEN3_NAMES = ["attn_q", "ffn_gate", "qwen3."]


_T = torch.arange(24000, dtype=torch.float32) / 16000
_AUDIO = 0.1 * torch.sin(2 * math.pi * 440 * _T) \
    + 0.05 * torch.sin(2 * math.pi * 1234 * _T)


def _recorded(arch_name="qwen3"):
    """The record of ``arch_name`` for the running torch release."""
    release = torch.__version__.split("+")[0]
    with open(os.path.join(HERE, f"{arch_name}_recorded.json")) as f:
        rec = json.load(f)
    if release not in rec:
        pytest.skip(f"no record for torch {release}; recorded: "
                    f"{', '.join(rec)} (its CPU draws differ by release)")
    return rec[release]


def _cfg(name):
    with open(os.path.join(harness.HERE, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_checkpoint_bytes_are_the_recorded(tmp_path, name):
    model = harness.tiny_model(_cfg(name))
    ckpt = weights.write_checkpoint(str(tmp_path), model, 0,
                                    torch.device("cpu"))
    got = {}
    for f in sorted(os.listdir(ckpt)):
        with open(os.path.join(ckpt, f), "rb") as fh:
            got[f] = hashlib.sha256(fh.read()).hexdigest()
    assert got == _recorded()["sha256"]


@pytest.mark.parametrize("act", [None, "fp8"])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_and_control_logits_are_the_recorded(name, act):
    rec = _recorded()[f"{name}.{act or 'ref'}"]
    cfg = dict(_cfg(name))
    cfg["model"] = harness.tiny_model(cfg)
    ref = reference.Reference(cfg, 0, torch.device("cpu"), act=act)
    with torch.inference_mode():
        enc, emb = ref.encode(_AUDIO)
        logits = ref.decoder_logits(ref.prompt(emb),
                                    torch.tensor([5, 17, 300, 42]))[0]
        got = {"decoder": logits[:, ::16],
               "ctc": ref.ctc_logits(enc)[::100, ::10]}
    for part, g in got.items():
        want = torch.tensor(rec[part], dtype=torch.float64)
        assert g.shape == want.shape, part
        err = (g.double() - want).abs().max() / want.abs().max()
        assert err <= 1e-6, (part, float(err))


def _deepseek2_cfg():
    cfg = _cfg("funasr-nano-2512.q8_0")
    cfg["model"] = harness.tiny_model({"model": {"llm": {"arch":
                                                         "deepseek2"}}})
    return cfg


def test_deepseek2_checkpoint_bytes_are_the_recorded(tmp_path):
    ckpt = weights.write_checkpoint(str(tmp_path), _deepseek2_cfg()["model"],
                                    0, torch.device("cpu"))
    got = {}
    for f in sorted(os.listdir(ckpt)):
        with open(os.path.join(ckpt, f), "rb") as fh:
            got[f] = hashlib.sha256(fh.read()).hexdigest()
    assert got == _recorded("deepseek2")["sha256"]


@pytest.mark.parametrize("act", [None, "fp8"])
def test_deepseek2_logits_are_the_recorded(act):
    want = torch.tensor(_recorded("deepseek2")[act or "ref"],
                        dtype=torch.float64)
    ref = reference.Reference(_deepseek2_cfg(), 0, torch.device("cpu"),
                              act=act)
    with torch.inference_mode():
        prompt = ref.prompt(ref.encode(_AUDIO)[1])
        got = ref.decoder_logits(prompt, torch.tensor([5, 17, 300, 42]))[0]
    got = got[:, ::16]
    assert got.shape == want.shape
    err = (got.double() - want).abs().max() / want.abs().max()
    assert err <= 1e-6, float(err)


@pytest.mark.parametrize("name, visible", sorted(DECODE_TOKEN))
def test_decode_token_counts_are_the_recorded(name, visible):
    cfg = _cfg(name)
    got = roofline.decode_token(cfg["model"]["llm"], cfg["decoder_weights"],
                                visible)
    assert got == DECODE_TOKEN[name, visible]


def test_deepseek2_decode_token_counts_the_experts_it_uses():
    """Moonlight-16B-A3B's shapes with 64 and with 128 experts: a step
    reads no more expert weights, only a wider router and bias."""
    llm = {"hidden": 2048, "n_layers": 27, "q_heads": 16, "kv_heads": 16,
           "qk_nope_dim": 128, "qk_rope_dim": 64, "v_head_dim": 128,
           "kv_lora_rank": 512, "ffn_dim": 11264, "moe_first_dense": 1,
           "n_experts": 64, "n_experts_per_tok": 6, "moe_ffn_dim": 1408,
           "n_shared_experts": 2, "vocab_size": 163840}
    deepseek2 = arch.of({"arch": "deepseek2"})
    b64, o64 = deepseek2.decode_token(llm, "q8_0", 200)
    b128, o128 = deepseek2.decode_token(dict(llm, n_experts=128), "q8_0",
                                        200)
    assert b128 - b64 == 26 * 64 * (2048 + 1) * 4
    assert o128 - o64 == 2 * 26 * 64 * 2048


@pytest.mark.parametrize("with_qkv, m", sorted(K4_COUNTS))
def test_k4_counts_are_the_recorded(with_qkv, m):
    llm = _cfg("funasr-nano-2512.q8_0")["model"]["llm"]
    assert (roofline.k4_bytes(llm, with_qkv, m),
            roofline.k4_ops(llm, with_qkv, m)) == K4_COUNTS[with_qkv, m]


@pytest.mark.parametrize("name", CONFIGS)
def test_tiny_model_of_each_configuration_is_tiny(name):
    assert harness.tiny_model(_cfg(name)) == harness.TINY


def test_unknown_arch_names_the_file_looked_for():
    with pytest.raises(SystemExit, match=r"bench_torch/arch/nosuch\.py"):
        arch.of({"arch": "nosuch"})


@pytest.mark.parametrize("caller", CALLERS)
def test_callers_name_no_decoder_tensor(caller):
    with open(os.path.join(harness.HERE, caller)) as f:
        text = f.read()
    assert [n for n in QWEN3_NAMES if n in text] == []


@pytest.mark.parametrize("name", CONFIGS)
def test_counters_find_every_counter_a_route_names(name):
    route = _cfg(name)["route"]
    keys = harness.counters()
    assert "flash_decode.launches_i8" in keys
    assert [k for k in route["launched"] + route["not_launched"]
            if k not in keys] == []
