"""The routing-aware comparison, on the CPU at the rehearsal's shapes.

``arch/deepseek2.py``'s plain decoder agrees with transformers'
``DeepseekV3ForCausalLM`` on the same dequantized weights. Following its
own routes gives its free pass bit for bit. A bf16-rounded copy of the
reference, standing in as the program, makes choices that differ from
the float32 reference's own at near-ties, and the reference that follows
it reads a smaller logit error than one that routes freely. Under limits
set between the sound stand-in's readings and a fault's, a routing fault
(the program computes and records a wrong expert), a program that
computes and records one expert k times, and one whose routes stop short
of the positions it ran each fail ``route_gap``, and an expert-id mix-up
(it records other experts than it computed) fails ``llm_logit_err``.
A decision that names an expert twice or one that does not exist reads
``arch.BROKEN_GAP``, and a configuration that states what
``arch/deepseek2.py`` does not compute is refused. A dense record reads
what the comparison read before routes existed (``routes_recorded.json``,
by torch release: the CPU draw of the encoder differs between releases).

    python -m pytest bench_torch/tests/test_routes.py -q
"""

import json
import math
import os

import pytest
import torch

from bench_torch import arch, correct, harness, reference, traffic, weights
from bench_torch.arch import deepseek2, qwen3

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TOP_K = 50
N_TOKENS = 60
CHUNKS = [0, 16, 32, 48, N_TOKENS]  # positions of the logit rows kept


def _cfg(arch):
    with open(os.path.join(harness.HERE, "configs",
                           "funasr-nano-2512.q8_0.json")) as f:
        cfg = json.load(f)
    cfg["model"] = harness.tiny_model({"model": {"llm": {"arch": arch}}})
    return cfg


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    with open(os.path.join(harness.HERE, "traffic", "short.json")) as f:
        mix = dict(json.load(f), pool=1)
    return traffic.write_pool(mix, SEED, str(tmp_path_factory.mktemp("w")))


def _bf16(x, w, act):
    return (x.bfloat16() @ w.bfloat16().t()).float()


def _record(cfg, wav, module, program="sound"):
    """A greedy request's record as the harness keeps it, from a stand-in
    program: the reference with every product rounded to bf16 (``_dmm``
    of ``module``). ``program``: "sound" records the experts it chose;
    "fault" computes and records ``arch.route_fault`` of them; "repeat"
    computes and records the first of them k times; "short" records
    them but for the last position it ran; "mixup" computes the
    neighbours of the experts it records."""
    ref = reference.Reference(cfg, SEED, torch.device("cpu"))
    audio = torch.from_numpy(traffic.read_wav(wav[0]))
    tokens = torch.randint(0, cfg["model"]["llm"]["vocab_size"],
                           (N_TOKENS,),
                           generator=torch.Generator().manual_seed(7))
    mp = pytest.MonkeyPatch()
    try:
        with torch.inference_mode():
            enc, emb = ref.encode(audio)
            prompt = ref.prompt(emb)
            ctc = ref.ctc_logits(enc)
            ids = ctc.argmax(-1)
            ids[::7] = (ids[::7] + 1) % ctc.shape[-1]
            mp.setattr(module, "_dmm", _bf16)
            logits, info = ref.decoder_logits(prompt, tokens)
            att = {"tokens": tokens.tolist()}
            if ref.routed:
                own = info["routes"]
                if program == "fault":
                    own = arch.route_fault(own, ref.decoder.n_experts)
                if program == "repeat":
                    own = own[..., :1].expand_as(own).contiguous()
                # the mix-up: each expert computed is its neighbour's
                # (0 <-> 1, 2 <-> 3, ...), of an even count of experts
                computed = own ^ 1 if program == "mixup" else own
                logits = ref.decoder_logits(prompt, tokens, computed)[0]
                att["routes"] = own[:, :-1] if program == "short" else own
    finally:
        mp.undo()
    att["logits"] = [(p, logits[p]) for p in CHUNKS]
    return {"clip": 0, "ctc_ids": ids.numpy(), "greedy": True, "ok": True,
            "served": att, "first": att}


def _readings(cfg, wav, rec, control=False):
    return correct.readings(cfg, SEED, torch.device("cpu"), [rec], wav,
                            TOP_K, control=control)


PROGRAMS = ("sound", "fault", "repeat", "short", "mixup")


@pytest.fixture(scope="module")
def routed(wav):
    """The readings of the sound stand-in and of each fault."""
    cfg = _cfg("deepseek2")
    return {p: _readings(cfg, wav, _record(cfg, wav, deepseek2, p))
            for p in PROGRAMS}


def _hf_model(llm, dec, decoder):
    transformers = pytest.importorskip("transformers")
    hf = transformers.DeepseekV3Config(
        vocab_size=llm["vocab_size"], hidden_size=llm["hidden"],
        intermediate_size=llm["ffn_dim"],
        moe_intermediate_size=llm["moe_ffn_dim"],
        num_hidden_layers=llm["n_layers"],
        num_attention_heads=llm["q_heads"],
        num_key_value_heads=llm["kv_heads"],
        n_shared_experts=llm["n_shared_experts"],
        n_routed_experts=llm["n_experts"],
        routed_scaling_factor=llm["routed_scaling_factor"],
        kv_lora_rank=llm["kv_lora_rank"], q_lora_rank=None,
        qk_rope_head_dim=llm["qk_rope_dim"], v_head_dim=llm["v_head_dim"],
        qk_nope_head_dim=llm["qk_nope_dim"], n_group=1, topk_group=1,
        num_experts_per_tok=llm["n_experts_per_tok"],
        first_k_dense_replace=llm["moe_first_dense"],
        norm_topk_prob=llm["norm_topk_prob"],
        max_position_embeddings=llm["max_position"],
        rms_norm_eps=llm["rms_eps"], rope_theta=llm["rope_theta"],
        tie_word_embeddings=False, attention_bias=False,
        rope_interleave=True, attn_implementation="eager")
    model = transformers.DeepseekV3ForCausalLM(hf).eval()
    params = model.state_dict()

    def dq(name, *i):
        return reference.q8_0_dequant(dec[name][0][i], dec[name][1][i])
    swiglu = (("gate_proj", "ffn_gate"), ("up_proj", "ffn_up"),
              ("down_proj", "ffn_down"))
    sd = {"model.embed_tokens.weight": decoder.embed,
          "lm_head.weight": decoder.head}
    k0 = llm["moe_first_dense"]
    for i in range(llm["n_layers"]):
        p = f"model.layers.{i}."
        for hf_name, name in (("q_proj", "attn_q"),
                              ("kv_a_proj_with_mqa", "attn_kv_a_mqa"),
                              ("kv_b_proj", "attn_kv_b"),
                              ("o_proj", "attn_output")):
            sd[f"{p}self_attn.{hf_name}.weight"] = dq(name, i)
        # the GGUF's one epsilon, which llama.cpp gives the latent norm
        # too (the published code leaves it at 1e-6)
        model.model.layers[i].self_attn.kv_a_layernorm.variance_epsilon = \
            llm["rms_eps"]
        if i < k0:
            for hf_name, name in swiglu:
                sd[f"{p}mlp.{hf_name}.weight"] = dq(name, i)
            continue
        j = i - k0
        sd[f"{p}mlp.gate.weight"] = decoder.router[j]
        sd[f"{p}mlp.gate.e_score_correction_bias"] = decoder.bias[j]
        for hf_name, name in swiglu:
            sd[f"{p}mlp.shared_experts.{hf_name}.weight"] = dq(
                name + "_shexp", j)
            for e in range(llm["n_experts"]):
                sd[f"{p}mlp.experts.{e}.{hf_name}.weight"] = dq(
                    name + "_exps", j, e)
        if f"{p}mlp.experts.gate_up_proj" in params:
            # later releases hold the experts as two stacked tensors,
            # gate rows then up rows
            ex = {n: torch.stack([sd.pop(f"{p}mlp.experts.{e}.{n}.weight")
                                  for e in range(llm["n_experts"])])
                  for n, _ in swiglu}
            for key, value in (
                    ("gate_up_proj", torch.cat([ex["gate_proj"],
                                                ex["up_proj"]], 1)),
                    ("down_proj", ex["down_proj"])):
                want = params[f"{p}mlp.experts.{key}"].shape
                if value.shape != want:
                    value = value.transpose(1, 2)
                assert value.shape == want, (key, want)
                sd[f"{p}mlp.experts.{key}"] = value
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all("norm" in k for k in missing), missing
    return model


def test_deepseek2_decoder_agrees_with_transformers(monkeypatch):
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    cfg = _cfg("deepseek2")
    llm = cfg["model"]["llm"]
    dec = weights.draw(cfg["model"], SEED, torch.device("cpu"))[1]
    decoder = deepseek2.Decoder(cfg, dec, torch.device("cpu"))
    model = _hf_model(llm, dec, decoder)
    prompt = decoder.embed[reference.byte_ids(reference.PROMPT_PREFIX)]
    tokens = torch.randint(0, llm["vocab_size"], (N_TOKENS,),
                           generator=torch.Generator().manual_seed(7))
    with torch.inference_mode():
        ours = decoder.logits(prompt, tokens)[0]
        theirs = model(inputs_embeds=torch.cat(
            [prompt, decoder.embed[tokens]])[None]).logits[
                0, prompt.shape[0] - 1:]
    err = float((ours - theirs).abs().max() / theirs.abs().max())
    assert err <= 1e-4, err


def test_following_its_own_routes_is_its_free_pass(wav):
    cfg = _cfg("deepseek2")
    ref = reference.Reference(cfg, SEED, torch.device("cpu"))
    prompt = ref.decoder.embed[reference.byte_ids(reference.PROMPT_PREFIX)]
    tokens = torch.arange(N_TOKENS) * 7 % 512
    with torch.inference_mode():
        free, own = ref.decoder_logits(prompt, tokens)
        followed, dec = ref.decoder_logits(prompt, tokens, own["routes"])
    assert torch.equal(free, followed)
    assert torch.equal(dec["routes"], own["routes"])
    assert dec["gap"].shape == own["routes"].shape[:2]
    assert float(dec["gap"].max()) == 0.0 and not dec["differs"].any()
    # the planted fault, read inside the pass, at every fifth position
    assert torch.equal(dec["fault_gap"], own["fault_gap"])
    assert dec["fault_gap"].shape == own["routes"].shape[:2]
    assert (dec["fault_gap"][:, 4::5] > 0).float().mean() > 0.9
    assert float(dec["fault_gap"][:, 0::5].max()) == 0.0


def test_route_fault_moves_one_expert_to_one_it_does_not_hold():
    routes = torch.tensor([[[0, 1, 2, 3]] * 5 + [[4, 5, 30, 31]] * 5])
    out = arch.route_fault(routes, 32)
    assert out[0, 4].tolist() == [4, 1, 2, 3]
    assert out[0, 9].tolist() == [6, 5, 30, 31]
    assert torch.equal(out[:, :4], routes[:, :4])
    assert torch.equal(out[:, 5:9], routes[:, 5:9])


@pytest.mark.parametrize("broken", ["twice", "above", "below"])
def test_broken_decisions_read_the_broken_gap(broken):
    cfg = _cfg("deepseek2")
    ref = reference.Reference(cfg, SEED, torch.device("cpu"))
    prompt = ref.decoder.embed[reference.byte_ids(reference.PROMPT_PREFIX)]
    tokens = torch.arange(N_TOKENS) * 7 % 512
    with torch.inference_mode():
        routes = ref.decoder_logits(prompt, tokens)[1]["routes"].clone()
        at = routes[:, 3::11]
        at[..., 1] = {"twice": at[..., 2], "above": 32,
                      "below": -1}[broken]
        gap = ref.decoder_logits(prompt, tokens, routes)[1]["gap"]
    assert (gap[:, 3::11] == arch.BROKEN_GAP).all()
    sound = torch.ones_like(gap, dtype=torch.bool)
    sound[:, 3::11] = False
    assert float(gap[sound].max()) < 1.0


@pytest.mark.parametrize("key, value", [
    ("q_lora_rank", 64), ("n_group", 2), ("topk_group", 2),
    ("rope_yarn_factor", 4.0), ("router_scoring", "softmax"),
    ("router_bias", False), ("tie_embeddings", True),
    ("rope_interleaved", False), ("qk_norm", True), ("head_dim", 16),
    ("rope_dim", 16)])
def test_what_the_reference_does_not_compute_is_refused(key, value):
    llm = dict(deepseek2.tiny_llm(), **{key: value})
    with pytest.raises(ValueError, match=key):
        deepseek2.decoder_tensors(llm)


def test_bf16_stand_in_differs_at_ties_and_is_judged_by_its_gap(wav,
                                                                 routed):
    read = routed["sound"]
    assert read["route_decisions"] > 0
    assert read["route_differs_pct"] > 0.0, read
    assert read["route_gap"] * 10 < read["fault_route_gap"], read
    # the reference that routes freely reads the ties as logit error
    cfg = _cfg("deepseek2")
    rec = _record(cfg, wav, deepseek2)
    ref = reference.Reference(cfg, SEED, torch.device("cpu"))
    att = rec["served"]
    with torch.inference_mode():
        prompt = ref.prompt(ref.encode(torch.from_numpy(
            traffic.read_wav(wav[0])))[1])
        free = ref.decoder_logits(prompt, torch.tensor(att["tokens"]))[0]
    got = torch.stack([lg for _, lg in att["logits"]])
    assert read["llm_logit_err"] < correct._rel_err(got, free[CHUNKS]), read


def _limit(lower, upper):
    assert upper >= 3 * lower, (lower, upper)
    return math.sqrt(max(lower, 1e-9) * upper)


@pytest.mark.parametrize("fault, number", [("fault", "route_gap"),
                                           ("repeat", "route_gap"),
                                           ("short", "route_gap"),
                                           ("mixup", "llm_logit_err")])
def test_route_faults_fail_judge(routed, fault, number):
    sound = routed["sound"]
    limits = {k: _limit(sound[k], routed[fault][k])
              for k in ("route_gap", "llm_logit_err")
              if routed[fault][k] >= 3 * sound[k]}
    assert number in limits, (sound, routed[fault])
    assert correct.judge(sound, limits)[0]
    ok, compared = correct.judge(routed[fault], limits)
    assert not ok
    assert compared[number]["value"] > compared[number]["limit"]


def test_judge_wants_decisions_where_route_gap_is_limited(routed):
    read = dict(routed["sound"], route_decisions=0)
    assert not correct.judge(read, {"route_gap": 1.0})[0]


@pytest.mark.parametrize("control", [False, True])
def test_dense_readings_are_the_recorded(wav, control):
    release = torch.__version__.split("+")[0]
    with open(os.path.join(HERE, "routes_recorded.json")) as f:
        rec = json.load(f)
    if release not in rec:
        pytest.skip(f"no record for torch {release}; recorded: "
                    f"{', '.join(rec)} (its CPU draws differ by release)")
    want = rec[release]["control" if control else "plain"]
    cfg = _cfg("qwen3")
    got = _readings(cfg, wav, _record(cfg, wav, qwen3), control)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
