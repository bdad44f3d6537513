"""A run with the timed path broken underneath must come out not correct.

Each case drives the whole of ``harness.run`` on the CPU at the tiny
model's shapes (the rehearsal: no look for a card, the program's plain
versions), under the cell's own limits, with one fault planted in the
program. The sound run comes out correct; a served token altered where
it is sampled (of every request, or of the sampled ones only, which no
greedy gap sees) and a decode step that leaves the state as it was come
out not correct. A CTC id altered where the head produces it is run on
the card at the cell's own size (the tiny head's 101 logits span less
than the cell's limit; the full head's 60515 span tens of times more),
and comes out not correct there; without a card it skips. (The cells
serve one request at a time on one chip: there is no batch to halve and
no exchange between chips.)
On the CPU the window serves the sequence's first ``CPU_REQUESTS``
requests, three sampled and one greedy, however fast the host is.

A run through ``run.py`` into which JAX or the JAX package was loaded
exits 3 and prints no result.

    python -m pytest bench_torch/tests/test_faults.py -q
"""

import argparse
import io
import json
import sys
import time
import types

import pytest
import torch

from bench_torch import harness, run
from fun_asr_gguf_tpu_torch.core import model_manager
from fun_asr_gguf_tpu_torch.models import generate

WORKLOAD = "nano-q8_0.clip60"
CPU_REQUESTS = 4    # the mix's first group of four: its last is greedy


def _run(seed, workload=WORKLOAD, device=None):
    out = io.StringIO()
    args = argparse.Namespace(workload=workload, seed=seed, seconds=5.0,
                              trace=0, t_start=time.perf_counter())
    if device is None:
        cfg = harness.load_cell(harness.ROOT, workload)[2]
        harness.run(args, torch.device("cpu"), model=harness.tiny_model(cfg),
                    out=out, requests=CPU_REQUESTS)
    else:
        harness.run(args, device, out=out)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _altered_token(monkeypatch, sampled_only=False):
    """Every fifth token drawn in the decode loop replaced by its
    neighbour id where it is produced; with ``sampled_only``, of the
    draws at a temperature above 0 only."""
    inner = generate.sample_residual
    calls = [0]

    def sample(logits, generator, temperature, *args, **kwargs):
        token = inner(logits, generator, temperature, *args, **kwargs)
        if sampled_only and temperature <= 0:
            return token
        calls[0] += 1
        if calls[0] % 5 == 0:
            token = (token + 1) % logits.shape[-1]
        return token
    monkeypatch.setattr(generate, "sample_residual", sample)


def _altered_ctc_id(monkeypatch):
    """Every fifth frame's CTC id moved to the next id where the head
    produces it."""
    inner = model_manager.ctc_head_forward

    def head(params, enc, cfg):
        idx = inner(params, enc, cfg).clone()
        idx[:, 4::5] = (idx[:, 4::5] + 1) % cfg.vocab_size
        return idx
    monkeypatch.setattr(model_manager, "ctc_head_forward", head)


def _stuck_step(monkeypatch):
    """Every decode step returns the first step's logits and leaves the
    cache as it was."""
    inner = generate.qwen3_decode_step
    first = {}

    def step(params, kv, emb, *args):
        if id(kv) not in first:
            first.clear()
            first[id(kv)] = inner(params, kv, emb, *args)[0].clone()
        return first[id(kv)], kv
    monkeypatch.setattr(generate, "qwen3_decode_step", step)


@pytest.mark.parametrize("fault", [None, "altered_token",
                                   "altered_sampled_token", "stuck_step"])
def test_fault_fails_correct(monkeypatch, fault):
    if fault == "altered_token":
        _altered_token(monkeypatch)
    elif fault == "altered_sampled_token":
        _altered_token(monkeypatch, sampled_only=True)
    elif fault == "stuck_step":
        _stuck_step(monkeypatch)
    res = _run(seed=2 ** 31 + 17)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"] is (fault is None), res["compared"]


def test_altered_ctc_id_fails_correct_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CTC head is read at full size")
    _altered_ctc_id(monkeypatch)
    res = _run(2 ** 31 + 19, "nano-int8.short", torch.device("cuda", 0))
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"] is False, res["compared"]
    assert res["compared"]["ctc_gap"]["value"] > \
        res["compared"]["ctc_gap"]["limit"], res["compared"]


def test_foreign_modules_are_compared_by_whole_top_level_names():
    names = ["fun_asr_gguf_tpu_torch", "fun_asr_gguf_tpu_torch.ops",
             "jaxtyping", "flaxen", "torch", "jax", "jax.numpy",
             "jaxlib.xla_client", "flax.linen", "fun_asr_gguf_tpu",
             "fun_asr_gguf_tpu.models.qwen3"]
    assert run.foreign(names) == [
        "flax.linen", "fun_asr_gguf_tpu", "fun_asr_gguf_tpu.models.qwen3",
        "jax", "jax.numpy", "jaxlib.xla_client"]


@pytest.mark.parametrize("name", [None, "jax", "jaxlib", "flax",
                                  "fun_asr_gguf_tpu.models"])
def test_run_that_loads_jax_prints_no_result(monkeypatch, capsys, name):
    """A stand-in module put into ``sys.modules`` where the program draws
    a token, inside the window: the run ends 3, with no result. What
    other tests of this process loaded of JAX is out of ``sys.modules``
    for the run and back after it."""
    for loaded in run.foreign(list(sys.modules)):
        monkeypatch.delitem(sys.modules, loaded)
    inner = generate.sample_residual

    def sample(*args, **kwargs):
        if name is not None and name not in sys.modules:
            monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        return inner(*args, **kwargs)
    monkeypatch.setattr(generate, "sample_residual", sample)
    rc = run.entry(["--workload", WORKLOAD, "--seed", str(2 ** 31 + 31),
                    "--seconds", "0", "--rehearse"])
    out, err = capsys.readouterr()
    if name is None:
        line = json.loads(out.strip().splitlines()[-1])
        assert rc == 0 and line["attempted"] == 1, err[-2000:]
    else:
        assert rc == 3 and '"correct"' not in out, out[-2000:]
        assert err.strip().splitlines()[-1].endswith(name)
