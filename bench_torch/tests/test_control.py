"""The control comes out not correct, at each cell's own size, on the card.

The control is the plain reference computed in the precision below the
configurations' bf16: fp8 (e4m3) activations in every product. For each
cell, one seed through ``calibrate``: the program's gaps stay within the
cell's limits and at least one of the control's gaps passes its limit.
Skips without a CUDA card (the tiny CPU model is too small for the
control to move its greedy tokens).

    python -m pytest bench_torch/tests/test_control.py -q
"""

import argparse
import io
import json
import time

import pytest
import torch

from bench_torch import harness

CELLS = {"nano-q8_0.clip60": 5, "nano-int8.short": 16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at full size")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(card, workload):
    out = io.StringIO()
    args = argparse.Namespace(workload=workload, seed=2 ** 31 + 101,
                              seconds=0.0, trace=0,
                              t_start=time.perf_counter())
    harness.run(args, card, out=out, requests=CELLS[workload],
                calibrate=True)
    read = json.loads(out.getvalue().strip().splitlines()[-1])
    limits = harness.load_cell(harness.ROOT, workload)[4]
    assert read["tokens"] > 0
    assert all(read[k] <= limits[k] for k in limits), read
    assert any(read["control_" + k] > limits[k] for k in limits), read
