"""The benchmark of the PyTorch/CUDA port: one cell, one run.

    python3 bench_torch/run.py --workload nano-q8_0.clip60 --seed 7 \\
        --seconds 45 --trace 0

Prints the cell's metrics as one JSON line, last on standard output
(``--trace 0``: the end-to-end metrics; ``--trace 1``: the per-layer
metrics, the device's busy time and a breakdown), and each compared
number beside its limit last on standard error. Needs as many CUDA cards
as the cell asks for, else it exits 2 and prints no result.

``--rehearse`` runs the same code on the CPU at the tiny model's shapes
(``HybridConfig.tiny()``) with the program's plain versions: the traffic,
the per-request output lengths, the window, the readers and the line's
shape. Its device reads ``cpu`` and it reports no device metric.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--dump", metavar="PATH",
                   help="write the window's requests, one JSON line each")
    args = p.parse_args(argv)
    args.t_start = T_START
    import torch
    from bench_torch import harness
    cell = harness.load_cell(ROOT, args.workload)[1]
    if args.rehearse:
        return harness.run(args, torch.device("cpu"), model=harness.TINY)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return harness.run(args, torch.device("cuda", 0))


if __name__ == "__main__":
    sys.exit(main())
