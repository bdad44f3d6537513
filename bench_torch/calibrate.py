"""Readings for the limits of ``correct``: the program's and the control's.

    python3 bench_torch/calibrate.py --workload nano-q8_0.clip60 \\
        --requests 7 --seeds 11,12,13

For each seed, in one process: the cell's set-up, then the first
``--requests`` requests of the sequence (enough for the sample a full
run compares), the comparison with the plain reference as a run makes it
(``llm_logit_err``, ``llm_gap``, ``ctc_gap``), and the control's readings
at the same positions (``control_*``: the reference in fp8). One JSON
line a seed. The limits in ``limits/<cell>.json`` are set from these readings:
above the program's largest, below the control's smallest.
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
    p.add_argument("--requests", type=int, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    import torch
    from bench_torch import harness
    if args.rehearse:
        device = torch.device("cpu")
        model = harness.tiny_model(harness.load_cell(harness.ROOT,
                                                     args.workload)[2])
    elif torch.cuda.is_available():
        device, model = torch.device("cuda", 0), None
    else:
        print("calibrate.py needs a CUDA card (or --rehearse)",
              file=sys.stderr)
        return 2
    for seed in args.seeds.split(","):
        run = argparse.Namespace(workload=args.workload, seed=int(seed),
                                 seconds=0.0, trace=0,
                                 t_start=time.perf_counter())
        harness.run(run, device, model=model, requests=args.requests,
                    calibrate=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
