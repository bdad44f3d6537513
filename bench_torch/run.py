"""The benchmark of the PyTorch/CUDA port: one cell, one run.

    python3 bench_torch/run.py --workload nano-q8_0.clip60 --seed 7 \\
        --seconds 45 --trace 0

Prints the cell's metrics as one JSON line, last on standard output
(``--trace 0``: the end-to-end metrics; ``--trace 1``: the per-layer
metrics, the device's busy time and a breakdown), and each compared
number beside its limit last on standard error. Needs as many CUDA cards
as the cell asks for, else it exits 2 and prints no result.

The script holds its standard output back until the run has ended, and
exits 3 and prints none of it where JAX, ``jaxlib``, ``flax`` or the
repository's JAX package (``fun_asr_gguf_tpu``) was loaded into the
process by then; it names the modules on standard error.

``--rehearse`` runs the same code on the CPU at the tiny model's shapes
(``HybridConfig.tiny()``) with the program's plain versions: the traffic,
the per-request output lengths, the window, the readers and the line's
shape. Its device reads ``cpu`` and it reports no device metric.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import io  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# JAX and the JAX package beside the port: a run loads none of them
FOREIGN = ("jax", "jaxlib", "flax", "fun_asr_gguf_tpu")


def foreign(names):
    """The modules among ``names`` that are JAX's or the JAX package's, by
    whole top-level name (``fun_asr_gguf_tpu_torch`` is the port's)."""
    return sorted(n for n in names if n.split(".")[0] in FOREIGN)


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
    cell, cfg = harness.load_cell(ROOT, args.workload)[1:3]
    if args.rehearse:
        return harness.run(args, torch.device("cpu"),
                           model=harness.tiny_model(cfg))
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return harness.run(args, torch.device("cuda", 0))


def entry(argv=None):
    """The script: :func:`main` with its standard output held back, and
    let out only where the process holds none of JAX or the JAX package
    at the end."""
    held = io.StringIO()
    with contextlib.redirect_stdout(held):
        rc = main(argv)
    found = foreign(list(sys.modules))
    if found:
        print("loaded in this run, which must load none of JAX or the JAX "
              f"package: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.write(held.getvalue())
    sys.stdout.flush()
    return rc


if __name__ == "__main__":
    sys.exit(entry())
