"""The share of the verify rounds that replayed a CUDA graph, from the
program's counters over the window's requests: ``spec.graph_replays`` over
``spec.rounds``, in %. A program whose rounds run as no graph counts
neither ``spec.graph_replays`` nor ``spec.graph_captures`` and gives
nothing."""

from bench_torch import program_trace


def read(ctx):
    c = program_trace.window_counters(ctx)
    if not c or not c.get("spec.rounds") or not (
            "spec.graph_replays" in c or "spec.graph_captures" in c):
        return None
    return 100.0 * c.get("spec.graph_replays", 0) / c["spec.rounds"]
