"""Tokens emitted while speculating over the verify rounds run, from the
program's counters (``spec.tokens`` / ``spec.rounds``) over the window's
requests: 1 means no draft token was accepted."""

from bench_torch import program_trace


def read(ctx):
    c = program_trace.window_counters(ctx)
    if not c or not c.get("spec.rounds"):
        return None
    return c.get("spec.tokens", 0) / c["spec.rounds"]
