"""The share of the decoder's tokens that the repetition fuse threw away,
from the program's counters over the window's requests: the tokens of
the attempts it aborted and retried (``llm.aborted_tokens``) over every
attempt's (``llm.tokens``), in %."""

from bench_torch import program_trace


def read(ctx):
    c = program_trace.window_counters(ctx)
    if not c or not c.get("llm.tokens"):
        return None
    return 100.0 * c.get("llm.aborted_tokens", 0) / c["llm.tokens"]
