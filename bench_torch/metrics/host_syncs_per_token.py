"""The program's device-to-host syncs (``host.syncs``: encode and CTC
reads, the prefill's sync, each chunk's read, each decode step's wait,
each verify round's flag, the guardrail's reads) over the decoder's
tokens of every attempt (``llm.tokens``), over the window's requests."""

from bench_torch import program_trace


def read(ctx):
    c = program_trace.window_counters(ctx)
    if not c or not c.get("llm.tokens"):
        return None
    return c.get("host.syncs", 0) / c["llm.tokens"]
