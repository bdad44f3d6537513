"""The decode step's share of the card's peak: over the plain chunks, the
least time their steps could take (every decoder weight in the
configuration's format, the head, and the visible KV cache of each step,
over 3.35 TB/s, or the operations over the peak if larger) divided by
their synced wall time, in %."""

from bench_torch import roofline


def read(ctx):
    if not ctx["on_card"]:
        return None
    plain = [c for c in ctx["chunks"] if c["kind"] == "generate"]
    secs = sum(c["s"] for c in plain)
    if not secs:
        return None
    llm, fmt = ctx["model"]["llm"], ctx["cfg"]["decoder_weights"]
    least = sum(roofline.bound_s(*roofline.decode_token(llm, fmt, v))
                for c in plain for v in c["visible"])
    return 100.0 * least / secs
