"""Mean per request of ``timings.inject``: the decoder's prefill in its bucket, synced."""


def read(ctx):
    rows = [r["timings"]["inject"] * 1e3 for r in ctx["records"] if r["ok"]]
    return sum(rows) / len(rows) if rows else None
