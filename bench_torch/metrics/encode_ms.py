"""Mean per request of ``timings.encode``: frontend, SANM encoder and adaptor (the 60 s padded window)."""


def read(ctx):
    rows = [r["timings"]["encode"] * 1e3 for r in ctx["records"] if r["ok"]]
    return sum(rows) / len(rows) if rows else None
