"""Mean per request of ``timings.ctc``: CTC head, device argmax, host greedy collapse and hotwords."""


def read(ctx):
    rows = [r["timings"]["ctc"] * 1e3 for r in ctx["records"] if r["ok"]]
    return sum(rows) / len(rows) if rows else None
