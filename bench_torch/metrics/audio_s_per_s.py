"""Audio seconds of the window's completed requests over its wall time:
the inverse of the real-time factor, what a batch transcriber pays."""


def read(ctx):
    audio = sum(r["seconds"] for r in ctx["records"] if r["ok"])
    return audio / ctx["window_s"]
