"""Synced wall time of the plain ``models.generate`` chunks over the
tokens they produced."""


def read(ctx):
    plain = [c for c in ctx["chunks"] if c["kind"] == "generate"]
    tokens = sum(c["tokens"] for c in plain)
    return sum(c["s"] for c in plain) * 1e3 / tokens if tokens else None
