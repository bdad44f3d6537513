"""Synced wall time of ``models.spec_generate`` calls over the verify
rounds they ran (the guardrail's probe, up to 16 rounds, comes before the
first streamed token)."""


def read(ctx):
    spec = [c for c in ctx["chunks"] if c["kind"] == "spec_generate"]
    rounds = sum(c["rounds"] for c in spec)
    return sum(c["s"] for c in spec) * 1e3 / rounds if rounds else None
