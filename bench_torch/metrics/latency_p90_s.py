"""90th percentile over the window's requests of the wall time from the
``transcribe`` call to its return (a failed request counts with the time
it took to fail)."""

from bench_torch.harness import p90


def read(ctx):
    return p90([r["wall_s"] for r in ctx["records"]])
