"""90th percentile over the window's requests of the wall time from the
``transcribe`` call to its first ``on_stream`` piece (a request that
streamed nothing counts with its whole wall time)."""

from bench_torch.harness import p90


def read(ctx):
    return p90([r["ttft_s"] if r["ttft_s"] is not None else r["wall_s"]
                for r in ctx["records"]])
