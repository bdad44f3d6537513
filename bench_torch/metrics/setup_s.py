"""Seconds from the process's start to the end of the warm-up: torch,
the kernel library from the checkout's build cache (built on a first
run), the checkpoint and WAV pool written from the seed, the engine built
(load, quantize, its own warm-up) and one warm-up request: the
pool's longest clip, greedy, at most 80 tokens, which the repetition fuse
retries sampled, so both sampling paths run."""


def read(ctx):
    return ctx["setup_s"]
