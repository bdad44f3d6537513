"""The host's time per verify round: over the requests served under the
device-only profile after the window, the program's ``spec.round`` spans
less their ``spec.sync`` children (the round's one read of the card),
over the rounds that ran a verify pass, in ms.

Read under the device-only ``torch.profiler`` (CUPTI records every
launch), which slows the host's enqueue: this reads above the host's
unprofiled time and may not back a claim, which rests on
``verify_round_ms``."""

from bench_torch import program_trace


def read(ctx):
    return program_trace.host_ms(program_trace.profiled_spans(ctx),
                                 "spec.round", "spec.sync", "spec.forward")
