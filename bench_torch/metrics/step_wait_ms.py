"""The host's wait on the card per plain decode step: over the requests
served under the device-only profile after the window, the program's
``decode.wait`` spans (the previous step's ``done`` copy, or the first
``done`` read of a chunk) over the steps that ran, in ms.

Read under the device-only ``torch.profiler`` (CUPTI records every
launch), which slows the host's enqueue and so moves its wait: this may
not back a claim, which rests on ``decode_ms_per_token``."""

from bench_torch import program_trace


def read(ctx):
    spans = program_trace.profiled_spans(ctx)
    if not spans or not spans.get("decode.forward", [0])[0]:
        return None
    return spans.get("decode.wait", [0, 0.0])[1] * 1e3 / \
        spans["decode.forward"][0]
