"""The host's time per plain decode step: over the requests served under
the device-only profile after the window, the program's ``decode.step``
spans less their ``decode.wait`` children (dispatch of the sampling and
the decode step), over the steps that ran, in ms.

Read under the device-only ``torch.profiler`` (CUPTI records every
launch), which slows the host's enqueue: this reads above the host's
unprofiled time and may not back a claim, which rests on
``decode_ms_per_token``."""

from bench_torch import program_trace


def read(ctx):
    return program_trace.host_ms(program_trace.profiled_spans(ctx),
                                 "decode.step", "decode.wait",
                                 "decode.forward")
