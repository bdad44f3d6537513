"""The share of the plain decode steps that replayed a CUDA graph, from
the program's counters over the window's requests: ``decode.graph_replays``
over ``decode.steps``, in %. A program without decode graphs (no
``models/decode_graph.py``) gives nothing."""

import importlib.util

from bench_torch import program_trace


def read(ctx):
    if importlib.util.find_spec(
            "fun_asr_gguf_tpu_torch.models.decode_graph") is None:
        return None
    c = program_trace.window_counters(ctx)
    if not c or not c.get("decode.steps"):
        return None
    return 100.0 * c.get("decode.graph_replays", 0) / c["decode.steps"]
