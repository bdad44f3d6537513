"""Measurement probes on the card, the H100 counterparts of the Pallas
probes in ``experiments/``; no path of the engine runs them.

* :mod:`.q8_mega_probes` — P12: the split-KV attention stage alone, at
  chunk counts 1 … 32 (``python -m fun_asr_gguf_tpu_torch.probes.q8_mega_probes``);
* :mod:`.q8_bw_probe` — P5: the stream rate of the decode's q8_0 bytes,
  summed, through the dequant GEMV, and with f16 scales
  (``python -m fun_asr_gguf_tpu_torch.probes.q8_bw_probe``).

Each kernel is held against its plain PyTorch version; a CPU tensor takes
the plain version, as everywhere in the port.
"""

import statistics

SLEEP_CYCLES = 4_000_000   # ~2 ms at the H100's clock: longer than the
                           # host's enqueue of a probe call


def time_ms(fn, iters=20, warmup=3):
    """Median device milliseconds of one ``fn()`` (CUDA events, a sleep
    kernel ahead of the start event so the host's enqueue is not timed)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got, ref):
    """max |got - ref| / max |ref|, in f32."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max()
            / ref.abs().max().clamp_min(1e-6)).item()
