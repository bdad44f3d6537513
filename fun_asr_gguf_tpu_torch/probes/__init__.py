"""Measurement probes on the card, the H100 counterparts of the Pallas
probes in ``experiments/``; no path of the engine runs them. Each kernel
is held against its plain PyTorch version; a CPU tensor takes the plain
version, as everywhere in the port.

* :mod:`.q8_probe` — P0–P4 (``experiments/q8_probe.py``): where a q8_0
  decode layer's time goes. P1 (28 K4 launches, no attention), P2 (one
  cooperative launch walking the 28 layers, ``csrc/q8_probe.cu``) and
  P2's barrier-only launch at K4's and K5's grids, against P5(a)'s
  stream rate, split it into stream, per-call fixed cost, barriers and
  stage work; P0 is the real fused and all-layers (K5) decode step;
  P3 (an in-kernel reshape) and P4 (f16 scales in the tiled order)
  (``python -m fun_asr_gguf_tpu_torch.probes.q8_probe``);
* :mod:`.q8_mega_probes` — P6–P11 (the natural-order scale expansion, a
  transpose, rope by lane shuffle and by a rotation product, a batched
  f32 dot, row-pair slices, a head sum over head- and slot-major blocks)
  and P12 (the split-KV attention stage alone, at chunk counts 1 … 32)
  (``python -m fun_asr_gguf_tpu_torch.probes.q8_mega_probes``);
* :mod:`.q8_bw_probe` — P5: the stream rate of the decode's q8_0 bytes,
  summed, through the dequant GEMV, and with f16 scales
  (``python -m fun_asr_gguf_tpu_torch.probes.q8_bw_probe``).

Each prints one line per measurement and a JSON summary.
"""

import statistics

SLEEP_CYCLES = 4_000_000   # ~2 ms at the H100's clock: longer than the
                           # host's enqueue of a probe call

# launches of the kernels of csrc/q8_probe.cu and the small probes of
# csrc/probes.cu since the last reset, by probe (plain ints)
probe_launches = dict.fromkeys(
    ("p2_q8_layer_walk", "p2_barrier_only", "p3_reshape",
     "p4_scale_expand_f16_tiled", "p6_scale_expand_natural", "p7_transpose",
     "p8a_rope_shuffle", "p8b_rope_matrix", "p9_batched_dot",
     "p10_pair_scale", "p11_head_sum"), 0)

def launch(key, name, *args):
    """Call the C entry ``name`` of the kernel library with ``args`` (a
    tensor passes its data pointer) and the current stream of the first
    tensor's device, raise on its error code, and count one launch of
    probe ``key``."""
    import torch
    from ..kernels import build
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    code = getattr(build.lib(), name)(
        *(build.ptr(a) if isinstance(a, torch.Tensor) else a for a in args),
        build.stream_ptr(dev))
    build.check(code, name)
    probe_launches[key] += 1


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_cuda(tensors, dtypes, shapes, name):
    """Raise unless each tensor is a contiguous, 16-byte aligned CUDA tensor
    of its dtype and shape (``None``: any), all on one device."""
    for t, dt, shape in zip(tensors, dtypes, shapes):
        if t.dtype != dt:
            raise TypeError(f"{name} takes {dt}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} takes shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not (t.is_cuda and t.device == tensors[0].device
                and t.is_contiguous() and t.data_ptr() % 16 == 0):
            raise ValueError(f"{name} takes contiguous 16-byte aligned "
                             "tensors on one CUDA device")


def time_ms(fn, iters=20, warmup=3, sleep_cycles=SLEEP_CYCLES):
    """Median device milliseconds of one ``fn()`` (CUDA events, a sleep
    kernel of ``sleep_cycles`` ahead of the start event so the host's
    enqueue is not timed)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
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
