"""Per-stage device busy share of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_profile.py        # needs one CUDA card

Writes the same full-width random checkpoint and 60 s clip as
``chip_smoke.py``, builds the engine, and profiles one window per stage
with ``torch.profiler`` after an unprofiled warm-up run of that window:

- encode (frontend + 70 SANM layers + adaptor) of the 60 s clip;
- the CTC head (5 blocks + 60515-way projection + device argmax);
- prefill of a 200-token prompt in the 256 bucket;
- 16 decode steps of q8_0 weights on the fused path (K4), greedy and at
  T = 0.4, 16 greedy steps of the unfused path on the same weights, and
  16 greedy steps of the all-layers kernel (K5: the same weights through
  ``fuse_qwen3_params_q8_mega``, head-major cache), and 16 greedy steps of
  the int8-dot path (K6 + K7: the unfused weights through
  ``fuse_qwen3_params_q8i``);
- 16 verify rounds of 9 rows (spec_k = 8) with an empty draft, greedy,
  q8_0 fused;
- 16 decode steps of the engine's default (per-channel int8 weights and
  head, bf16 cache), greedy.

For each window it prints the wall time, the device busy time (the union
of kernel and memcpy intervals on the card), the idle share, and the
counts of device events and aten calls; the heaviest kernels of each
window go to ``chiprun_out/profile.txt``. The profiler slows the host, so
profiled wall times run above unprofiled ones. Imports nothing of JAX.
"""

import collections
import os
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke

DECODE_STEPS = 16
TOP_KERNELS = 25


def busy_us(events):
    """Length of the union of the events' [start, end) intervals, in µs."""
    total, cur = 0.0, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


def profile_window(label, fn, setup=lambda: None):
    """Run ``fn(setup())`` once to warm up, then once under the profiler;
    returns the summary line and the per-kernel report."""
    fn(setup())
    torch.cuda.synchronize()
    arg = setup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    n_aten = sum(1 for e in events if e.device_type == DeviceType.CPU
                 and e.name.startswith("aten::"))
    busy_ms = busy_us(dev) / 1e3
    if not dev:
        raise RuntimeError(f"{label}: the profiler saw no device event")
    line = (f"== {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
            f"({100 * busy_ms / wall_ms:.1f} %), idle "
            f"{100 * (1 - busy_ms / wall_ms):.1f} %, {len(dev)} device "
            f"events, {n_aten} aten calls")
    per = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        per[e.name][0] += e.time_range.elapsed_us()
        per[e.name][1] += 1
    rows = [line] + [
        f"   {us / 1e3:9.3f} ms dev {n:8d} calls  {name[:100]}"
        for name, (us, n) in sorted(per.items(), key=lambda kv: -kv[1][0])
        [:TOP_KERNELS]]
    return line, "\n".join(rows)


def main():
    from fun_asr_gguf_tpu_torch.audio import load_audio
    from fun_asr_gguf_tpu_torch import create_asr_engine
    from fun_asr_gguf_tpu_torch.models.decode_graph import DecodeGraphs
    from fun_asr_gguf_tpu_torch.models.generate import generate_chunk
    from fun_asr_gguf_tpu_torch.models.qwen3 import (
        fuse_qwen3_params_q8_mega, fuse_qwen3_params_q8i)

    chip_smoke.phase_device()
    with tempfile.TemporaryDirectory(prefix="chip_profile_") as root:
        ckpt, wav, _cfg = chip_smoke.write_inputs(root)
        engine = create_asr_engine(ckpt, verbose=False,
                                   llm_weight_format="q8_0")
        default = create_asr_engine(ckpt, verbose=False)
        try:
            m = engine.models
            audio = load_audio(wav, 16000)
            _embd, enc = m.encode_audio(audio)
            prompt = np.zeros((200, m.hybrid_cfg.llm.hidden), np.float32)

            unfused = {k: v for k, v in m.llm_params.items()
                       if k != "q8_fused"}
            mega = fuse_qwen3_params_q8_mega(m.llm_params, m.hybrid_cfg.llm)
            if "q8_mega" not in mega:
                raise RuntimeError("the q8_0 params were not marked mega")
            q8i = fuse_qwen3_params_q8i(unfused)

            def prefill_mega():
                own, m.llm_params = m.llm_params, mega
                try:      # prefill_init builds the head-major cache
                    return m.prefill(prompt, rng_seed=0)
                finally:
                    m.llm_params = own
            draft = torch.full((1, m.config.spec_draft_len), -1,
                               dtype=torch.int64, device=m.device)

            def decode(temp, params=m.llm_params):
                graphs = DecodeGraphs()   # the warm-up call captures

                def run(state):
                    with torch.inference_mode():
                        return generate_chunk(
                            params, state, m.hybrid_cfg.llm, temp, 1.0, 50,
                            chunk_len=DECODE_STEPS,
                            stop_tokens=m.stop_tokens, graphs=graphs)
                return run
            d = default.models

            def verify(state):
                return m.spec_generate(state, draft, 0.0, 1.0, 50,
                                       chunk_len=DECODE_STEPS)

            windows = [
                ("encode 60 s (frontend + 70 SANM + adaptor)",
                 lambda _: m.encode_audio(audio), lambda: None),
                ("ctc head (5 blocks + 60515 proj + argmax)",
                 lambda _: m.ctc_indices(enc), lambda: None),
                ("prefill, 200-token prompt in bucket 256",
                 lambda _: m.prefill(prompt, rng_seed=0), lambda: None),
                (f"decode {DECODE_STEPS} steps greedy, fused (K4)",
                 decode(0.0), lambda: m.prefill(prompt, rng_seed=0)),
                (f"decode {DECODE_STEPS} steps greedy, unfused",
                 decode(0.0, unfused), lambda: m.prefill(prompt, rng_seed=0)),
                (f"decode {DECODE_STEPS} steps greedy, all-layers (K5)",
                 decode(0.0, mega), prefill_mega),
                (f"decode {DECODE_STEPS} steps greedy, int8-dot (K6 + K7)",
                 decode(0.0, q8i), lambda: m.prefill(prompt, rng_seed=0)),
                (f"decode {DECODE_STEPS} steps T=0.4, fused (K4)",
                 decode(0.4), lambda: m.prefill(prompt, rng_seed=0)),
                (f"verify {DECODE_STEPS} rounds of 9 rows greedy, fused",
                 verify, lambda: m.spec_prepare(m.prefill(prompt,
                                                          rng_seed=0))),
                (f"decode {DECODE_STEPS} steps greedy, int8 weights, bf16 KV",
                 decode(0.0, d.llm_params),
                 lambda: d.prefill(prompt, rng_seed=0)),
            ]
            reports = []
            for label, fn, setup in windows:
                line, report = profile_window(label, fn, setup)
                print(line, flush=True)
                reports.append(report)
        finally:
            engine.cleanup()
            default.cleanup()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out", "profile.txt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        f.write("\n".join(reports) + "\n")
    print(f"per-kernel report: {out}")


if __name__ == "__main__":
    sys.exit(main())
