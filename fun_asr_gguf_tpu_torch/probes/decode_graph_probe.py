"""The decode step's CUDA graph against the eager step, route by route, at
Qwen3-0.6B's widths on the card.

    python -m fun_asr_gguf_tpu_torch.probes.decode_graph_probe

For each route (fused q8_0 over a bf16 and an int8 cache, per-channel
int8, int8-dot q8i, all-layers K5): a 200-token prompt in the 256 bucket,
a cache of 256 + 256 + 9 slots; then the eager step and the graph's
(``models.decode_graph``), both fed the same tokens: ms a step by the
two-point method (host clock, synced), the host's enqueue of a graphed
step (no sync, the card behind), the capture's time, a graphed step's
device events by kind from ``torch.profiler`` (the replay's nodes and
the three input writes) and whether 16 replays
give the logits and cache of 16 eager steps bit for bit. One line a route,
then a JSON summary. :func:`decode_params` also feeds the card tests.
"""

import dataclasses
import json
import time

import torch

from ..models import decode_graph as dg
from ..models.config import Qwen3Config
from ..models.generate import prefill_init
from ..models.qwen3 import embed_tokens, fuse_qwen3_params_q8i, \
    qwen3_decode_step
from ..ops.quant_matmul import Int8Weight
from .q8_probe import q8_decode_params, two_point_ms

ROUTES = [("q8_0", False), ("q8_0", True), ("int8", False), ("q8i", False),
          ("mega", False)]
P_LEN, BUCKET, MAX_LEN = 200, 256, 256 + 256 + 9
CHECK_STEPS = 16


def decode_params(device, route, cfg, seed=2):
    """Random decoder params at ``cfg``'s widths on the card: ``q8_0``,
    the fused q8_0 tree (K4 + K2, the K1 head); ``mega``, the same marked
    for K5; ``q8i``, the unfused tree relabelled for K7 + K6; ``int8``,
    per-channel int8 weights and the int8 head (bf16 compute)."""
    fused, mega = q8_decode_params(cfg, device, seed)
    if route in ("q8_0", "mega"):
        return fused if route == "q8_0" else mega
    if route == "q8i":
        return fuse_qwen3_params_q8i(
            {k: v for k, v in fused.items() if k != "q8_fused"})
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)

    def scale(*shape):
        return torch.rand(*shape, generator=gen, device=device) * 1.5e-4 \
            + 2e-4
    layers = {k: v for k, v in fused["layers"].items()
              if isinstance(v, torch.Tensor)}
    for key, w in fused["layers"].items():
        if not isinstance(w, torch.Tensor):     # q8_0 [L, n, k] → [L, k, n]
            n_layers, n, k = w.q.shape
            layers[key] = Int8Weight(i8(n_layers, k, n),
                                     scale(n_layers, 1, n).to(torch.bfloat16))
    return {"embed": fused["embed"], "final_ln": fused["final_ln"],
            "layers": layers,
            "lm_head_i8": (i8(cfg.hidden, cfg.vocab_size),
                           scale(cfg.vocab_size))}


def prefilled(device, params, cfg, kv_int8, seed=3, p_len=P_LEN,
              bucket=BUCKET, max_len=MAX_LEN):
    """A GenState of one row after a ``p_len``-token prompt in ``bucket``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    emb = (0.05 * torch.randn(1, bucket, cfg.hidden, generator=gen,
                              device=device)).to(torch.bfloat16)
    mask = torch.zeros(1, bucket, device=device)
    mask[:, bucket - p_len:] = 1
    return prefill_init(params, emb, mask, gen, cfg, max_len=max_len,
                        kv_int8=kv_int8)


def clone(state):
    """An independent copy of a GenState on the card."""
    out = dataclasses.replace(
        state, kv=dg._copy(dg._empty_like(state.kv), state.kv),
        logits=state.logits.clone(), ring=state.ring.clone(),
        generator=torch.Generator(device=state.logits.device))
    out.generator.set_state(state.generator.get_state())
    return out


def eager_step(params, state, token, cfg):
    """One decode step as ``generate_chunk`` runs it on the CPU."""
    state.logits, state.kv = qwen3_decode_step(
        params, state.kv, embed_tokens(params, token),
        state.prompt_slots + state.step, state.prompt_len + state.step,
        state.valid_from, cfg)
    state.step += 1


def graph_step(graphs, params, state, token, cfg):
    graphs.step(params, state, token, cfg)
    state.step += 1


def step_events(step):
    """{kind: count} of the device events of one ``step()``, from
    ``torch.profiler``, and the K4 / K2 kernels among them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    kinds = {"kernels": sum("emcpy" not in n and "emset" not in n
                            for n in names),
             "memcpy": sum("emcpy" in n for n in names),
             "memset": sum("emset" in n for n in names)}
    kinds["K4"] = sum("q8_layer_fused_kernel" in n for n in names)
    kinds["K2"] = sum("flash_decode_kernel" in n for n in names)
    return kinds


def route_report(device, route, kv_int8, cfg):
    params = decode_params(device, route, cfg)
    base = prefilled(device, params, cfg, kv_int8)
    vocab = cfg.vocab_size
    tokens = torch.randint(0, vocab, (64, 1), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(5))
    graphs = dg.DecodeGraphs()
    res = {"route": route, "kv": "int8" if kv_int8 else "bf16"}

    # the capture, on a state of its own
    first = clone(base)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph_step(graphs, params, first, tokens[0], cfg)
    torch.cuda.synchronize()
    res["capture_ms"] = (time.perf_counter() - t0) * 1e3

    # bit-equal: 16 replays against 16 eager steps
    got, want = clone(base), clone(base)
    same = True
    for t in tokens[:CHECK_STEPS]:
        graph_step(graphs, params, got, t, cfg)
        eager_step(params, want, t, cfg)
        same &= torch.equal(got.logits, want.logits)
    res["bit_equal"] = bool(same and all(
        torch.equal(a, b) for a, b in zip(dg._tensors(got.kv),
                                          dg._tensors(want.kv))))

    def runner(step):
        def run(n):
            state = clone(base)
            for t in tokens[:n]:
                step(state, t)
            torch.cuda.synchronize()
        return run
    eager = runner(lambda s, t: eager_step(params, s, t, cfg))
    graphed = runner(lambda s, t: graph_step(graphs, params, s, t, cfg))
    res["eager_ms"] = two_point_ms(eager, 8, 40)
    res["graph_ms"] = two_point_ms(graphed, 8, 40)

    # the host's enqueue of a graphed step, the card behind (a sleep
    # ahead; an eager step's ~1 000 launches would fill the launch queue,
    # so its enqueue is its host time, eager_ms)
    state = clone(base)
    graph_step(graphs, params, state, tokens[0], cfg)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)              # ~0.1 s of card time
    times = []
    for t in tokens[1:9]:
        t0 = time.perf_counter()
        graph_step(graphs, params, state, t, cfg)
        times.append(time.perf_counter() - t0)
    res["graph_enqueue_ms"] = sorted(times)[len(times) // 2] * 1e3
    torch.cuda.synchronize()
    state = clone(base)
    graph_step(graphs, params, state, tokens[0], cfg)
    res["step_events"] = step_events(
        lambda: graph_step(graphs, params, state, tokens[1], cfg))
    return res


def main():
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Qwen3Config()
    out = []
    for route, kv_int8 in ROUTES:
        r = route_report(device, route, kv_int8, cfg)
        print(f"[decode graph] {r['route']} ({r['kv']} cache): capture "
              f"{r['capture_ms']:.1f} ms, eager {r['eager_ms']:.3f} ms/step,"
              f" graph {r['graph_ms']:.3f} ms/step, a graphed step's "
              f"enqueue {r['graph_enqueue_ms']:.3f} ms, its device events "
              f"{r['step_events']}, bit-equal {r['bit_equal']}",
              flush=True)
        out.append(r)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "routes": out}))
    return 0 if all(r["bit_equal"] for r in out) else 1


if __name__ == "__main__":
    raise SystemExit(main())
