"""The decode step's and the verify round's CUDA graphs against the eager
step and round, route by route, at Qwen3-0.6B's widths on the card.

    python -m fun_asr_gguf_tpu_torch.probes.decode_graph_probe --mode both

(``--mode decode`` or ``verify`` runs one half; ``both`` is the default.)

For each route of the decode step (fused q8_0 over a bf16 and an int8
cache, per-channel int8, int8-dot q8i, all-layers K5): a 200-token prompt
in the 256 bucket, a cache of 256 + 256 + 9 slots; then the eager step and
the graph's (``models.decode_graph``), both fed the same tokens: ms a step
by the two-point method (host clock, synced), the host's enqueue of a
graphed step (no sync, the card behind), the capture's time, a graphed
step's device events by kind from ``torch.profiler`` (the replay's nodes
and the three input writes) and whether 16 replays give the logits and
cache of 16 eager steps bit for bit.

For each route of the verify round (the same but K5, which has no verify
step), from the same prompt with a draft of 64 random ids (which random
weights never accept, so each round emits one token): ms a round eager and
graphed (``models.speculative``, ``spec_k`` 8, 64-token chunks; two-point,
synced), the capture's time (a chunk of one round: its eager run and the
capture), one round's device events (the flag read, the uniforms and the
replay) and whether 16 replayed rounds give the tokens, carry, cache and
generator state of 16 eager rounds bit for bit, greedy and at T = 0.4.

Both graphs are reached as the engine reaches them, through
``DecodeGraphs.graph``. One line a route, then a JSON summary.
:func:`decode_params`, :func:`prefilled`, :func:`clone`,
:func:`verify_draft` and :func:`verify_chunk` also feed the card tests.
"""

import argparse
import dataclasses
import functools
import json
import time

import torch

from ..models import decode_graph as dg
from ..models import generate
from ..models.config import Qwen3Config
from ..models.generate import prefill_init, step_graph
from ..models.qwen3 import embed_tokens, fuse_qwen3_params_q8i, \
    qwen3_decode_step
from ..models.speculative import CARRY, round_graph, run_rounds, spec_init
from ..ops.quant_matmul import Int8Weight
from .q8_probe import q8_decode_params, two_point_ms

ROUTES = [("q8_0", False), ("q8_0", True), ("int8", False), ("q8i", False),
          ("mega", False)]
VERIFY_ROUTES = [("q8_0", False), ("q8_0", True), ("int8", False),
                 ("q8i", False)]
P_LEN, BUCKET, MAX_LEN = 200, 256, 256 + 256 + 9
CHECK_STEPS = 16
SPEC_K, DRAFT_LEN, CHUNK = 8, 512, 64     # the engine's


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


def decode_graph(graphs, params, state, cfg):
    """``state``'s decode graph of ``graphs``, begun as a chunk begins."""
    graph = step_graph(graphs, params, cfg, state)
    graph.begin(state)
    return graph


def graph_step(graph, state, token):
    """One decode step of ``state`` through ``graph`` as ``generate_chunk``
    runs it (no sync); returns the logits, the graph's buffer."""
    logits = generate.graphed_step(graph, state, token)
    state.step += 1
    return logits


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
    graph_step(decode_graph(graphs, params, first, cfg), first, tokens[0])
    torch.cuda.synchronize()
    res["capture_ms"] = (time.perf_counter() - t0) * 1e3

    # bit-equal: 16 replays against 16 eager steps
    got, want = clone(base), clone(base)
    graph = decode_graph(graphs, params, got, cfg)
    same = True
    for t in tokens[:CHECK_STEPS]:
        logits = graph_step(graph, got, t)
        eager_step(params, want, t, cfg)
        same &= torch.equal(logits, want.logits)
    graph.end(got)
    res["bit_equal"] = bool(same and torch.equal(got.logits, want.logits)
                            and all(torch.equal(a, b) for a, b in zip(
                                dg._tensors(got.kv), dg._tensors(want.kv))))

    def runner(start):
        def run(n):
            state = clone(base)
            step = start(state)
            for t in tokens[:n]:
                step(t)
            torch.cuda.synchronize()
        return run
    eager = runner(lambda s: functools.partial(eager_step, params, s,
                                               cfg=cfg))
    graphed = runner(lambda s: functools.partial(
        graph_step, decode_graph(graphs, params, s, cfg), s))
    res["eager_ms"] = two_point_ms(eager, 8, 40)
    res["graph_ms"] = two_point_ms(graphed, 8, 40)

    # the host's enqueue of a graphed step, the card behind (a sleep
    # ahead; an eager step's ~1 000 launches would fill the launch queue,
    # so its enqueue is its host time, eager_ms)
    state = clone(base)
    graph = decode_graph(graphs, params, state, cfg)
    graph_step(graph, state, tokens[0])
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)              # ~0.1 s of card time
    times = []
    for t in tokens[1:9]:
        t0 = time.perf_counter()
        graph_step(graph, state, t)
        times.append(time.perf_counter() - t0)
    res["graph_enqueue_ms"] = sorted(times)[len(times) // 2] * 1e3
    torch.cuda.synchronize()
    state = clone(base)
    graph = decode_graph(graphs, params, state, cfg)
    graph_step(graph, state, tokens[0])
    res["step_events"] = step_events(
        lambda: graph_step(graph, state, tokens[1]))
    return res


def verify_draft(device, vocab, seed=6):
    """[1, DRAFT_LEN] draft ids: 64 random ids, then -1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draft = torch.full((1, DRAFT_LEN), -1, dtype=torch.int64, device=device)
    draft[0, :64] = torch.randint(0, vocab, (64,), generator=gen,
                                  device=device)
    return draft


def verify_chunk(graphs, params, state, draft, cfg, temperature, limit):
    """A chunk of up to ``limit`` verify rounds of ``state`` (a SpecState)
    through the verify graph of ``graphs``, as the engine runs them, or
    eagerly where ``graphs`` is None; no stop ids."""
    graph = None if graphs is None else round_graph(
        graphs, params, cfg, state, draft, 50, SPEC_K, CHUNK, ())
    return run_rounds(params, state, draft, cfg, temperature, 1.0, 50,
                      SPEC_K, CHUNK, (), limit, graph)


def same_rounds(a, b):
    """Two SpecStates equal in carry, cache and generator state."""
    return (all(torch.equal(getattr(a, n), getattr(b, n)) for n in CARRY)
            and all(torch.equal(x, y) for x, y in zip(dg._tensors(a.kv),
                                                      dg._tensors(b.kv)))
            and torch.equal(a.generator.get_state(),
                            b.generator.get_state()))


def verify_report(device, route, kv_int8, cfg):
    params = decode_params(device, route, cfg)
    base = prefilled(device, params, cfg, kv_int8)
    draft = verify_draft(device, cfg.vocab_size)
    graphs = dg.DecodeGraphs()
    res = {"route": route, "kv": "int8" if kv_int8 else "bf16"}

    def spec():
        return spec_init(clone(base))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verify_chunk(graphs, params, spec(), draft, cfg, 0.0, 1)
    torch.cuda.synchronize()
    res["capture_ms"] = (time.perf_counter() - t0) * 1e3

    same = True
    for temperature in (0.0, 0.4):
        got, want = spec(), spec()
        a = verify_chunk(graphs, params, got, draft, cfg, temperature,
                         CHECK_STEPS)
        b = verify_chunk(None, params, want, draft, cfg, temperature,
                         CHECK_STEPS)
        same &= (torch.equal(a, b) and same_rounds(got, want)
                 and int(got.rounds[0]) == CHECK_STEPS)
    res["bit_equal"] = bool(same)

    def runner(g):
        def run(n):
            verify_chunk(g, params, spec(), draft, cfg, 0.4, n)
            torch.cuda.synchronize()
        return run
    res["eager_ms"] = two_point_ms(runner(None), 4, 16)
    res["graph_ms"] = two_point_ms(runner(graphs), 4, 16)

    # one round's device events: a chunk of two rounds less one of one
    events = [step_events(lambda n=n: verify_chunk(
        graphs, params, spec(), draft, cfg, 0.4, n)) for n in (1, 2)]
    res["round_events"] = {k: events[1][k] - events[0][k] for k in events[0]}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("decode", "verify", "both"),
                    default="both")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Qwen3Config()
    out, verify = [], []
    for route, kv_int8 in ROUTES if args.mode != "verify" else ():
        r = route_report(device, route, kv_int8, cfg)
        print(f"[decode graph] {r['route']} ({r['kv']} cache): capture "
              f"{r['capture_ms']:.1f} ms, eager {r['eager_ms']:.3f} ms/step,"
              f" graph {r['graph_ms']:.3f} ms/step, a graphed step's "
              f"enqueue {r['graph_enqueue_ms']:.3f} ms, its device events "
              f"{r['step_events']}, bit-equal {r['bit_equal']}",
              flush=True)
        out.append(r)
    for route, kv_int8 in VERIFY_ROUTES if args.mode != "decode" else ():
        r = verify_report(device, route, kv_int8, cfg)
        print(f"[verify graph] {r['route']} ({r['kv']} cache): capture "
              f"{r['capture_ms']:.1f} ms, eager {r['eager_ms']:.3f} "
              f"ms/round, graph {r['graph_ms']:.3f} ms/round, a round's "
              f"device events {r['round_events']}, bit-equal "
              f"{r['bit_equal']}", flush=True)
        verify.append(r)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "routes": out,
                      "verify": verify}))
    return 0 if all(r["bit_equal"] for r in out + verify) else 1


if __name__ == "__main__":
    raise SystemExit(main())
