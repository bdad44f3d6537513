"""One run of one cell: set-up, the closed-loop window, the traced parts,
the comparison, and the result line.

The window drives the user's call, ``create_asr_engine(ckpt,
**engine_kwargs).transcribe(wav, verbose=False, temperature=...,
on_stream=...)``, one request after another (one caller, closed loop).
Before each request the harness sets ``engine.config.n_predict`` to the
request's output length, which the program reads on every call. The
window opens at the first timed request and closes when the request in
flight at ``--seconds`` completes.

What the harness reads of the program: the engine's ``models`` entry
points, wrapped per instance (``prefill``, ``generate``,
``spec_generate``, ``ctc_indices``) to keep the ids they return and, in a
traced run, to time them; the LLM decoder's result of every attempt
(its synced prefill and generation times, a retry's too); the kernel
launch counters; the device trace.
"""

import gc
import importlib.util
import json
import os
import pkgutil
import resource
import statistics
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import arch, correct, devtrace, traffic, weights

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROFILE_S = 10.0       # device-traced requests after the window, at least
HOST_PROFILE_S = 1.0   # host-and-device-traced span for the idle gaps
WARM_TOKENS = 80       # the warm-up's output: a verify probe and a chunk

# HybridConfig.tiny(): the CPU rehearsal's shapes; its decoder is qwen3's
TINY = {
    "encoder": {"input_size": 560, "d_model": 64, "heads": 4, "ffn_dim": 128,
                "num_blocks": 2, "tp_blocks": 1, "kernel_size": 11,
                "ln_eps": 1e-05},
    "adaptor": {"in_dim": 64, "out_dim": 64, "ffn_dim": 128, "n_layers": 1,
                "heads": 4, "downsample": 1, "ln_eps": 1e-12},
    "ctc": {"adaptor": {"in_dim": 64, "out_dim": 64, "ffn_dim": 128,
                        "n_layers": 1, "heads": 4, "downsample": 1,
                        "ln_eps": 1e-12}, "vocab_size": 101},
    "llm": arch.of({"arch": "qwen3"}).tiny_llm(),
}


def tiny_model(cfg):
    """The CPU rehearsal's shapes for ``cfg``: TINY's encoder, adaptor and
    CTC with the LLM of its decoder architecture's ``tiny_llm()``."""
    return dict(TINY, llm=arch.of(cfg["model"]["llm"]).tiny_llm())


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(root, name):
    """The cell ``name`` of ``BENCHMARK.json``: (bench, cell, config,
    mix, limits)."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = _json(os.path.join(root, cfg_entry["file"]))
    mix = _json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", name + ".json"))
    return bench, cell, cfg, mix, limits


def metrics_of(bench, cell, trace):
    """The metric entries this cell reports in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name):
    """``metrics/<name>.py``'s ``read(ctx)``; a metric split by the cells it
    reports in (``<base>.<part>``) without a file of its own reads
    ``metrics/<base>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_torch_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def counters():
    """The program's kernel launch counters, by ``module.attribute``: every
    int attribute with ``launches`` in its name of every module under
    ``fun_asr_gguf_tpu_torch.ops``."""
    from fun_asr_gguf_tpu_torch import ops
    found = {}
    for m in pkgutil.walk_packages(ops.__path__, ops.__name__ + "."):
        short = m.name.removeprefix(ops.__name__ + ".")
        found.update({f"{short}.{a}": v for a, v in
                      vars(importlib.import_module(m.name)).items()
                      if "launches" in a and type(v) is int})
    return found


class Spans:
    """Per-instance wrappers of the engine's entry points. They keep what
    each returns for the comparison and, in a traced run, time each call
    between two synchronizations."""

    def __init__(self, engine, timed, sync):
        models = engine.models
        self.models, self.timed, self.sync = models, timed, sync
        self.cur = None              # the request being served
        self.chunks = []             # timed plain chunks and verify calls
        self.on_chunk = None         # hook after each chunk (host profile)
        inner = {n: getattr(models, n) for n in
                 ("prefill", "generate", "spec_generate", "ctc_indices")}

        def prefill(full_embd, rng_seed):
            state = inner["prefill"](full_embd, rng_seed)
            if self.cur is not None:
                att = {"chunks": [], "logits": []}
                self.cur["attempts"].append(att)
                self._keep_logits(att, state)
            return state

        def ctc_indices(enc):
            ids = inner["ctc_indices"](enc)
            if self.cur is not None and self.cur["ctc_ids"] is None:
                self.cur["ctc_ids"] = np.array(ids)
            return ids

        def chunk(kind):
            def call(state, *args, **kwargs):
                if self.timed:
                    self.sync()
                    t0 = time.perf_counter()
                    if kind == "spec_generate":
                        r0 = int(state.rounds[0])
                    else:
                        step0 = state.step
                tokens = inner[kind](state, *args, **kwargs)
                if self.cur is not None and self.cur["attempts"]:
                    att = self.cur["attempts"][-1]
                    att["chunks"].append(tokens)
                    self._keep_logits(att, state)
                    if kind == "spec_generate":
                        att["rounds"] = state.rounds
                if self.timed:
                    self.sync()
                    rec = {"kind": kind, "s": time.perf_counter() - t0,
                           "tokens": int((tokens[0] >= 0).sum())}
                    if kind == "spec_generate":
                        rec["rounds"] = int(state.rounds[0]) - r0
                    else:
                        rec["visible"] = [int(state.prompt_len[0]) + j + 1
                                          for j in range(step0, state.step)]
                    self.chunks.append(rec)
                if self.on_chunk is not None:
                    self.on_chunk()
                return tokens
            return call

        llm = engine.orchestrator.decoder.llm_decoder
        decode = llm.decode

        def llm_decode(*args, **kwargs):
            res = decode(*args, **kwargs)
            if self.cur is not None:
                self.cur["llm_s"] += res.t_inject + res.t_gen
            return res

        models.prefill = prefill
        models.ctc_indices = ctc_indices
        models.generate = chunk("generate")
        models.spec_generate = chunk("spec_generate")
        llm.decode = llm_decode

    def _keep_logits(self, att, state):
        """A copy of the next-token logits after the prefill and after
        each chunk, with the number of chunks before it; of a state that
        carries ``routes`` (a routed decoder, ``arch/__init__.py``) also
        the latest copy of them, with the slot of the first position and
        the prompt's length. Copies on the device: nothing waits."""
        att["logits"].append((len(att["chunks"]),
                              state.logits[0].detach().clone()))
        routes = getattr(state, "routes", None)
        if routes is not None:
            att["routes"] = (routes.detach().clone(),
                             state.valid_from[0].clone(),
                             state.prompt_len[0].clone())


def serve(engine, spans, req, wav, sync):
    """One request through ``transcribe``; its record."""
    engine.config.n_predict = req.n_predict
    first = []
    rec = {"index": req.index, "clip": req.clip, "seconds": req.seconds,
           "greedy": req.greedy, "n_predict": req.n_predict,
           "attempts": [], "ctc_ids": None, "llm_s": 0.0, "ok": False}
    spans.cur = rec
    t0 = time.perf_counter()
    try:
        res = engine.transcribe(
            wav, verbose=False, temperature=req.temperature,
            top_k=req.top_k, on_stream=lambda piece: first or first.append(
                time.perf_counter()))
        sync()
        rec["ok"] = isinstance(res.text, str)
        rec["timings"] = {k: getattr(res.timings, k) for k in (
            "encode", "ctc", "prepare", "inject", "llm_generate", "align",
            "total")}
    except Exception:  # a failed request counts in "failed"; go on
        traceback.print_exc(file=sys.stderr)
    t1 = time.perf_counter()
    spans.cur = None
    rec.update(start=t0, end=t1, wall_s=t1 - t0,
               ttft_s=(first[0] - t0) if first else None)
    atts = rec.pop("attempts")
    rec["retries"] = max(0, len(atts) - 1)
    rec["rounds"] = sum(int(a["rounds"][0]) for a in atts if "rounds" in a)
    # the served (last) attempt; a greedy request's first attempt too,
    # which is its greedy one when the repetition fuse made it retry
    rec["served"] = _attempt(atts[-1]) if atts else None
    rec["first"] = (_attempt(atts[0]) if rec["greedy"] and atts
                    else None)
    return rec


def dump(path, records, t0):
    """The window's requests, one JSON line each, without their logits."""
    keys = ("index", "clip", "seconds", "greedy", "n_predict", "ok",
            "wall_s", "ttft_s", "llm_s", "retries", "rounds", "timings")
    with open(path, "w") as f:
        for r in records:
            row = {k: r.get(k) for k in keys}
            row["start_s"] = r["start"] - t0
            row["served_tokens"] = (len(r["served"]["tokens"])
                                    if r["served"] else 0)
            f.write(json.dumps(row) + "\n")


def _attempt(att):
    """{"tokens": [ids], "logits": [(position of the token they predict,
    logits on the host)]} of one attempt; where the decoder routes, also
    "routes": the experts of each position it ran, prompt and every
    served token (each one is fed back), [routed layers, positions, k]
    on the host."""
    toks = [t[0][t[0] >= 0].tolist() for t in att["chunks"]]
    done = np.cumsum([0] + [len(t) for t in toks])
    out = {"tokens": [t for c in toks for t in c],
           "logits": [(int(done[k]), lg.float().cpu())
                      for k, lg in att["logits"]]}
    if "routes" in att:
        routes, first, prompt = att["routes"]
        first = int(first)
        out["routes"] = routes[:, first:first + int(prompt)
                               + len(out["tokens"])].cpu()
    return out


def _np_seed(seed, k):
    """The program draws each request's sampling seed from numpy's global
    generator: seed it from the run's seed."""
    np.random.seed(int(np.random.SeedSequence([seed, k]).generate_state(1)[0]))


def run(args, device, model=None, out=None, requests=None,
        calibrate=False):
    """The whole run; returns the exit code. The line goes to ``out``, by
    default standard output as it is at the call. ``model`` replaces the
    configuration's shapes (the CPU rehearsal's tiny model). With
    ``requests`` (a count) the window serves the sequence's first
    ``requests`` requests, whatever ``args.seconds`` says. With
    ``calibrate`` the line holds the readings of the program and of the
    control (``calibrate.py``) in place of the result."""
    t_start = args.t_start
    out = sys.stdout if out is None else out
    bench, cell, cfg, mix, limits = load_cell(ROOT, args.workload)
    cfg = dict(cfg)
    if model is not None:
        cfg["model"] = model
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else \
        (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fun_asr_gguf_tpu_torch import create_asr_engine

    tmp = tempfile.TemporaryDirectory(prefix="bench_torch_")
    try:
        marks = [("start", time.perf_counter())]
        ckpt = weights.write_checkpoint(tmp.name, cfg["model"], args.seed,
                                        device)
        marks.append(("checkpoint", time.perf_counter()))
        wavs = traffic.write_pool(mix, args.seed, tmp.name)
        marks.append(("wavs", time.perf_counter()))
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        kwargs = dict(cfg["engine"])
        if not on_card:
            kwargs["device"] = "cpu"
        engine = create_asr_engine(ckpt, verbose=False, **kwargs)
        # the engine holds what it loaded (on the card, and maps of the
        # host files), so the weight files go now, before the kernel
        # writes their pages back: a run leaves next to nothing on disk
        weights.drop_weight_files(ckpt)
        marks.append(("engine", time.perf_counter()))
        spans = Spans(engine, bool(args.trace), sync)
        seq = traffic.requests(mix, args.seed)
        # warm-up: one greedy request on the pool's longest clip, its
        # output cut to a probe and a chunk (the repetition fuse sends
        # random weights' greedy decoding into a sampled retry, so both
        # sampling paths run)
        lengths = traffic.clip_lengths(mix)
        longest = max(range(len(lengths)), key=lambda i: lengths[i])
        warm = traffic.Request(-1, longest, lengths[longest], min(
            WARM_TOKENS, traffic.n_predict(mix, lengths[longest])), 0.0, True,
            int(mix["top_k"]))
        _np_seed(args.seed, 0)
        if not serve(engine, spans, warm, wavs[longest], sync)["ok"]:
            raise RuntimeError("the warm-up request failed")
        spans.chunks.clear()
        setup_s = time.perf_counter() - t_start
        marks.append(("warm_up", time.perf_counter()))
        # seconds of each set-up step; "start" is torch's import
        setup_parts = {b[0]: b[1] - a[1] for a, b in zip(
            [("", t_start)] + marks, marks)}

        # the window
        _np_seed(args.seed, 1)
        before = counters()
        records, t0 = [], time.perf_counter()
        for req in seq:
            if requests is not None:
                if req.index >= requests:
                    break
            elif records and time.perf_counter() - t0 >= args.seconds:
                break
            records.append(serve(engine, spans, req, wavs[req.clip], sync))
        window_s = records[-1]["end"] - t0
        if getattr(args, "dump", None):
            dump(args.dump, records, t0)
        launched = {k: v - before.get(k, 0) for k, v in counters().items()}

        trace = None
        if args.trace:
            trace = traced_parts(engine, spans, seq, wavs, sync, on_card)
        if on_card:
            peak = torch.cuda.max_memory_allocated(device)
        else:
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        engine.cleanup()
        del engine, spans
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # the comparison
        sample = correct.choose(records, args.seed)
        read = correct.readings(cfg, args.seed, device, sample, wavs,
                                int(mix["top_k"]), control=bool(calibrate))
    finally:
        tmp.cleanup()
    if calibrate:
        print(json.dumps(dict(read, seed=args.seed, workload=args.workload,
                              requests=len(records), compared_requests=len(
                                  sample), retries=sum(r["retries"]
                                                       for r in records))),
              file=out, flush=True)
        return 0
    ok, compared = correct.judge(read, limits)
    route = route_check(cfg, launched, on_card)
    failed = sum(not r["ok"] for r in records)
    ctx = {"records": records, "window_s": window_s, "setup_s": setup_s,
           "on_card": on_card,
           "chunks": [], "cfg": cfg, "model": cfg["model"], "trace": trace,
           "launched": launched}
    if args.trace:
        ctx["chunks"] = trace["chunks"]
    metrics = {}
    for m in metrics_of(bench, cell, args.trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu (rehearsal, tiny model)"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and route["ok"] and failed == 0),
              "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": device_info}
    if args.trace and on_card:
        device_info.update(busy_s=trace["busy_s"],
                           window_s=trace["window_s"])
        result["breakdown"] = trace["breakdown"]
    result["info"] = {
        "window_s": window_s, "requests": len(records),
        "setup_parts": setup_parts,
        "audio_s": sum(r["seconds"] for r in records if r["ok"]),
        "retries": sum(r["retries"] for r in records),
        # the LLM decoder's attempts that the repetition fuse aborted (the
        # served attempt's prefill and generation are in its timings)
        "retried_s": sum(r["llm_s"] - r["timings"]["inject"]
                         - r["timings"]["llm_generate"]
                         for r in records if r["ok"]),
        "compared_greedy_tokens": read["tokens"],
        "compared_served_tokens": read["served_tokens"],
        "compared_logit_rows": read["logit_rows"],
        "compared_frames": read["frames"],
        "compared_requests": len(sample), "route": route,
        "readings": {k: read[k] for k in sorted(read)}}
    result["compared"] = compared
    for k, v in compared.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0 if route["ok"] else 1


def route_check(cfg, launched, on_card):
    """The configuration's route: its kernels launched in the window and
    no other route's. On the CPU the plain versions run: not checked."""
    if not on_card:
        return {"ok": True, "checked": False}
    r = cfg["route"]
    missing = [k for k in r["launched"] if launched.get(k, 0) <= 0]
    extra = [k for k in r["not_launched"] if launched.get(k, 0) > 0]
    return {"ok": not missing and not extra, "checked": True,
            "missing": missing, "unexpected": extra}


def traced_parts(engine, spans, seq, wavs, sync, on_card):
    """After the window: whole requests under a device-only profile (the
    busy share, the kernels' times), then about a second of one request
    under a host-and-device profile (the idle gaps by host operation)."""
    chunks = list(spans.chunks)
    spans.timed = False
    n_req, t0 = 0, time.perf_counter()
    prof = devtrace.device_profile(on_card)
    prof.start()
    while n_req == 0 or time.perf_counter() - t0 < PROFILE_S:
        req = next(seq)
        serve(engine, spans, req, wavs[req.clip], sync)
        n_req += 1
    sync()
    window = time.perf_counter() - t0
    prof.stop()
    summary = devtrace.device_summary(prof)
    del prof

    host = devtrace.host_profile(on_card)
    state = {"stopped": False, "t0": time.perf_counter()}

    def stop():
        if not state["stopped"] and \
                time.perf_counter() - state["t0"] >= HOST_PROFILE_S:
            sync()
            host.stop()
            state["stopped"] = True
    spans.on_chunk = stop
    host.start()
    req = next(seq)
    serve(engine, spans, req, wavs[req.clip], sync)
    if not state["stopped"]:
        sync()
        host.stop()
    spans.on_chunk = None
    gaps = devtrace.idle_gaps_by_host(host)
    del host
    return {"chunks": chunks, "on_card": on_card, "busy_s": summary["busy_s"],
            "window_s": window, "requests": n_req,
            "kernels": summary["kernels"],
            "breakdown": {"device_ops": devtrace.top_device_ops(
                summary["kernels"]), "idle_gaps": gaps}}


def p90(values):
    """The 90th percentile (statistics.quantiles, inclusive)."""
    return statistics.quantiles(values, n=10, method="inclusive")[8] \
        if len(values) > 1 else values[0]
