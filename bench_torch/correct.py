"""The comparison that decides ``correct``.

After the window closes and the program is freed, a sample of the
window's finished requests, drawn from the seed with the longest among
them and at least two greedy ones, goes through the plain reference
(``reference.py``): each clip's audio, the program's CTC frame ids, the
served token ids and the next-token logits the decoder left after its
prefill and after each chunk (verify rounds and decode steps through the
cache), and of a greedy request also its first attempt (the greedy one,
where the repetition fuse made it retry at a higher temperature). The
reference runs prompt and tokens as one causal pass. Four numbers are
read, and those that the cell's ``limits/<cell>.json`` names are held to
their limits:

* ``llm_logit_err``: the largest |program - reference| of those logit
  rows over the largest |reference logit| of each row's request;
* ``llm_gap``: the widest gap by which a greedy token's logit lies below
  the reference's best logit at its position;
* ``llm_topk_gap``: the widest gap by which any served token's logit,
  sampled or greedy, lies below the reference's ``top_k``-th best at its
  position: the sampler draws only from its ``top_k`` best (the mix's
  ``top_k``, the facade's 50), so a sound token lies above that line but
  for rounding, and a token altered where it is sampled seldom does;
* ``ctc_gap``: the widest gap by which the CTC head's id of a frame lies
  below the reference's best, over every frame of the padded window.

Where the decoder routes each token to the top k of its experts
(``ROUTED`` in ``arch/<arch>.py``), the reference does not choose its
own experts where the program ran: near-ties of two experts' scores fall
one way in the program's rounding and the other in float32, and each
such decision moves every later logit. It follows the program's
``routes`` and judges them by a fifth number:

* ``route_gap``: the widest gap by which the lowest-scored expert of the
  program's choice lies below the reference's own k-th best selection
  score, over every routed layer at every position the program ran;
  ``arch.BROKEN_GAP`` where a decision is not k distinct experts, or
  where the program's ``routes`` do not cover every position it ran.

The logit numbers above are then taken against the reference that
follows the program, and measure its precision again. The two guard each
other: a program that routes to the wrong experts fails ``route_gap``;
one whose ``routes`` are not the experts it computed fails
``llm_logit_err``. ``route_decisions`` and ``route_differs_pct`` (the
share of decisions whose set is not the reference's own top k) are read
beside them and judged by nothing.

Beside them, every run reads what the faults of ``tests/test_faults.py``
would read, planted in the reference put in the program's place
(``fault_*``): the upper readings of the numbers the control seldom
moves.

The control is the reference in the precision below the configuration's
bf16, fp8 (the input and the output of every product rounded to e4m3):
its logit rows against the reference's, and at each position of the same
prompts and tokens (and frames) the reference's gap of the token the
control puts first. A routed control chooses its own experts; the
reference follows and scores them, as it does the program's.
"""

import numpy as np
import torch

from . import arch, reference, traffic

TARGET_TOKENS = 300     # served tokens to compare, at least, where there are


def choose(records, seed, target=TARGET_TOKENS, greedy=2):
    """The sample: finished requests in a seeded order, the one with the
    most served tokens first, until ``target`` served tokens and
    ``greedy`` greedy requests (or all there are)."""
    pool = [r for r in records if r["ok"] and r["served"]["tokens"]]
    if not pool:
        return []
    n_greedy = min(greedy, sum(r["greedy"] for r in pool))
    rng = np.random.default_rng([seed, 3])
    order = list(rng.permutation(len(pool)))
    longest = max(range(len(pool)),
                  key=lambda i: len(pool[i]["served"]["tokens"]))
    order.remove(longest)
    out, n, g = [], 0, 0
    for i in [longest] + order:
        out.append(pool[i])
        n += len(pool[i]["served"]["tokens"])
        g += pool[i]["greedy"]
        if n >= target and g >= n_greedy:
            break
    return out


def _gap(logits, ids):
    """max over rows of (row max - row[id])."""
    ids = torch.as_tensor(ids, dtype=torch.int64, device=logits.device)
    best = logits.max(dim=-1).values
    got = logits.gather(-1, ids[:, None])[:, 0]
    return float((best - got).max())


def _topk_gap(logits, ids, k):
    """max over rows of (the row's k-th best - row[id]), 0 at least."""
    ids = torch.as_tensor(ids, dtype=torch.int64, device=logits.device)
    if not len(ids):
        return 0.0
    kth = logits.topk(k, dim=-1).values[:, -1]
    got = logits.gather(-1, ids[:, None])[:, 0]
    return max(0.0, float((kth - got).max()))


def _rel_err(got, ref):
    """max |got - ref| over max |ref|, over every row."""
    return float((got - ref).abs().max() / ref.abs().max())


def _faults(read, name, ref_llm, pos, tokens, top_k):
    """The faults of tests/test_faults.py, planted in the reference put in
    the program's place, at the same positions: every fifth token moved
    to the next id (of the served tokens, and of the greedy ones); every
    step leaving the prefill's logits as they were."""
    rows = ref_llm[pos]
    read["fault_stuck_logit_err"] = max(
        read.get("fault_stuck_logit_err", 0.0),
        _rel_err(rows[:1].expand_as(rows)[1:], rows[1:])
        if len(pos) > 1 else 0.0)
    vocab = ref_llm.shape[-1]
    read["fault_token_topk_gap"] = max(
        read.get("fault_token_topk_gap", 0.0),
        _topk_gap(ref_llm[:-1][4::5], (tokens[4::5] + 1) % vocab, top_k))
    if name == "first":
        best = ref_llm[:-1].argmax(-1)[4::5]
        read["fault_token_llm_gap"] = _gap(
            ref_llm[:-1][4::5], (best + 1) % vocab) if len(best) else 0.0


def _widest(gap):
    return float(gap.max()) if gap.numel() else 0.0


def readings(cfg, seed, device, sample, wavs, top_k, control=False):
    """{"llm_logit_err", "llm_gap", "llm_topk_gap", "ctc_gap", "tokens",
    "frames"} of the program's sample, the ``fault_*`` readings of the
    planted faults at the same positions; with ``control`` also the
    control's ``control_llm_logit_err``, ``control_llm_gap``,
    ``control_llm_topk_gap`` and ``control_ctc_gap``. A routed decoder
    adds ``route_gap``, ``fault_route_gap`` (``arch.route_fault`` of the
    following reference's own routing), ``route_decisions`` and
    ``route_differs_pct``, and with ``control`` ``control_route_gap``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference.Reference(cfg, seed, device)
    routed = ref.routed
    names = ("llm_logit_err", "llm_gap", "llm_topk_gap", "ctc_gap") + (
        ("route_gap",) if routed else ())
    out = dict.fromkeys(names, 0.0)
    out.update(tokens=0, served_tokens=0, frames=0, logit_rows=0)
    if control:
        out.update({"control_" + k: 0.0 for k in names})
    out.update(fault_stuck_logit_err=0.0, fault_token_llm_gap=0.0,
               fault_token_topk_gap=0.0, fault_ctc_gap=0.0)
    if routed:
        out.update(fault_route_gap=0.0, route_decisions=0)
    differs = 0
    with torch.inference_mode():
        for r in sample:
            audio = torch.from_numpy(traffic.read_wav(wavs[r["clip"]]))
            ref.act = None
            enc, emb = ref.encode(audio)
            prompt = ref.prompt(emb)
            ctc = ref.ctc_logits(enc)
            best = ctc.argmax(-1)[4::5]
            # the fault of an answer altered where it is produced: every
            # fifth frame's CTC id moved to the next id
            read = {"ctc_gap": _gap(ctc, r["ctc_ids"]),
                    "fault_ctc_gap": _gap(ctc[4::5],
                                          (best + 1) % ctc.shape[-1])}
            runs = [("served", r["served"])]
            if r["first"] is not None:
                runs.append(("first", r["first"]))
            llm = {}
            for name, att in runs:
                tokens = torch.as_tensor(att["tokens"], device=device)
                routes = att.get("routes")
                if routed and not ref.decoder.covers(
                        routes, prompt.shape[0] + len(tokens)):
                    # the program ran positions it gave no experts for
                    read["route_gap"] = arch.BROKEN_GAP
                    routes = None
                llm[name], info = ref.decoder_logits(prompt, tokens, routes)
                if routed:
                    read["route_gap"] = max(read.get("route_gap", 0.0),
                                            _widest(info["gap"]))
                    read["fault_route_gap"] = max(
                        read.get("fault_route_gap", 0.0),
                        _widest(info["fault_gap"]))
                    out["route_decisions"] += info["gap"].numel()
                    differs += int(info["differs"].sum())
                del info
                pos = [p for p, _ in att["logits"]]
                got = torch.stack([lg for _, lg in att["logits"]]).to(device)
                read["llm_logit_err"] = max(read.get("llm_logit_err", 0.0),
                                            _rel_err(got, llm[name][pos]))
                read["llm_topk_gap"] = max(
                    read.get("llm_topk_gap", 0.0),
                    _topk_gap(llm[name][:-1], att["tokens"], top_k))
                out["logit_rows"] += len(pos)
                _faults(read, name, llm[name], pos, tokens, top_k)
            if r["first"] is not None:
                read["llm_gap"] = _gap(llm["first"][:-1], r["first"]["tokens"])
                out["tokens"] += len(r["first"]["tokens"])
            if control:
                ref.act = "fp8"
                c_enc, c_emb = ref.encode(audio)
                c_prompt = ref.prompt(c_emb)
                read["control_ctc_gap"] = _gap(ctc, ref.ctc_logits(
                    c_enc).argmax(-1))
                ref.act = None
                for name, att in runs:
                    tokens = torch.as_tensor(att["tokens"], device=device)
                    c_llm, c_info = ref.decoder_logits(c_prompt, tokens,
                                                       act="fp8")
                    base = llm[name]
                    if routed:
                        # the reference follows the control's experts
                        base, info = ref.decoder_logits(prompt, tokens,
                                                        c_info["routes"])
                        read["control_route_gap"] = max(
                            read.get("control_route_gap", 0.0),
                            _widest(info["gap"]))
                        del info
                    del c_info
                    pos = [p for p, _ in att["logits"]]
                    read["control_llm_logit_err"] = max(
                        read.get("control_llm_logit_err", 0.0),
                        _rel_err(c_llm[pos], base[pos]))
                    read["control_llm_topk_gap"] = max(
                        read.get("control_llm_topk_gap", 0.0),
                        _topk_gap(base[:-1], c_llm[:-1].argmax(-1),
                                  top_k))
                    if name == "first":
                        read["control_llm_gap"] = _gap(
                            base[:-1], c_llm[:-1].argmax(-1))
                    del base
                del c_enc, c_emb, c_prompt
            for k, v in read.items():
                out[k] = max(out[k], v)
            out["served_tokens"] += len(r["served"]["tokens"])
            out["frames"] += len(r["ctc_ids"])
            del enc, emb, ctc, llm
    del ref
    if routed:
        out["route_differs_pct"] = (100.0 * differs / out["route_decisions"]
                                    if out["route_decisions"] else 0.0)
    return out


def judge(read, limits):
    """(correct, {name: {"value", "limit"}}) of the numbers the cell's
    limits file names; a cell that names ``route_gap`` also needs routing
    decisions to judge."""
    compared = {k: {"value": read[k], "limit": limits[k]} for k in limits}
    ok = read["tokens"] > 0 and read["logit_rows"] > 0 and all(
        v["limit"] is not None and v["value"] <= v["limit"]
        for v in compared.values())
    if "route_gap" in limits:
        ok = ok and read["route_decisions"] > 0
    return ok, compared
