"""The decoder architectures: one file each, ``bench_torch/arch/<arch>.py``,
chosen by a configuration's ``model.llm.arch``.

A module provides what the harness knows of its decoder and nothing
else of the harness knows:

* ``decoder_tensors(llm)``: an ordered map from each GGUF tensor name (or
  name template) to its full drawn shape, layer and expert dimensions
  included; ``weights.draw`` draws them in this order as q8_0 pairs;
* ``write_gguf(path, llm, dec)``: the decoder's GGUF, its keys, tensor
  names and norm scales, through ``weights.write_gguf_v3``;
* ``Decoder(cfg, dec, device)``: the plain decoder, from the drawn pairs
  on the device, with ``embed`` (the rows a prompt reads) and
  ``logits(prompt, tokens, act=None, routes=None)`` → ``(logits, info)``;
  ``act`` None is the reference, ``"fp8"`` the control
  (``reference.fp8`` on every product's input and output); ``info`` is
  empty for a dense decoder. It decides how much of the pairs to
  dequantize at a time;
* ``decode_token(llm, fmt, visible)``: (bytes, operations) of one batch-1
  decode step with ``visible`` cache slots;
* ``tiny_llm()``: the LLM part of the CPU rehearsal's shapes.

A decoder whose layers route each token to the top k of E experts says so
with ``ROUTED = True``. Its ``Decoder`` has ``covers(routes, t)``, whether
``routes`` hold k ids of each routed layer at each of ``t`` positions,
and its ``logits`` computes every routed layer at each position below
``routes.shape[1]`` with the experts of ``routes`` [routed layers,
positions, k] (the program's), weighted by its own scores under the
architecture's rule, and at every other position with its own choice.
Its ``info`` holds ``routes``, the experts it used [routed layers, P + n,
k] in ascending order; ``gap``, for each followed decision [routed
layers, positions], its own k-th best selection score less its score of
the lowest-scored expert followed, floored at 0, and ``BROKEN_GAP`` where
the decision is not k distinct ids in [0, E); ``differs``, whether the
followed set is not its own top k; and ``fault_gap``, at every position
[routed layers, P + n], the gap of ``route_fault`` of its own choice.
``correct.py`` judges the program's choice by the gap and its precision
by the logits of the reference that follows it.

The program's side of that contract: a decode state that
``models.prefill``, ``generate`` and ``spec_generate`` return
(``GenState``, ``SpecState``) may carry ``routes``, an integer tensor on
the device shaped [routed layers, cache slots, k], which holds for each
routed layer and cache slot the expert ids that the position in that
slot was routed to (slot s holds position s - ``valid_from``, the
state's own). The program writes it wherever it computes that layer: in
the prefill, in verify rounds and in decode steps, inside a CUDA graph
too; a rejected draft's slot is overwritten by the token that later
takes it. A state without ``routes`` is dense, and nothing changes for
it.
"""

import importlib

import torch

# the gap of a routing decision that names an expert twice or one that
# does not exist, and of routes that do not cover what the program ran:
# above any limit, and finite, so that the result line stays JSON
BROKEN_GAP = 1.0e9


def of(llm):
    """The module of ``llm["arch"]``, ``bench_torch/arch/<arch>.py``."""
    name = llm["arch"]
    full = f"{__name__}.{name}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        # the file itself is missing, not a module that it imports
        if not (e.name or "").startswith(__name__ + ".") or \
                not full.startswith(e.name):
            raise
        raise SystemExit(f"decoder architecture {name!r}: no file "
                         f"bench_torch/arch/{name}.py") from None


def route_fault(routes, n_experts):
    """The fault of a routing altered where it is made: at every fifth
    position of ``routes`` [..., positions, k], the first expert moved to
    the next id that the decision does not hold."""
    out = routes.clone()
    held = out[..., 4::5, :]
    nxt = (held[..., 0] + 1) % n_experts
    for _ in range(held.shape[-1]):
        nxt = torch.where((held == nxt[..., None]).any(-1),
                          (nxt + 1) % n_experts, nxt)
    out[..., 4::5, 0] = nxt
    return out
