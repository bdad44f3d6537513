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
  ``logits(prompt, tokens, act)``; ``act`` None is the reference,
  ``"fp8"`` the control (``reference.fp8`` on every product's input and
  output). It decides how much of the pairs to dequantize at a time;
* ``decode_token(llm, fmt, visible)``: (bytes, operations) of one batch-1
  decode step with ``visible`` cache slots;
* ``tiny_llm()``: the LLM part of the CPU rehearsal's shapes.
"""

import importlib


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
