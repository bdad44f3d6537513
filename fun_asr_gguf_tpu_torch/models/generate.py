"""Autoregressive generation on the device (``fun_asr_gguf_tpu/models/generate.py``).

``prefill_init`` :58 runs the embedding-injection prefill and builds the
generation state; ``generate_chunk`` :104 runs up to ``chunk_len`` steps
— sampling, stop detection, the repetition fuse, the feed-back of the
sampled token and one decode step — on device tensors. Like JAX's
``lax.while_loop`` (:125-127), the chunk stops before a step once every
row is done. On a card the host reads ``done`` without draining the
queue: each step copies it to pinned memory right after the sampling,
before the decode step, and the next step waits only for that copy, so
the decode step it enqueued keeps the card busy meanwhile. On a card the
decode step is one replay of a CUDA graph (:mod:`.decode_graph`); the CPU
runs it eagerly. Each step is a ``decode.step`` span (``..profiling``) of
``decode.wait`` (that wait), ``decode.sample`` and ``decode.forward`` (the
step's enqueue).

Reference behaviour kept: stop ids {151643, 151645} end generation and are
not counted; the sampled token is fed back even when it is a stop id; the
fuse aborts when the last 30 counted tokens hold ≤ 3 distinct ids; a
pending ``forbid`` (a speculative draft rejected just before the
speculation guardrail handed the state over, :func:`..speculative.
spec_to_gen`) is excluded from the chunk's first draw only (JAX :132-136).
"""

from dataclasses import dataclass
from typing import Tuple

import torch

from ..ops.sampling import sample_residual
from ..profiling import count, span
from .decode_graph import DecodeGraphs
from .qwen3 import KVCache, embed_tokens, qwen3_decode_step, qwen3_prefill

RING = 30          # fuse window
FUSE_DISTINCT = 3  # fuse threshold


@dataclass
class GenState:
    kv: KVCache
    logits: torch.Tensor       # [B, V] f32 — next-token logits
    prompt_len: torch.Tensor   # [B] int64
    valid_from: torch.Tensor   # [B] int64 — first valid KV slot
    step: int                  # tokens generated so far (host counter)
    generator: torch.Generator
    ring: torch.Tensor         # [B, RING] int64 — last counted ids
    n_gen: torch.Tensor        # [B] int64 — counted (non-stop) tokens
    done: torch.Tensor         # [B] bool
    aborted: torch.Tensor      # [B] bool
    prompt_slots: int          # P
    forbid: torch.Tensor       # [B] int64 — id excluded from the next
    #   draw only (-1: none); see spec_to_gen


def prefill_init(params, embeds, attn_mask, generator: torch.Generator, cfg,
                 max_len: int, kv_int8: bool = False) -> GenState:
    """embeds [B, P, hidden] left-padded, attn_mask [B, P]; ``max_len`` is
    the KV capacity (>= P + n_predict); ``kv_int8`` keeps the cache in
    int8 (``qwen3.QuantKV``), and every later step and verify round
    writes and reads it so. ``q8_mega`` params at b = 1 with a bf16 / f32
    cache get the head-major cache of the all-layers kernel (JAX :66-73)."""
    b, p, _ = embeds.shape
    dev = embeds.device
    if "q8_mega" in params and b == 1 and not kv_int8:
        # the all-layers kernel (K5) decodes from a HEAD-MAJOR cache
        # [L, kh, S, D]; S is rounded up to a multiple of 256 as in JAX
        max_len += -max_len % 256
        logits, kv = qwen3_prefill(params, embeds, attn_mask, cfg,
                                   kv_max_len=max_len)
        kv = KVCache(k=kv.k[:, 0].transpose(1, 2).contiguous(),
                     v=kv.v[:, 0].transpose(1, 2).contiguous())
    else:
        logits, kv = qwen3_prefill(params, embeds, attn_mask, cfg,
                                   kv_max_len=max_len, kv_int8=kv_int8)
    prompt_len = attn_mask.sum(dim=1).to(torch.int64)
    return GenState(
        kv=kv, logits=logits, prompt_len=prompt_len,
        valid_from=p - prompt_len, step=0, generator=generator,
        ring=torch.full((b, RING), -1, dtype=torch.int64, device=dev),
        n_gen=torch.zeros(b, dtype=torch.int64, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
        aborted=torch.zeros(b, dtype=torch.bool, device=dev),
        prompt_slots=p,
        forbid=torch.full((b,), -1, dtype=torch.int64, device=dev))


def _distinct_count(ring):
    """Number of distinct values per row of [B, RING]."""
    s, _ = torch.sort(ring, dim=1)
    return 1 + (s[:, 1:] != s[:, :-1]).sum(dim=1)


def generate_chunk(params, state: GenState, cfg, temperature: float,
                   top_p: float, top_k: int = 50, chunk_len: int = 64,
                   stop_tokens: Tuple[int, ...] = (151643, 151645),
                   limit: int = None,
                   graphs: DecodeGraphs = None) -> torch.Tensor:
    """Run up to ``min(chunk_len, limit)`` steps, stopping once every row
    is done (JAX's ``cond``); returns the token buffer [B, chunk_len] (-1
    where a row was already done, or past the last step). ``state`` is
    advanced in place. On a card the steps replay graphs of ``graphs``
    (an engine's, so that its requests capture once; a new one
    otherwise)."""
    b = state.logits.shape[0]
    dev = state.logits.device
    n_steps = chunk_len if limit is None else min(chunk_len, limit)
    buf = torch.full((b, chunk_len), -1, dtype=torch.int64, device=dev)
    stops = torch.tensor(stop_tokens, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    p = state.prompt_slots
    # ``done`` as of the last sampling, copied to the host behind an event
    # (on a card); on the CPU, and before the first step, read directly
    done_host, copied = None, None
    if dev.type == "cuda":
        done_host = torch.empty(b, dtype=torch.bool, pin_memory=True)
        copied = torch.cuda.Event()
        if graphs is None:
            graphs = DecodeGraphs()
    with span("decode.chunk"):
        for t in range(n_steps):
            with span("decode.step"):
                with span("decode.wait"):
                    count("host.syncs")
                    if done_host is None or t == 0:
                        stop = bool(state.done.all())
                    else:
                        copied.synchronize()
                        stop = bool(done_host.all())
                if stop:
                    break
                count("decode.steps")
                with span("decode.sample"):
                    # sample_residual with no exclusion is sample_token; a
                    # pending exclusion is consumed by exactly one draw
                    token = sample_residual(state.logits, state.generator,
                                            temperature, top_p, top_k,
                                            state.forbid if t == 0 else None)
                    if t == 0:
                        state.forbid = torch.full_like(state.forbid, -1)
                    active = ~state.done
                    is_stop = torch.isin(token, stops)
                    counted = active & ~is_stop
                    buf[:, t] = torch.where(active, token, -1)

                    pos = state.n_gen % RING
                    cur = state.ring[rows, pos]
                    state.ring[rows, pos] = torch.where(counted, token, cur)
                    state.n_gen = state.n_gen + counted.to(torch.int64)
                    fused = counted & (state.n_gen > RING) & \
                        (_distinct_count(state.ring) <= FUSE_DISTINCT)
                    state.done = state.done | (active & is_stop) | fused
                    state.aborted = state.aborted | fused
                    if done_host is not None:
                        done_host.copy_(state.done, non_blocking=True)
                        copied.record()

                with span("decode.forward"):
                    # feed the sampled token back (stop ids included; rows
                    # already done feed a dummy whose logits are never
                    # used)
                    fed = torch.where(active, token, 0)
                    if dev.type == "cuda":
                        graphs.step(params, state, fed, cfg)
                    else:
                        state.logits, state.kv = qwen3_decode_step(
                            params, state.kv, embed_tokens(params, fed),
                            p + state.step, state.prompt_len + state.step,
                            state.valid_from, cfg)
                state.step += 1
    return buf
