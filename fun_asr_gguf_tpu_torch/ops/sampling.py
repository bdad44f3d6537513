"""On-device token sampling (``fun_asr_gguf_tpu/ops/sampling.py``).

The llama.cpp sampler chain in the same order: top-k → top-p on the
softmax of the top-k candidates at temperature 1 (smallest prefix whose
cumulative probability reaches p, min_keep = 1) → temperature → one
categorical draw; pure argmax when the temperature is <= 0. Draws come
from an explicit ``torch.Generator`` on the logits' device (Gumbel-max, as
``jax.random.categorical``); they cannot match JAX's PRNG draw for draw.

:func:`sample_drawn` is the draw of :func:`sample_residual` from uniforms
drawn beforehand, with the temperature and ``top_p`` numbers or device
scalars alike, so that a CUDA graph can take the warping and the draw
while the host keeps the generator (``models/speculative.py``).
"""

import torch

NEG_INF = -1e30


def candidates(vocab: int, top_k: int) -> int:
    """How many candidates the sampler keeps, and so draws uniforms for."""
    return min(top_k, vocab) if top_k > 0 else vocab


def _top_candidates(logits, top_p, top_k: int):
    """(kept logits [B, k] with NEG_INF outside top-p, ids [B, k], keep)."""
    vals, idx = torch.topk(logits, candidates(logits.shape[-1], top_k),
                           dim=-1)                           # descending
    p1 = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(p1, dim=-1)
    keep = (cum - p1) < top_p
    keep[..., 0] = True
    return torch.where(keep, vals, torch.full_like(vals, NEG_INF)), idx, keep


def _floor(temperature):
    """The temperature the warping divides by: at least 1e-6."""
    if isinstance(temperature, torch.Tensor):
        return temperature.clamp_min(1e-6)
    return max(temperature, 1e-6)


def _over(x, t):
    """x / t with the bits of dividing by a host number, where ``t`` may
    be a device scalar: PyTorch's CUDA kernel multiplies by the host
    number's reciprocal, its CPU kernel divides."""
    if isinstance(t, torch.Tensor) and x.is_cuda:
        return x * torch.reciprocal(t)
    return x / t


def warped_candidates(logits, temperature, top_p, top_k: int):
    """The distribution the sampler draws from: (probs [..., k], ids
    [..., k]); mass outside the surviving candidates is exactly 0.
    ``temperature`` and ``top_p`` are numbers or device scalars."""
    logits = logits.to(torch.float32)
    masked, idx, keep = _top_candidates(logits, top_p, top_k)
    probs = torch.softmax(_over(masked, _floor(temperature)), dim=-1)
    return torch.where(keep, probs, torch.zeros_like(probs)), idx


def sample_drawn(logits, u, temperature, top_p, top_k: int = 50,
                 forbid=None):
    """logits [B, V] → token ids [B] int64 drawn with the uniforms ``u``
    [B, candidates(V, top_k)] (f32, drawn beforehand), excluding
    ``forbid [B]`` (-1 = none; None: no exclusion). ``temperature`` and
    ``top_p`` are numbers or device scalars; the temperature is not
    tested for greedy here."""
    logits = logits.to(torch.float32)
    masked, idx, _ = _top_candidates(logits, top_p, top_k)
    if forbid is not None:
        masked = torch.where(idx == forbid[:, None],
                             torch.full_like(masked, NEG_INF), masked)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    choice = torch.argmax(_over(masked, _floor(temperature)) + gumbel,
                          dim=-1)
    return torch.gather(idx, 1, choice[:, None])[:, 0]


def sample_residual(logits, generator, temperature: float, top_p: float,
                    top_k: int = 50, forbid=None):
    """logits [B, V] → token ids [B] int64, excluding ``forbid [B]``
    (-1 = none) from the draw (the residual distribution after a rejected
    speculative draft). ``forbid=None`` is plain sampling."""
    if temperature <= 0:
        # greedy rejection only happens when the draft != argmax
        return torch.argmax(logits.to(torch.float32), dim=-1)
    u = torch.rand((logits.shape[0], candidates(logits.shape[-1], top_k)),
                   generator=generator, device=logits.device)
    return sample_drawn(logits, u, temperature, top_p, top_k, forbid)


def sample_token(logits, generator, temperature: float, top_p: float,
                 top_k: int = 50):
    """logits [B, V] f32 → token ids [B] int64 (greedy when T <= 0)."""
    return sample_residual(logits, generator, temperature, top_p, top_k)
