"""The one traffic generator: a mix file of parameters -> requests and WAVs.

A mix (``traffic/<name>.json``) gives the clip-length distribution, the
pool size, the output tokens per audio second, the share of greedy
requests and the synthetic signal. Every seed gets the same clip lengths
in the same order; the seed draws only the audio (and, in the harness,
the weights), so the runs of one cell do the same work.

The lengths are the distribution's quantiles, one a pool entry, in rank
order. Ranks are taken in groups of ``greedy_every`` neighbours, and the
groups in bit-reversed order (a van der Corput sequence): every stretch
of 2**k groups holds one group from each of 2**k equal slices of the
distribution, so any prefix of the sequence is as near to the whole
distribution as a prefix can be. The last (longest) request of each
group is greedy, so the greedy requests span the lengths: the
comparison that decides ``correct`` needs greedy tokens. Where the mix
sets ``greedy_max_seconds``, only groups whose last clip is no longer
are greedy: random weights' greedy output can repeat itself, and past 30
tokens the program's repetition fuse then retries the request sampled,
on some seeds and not on others, which would make the work depend on the
seed. The others sample at the mix's temperature, the facade's default
0.4.
"""

import math
import os
import statistics
import wave
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

SAMPLE_RATE = 16000


@dataclass(frozen=True)
class Request:
    index: int          # position in the sequence (0 = first timed)
    clip: int           # pool entry
    seconds: float      # clip length
    n_predict: int      # output tokens: round(tokens_per_audio_second * s)
    temperature: float
    greedy: bool
    top_k: int          # the sampler's candidates (the facade's 50)


def clip_lengths(mix) -> List[float]:
    """The pool's clip lengths in seconds, ascending, the same for every
    seed: the distribution's quantiles at (i + 0.5) / pool, in whole
    samples."""
    dist, n = mix["clip_seconds"], int(mix["pool"])
    if dist["kind"] == "fixed":
        vals = [float(dist["value"])] * n
    elif dist["kind"] == "lognormal":
        z = statistics.NormalDist()
        vals = [min(max(dist["median"] * math.exp(
                    dist["sigma"] * z.inv_cdf((i + 0.5) / n)), dist["min"]),
                    dist["max"]) for i in range(n)]
    else:
        raise ValueError(f"unknown clip length distribution {dist['kind']!r}")
    return [round(v * SAMPLE_RATE) / SAMPLE_RATE for v in vals]


def n_predict(mix, seconds: float) -> int:
    return max(1, round(mix["tokens_per_audio_second"] * seconds))


def order(n: int, group: int) -> List[int]:
    """Ranks 0 .. n-1 in groups of ``group`` neighbours, the groups in the
    order of their bit-reversed index (``n / group`` a power of two)."""
    n_groups = n // group
    bits = (n_groups - 1).bit_length()
    if n % group or n_groups != 1 << bits:
        raise ValueError("pool / greedy_every must be a power of two")
    groups = sorted(range(n_groups), key=lambda i: int(
        format(i, f"0{bits}b")[::-1] or "0", 2))
    return [g * group + j for g in groups for j in range(group)]


def requests(mix, seed: int) -> Iterator[Request]:
    """The endless request sequence of one caller (closed loop): the pool
    in :func:`order`, over and over. The same for every seed."""
    del seed  # the seed draws the audio, never the lengths or the order
    lengths = clip_lengths(mix)
    every = int(mix["greedy_every"])
    longest = float(mix.get("greedy_max_seconds", math.inf))
    r = 0
    while True:
        for clip in order(len(lengths), every):
            s = lengths[clip]
            greedy = clip % every == every - 1 and s <= longest
            yield Request(index=r, clip=clip, seconds=s,
                          n_predict=n_predict(mix, s),
                          temperature=0.0 if greedy
                          else float(mix["temperature"]),
                          greedy=greedy, top_k=int(mix["top_k"]))
            r += 1


def signal(mix, seconds: float, rng) -> np.ndarray:
    """A speech-like clip: a harmonic voice with a drifting pitch, cut into
    syllables with pauses, plus noise; int16 samples."""
    p = mix["signal"]
    n = int(round(seconds * SAMPLE_RATE))
    t = np.arange(n) / SAMPLE_RATE
    f0 = rng.uniform(*p["f0_hz"]) * (1 + 0.1 * np.sin(
        2 * np.pi * rng.uniform(0.1, 0.5) * t + rng.uniform(0, 2 * np.pi)))
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    amps = rng.uniform(0.2, 1.0, size=p["harmonics"]) / np.arange(
        1, p["harmonics"] + 1)
    voice = sum(a * np.sin((k + 1) * phase) for k, a in enumerate(amps))
    rate = rng.uniform(*p["syllables_per_s"])
    env = np.clip(np.sin(np.pi * rate * t + rng.uniform(0, np.pi)), 0, None)
    gate = rng.uniform(size=int(seconds * rate) + 1) > p["pause_share"]
    env = env * gate[np.minimum((t * rate).astype(int), gate.size - 1)]
    x = rng.uniform(*p["level"]) * voice / np.abs(voice).max() * env
    x = x + p["noise"] * rng.standard_normal(n)
    return np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)


def write_pool(mix, seed: int, root: str) -> List[str]:
    """One 16 kHz mono 16-bit WAV per pool entry, from the seed; returns
    their paths in pool order."""
    rng = np.random.default_rng([seed, 2])
    paths = []
    for i, s in enumerate(clip_lengths(mix)):
        path = os.path.join(root, f"clip{i:03d}.wav")
        with wave.open(path, "wb") as wf:
            wf.setnchannels(1)
            wf.setsampwidth(2)
            wf.setframerate(SAMPLE_RATE)
            wf.writeframes(signal(mix, s, rng).astype("<i2").tobytes())
        paths.append(path)
    return paths


def read_wav(path: str) -> np.ndarray:
    """The samples a WAV of :func:`write_pool` holds, as float32 in [-1, 1)
    (int16 / 32768)."""
    with wave.open(path, "rb") as wf:
        raw = wf.readframes(wf.getnframes())
    return (np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0)
