"""The plain reference: Fun-ASR-Nano in float32 PyTorch, from the seed.

It follows the published model and the program's stated semantics, and
imports nothing of the program: frontend (mean removal, pre-emphasis
0.97, centred 400/160 Hamming frames, |rfft|^2, 80-bin HTK mel 20-8000
Hz, log(+1e-7), LFR 7/6), the SANM encoder (sqrt(d) scaling, sinusoidal
positions, 4-head masked attention plus the FSMN memory, 1 + 49 + 20
layers and their norms), the adaptor and the CTC head (linear-ReLU-linear
and pre-norm transformer blocks), and the LLM decoder of the
configuration's architecture (``arch/<arch>.py``'s ``Decoder``). The
window is padded to the configuration's ``segment_pad_seconds`` as the
program pads it, and the prompt is the program's ChatML prompt in
byte-level ids.

The weights are the seed's (``weights.draw``); the decoder takes them in
the configuration's stated format, with the format helpers here:
``q8_0_dequant`` (the values as stored), ``int8_rows`` (per-output-channel
int8, absmax / 127, half to even) and ``q8_0_requant`` (ggml's q8_0
rounding). Everything runs in float32 with TF32 off. ``act="fp8"`` is
the control: the input and the output of every product rounded to
float8 e4m3 with a per-row scale (``fp8``), the precision below bf16.
"""

import math

import torch
import torch.nn.functional as F

from . import arch, weights

PROMPT_PREFIX = ("<|im_start|>system\nYou are a helpful assistant."
                 "<|im_end|>\n<|im_start|>user\n语音转写：")
PROMPT_SUFFIX = "<|im_end|>\n<|im_start|>assistant\n"
SPECIAL_IDS = {"<|endoftext|>": 256, "<|im_start|>": 257, "<|im_end|>": 258}
HOP, N_FFT, LFR_M, LFR_N, SR = 160, 400, 7, 6, 16000


def byte_ids(text):
    """The byte-level tokenizer a checkpoint without a tokenizer file
    gets: the special tokens, else the UTF-8 bytes."""
    ids, i = [], 0
    while i < len(text):
        for s, tid in SPECIAL_IDS.items():
            if text.startswith(s, i):
                ids.append(tid)
                i += len(s)
                break
        else:
            ids.extend(text[i].encode("utf-8"))
            i += 1
    return ids


def fp8(x):
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _round_away(x):
    return torch.sign(x) * torch.floor(x.abs() + 0.5)


def q8_0_requant(w):
    """ggml's q8_0 of rows ``w`` [n, k] f32: f16 scale amax / 127, values
    rounded half away from zero against the unrounded scale."""
    b = w.reshape(w.shape[0], -1, weights.QK)
    d = b.abs().amax(dim=-1, keepdim=True) / 127.0
    inv = torch.where(d > 0, 1.0 / d, torch.zeros_like(d))
    q = _round_away(b * inv).clamp(-127, 127)
    d16 = d.half().float()
    d16 = torch.where(d16 < 6.103515625e-05, torch.zeros_like(d16), d16)
    return (q * d16).reshape(w.shape)


def q8_0_dequant(q, d):
    """The f32 values of q8_0 pairs: ``q`` int8 [..., k], ``d`` [..., k /
    32]."""
    return q.float() * d.float().repeat_interleave(weights.QK, -1)


def int8_rows(w, scale_dtype):
    """Per-row (output channel) int8 of ``w`` [n, k]: absmax / 127, half
    to even, the scale stored in ``scale_dtype``."""
    s = w.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(w / torch.where(s == 0, torch.ones_like(s), s))
    return q * s.to(scale_dtype).float()


class Reference:
    """The model of one seed on one device; ``act`` None is the reference,
    ``"fp8"`` the control."""

    def __init__(self, cfg, seed, device, act=None):
        self.cfg, self.model, self.dev = cfg, cfg["model"], device
        self.act = act
        enc, dec = weights.draw(self.model, seed, device)
        self.enc = {k: v.float() for k, v in enc.items()}
        del enc
        module = arch.of(self.model["llm"])
        self.routed = getattr(module, "ROUTED", False)
        self.decoder = module.Decoder(cfg, dec, device)
        del dec

    # -- products -------------------------------------------------------------
    def _mm(self, x, w):
        """x [..., k] @ w [k, n] (encoder layout)."""
        if self.act == "fp8":
            return fp8(fp8(x) @ w)
        return x @ w

    def _lin(self, x, p):
        return self._mm(x, self.enc[p + ".w"]) + self.enc[p + ".b"]

    def _ln(self, x, p, eps):
        return F.layer_norm(x, x.shape[-1:], self.enc[p + ".scale"],
                            self.enc[p + ".bias"], eps)

    # -- audio --------------------------------------------------------------
    def features(self, audio):
        """audio [n] f32 → (LFR features [T, 560], mask [T]) on the padded
        window."""
        n = audio.numel()
        base = int(self.cfg["segment_pad_seconds"] * SR)
        n_pad = base if n <= base else -(-n // SR) * SR
        x = torch.zeros(n_pad, device=self.dev)
        x[:n] = audio.to(self.dev)
        valid = (torch.arange(n_pad, device=self.dev) < n).float()
        x = (x - x[:n].sum() / n) * valid
        x = torch.cat([x[:1], x[1:] - 0.97 * x[:-1]]) * valid
        frames = F.pad(x, (N_FFT // 2, N_FFT // 2)).unfold(0, N_FFT, HOP)
        k = torch.arange(N_FFT, dtype=torch.float64, device=self.dev)
        win = (0.54 - 0.46 * torch.cos(2 * math.pi * k / N_FFT)).float()
        power = torch.fft.rfft(frames * win, n=N_FFT).abs().square()
        mel = torch.log(power @ self._fbank().t() + 1e-7)
        t_phys, t_valid = n_pad // HOP + 1, n // HOP + 1
        t_lfr = -(-t_phys // LFR_N)
        mel = torch.where(torch.arange(t_phys, device=self.dev)[:, None]
                          < t_valid, mel, mel[t_valid - 1])
        right = t_lfr * LFR_N + LFR_M - t_phys
        mel = torch.cat([mel[:1].expand(3, -1), mel,
                         mel[-1:].expand(right, -1)])
        feats = torch.cat([mel[i:i + t_lfr * LFR_N:LFR_N]
                           for i in range(LFR_M)], dim=-1)
        mask = (torch.arange(t_lfr, device=self.dev)
                < -(-t_valid // LFR_N)).float()
        return feats * mask[:, None], mask

    def _fbank(self, n_mels=80, f_min=20.0, f_max=8000.0):
        def mel(f):
            return 2595.0 * torch.log10(1.0 + f / 700.0)
        freqs = torch.linspace(0, SR / 2, N_FFT // 2 + 1, dtype=torch.float64)
        pts = torch.linspace(mel(torch.tensor(f_min, dtype=torch.float64)),
                             mel(torch.tensor(f_max, dtype=torch.float64)),
                             n_mels + 2, dtype=torch.float64)
        hz = 700.0 * (10.0 ** (pts / 2595.0) - 1.0)
        diff = hz[1:] - hz[:-1]
        slopes = hz[None, :] - freqs[:, None]
        down = -slopes[:, :-2] / diff[:-1]
        up = slopes[:, 2:] / diff[1:]
        return torch.clamp(torch.minimum(down, up), min=0).t().float().to(
            self.dev)

    def _attend(self, q, k, v, mask, heads):
        """[T, d] q (unscaled), k, v → [T, d], keys masked by (mask-1)·1e4."""
        t, d = q.shape
        dk = d // heads
        qh, kh, vh = (a.reshape(t, heads, dk).transpose(0, 1)
                      for a in (q, k, v))
        s = (qh * dk ** -0.5) @ kh.transpose(1, 2)
        if mask is not None:
            s = s + ((mask - 1.0) * 1e4)[None, None, :]
        o = torch.softmax(s, dim=-1) @ vh
        return o.transpose(0, 1).reshape(t, d)

    def _sanm(self, x, mask, p, heads, eps, first=False):
        e = self.model["encoder"]
        qkv = self._lin(self._ln(x, p + ".norm1", eps), p + ".attn.qkv")
        q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
        vm = v * mask[:, None]
        kern = self.enc[p + ".attn.fsmn_w"]            # [K, d]
        lp = (e["kernel_size"] - 1) // 2
        conv = F.conv1d(F.pad(vm.t()[None], (lp, e["kernel_size"] - 1 - lp)),
                        kern.t()[:, None, :], groups=vm.shape[-1])[0].t()
        h = self._lin(self._attend(q, k, v, mask, heads), p + ".attn.out") \
            + vm + conv
        if first:
            return h
        x = x + h
        f = self._lin(torch.relu(self._lin(self._ln(x, p + ".norm2", eps),
                                           p + ".ffn.w1")), p + ".ffn.w2")
        return x + f

    def encode(self, audio):
        """audio [n] → (encoder output [T, 512], audio embeddings [n_tok,
        1024], the LLM tokens of the clip's real length)."""
        e = self.model["encoder"]
        x, mask = self.features(audio)
        t = x.shape[0]
        pos = torch.arange(1, t + 1, dtype=torch.float32, device=self.dev)
        depth = e["input_size"]
        inv = torch.exp(torch.arange(depth // 2, dtype=torch.float32,
                                     device=self.dev)
                        * -(math.log(10000.0) / (depth / 2 - 1)))
        x = x * e["d_model"] ** 0.5 + torch.cat(
            [torch.sin(pos[:, None] * inv), torch.cos(pos[:, None] * inv)], 1)
        x = self._sanm(x, mask, "encoder.encoder0", e["heads"], e["ln_eps"],
                       first=True)
        for stack, n in (("encoders", e["num_blocks"] - 1),
                         ("tp_encoders", e["tp_blocks"])):
            with _layers(self.enc, f"encoder.{stack}", n) as layer:
                for i in range(n):
                    layer(i)
                    x = self._sanm(x, mask, f"encoder.{stack}#", e["heads"],
                                   e["ln_eps"])
            norm = "after_norm" if stack == "encoders" else "tp_norm"
            x = self._ln(x, f"encoder.{norm}", e["ln_eps"]) * mask[:, None]
        emb = self._adaptor(x, mask, "adaptor", self.model["adaptor"])
        n = audio.numel()
        t_lfr = -(-(n // HOP + 1) // LFR_N)
        o1 = 1 + (t_lfr - 1) // 2
        n_tok = (1 + (o1 - 1) // 2 - 1) // 2 + 1
        return x, emb[:n_tok]

    def _adaptor(self, x, mask, p, a):
        x = self._lin(torch.relu(self._lin(x, p + ".linear1")),
                      p + ".linear2")
        with _layers(self.enc, p + ".blocks", a["n_layers"]) as layer:
            for i in range(a["n_layers"]):
                layer(i)
                b = p + ".blocks#"
                h = self._ln(x, b + ".norm1", a["ln_eps"])
                att = self._attend(self._lin(h, b + ".attn.q"),
                                   self._lin(h, b + ".attn.k"),
                                   self._lin(h, b + ".attn.v"), mask,
                                   a["heads"])
                x = x + self._lin(att, b + ".attn.out")
                h = self._ln(x, b + ".norm2", a["ln_eps"])
                x = x + self._lin(torch.relu(self._lin(h, b + ".ffn.w1")),
                                  b + ".ffn.w2")
        return x

    def ctc_logits(self, enc_out):
        """[T, 512] → CTC logits [T, vocab] (unmasked, every frame)."""
        h = self._adaptor(enc_out, None, "ctc.decoder",
                          self.model["ctc"]["adaptor"])
        return self._lin(h, "ctc.proj")

    # -- decoder ------------------------------------------------------------
    def prompt(self, audio_embd):
        pre = self.decoder.embed[byte_ids(PROMPT_PREFIX)]
        suf = self.decoder.embed[byte_ids(PROMPT_SUFFIX)]
        return torch.cat([pre, audio_embd, suf])

    def decoder_logits(self, prompt, tokens, routes=None, act=None):
        """The next-token logits after ``prompt`` [P, h] and each prefix of
        ``tokens`` [n]: rows P-1 ... P+n-1 of one causal pass → ([n + 1,
        vocab], info); row i predicts token i. ``act`` (``self.act`` where
        None) is the precision of this pass; a routed decoder follows
        ``routes`` where they reach and returns its decisions in ``info``,
        as ``arch/__init__.py`` says."""
        return self.decoder.logits(prompt, tokens, act or self.act, routes)


class _layers:
    """Binds ``prefix#`` names of ``tree`` to layer ``i`` of the stacked
    ``prefix`` leaves while the block is open."""

    def __init__(self, tree, prefix, n):
        self.tree, self.prefix = tree, prefix
        self.keys = [k for k in tree if k.startswith(prefix + ".")]

    def __enter__(self):
        return self.bind

    def bind(self, i):
        for k in self.keys:
            self.tree[self.prefix + "#" + k[len(self.prefix):]] = \
                self.tree[k][i]

    def __exit__(self, *exc):
        for k in self.keys:
            self.tree.pop(self.prefix + "#" + k[len(self.prefix):], None)
        return False
