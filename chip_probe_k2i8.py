"""Quick first check of K2 and K2-i8 on one CUDA card.

    python3 chip_probe_k2i8.py

Builds the kernel library with ptxas's register / shared-memory report,
then holds K2-i8 (int8 cache) and K2 (bf16 cache) against their plain
versions over decode and verify shapes, batch 1 and 3, and prints the
relative error of each; exits non-zero when K2-i8's worst error passes
2e-2. Imports nothing of JAX.
"""

import sys
import time

import torch

from fun_asr_gguf_tpu_torch.kernels import build
from fun_asr_gguf_tpu_torch.models.qwen3 import _kv_quantize
from fun_asr_gguf_tpu_torch.ops import flash_decode as fd


def main():
    t0 = time.perf_counter()
    build.build(verbose=True)
    print("build s", time.perf_counter() - t0, flush=True)
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for t, qh, kh, s in [(1, 16, 8, 17), (1, 16, 8, 1024), (9, 16, 8, 1033),
                         (3, 8, 2, 65), (5, 16, 8, 777), (1, 4, 1, 300),
                         (2, 16, 8, 2000)]:
        for b in (1, 3):
            q = (torch.randn(b, t, qh, 128, generator=g, device=dev)
                 / 11.3).to(bf)
            kq, ks = _kv_quantize(torch.randn(b, s, kh, 128, generator=g,
                                              device=dev).to(bf))
            vq, vs = _kv_quantize(torch.randn(b, s, kh, 128, generator=g,
                                              device=dev).to(bf))
            j = torch.arange(s, device=dev)
            bias = torch.where(j < s - 3, 0.0, -1e30).float().expand(
                b, t, s).contiguous()
            n0 = fd.launches_i8
            out = fd.flash_decode_attention(q, kq, vq, bias, ks, vs)
            torch.cuda.synchronize()
            assert fd.launches_i8 == n0 + 1
            ref = fd.flash_decode_plain(q, kq, vq, bias, ks, vs)
            err = ((out.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
            worst = max(worst, err)
            print(f"i8 b={b} t={t} qh={qh} kh={kh} s={s} rel {err:.3e}",
                  flush=True)
            k = torch.randn(b, s, kh, 128, generator=g, device=dev).to(bf)
            v = torch.randn(b, s, kh, 128, generator=g, device=dev).to(bf)
            out = fd.flash_decode_attention(q, k, v, bias)
            ref = fd.flash_decode_plain(q, k, v, bias)
            err = ((out.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
            print(f"bf16 b={b} t={t} s={s} rel {err:.3e}", flush=True)
    print("worst i8", worst)
    return 0 if worst < 2e-2 else 1


if __name__ == "__main__":
    sys.exit(main())
