"""K3 (``flash_attention_kernel``, the encoder's attention): the sum of
its calls' bounds over the sum of their device times in the traced
requests, in %. Every call covers the padded window (T = 1001 frames
at 60 s, all heads); its bound is the operations over the bf16 peak."""

from bench_torch import roofline

KERNEL = "flash_attention_kernel"


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["on_card"]:
        return None
    calls = [v for k, v in tr["kernels"].items() if KERNEL in k]
    n, secs = sum(c[1] for c in calls), sum(c[0] for c in calls)
    if not n:
        return None
    t = roofline.lfr_frames(int(ctx["cfg"]["segment_pad_seconds"] * 16000))
    return 100.0 * n * roofline.bound_s(
        *roofline.k3_count(ctx["model"], t)) / secs
