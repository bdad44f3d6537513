"""K4 (``q8_layer_fused_kernel``): the sum of its calls' bounds over the
sum of their device times in the traced requests, in %. A decode step
or verify round makes one call a layer, the last without the next
layer's qkv stage; each call's bytes are counted at one row (a verify
round's nine rows add under 1 %, so the share is never overstated)."""

from bench_torch import roofline

KERNEL = "q8_layer_fused_kernel"


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["on_card"]:
        return None
    calls = [v for k, v in tr["kernels"].items() if KERNEL in k]
    n, secs = sum(c[1] for c in calls), sum(c[0] for c in calls)
    llm = ctx["model"]["llm"]
    if not n or n % llm["n_layers"]:
        return None
    a = roofline.bound_s(roofline.k4_bytes(llm, True), roofline.k4_ops(llm))
    b = roofline.bound_s(roofline.k4_bytes(llm, False),
                         roofline.k4_ops(llm, False))
    steps = n // llm["n_layers"]
    return 100.0 * steps * ((llm["n_layers"] - 1) * a + b) / secs
