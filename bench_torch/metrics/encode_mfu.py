"""The encoder's share of the card's peak: the least time of each
request's encode counted for the clip's real length (so the padding of
the 60 s window shows as waste) over ``timings.encode``, in %."""

from bench_torch import roofline


def read(ctx):
    if not ctx["on_card"]:
        return None
    rows = [r for r in ctx["records"] if r["ok"]]
    secs = sum(r["timings"]["encode"] for r in rows)
    if not secs:
        return None
    least = sum(roofline.bound_s(*roofline.encode_count(
        ctx["model"], int(round(r["seconds"] * 16000)))) for r in rows)
    return 100.0 * least / secs
