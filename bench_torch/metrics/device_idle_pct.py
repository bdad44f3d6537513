"""The share of the traced requests' wall time in which nothing ran on
the card (the union of kernel, copy and set intervals, device activity
only in the profiler), in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["on_card"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
