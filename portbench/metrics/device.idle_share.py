"""device.idle_share: the share of the profiler window in which no kernel,
copy or memset ran on the card (one minus the union of their intervals
over the window)."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
