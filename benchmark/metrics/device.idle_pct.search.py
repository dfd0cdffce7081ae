"""device.idle_pct.search: the share of a search window, in %, in which no
operation ran on the card (the profiler's device activity)."""


def read(ctx):
    r = ctx.get("trace")
    if r is None or ctx.get("calls") is None:
        return None
    return 100.0 * (r.window_s - r.busy_s) / r.window_s
