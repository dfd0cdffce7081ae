"""device.idle_pct.train: the share of a training window, in %, in which
no operation ran on the card (the profiler's device activity)."""


def read(ctx):
    r = ctx.get("trace")
    if r is None or ctx.get("step_flops") is None:
        return None
    return 100.0 * (r.window_s - r.busy_s) / r.window_s
