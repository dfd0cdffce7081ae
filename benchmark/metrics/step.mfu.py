"""step.mfu: the training step's share of the card's bf16 peak, in %:
model FLOP of a step (counts/flops.py) x steps completed in the window /
the window's seconds / 989 TFLOP/s."""

from benchmark.counts import peaks


def read(ctx):
    if not ctx.get("step_flops") or not ctx.get("units"):
        return None
    return 100.0 * ctx["step_flops"] * ctx["units"] / ctx["window_s"] \
        / peaks.BF16
