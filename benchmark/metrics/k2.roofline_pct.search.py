"""k2.roofline_pct.search: K2 (the token-interaction similarity,
csrc/interaction_similarity.cu) against its roofline in the search path:
the sum of each traced call's bound (3xTF32 for the float32 form) over
those calls' device time, %."""

from benchmark.harness.readers import roofline

# silent, and so left out, where a later program takes these kernels off
# the path; the harness refuses the run when no entry span saw a launch
OFF_PATH_SILENT = True


def read(ctx):
    if ctx.get("calls") is None:
        return None
    return roofline(ctx, ("K2",))
