"""k8k9.roofline_pct: K8 and K9 (attention over packed qkv, forward and
backward, csrc/frame_attention.cu) against their roofline: the sum of each
traced call's bound over those calls' device time, %."""

from benchmark.harness.readers import roofline

# silent, and so left out, where a later program takes these kernels off
# the path; the harness refuses the run when no entry span saw a launch
OFF_PATH_SILENT = True


def read(ctx):
    return roofline(ctx, ("K8", "K9"))
