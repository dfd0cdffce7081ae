"""k1k3.roofline_pct: K1 and K3 (the attention sublayer forward and
backward, csrc/ln_attention_residual{,_bwd}.cu) against their roofline:
the sum of each traced call's bound over those calls' device time, %."""

from benchmark.harness.readers import roofline

# silent, and so left out, where a later program takes these kernels off
# the path; the harness refuses the run when no entry span saw a launch
OFF_PATH_SILENT = True


def read(ctx):
    return roofline(ctx, ("K1", "K3"))
