"""torch_ops.ms_per_step: device milliseconds a training step spends in
work that is not one of the program's own kernels (cuBLAS, cuDNN and
PyTorch's elementwise, reduction and copy kernels): every device operation
of the window not launched from inside a kernel entry's span, over the
steps completed."""


def read(ctx):
    r = ctx.get("trace")
    if r is None or ctx.get("step_flops") is None or not ctx.get("units"):
        return None
    return 1e3 * r.other_device_s / ctx["units"]
