"""Device milliseconds a step in the BatchNorm kernels."""


def read(ctx):
    return ctx["ms_per_step"]("batch_norm")
