"""Device milliseconds a step in the trainer's multi-tensor kernels: the
gradient norm (`get_total_norm`) and the SGD-momentum update."""


def read(ctx):
    return ctx["ms_per_step"]("optimizer")
