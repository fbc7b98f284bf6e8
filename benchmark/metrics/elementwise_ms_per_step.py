"""Device milliseconds a step in PyTorch's elementwise kernels (casts,
copies, adds, activations, the LayerNorm's arithmetic)."""


def read(ctx):
    return ctx["ms_per_step"]("elementwise")
