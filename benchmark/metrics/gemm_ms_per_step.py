"""Device milliseconds a step in cuBLAS's products (the Transformer's
dense layers and its float32 tied logits)."""


def read(ctx):
    return ctx["ms_per_step"]("matmul")
