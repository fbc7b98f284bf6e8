"""Device milliseconds a step in the convolutions: cuDNN's convolution
kernels and the GEMM kernels it runs some of them as (group `matmul`; in
ResNet-50 every product but the 0.5 GFLOP float32 head is a
convolution)."""


def read(ctx):
    return ctx["ms_per_step"]("conv", "matmul")
