"""Hand-written CUDA kernels for hot ops (Hopper, sm_90a).

`flash_attention` (the module) holds the kernels' wrappers, their plain
PyTorch versions and the launch counters; the function of the same name
is its public entry point.
"""
