"""The port's job-side and worker-side control plane: copies of the
jax-free modules of `shockwave_tpu/runtime/` that the lease iterator, the
dispatcher and the worker daemon need, with the device binding made
CUDA's. The scheduler side stays in the JAX package, unchanged."""
