"""The benchmark of the PyTorch and CUDA port (`shockwave_tpu_torch`):
BENCHMARK.json's cells, run one at a time by `benchmark/run.py`."""
