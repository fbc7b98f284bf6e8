"""shockwave_tpu_torch: the PyTorch/CUDA port of shockwave_tpu's workloads.

A second package beside `shockwave_tpu`, which stays the JAX reference.
It imports torch and never jax or anything of `shockwave_tpu`; what it
needs from the reference's jax-free modules it keeps as its own copy.
Each module keeps the reference's name and place, so a reader finds its
counterpart:

  ops/flash_attention.py       hand-written CUDA kernels (csrc/) for the
                               three Pallas flash-attention kernels
  models/transformer.py        Seq2SeqTransformer (the translation model)
  models/lm.py, recommendation.py, resnet.py
                               the LM, Recommendation and ResNet models
  models/data.py               input pipelines (numpy, copied)
  models/train_common.py       CLI, Trainer, checkpoints, the
                               Accordion/GNS adaptation monitors
  runtime/                     lease iterator, worker daemon, dispatcher
  parallel/mesh.py             data-parallel gangs over torch.distributed
  core/durable_io.py           the checkpoint CRC footer (copied)
  core/{constants,job_table,oracle}.py
                               the job table and oracle files (copied)
  core/{timing,artifacts}.py   two-point step timing, measurement files
  profiling/                   the throughput oracle, cold-dispatch and
                               flagship-bench profilers; peak rates
  workloads/<working_directory>/
                               the entry points the dispatcher launches
  convert.py                   flax parameter trees -> state_dicts

Entry points run on the CUDA card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
