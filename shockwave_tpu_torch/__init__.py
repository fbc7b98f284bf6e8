"""shockwave_tpu_torch: the PyTorch/CUDA port of shockwave_tpu's workloads.

A second package beside `shockwave_tpu`, which stays the JAX reference.
It imports torch and never jax or anything of `shockwave_tpu`; what it
needs from the reference's jax-free modules it keeps as its own copy.
Each module keeps the reference's name and place, so a reader finds its
counterpart:

  ops/flash_attention.py       hand-written CUDA kernels (csrc/) for the
                               three Pallas flash-attention kernels
  models/transformer.py        Seq2SeqTransformer (the translation model)
  models/data.py               multi30k batches (numpy, copied)
  models/train_common.py       CLI, Trainer, checkpoints
  core/durable_io.py           the checkpoint CRC footer (copied)
  workloads/translation/       the translation trainer's entry point
  convert.py                   flax parameter tree -> state_dict

Entry points run on the CUDA card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
