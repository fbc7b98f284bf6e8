"""Parallelism for the port's jobs: data-parallel gangs and the
(dp, pp, tp, sp, ep) mesh (`mesh.py`); the model-parallel axes in
`comm.py`, `ring_attention.py`, `pipeline.py`, `moe.py`,
`train_step.py` and `dryrun.py`."""
from .mesh import (backend, barrier, gang_allreduce, local_batch_slice,
                   maybe_initialize_distributed, process_count, process_index)

__all__ = ["backend", "barrier", "gang_allreduce", "local_batch_slice",
           "maybe_initialize_distributed", "process_count", "process_index"]
