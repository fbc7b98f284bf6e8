"""Parallelism for the port's jobs: data-parallel gangs (`mesh.py`)."""
from .mesh import (backend, barrier, gang_allreduce, local_batch_slice,
                   maybe_initialize_distributed, process_count, process_index)

__all__ = ["backend", "barrier", "gang_allreduce", "local_batch_slice",
           "maybe_initialize_distributed", "process_count", "process_index"]
