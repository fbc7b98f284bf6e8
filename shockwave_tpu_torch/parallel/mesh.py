"""Data-parallel gangs over `torch.distributed`.

The port of the data-parallel part of `shockwave_tpu/parallel/mesh.py`.
The scheduler dispatches a job of scale factor N as N processes, each
with `--coordinator H:P --num_processes N --process_id R`
(`sched/physical.py`). Where the JAX package joins a `jax.distributed`
cluster and shards each batch over a "dp" mesh axis, a port process
joins a process group:

- Rendezvous is a `torch.distributed.TCPStore` at the coordinator's
  address, with rank 0 as its server.
- The backend that carries the collectives: `gloo` on the CPU; on CUDA,
  `nccl` when every rank has a card of its own and `gloo` when ranks
  share one (NCCL refuses two ranks on one device). The ranks decide by
  putting their card's UUID into the store and reading every rank's.
  The backend only chooses where the collectives run: tensors stay on
  the card either way (gloo copies CUDA tensors through the host).
- The lease iterator's control decisions (`barrier`, `gang_allreduce`)
  run on a CPU gloo group of their own, the default group when that is
  gloo already.

Each rank builds the same global host batch from the seed and keeps its
slice (`local_batch_slice`), as every JAX process does before it puts
the batch on its devices. The trainer (`models/train_common.py`)
all-reduces the gradients; BatchNorm (`models/resnet.py`) all-reduces
its batch statistics.

The model-parallel axes of the JAX mesh (pp, tp, sp, ep) are ROADMAP.md
Queue 1, item 8.
"""
from __future__ import annotations

import atexit
import datetime
from typing import List, Optional

import torch
import torch.distributed as dist

#: How long a rank waits for its peers: at the rendezvous and in any
#: collective (a peer that died must not hold the gang for the default 30
#: minutes; the scheduler's liveness watchdog acts well before).
GANG_TIMEOUT_S = 300.0

_state = {"backend": None, "control": None}


def select_backend(store, rank: int, world_size: int,
                   device_uuid: Optional[str]) -> str:
    """The collective backend of a gang: `gloo` for CPU ranks
    (`device_uuid` None); for CUDA ranks, each puts its card's UUID into
    `store` and reads every rank's: `nccl` if all differ, else `gloo`."""
    if device_uuid is None:
        return "gloo"
    store.set(f"swtpu/device_uuid/{rank}", device_uuid)
    uuids: List[str] = [store.get(f"swtpu/device_uuid/{r}").decode()
                        for r in range(world_size)]
    return "nccl" if len(set(uuids)) == world_size else "gloo"


def maybe_initialize_distributed(coordinator: Optional[str],
                                 num_processes: Optional[int],
                                 process_id: Optional[int],
                                 device: torch.device) -> None:
    """Join the job's gang when dispatched as one of `num_processes` > 1
    ranks; otherwise (and when already joined) do nothing.

    A gang flag that is missing raises ValueError at once: without a
    rendezvous address or a rank the process would wait for peers that
    cannot find it."""
    if not num_processes or num_processes <= 1 or dist.is_initialized():
        return
    if not coordinator:
        raise ValueError(f"--num_processes {num_processes} needs --coordinator "
                         "HOST:PORT (the gang's rendezvous address)")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"--num_processes {num_processes} needs --process_id "
                         f"in [0, {num_processes}), not {process_id}")
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=GANG_TIMEOUT_S)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=timeout)
    device = torch.device(device)
    uuid = None
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        torch.cuda.set_device(index)
        uuid = str(torch.cuda.get_device_properties(index).uuid)
    backend = select_backend(store, process_id, num_processes, uuid)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _state["backend"] = backend
    _state["control"] = (None if backend == "gloo"
                         else dist.new_group(backend="gloo", timeout=timeout))
    atexit.register(_destroy)
    # The line a gang's logs are searched for (chip_smoke.py reads it).
    print(f"[GANG] rank {process_id} of {num_processes}: backend {backend}, "
          f"device {device}", flush=True)


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(backend=None, control=None)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> Optional[str]:
    """The gang's collective backend, or None outside a gang."""
    return _state["backend"]


def local_batch_slice(global_batch_size: int, index: Optional[int] = None,
                      count: Optional[int] = None) -> slice:
    """The rows of a global batch that rank `index` of `count` trains on.

    The reference requires `count` to divide the batch. Here the first
    ranks take `global_batch_size // count` rows and the last
    `global_batch_size % count` ranks one more, so that rank 0's slice
    is still the GNS small batch `b[:B // n_dev]`; the trainer weights
    each rank's gradient by its loss's element count, so the gang's step
    is the global batch's step either way."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if global_batch_size < count:
        raise ValueError(f"a global batch of {global_batch_size} cannot feed "
                         f"{count} ranks")
    per, extra = divmod(global_batch_size, count)
    plain = count - extra  # ranks that take `per` rows
    start = index * per + max(index - plain, 0)
    return slice(start, start + per + (index >= plain))


def barrier() -> None:
    """Wait for every rank of the gang (on the CPU control group)."""
    dist.barrier(group=_state["control"])


def gang_allreduce(value: float, op: str) -> float:
    """The max or min of `value` over the gang, the same float on every
    rank. In float64, so the agreed value is one rank's own value
    exactly (the reference's allgather rounds to float32)."""
    reduce_op = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(t, op=reduce_op, group=_state["control"])
    return float(t.item())


def all_reduce_sum(tensor: torch.Tensor, async_op: bool = False):
    """Sum `tensor` in place over the gang, on the default group."""
    return dist.all_reduce(tensor, async_op=async_op)
