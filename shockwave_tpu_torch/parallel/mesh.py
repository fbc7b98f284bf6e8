"""Gangs and the (dp, pp, tp, sp, ep) mesh over `torch.distributed`.

The port of `shockwave_tpu/parallel/mesh.py`.
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

`make_mesh` gives a rank its place in the JAX package's five-axis mesh:
ranks stand in for devices, laid out row-major over (dp, pp, tp, sp, ep)
as the reference reshapes its device list, and every axis (and the pair
(dp, sp) that splits a batch) gets a process group of its own. What XLA
inserts on the TPU for a sharding, the port's modules call explicitly
(`comm.py`): ring shifts for sp and pp, sums and copies over tp and ep.
`shard` cuts a global array by a spec (the port's `PartitionSpec`: one
axis name or None per dimension); `shard_batch`, `replicate` and
`data_parallel_sharding` are the reference's helpers in those terms.
"""
from __future__ import annotations

import atexit
import datetime
import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

#: The mesh's axes, in the reference's order.
AXES = ("dp", "pp", "tp", "sp", "ep")
#: Groups of more than one axis that collectives run over: the axes that
#: split a batch (a replicated parameter's gradient is summed over them).
BATCH_AXES = ("dp", "sp")
Axes = Union[str, Sequence[str]]
Spec = Tuple[Optional[str], ...]

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


# ---------------------------------------------------------------------------
# The (dp, pp, tp, sp, ep) mesh.
# ---------------------------------------------------------------------------

def mesh_shape(world_size: int, dp: Optional[int] = None, tp: int = 1, sp: int = 1,
               pp: int = 1, ep: int = 1,
               batch_size: Optional[int] = None) -> Tuple[int, int, int, int, int]:
    """(dp, pp, tp, sp, ep) over `world_size` ranks, with the reference's
    rules: dp defaults to the remaining ranks, capped by `batch_size` at
    the largest divisor of the global batch (the ranks past the mesh then
    idle); an explicit shape must cover the ranks exactly."""
    rest = pp * tp * sp * ep
    if dp is None:
        assert world_size % rest == 0, (world_size, pp, tp, sp, ep)
        dp = world_size // rest
        if batch_size is not None:
            while dp > 1 and batch_size % dp:
                dp -= 1
            if dp * rest < world_size:
                logger.warning("mesh: batch_size=%d caps dp at %d; %d of %d ranks left out "
                               "of the mesh and will idle", batch_size, dp,
                               world_size - dp * rest, world_size)
    else:
        # An explicit shape must cover the ranks exactly: a silently
        # undersized mesh would skew profiling and throughput numbers.
        assert dp * rest == world_size, f"mesh {dp}x{pp}x{tp}x{sp}x{ep} != {world_size} devices"
    return dp, pp, tp, sp, ep


class Mesh:
    """One rank's view of a (dp, pp, tp, sp, ep) mesh: the axis sizes
    (`shape`), its coordinates (`coords`, None on a rank left out of the
    mesh) and a process group for each axis and for `BATCH_AXES` (None
    where the group is one rank: every collective over it is the
    identity)."""

    def __init__(self, shape: Sequence[int], rank: int, groups: Dict[Tuple[str, ...], object]):
        self.shape = dict(zip(AXES, shape))
        self.rank = rank
        inside = rank < math.prod(shape)
        self.coords = (dict(zip(AXES, (int(c) for c in np.unravel_index(rank, shape))))
                       if inside else None)
        self._groups = groups

    @staticmethod
    def _axes(axes: Axes) -> Tuple[str, ...]:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes: Axes) -> int:
        """This rank's position in its group over `axes` (row-major)."""
        index = 0
        for a in self._axes(axes):
            index = index * self.shape[a] + self.coords[a]
        return index

    def group(self, axes: Axes):
        return self._groups[self._axes(axes)]

    def rank_at(self, **coords) -> int:
        """The global rank at this rank's coordinates with `coords` changed."""
        at = dict(self.coords, **coords)
        return int(np.ravel_multi_index([at[a] for a in AXES], [self.shape[a] for a in AXES]))


def _group_ranks(shape: Sequence[int], axes: Tuple[str, ...]) -> List[List[int]]:
    """Every group of ranks that differ only along `axes`, each sorted."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    moved = [AXES.index(a) for a in axes]
    kept = [i for i in range(len(AXES)) if i not in moved]
    order = ranks.transpose(kept + moved).reshape(-1, math.prod(shape[i] for i in moved))
    return [sorted(int(r) for r in row) for row in order]


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1, pp: int = 1, ep: int = 1,
              batch_size: Optional[int] = None) -> Mesh:
    """This rank's mesh over the initialized process group's ranks (one
    rank when there is none), shaped by `mesh_shape`'s rules. Every rank
    creates every group in the same order, as `new_group` requires."""
    world = process_count()
    shape = mesh_shape(world, dp=dp, tp=tp, sp=sp, pp=pp, ep=ep, batch_size=batch_size)
    groups = {}
    for axes in [(a,) for a in AXES] + [BATCH_AXES]:
        groups[axes] = None
        for ranks in _group_ranks(shape, axes):
            if len(ranks) > 1:
                group = dist.new_group(ranks)
                if process_index() in ranks:
                    groups[axes] = group
    return Mesh(shape, process_index(), groups)


def data_parallel_sharding(mesh: Mesh) -> Tuple[Spec, Spec]:
    """(batch spec, replicated spec) for pure data parallelism."""
    return ("dp",), ()


def shard(mesh: Mesh, x, spec: Spec):
    """This rank's block of the global array `x` (numpy or torch) under
    `spec`: dimension i is cut into `mesh.size(spec[i])` equal blocks
    when spec[i] names an axis."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = mesh.size(axis)
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over "
                                 f"{axis}={n}")
            per = x.shape[dim] // n
            index = [slice(None)] * x.ndim
            index[dim] = slice(mesh.index(axis) * per, (mesh.index(axis) + 1) * per)
            x = x[tuple(index)]
    return x


def shard_batch(mesh: Mesh, batch):
    """Each leaf's rows of this rank's dp index (a tensor or array, or a
    dict, list or tuple of them)."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return shard(mesh, batch, ("dp",))


def replicate(mesh: Mesh, tree):
    """Every rank of the mesh holds rank 0's values of `tree` (a tensor,
    or a dict, list or tuple of them): broadcast over the process group,
    through the host (gloo)."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    if process_count() == 1:
        return tree
    host = tree.detach().to("cpu", copy=True)
    dist.broadcast(host, src=0)
    return host.to(tree.device)
