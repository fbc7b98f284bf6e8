"""GPipe pipeline parallelism over the mesh's "pp" axis.

The port of `shockwave_tpu/parallel/pipeline.py`. Stage s holds only its
own block's parameters (its shard of parameters with a leading stage
dimension). Over M + S - 1 ticks the microbatches stream through the
stage chain: stage 0 injects microbatch t, every stage applies its
block, and one ring hop a tick (`comm.ring_shift`, whose backward is the
hop back) carries each output to the next stage. The last stage's
outputs are broadcast over pp, so every pp rank holds them and goes on
with the same activations; the gradient reaches the stages once.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from . import comm
from .mesh import Mesh


def pipeline_apply(stage_params: Dict[str, torch.Tensor], x: torch.Tensor, mesh: Mesh,
                   num_microbatches: int, stage_fn: Callable, axis_name: str = "pp"):
    """Run this rank's rows x (batch, ...) through the staged blocks.

    `stage_params`: this rank's shard of each stage-stacked parameter
    (leading dimension 1). `stage_fn(params, mb)` maps a microbatch to an
    output of the same shape and dtype, row by row.

    The reference reshapes the global batch into (M, batch / M) and
    shards each microbatch's rows over dp. Since the block is row-wise,
    each rank splitting its own rows into M microbatches gives every row
    the same stages in the same order, so the outputs are the same rows.
    """
    n_stages, stage = mesh.size(axis_name), mesh.index(axis_name)
    params = {k: v[0] for k, v in stage_params.items()}
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(f"{batch} rows do not split into {num_microbatches} microbatches")
    # Only stage 0 reads x, but every pp rank holds it: the backward sums
    # the pp ranks' gradients of x (the others' are zero).
    x = comm.copy_to_axis(x, mesh, axis_name)
    mbs = x.reshape((num_microbatches, batch // num_microbatches) + tuple(x.shape[1:]))
    first = torch.tensor(stage == 0, device=x.device)
    buf = torch.zeros_like(mbs[0])
    outs = []
    ticks = num_microbatches + n_stages - 1
    for t in range(ticks):
        # Stage 0 injects microbatch t (past the last it re-injects the
        # last one, whose outputs never reach the window), every other
        # stage the activation that arrived. Both branches stay in the
        # graph, so every rank's backward runs the same hops.
        y = stage_fn(params, torch.where(first, mbs[min(t, num_microbatches - 1)], buf))
        if t >= n_stages - 1:  # the microbatch leaving the last stage at tick t
            outs.append(y)
        if t < ticks - 1 and n_stages > 1:
            buf = comm.ring_shift(y, mesh, axis_name)
    # Only the last stage holds real outputs: broadcast them over the ring.
    last = torch.tensor(stage == n_stages - 1, dtype=x.dtype, device=x.device)
    out = comm.sum_over_axis(torch.stack(outs) * last, mesh, axis_name)
    return out.reshape((batch,) + tuple(out.shape[2:]))
