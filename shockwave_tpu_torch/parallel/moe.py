"""Expert-parallel mixture-of-experts MLP over the mesh's "ep" axis.

The port of `shockwave_tpu/parallel/moe.py`: Switch-style top-1 routing
with a fixed capacity per expert, over the global token count, and the
Switch load-balancing loss. A token's slot in its expert's buffer is its
rank among the tokens that chose that expert, in the global (batch,
sequence) order; tokens past the capacity are dropped. The batch is
split over dp and sp, so each rank gathers every rank's expert choices
(`BATCH_AXES`) and counts the earlier tokens itself: counting only its
own would drop other tokens than the reference drops.

The experts are sharded over ep. Every ep rank holds the same tokens; it
runs its own experts on the kept tokens that chose them (row by row, as
the reference's one-hot dispatch and combine einsums amount to), the
ranks' outputs are summed over ep, and the gate multiplies the sum.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import comm
from .mesh import BATCH_AXES, Mesh


def gather_batch(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global (B, S, ...) array of every rank's (batch, seq, ...)
    block x over the batch axes: dp blocks of rows, each of sp blocks of
    sequence positions (no gradient)."""
    if mesh is None:
        return x.detach().clone()
    blocks = comm.all_gather(x, mesh, BATCH_AXES)
    sp = mesh.size("sp")
    return torch.cat([torch.cat(blocks[r * sp:(r + 1) * sp], dim=1)
                      for r in range(mesh.size("dp"))], dim=0)


def route(x: torch.Tensor, router_w: torch.Tensor, mesh: Optional[Mesh],
          capacity_factor: float = 1.25):
    """(probs (T, E) f32, expert_idx (T,), gate (T,), keep (T,) bool,
    global expert counts (E,), global token count) of this rank's tokens
    x (batch, seq, dim), T = batch * seq, with the reference's capacity
    max(int(capacity_factor * tokens / E), 1) over the global tokens."""
    b, s, d = x.shape
    n_experts = router_w.shape[-1]
    tokens = x.reshape(b * s, d)
    logits = tokens @ router_w.to(tokens.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    expert_idx = probs.argmax(dim=-1)
    gate = probs.gather(-1, expert_idx[:, None])[:, 0]
    global_idx = gather_batch(expert_idx.view(b, s), mesh)  # (B, S)
    dp, sp = (mesh.size(a) if mesh is not None else 1 for a in BATCH_AXES)
    n_tokens = global_idx.numel()
    capacity = max(int(capacity_factor * n_tokens / n_experts), 1)
    assign = F.one_hot(global_idx.reshape(-1), n_experts)
    pos = (torch.cumsum(assign, dim=0) * assign).amax(dim=-1) - 1  # slot in its expert
    r, c = ((mesh.coords["dp"], mesh.coords["sp"]) if mesh is not None else (0, 0))
    local_pos = pos.view(dp * b, sp * s)[r * b:(r + 1) * b, c * s:(c + 1) * s].reshape(-1)
    return (probs, expert_idx, gate, local_pos < capacity, assign.sum(dim=0), n_tokens)


def moe_mlp(x, router_w, w1, w2, mesh: Optional[Mesh] = None, capacity_factor: float = 1.25,
            axis_name: str = "ep", routing: Optional[dict] = None):
    """Top-1 MoE feed-forward of this rank's tokens x (batch, seq, dim).

    router_w: (dim, E); w1 (E / ep, dim, hidden) and w2 (E / ep, hidden,
    dim): this rank's experts, the ep-th block of E. Returns (out, aux):
    out like x; aux the Switch loss E * sum(density * density_proxy)
    over the global tokens. `routing`, when given, receives this rank's
    expert_idx and keep."""
    b, s, d = x.shape
    n_experts = router_w.shape[-1]
    probs, expert_idx, gate, keep, counts, n_tokens = route(x, router_w, mesh, capacity_factor)
    if routing is not None:
        routing.update(expert_idx=expert_idx.view(b, s), keep=keep.view(b, s))
    tokens = x.reshape(b * s, d)
    ep_index = mesh.index(axis_name) if mesh is not None else 0
    local = w1.shape[0]
    if mesh is not None:
        # Every ep rank holds these tokens and runs only its own experts
        # on them: the backward sums the ranks' token gradients.
        tokens = comm.copy_to_axis(tokens, mesh, axis_name)
    out = torch.zeros_like(tokens)
    for e in range(local):
        rows = ((expert_idx == ep_index * local + e) & keep).nonzero().squeeze(1)
        h = F.gelu(tokens[rows] @ w1[e].to(tokens.dtype), approximate="tanh")
        out = out.index_add(0, rows, h @ w2[e].to(tokens.dtype))
    if mesh is not None:
        out = comm.sum_over_axis(out, mesh, axis_name)
    combined = out * (gate * keep).to(out.dtype)[:, None]

    # Switch load-balancing loss over the global tokens: each rank's sum
    # of its probs, summed over the batch axes (the backward keeps each
    # rank's own part).
    density = counts.float() / n_tokens
    proxy_sum = probs.sum(dim=0)
    if mesh is not None:
        proxy_sum = comm.sum_over_axis(proxy_sum, mesh, BATCH_AXES)
    aux = n_experts * torch.sum(density * proxy_sum / n_tokens)
    return combined.reshape(b, s, d).to(x.dtype), aux
