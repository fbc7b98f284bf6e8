"""A fully parallel transformer training step: dp x pp x tp x sp x ep.

The port of `shockwave_tpu/parallel/train_step.py`, one rank's part of
one step:
- the batch split over dp (rows) and sp (sequence positions),
- embed -> q/k/v -> ring attention over sp (`ring_attention.py`, K1-K3
  at each ring step) -> wo,
- an MLP with w1 split by column and w2 by row over tp (the input copied
  to the axis, the output summed over it),
- a stack of residual MLP blocks pipelined over pp (`pipeline.py`),
- an MoE layer with its experts split over ep (`moe.py`),
- out -> mean NLL over the global tokens + 1e-2 * the MoE's aux loss,
- SGD at lr 1e-2.

Every rank computes the global loss: each sum over ranks is a
`comm.sum_over_axis`, whose backward leaves each rank the gradient of
its own terms. So a parameter's gradient on one rank is its part from
that rank's tokens, complete over tp, pp and ep (whose ranks hold the
same tokens), and is summed over the axes that split the batch (dp, sp)
and nowhere else.

The global parameters and tokens are drawn from
`np.random.RandomState(0)` in the reference's order, so the same call
builds the same numbers; `shard_params` and `gather_params` carry the
reference's parameter dict (numpy) to a rank's shards and back.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import comm
from .mesh import BATCH_AXES, Mesh, shard
from .moe import moe_mlp
from .pipeline import pipeline_apply
from .ring_attention import ring_attention

# How each parameter is split over the mesh (one axis name or None per
# dimension; replicated where it names none), as the reference's specs.
PARAM_SPECS = {
    "embed": (), "wq": (), "wk": (), "wv": (), "wo": (),
    "w1": (None, "tp"), "w2": ("tp", None),
    "pp_w1": ("pp",), "pp_w2": ("pp",),
    "router": (),
    "moe_w1": ("ep",), "moe_w2": ("ep",),
    "out": (),
}
LR = 1e-2
AUX_WEIGHT = 1e-2


def init_params(vocab: int, dim: int, heads: int, mlp_dim: int, pp: int, n_experts: int,
                rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """The reference's global parameters, drawn from `rng` in its order
    (normal, 0.02), as float32."""
    head_dim = dim // heads
    shapes = {
        "embed": (vocab, dim),
        "wq": (dim, heads, head_dim), "wk": (dim, heads, head_dim),
        "wv": (dim, heads, head_dim), "wo": (heads, head_dim, dim),
        "w1": (dim, mlp_dim), "w2": (mlp_dim, dim),
        "pp_w1": (pp, dim, mlp_dim), "pp_w2": (pp, mlp_dim, dim),
        "router": (dim, n_experts),
        "moe_w1": (n_experts, dim, mlp_dim), "moe_w2": (n_experts, mlp_dim, dim),
        "out": (dim, vocab),
    }
    return {name: rng.normal(0, 0.02, shape).astype(np.float32)
            for name, shape in shapes.items()}


def shard_params(global_np: Dict[str, np.ndarray], mesh: Mesh,
                 device=None) -> Dict[str, torch.Tensor]:
    """This rank's shard of each parameter, a leaf tensor on `device`."""
    return {name: torch.from_numpy(np.ascontiguousarray(shard(mesh, value, PARAM_SPECS[name])))
            .to(device).requires_grad_()
            for name, value in global_np.items()}


def gather_params(local: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, np.ndarray]:
    """The global parameter dict (numpy) from every rank's shards."""
    out = {}
    for name, value in local.items():
        value = value.detach()
        for dim, axis in enumerate(PARAM_SPECS[name]):
            if axis is not None:
                value = torch.cat(comm.all_gather(value, mesh, axis), dim=dim)
        out[name] = value.cpu().numpy()
    return out


def _pp_block(stage, x):
    h = F.gelu(torch.einsum("bsd,df->bsf", x, stage["w1"]), approximate="tanh")
    return x + torch.einsum("bsf,fd->bsd", h, stage["w2"])


class MultiParallelStep:
    """step(params, tokens, targets) -> (new params, loss) on this rank's
    shards and batch block; `routing` holds the last step's MoE routing
    of this rank's tokens (expert_idx and keep)."""

    def __init__(self, mesh: Mesh, num_microbatches: int):
        self.mesh = mesh
        self.num_microbatches = num_microbatches
        self.routing: Dict[str, torch.Tensor] = {}

    def forward(self, params, tokens):
        mesh = self.mesh
        x = params["embed"][tokens]  # (b, s, d)
        q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
        k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
        attn = ring_attention(q, k, v, mesh, axis_name="sp", causal=True)
        x = x + torch.einsum("bshk,hkd->bsd", attn, params["wo"])
        # Tensor-parallel MLP: w1 column-split, w2 row-split over tp.
        h = F.gelu(torch.einsum("bsd,df->bsf", comm.copy_to_axis(x, mesh, "tp"), params["w1"]),
                   approximate="tanh")
        x = x + comm.sum_over_axis(torch.einsum("bsf,fd->bsd", h, params["w2"]), mesh, "tp")
        x = pipeline_apply({"w1": params["pp_w1"], "w2": params["pp_w2"]}, x, mesh,
                           num_microbatches=self.num_microbatches, stage_fn=_pp_block)
        moe_out, aux = moe_mlp(x, params["router"], params["moe_w1"], params["moe_w2"], mesh,
                               routing=self.routing)
        x = x + moe_out
        return torch.einsum("bsd,dv->bsv", x, params["out"]), aux

    def loss(self, params, tokens, targets):
        logits, aux = self.forward(params, tokens)
        logp = torch.log_softmax(logits, dim=-1)
        nll_sum = -logp.gather(-1, targets[..., None]).sum()
        n_tokens = targets.numel() * self.mesh.size(BATCH_AXES)
        return comm.sum_over_axis(nll_sum, self.mesh, BATCH_AXES) / n_tokens + AUX_WEIGHT * aux

    def __call__(self, params, tokens, targets):
        for p in params.values():
            p.grad = None
        loss = self.loss(params, tokens, targets)
        loss.backward()
        new = {}
        with torch.no_grad():
            for name, p in params.items():
                grad = p.grad if p.grad is not None else torch.zeros_like(p)
                grad = comm.all_reduce_sum(grad, self.mesh, BATCH_AXES)
                new[name] = (p - LR * grad).requires_grad_()
        return new, loss.detach()


def build_multi_parallel_train_step(mesh: Mesh, vocab: int = 1024, dim: int = 128,
                                    heads: int = 8, mlp_dim: int = 512, seq_len: int = 64,
                                    batch: int = 8, n_experts: Optional[int] = None,
                                    num_microbatches: Optional[int] = None, device=None):
    """(step, this rank's parameter shards, (tokens, targets) of this
    rank's batch block), with the reference's defaults."""
    assert dim % heads == 0
    pp, ep = mesh.size("pp"), mesh.size("ep")
    if n_experts is None:
        n_experts = max(2 * ep, 2)
    if num_microbatches is None:
        num_microbatches = max(2 * pp, 2)
    rng = np.random.RandomState(0)
    params = shard_params(init_params(vocab, dim, heads, mlp_dim, pp, n_experts, rng), mesh,
                          device)
    tokens = rng.randint(1, vocab, (batch, seq_len))
    targets = rng.randint(1, vocab, (batch, seq_len))
    spec = ("dp", "sp")
    batch_block = tuple(torch.from_numpy(np.ascontiguousarray(shard(mesh, t, spec))).to(device)
                        for t in (tokens, targets))
    return MultiParallelStep(mesh, num_microbatches), params, batch_block
