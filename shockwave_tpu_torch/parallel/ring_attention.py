"""Ring attention: sequence-parallel exact attention over the `sp` axis.

The port of `shockwave_tpu/parallel/ring_attention.py`. Each rank holds
one sequence shard of Q, K and V; the K/V blocks travel around the sp
ring (`comm.shift`) while each rank merges its queries' attention over
every block. Where the reference runs an einsum online-softmax step per
block, each step here is K1 (`ops.flash_attention.attention_forward`, on
the card the flash kernel, on the CPU its plain version) on the block,
its (out, lse) merged into the running pair in f32. The head dim is
zero-padded to the kernel width as `flash_attention` pads it; the scale
is 1/sqrt of the unpadded head dim.

Causal: step 0 is the diagonal block (rank i's own keys), causal. A block
from an earlier rank is seen whole, one from a later rank not at all:
the reference adds exp(-1e30 - m) = 0 for it, since step 0 always gives
each row a real max, so skipping it is exact. Rank i of n runs i + 1
blocks, non-causal every rank n.

The backward runs the same schedule: delta = rowsum(dO * out) once, then
at each step K2 and K3 (`attention_dq`, `attention_dkv`) with the global
lse and delta. dQ is summed locally; each block's dK and dV partials
travel on around the ring with the block and reach their home rank after
n hops. Sums run in f32.
"""
from __future__ import annotations

import math

import torch

from ..ops import flash_attention as fa
from . import comm
from .mesh import Mesh

NEG_INF = fa.NEG_INF


def _to_bhtd(x: torch.Tensor, width: int) -> torch.Tensor:
    b, t, h, _ = x.shape
    x = fa.pad_head_dim(x.transpose(1, 2), width)
    return x.reshape(b * h, t, width).contiguous()


def _schedule(mesh: Mesh, axis: str, causal: bool):
    """(step, whether the step's block is attended to, whether it is the
    causal diagonal) for each of the ring's steps on this rank."""
    n, i = mesh.size(axis), mesh.index(axis)
    for step in range(n):
        src = (i - step) % n
        yield step, not (causal and src > i), causal and step == 0


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal):
        b, t, h, d = q.shape
        width = fa.kernel_head_dim(d)
        scale = 1.0 / math.sqrt(d)
        qb, kb, vb = (_to_bhtd(x, width) for x in (q, k, v))
        own_k, own_v = kb, vb
        out = lse = None
        for step, runs, diagonal in _schedule(mesh, axis, causal):
            if step:
                kb, vb = comm.shift([kb, vb], mesh, axis)
            if not runs:
                continue
            o, l = fa.attention_forward(qb, kb, vb, None, h, scale, diagonal)
            if out is None:
                out, lse = o.float(), l
                continue
            m = torch.maximum(lse, l)
            a, c = torch.exp(lse - m), torch.exp(l - m)
            out = (out * a[..., None] + o.float() * c[..., None]) / (a + c)[..., None]
            lse = m + torch.log(a + c)
        out = out.to(q.dtype)
        ctx.save_for_backward(qb, own_k, own_v, out, lse)
        ctx.mesh, ctx.axis, ctx.causal, ctx.scale, ctx.shape = mesh, axis, causal, scale, q.shape
        return out.reshape(b, h, t, width)[..., :d].transpose(1, 2).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        qb, kb, vb, out, lse = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        b, t, h, d = ctx.shape
        width = qb.shape[-1]
        gb = _to_bhtd(g.to(qb.dtype), width)
        delta = (out.float() * gb.float()).sum(dim=-1)
        dq = torch.zeros(qb.shape, dtype=torch.float32, device=qb.device)
        dk = torch.zeros(kb.shape, dtype=torch.float32, device=kb.device)
        dv = torch.zeros_like(dk)
        n = mesh.size(axis)
        for step, runs, diagonal in _schedule(mesh, axis, ctx.causal):
            if runs:
                args = (gb, lse, delta, None, h, ctx.scale, diagonal)
                dq += fa.attention_dq(qb, kb, vb, *args).float()
                dk_s, dv_s = fa.attention_dkv(qb, kb, vb, *args)
                dk += dk_s.float()
                dv += dv_s.float()
            # The block moves on with its partial gradients; after the
            # last step only the gradients travel, which takes them home.
            if step < n - 1:
                kb, vb, dk, dv = comm.shift([kb, vb, dk, dv], mesh, axis)
            elif n > 1:
                dk, dv = comm.shift([dk, dv], mesh, axis)

        def back(x):
            return x.reshape(b, h, t, width)[..., :d].transpose(1, 2).to(g.dtype)

        return back(dq), back(dk), back(dv), None, None, None


def ring_attention(q, k, v, mesh: Mesh, axis_name: str = "sp", causal: bool = False):
    """Exact attention with q, k, v (batch, seq/sp, heads, head_dim) this
    rank's sequence shard along `axis_name`; returns this rank's shard of
    the output, in q's dtype."""
    return _RingAttention.apply(q, k, v, mesh, axis_name, causal)


def reference_attention(q, k, v, causal: bool = False):
    """Unsharded attention for correctness checks, as the reference's:
    scores in f32, causal entries at -1e30, softmax weights cast to v's
    dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    scores = scores.float()
    if causal:
        q_len, k_len = q.shape[1], k.shape[1]
        mask = torch.ones(q_len, k_len, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v).to(q.dtype)
