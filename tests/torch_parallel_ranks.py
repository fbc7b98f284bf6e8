"""One rank of `tests/test_torch_parallel.py`'s probes of the port's
model-parallel modules on the CPU: ring attention, the pipeline and the
MoE, each on a mesh of its own over the same four gloo ranks.

    python tests/torch_parallel_ranks.py RANK WORLD PORT OUT

Each probe's global inputs come from `probe_inputs` (numpy, from a seed),
so the test hands the same arrays to the JAX package. The rank saves
its own blocks of the outputs and gradients, with its coordinates.
"""
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

from shockwave_tpu_torch.parallel import comm
from shockwave_tpu_torch.parallel.mesh import make_mesh, shard
from shockwave_tpu_torch.parallel.moe import moe_mlp
from shockwave_tpu_torch.parallel.pipeline import pipeline_apply
from shockwave_tpu_torch.parallel.ring_attention import ring_attention

# (mesh sizes, ...) of each probe. Ring attention over an sp ring of 4;
# the pipeline on 2 stages with each stage's rows split over dp 2; the
# MoE with its tokens split over dp x sp and with its experts split over
# ep, at a capacity factor low enough that every rank drops tokens.
RING_MESH = dict(sp=4)
PIPE_MESH = dict(dp=2, pp=2)
MOE_MESHES = {"dp_sp": dict(dp=2, sp=2), "dp_ep": dict(dp=2, ep=2)}
MOE_CAPACITY_FACTOR = 0.5
PIPE_MICROBATCHES = 2


def probe_inputs(name: str):
    """The global numpy inputs of probe `name`."""
    rng = np.random.RandomState({"ring": 1, "pipe": 2, "moe": 3}[name])

    def randn(*shape, scale=1.0):
        return (scale * rng.randn(*shape)).astype(np.float32)

    if name == "ring":  # q, k, v, cotangent (B, T, H, D)
        return {k: randn(2, 32, 2, 16) for k in ("q", "k", "v", "g")}
    if name == "pipe":  # x (B, S, D), stage weights, cotangent
        return {"x": randn(8, 4, 8), "w1": randn(2, 8, 16, scale=0.3),
                "w2": randn(2, 16, 8, scale=0.3), "g": randn(8, 4, 8)}
    return {"x": randn(4, 8, 8), "router": randn(8, 4), "w1": randn(4, 8, 16, scale=0.3),
            "w2": randn(4, 16, 8, scale=0.3), "g": randn(4, 8, 8)}


def pp_block(stage, x):
    h = torch.nn.functional.gelu(torch.einsum("bsd,df->bsf", x, stage["w1"]),
                                 approximate="tanh")
    return x + torch.einsum("bsf,fd->bsd", h, stage["w2"])


def leaf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()


def ring_probe():
    mesh = make_mesh(**RING_MESH)
    inp = probe_inputs("ring")
    out = {"coords": mesh.coords}
    for causal in (False, True):
        q, k, v = (leaf(shard(mesh, inp[n], (None, "sp"))) for n in ("q", "k", "v"))
        o = ring_attention(q, k, v, mesh, causal=causal)
        # The loss over the whole sequence on every rank: gather's backward
        # hands each rank the gradient of its own block.
        (comm.gather_over_axis(o, mesh, "sp", dim=1) * torch.from_numpy(inp["g"])).sum().backward()
        out[causal] = {"out": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                       "dv": v.grad.numpy()}
    return out


def pipe_probe():
    mesh = make_mesh(**PIPE_MESH)
    inp = probe_inputs("pipe")
    x = leaf(shard(mesh, inp["x"], ("dp",)))
    w = {n: leaf(shard(mesh, inp[n], ("pp",))) for n in ("w1", "w2")}
    y = pipeline_apply(w, x, mesh, PIPE_MICROBATCHES, pp_block)
    (y * torch.from_numpy(shard(mesh, inp["g"], ("dp",)))).sum().backward()
    # The stage weights' gradients, summed over the rows' dp blocks.
    grads = {n: comm.all_reduce_sum(w[n].grad, mesh, "dp").numpy() for n in w}
    return {"coords": mesh.coords, "out": y.detach().numpy(), "dx": x.grad.numpy(), **grads}


def moe_probe(sizes):
    mesh = make_mesh(**sizes)
    inp = probe_inputs("moe")
    x = leaf(shard(mesh, inp["x"], ("dp", "sp")))
    router = leaf(inp["router"])
    w1, w2 = (leaf(shard(mesh, inp[n], ("ep",))) for n in ("w1", "w2"))
    routing = {}
    y, aux = moe_mlp(x, router, w1, w2, mesh, capacity_factor=MOE_CAPACITY_FACTOR,
                     routing=routing)
    loss = comm.sum_over_axis((y * torch.from_numpy(shard(mesh, inp["g"], ("dp", "sp")))).sum(),
                              mesh, ("dp", "sp")) + aux
    loss.backward()
    return {"coords": mesh.coords, "out": y.detach().numpy(), "aux": float(aux),
            "expert_idx": routing["expert_idx"].numpy(), "keep": routing["keep"].numpy(),
            "dx": x.grad.numpy(),
            "drouter": comm.all_reduce_sum(router.grad, mesh, ("dp", "sp")).numpy(),
            "dw1": comm.all_reduce_sum(w1.grad, mesh, ("dp", "sp")).numpy(),
            "dw2": comm.all_reduce_sum(w2.grad, mesh, ("dp", "sp")).numpy()}


def main(rank, world, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        results = {"ring": ring_probe(), "pipe": pipe_probe(),
                   "moe": {name: moe_probe(sizes) for name, sizes in MOE_MESHES.items()}}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(results, out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
