"""The port's model-parallel axes (tp, sp, pp, ep) against the JAX
package's, on the CPU.

Four gloo ranks, CPU processes with one torch thread each, stand for the
four devices of the reference's dryrun; the JAX package runs on four of
the eight virtual CPU devices (tests/conftest.py). The ranks are spawned
twice per module: the port's `dryrun_multichip(4, device="cpu")`, which
runs one step of each of the reference's two meshes, and
`tests/torch_parallel_ranks.py`, which runs ring attention, the pipeline
and the MoE, each on a mesh of its own. The same numpy inputs (and, for
the step, the same `RandomState(0)` draws) go to both packages.

Tolerances, all f32 with TF32 off on both sides: forward values 2e-6
abs, gradients 2e-5 relative to the largest entry (the sums run in
other orders: the ring merges per-block softmaxes, the pipeline and the
MoE sum over ranks through the host), the step's loss 2e-6 relative and
every updated parameter within 1e-7 abs of the reference's (SGD at lr
1e-2 moves a parameter by 1e-2 of its gradient). The MoE routing
(expert indices and the kept mask) must be identical.
"""
import contextlib
import functools
import io
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shockwave_tpu.parallel import train_step as jax_train_step
from shockwave_tpu.parallel.mesh import make_mesh as jax_make_mesh
from shockwave_tpu.parallel.moe import moe_mlp as jax_moe_mlp
from shockwave_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from shockwave_tpu.parallel.ring_attention import reference_attention as jax_reference_attention
from shockwave_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from shockwave_tpu_torch.parallel import dryrun
from shockwave_tpu_torch.parallel import mesh as port_mesh
from shockwave_tpu_torch.parallel.ring_attention import reference_attention

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_parallel_ranks as ranks  # noqa: E402

N = 4
FWD_TOL, GRAD_TOL, LOSS_TOL, PARAM_TOL = 2e-6, 2e-5, 2e-6, 1e-7


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def probe_ranks(tmp_path_factory):
    """The probes' rank processes, started before the dryrun's so that
    the two spawns overlap."""
    work = tmp_path_factory.mktemp("parallel")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]))
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_ranks.py"),
                               str(r), str(N), str(port), str(work / f"rank{r}.pt")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(N)]
    yield work, procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def port_steps(probe_ranks):
    """Every rank's results of both meshes' steps, and what was printed."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        results = dryrun.dryrun_multichip(N, device="cpu")
    return results, printed.getvalue()


@pytest.fixture(scope="module")
def probes(probe_ranks):
    """Every rank's results of the ring, pipeline and MoE probes."""
    work, procs = probe_ranks
    outs = [proc.communicate(timeout=240)[0] for proc in procs]
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-3000:]
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(N)]


def _jax_routing(x, router, capacity_factor=1.25):
    """expert_idx and keep of the reference's moe_mlp for x (B, S, d)."""
    b, s, d = x.shape
    n_experts = router.shape[-1]
    probs = jax.nn.softmax((x.reshape(b * s, d) @ router).astype(jnp.float32), axis=-1)
    idx = jnp.argmax(probs, axis=-1)
    assign = jax.nn.one_hot(idx, n_experts, dtype=jnp.int32)
    pos = jnp.max(jnp.cumsum(assign, axis=0) * assign, axis=-1) - 1
    capacity = max(int(capacity_factor * b * s / n_experts), 1)
    return np.asarray(idx).reshape(b, s), np.asarray(pos < capacity).reshape(b, s)


@functools.lru_cache(maxsize=None)
def jax_step(index):
    """The reference's step on the dryrun's mesh `index` over four
    virtual devices: (loss, updated parameters, MoE routing), the routing
    from moe_mlp's input in its forward, sent out by a debug callback."""
    sizes, args = dryrun.mesh_plans(N)[index]
    mesh = jax_make_mesh(**sizes, devices=jax.devices()[:N])
    step, params, (tokens, targets) = jax_train_step.build_multi_parallel_train_step(mesh, **args)
    seen = {}
    moe_mlp = jax_train_step.moe_mlp

    def recording(x, *a, **k):
        jax.debug.callback(lambda value: seen.update(x=np.asarray(value)), x)
        return moe_mlp(x, *a, **k)

    router = np.asarray(params["router"])  # the step donates its parameters
    jax_train_step.moe_mlp = recording  # read when the step is traced, at its first call
    try:
        new, loss = step(params, tokens, targets)
        jax.block_until_ready(loss)
    finally:
        jax_train_step.moe_mlp = moe_mlp
    routing = _jax_routing(jnp.asarray(seen["x"]), jnp.asarray(router))
    return float(loss), {k: np.asarray(v) for k, v in new.items()}, routing


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


# -- the step -----------------------------------------------------------------


def test_dryrun_prints_the_reference_lines(port_steps):
    results, printed = port_steps
    lines = printed.strip().splitlines()
    assert len(lines) == 2
    first, second = results[0]
    assert re.fullmatch(r"dryrun_multichip\(4\): mesh dp=1 tp=2 sp=2, loss=\d+\.\d{4}", lines[0])
    assert re.fullmatch(r"dryrun_multichip\(4\): mesh dp=1 pp=2 ep=2, loss=\d+\.\d{4}", lines[1])
    assert lines[0].endswith(f"loss={first['loss']:.4f}")
    assert lines[1].endswith(f"loss={second['loss']:.4f}")


@pytest.mark.parametrize("index", [0, 1], ids=["dp_tp_sp", "dp_pp_ep"])
def test_moe_routing_is_the_references(port_steps, index):
    """Checked first: the same tokens go to the same experts and the same
    ones are dropped, on every rank."""
    _, _, (idx, keep) = jax_step(index)
    for rank in port_steps[0]:
        routing = rank[index]["routing"]
        np.testing.assert_array_equal(routing["expert_idx"], idx)
        np.testing.assert_array_equal(routing["keep"], keep)


@pytest.mark.parametrize("index", [0, 1], ids=["dp_tp_sp", "dp_pp_ep"])
def test_step_matches_the_reference(port_steps, index):
    """The loss and every updated parameter, gathered from the ranks'
    shards, against the reference's step on the same numbers; every
    rank reports the same."""
    loss, params, _ = jax_step(index)
    for rank in port_steps[0]:
        got = rank[index]
        assert abs(got["loss"] - loss) <= LOSS_TOL * abs(loss)
        assert set(got["params"]) == set(params)
        for name, value in params.items():
            assert got["params"][name].shape == value.shape, name
            assert np.abs(got["params"][name] - value).max() <= PARAM_TOL, name
        assert got["launches"] == {}  # the CPU runs the plain versions


def test_the_ranks_cover_each_mesh(port_steps):
    for index, (sizes, _) in enumerate(dryrun.mesh_plans(N)):
        coords = {tuple(rank[index]["coords"][a] for a in port_mesh.AXES)
                  for rank in port_steps[0]}
        shape = port_mesh.mesh_shape(N, **sizes)
        assert coords == {tuple(int(i) for i in c) for c in np.ndindex(*shape)}


# -- ring attention, the pipeline, the MoE --------------------------------------


def _assemble(blocks, coords, axis_dims):
    """The global array of the ranks' blocks, placed by their coordinates
    along the axes of `axis_dims` (mesh axis -> the dimension it splits);
    ranks that differ only along other axes hold the same block."""
    placed = {tuple(c[a] for a in axis_dims): b for b, c in zip(blocks, coords)}
    axes = list(axis_dims)

    def build(prefix):
        depth = len(prefix)
        if depth == len(axes):
            return placed[prefix]
        n = 1 + max(k[depth] for k in placed if k[:depth] == prefix)
        return np.concatenate([build(prefix + (i,)) for i in range(n)],
                              axis=axis_dims[axes[depth]])

    return build(())


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_against_the_reference(probes, causal):
    """Over a ring of four: the output and dQ, dK, dV of sum(out * g)
    against the reference's ring_attention (and its reference_attention,
    and the port's own) on the whole sequence."""
    inp = ranks.probe_inputs("ring")
    mesh = jax_make_mesh(**ranks.RING_MESH, devices=jax.devices()[:N])
    coords = [p["ring"]["coords"] for p in probes]

    def loss(q, k, v):
        out = jax_ring_attention(q, k, v, mesh, causal=causal)
        return (out * inp["g"]).sum(), out

    args = tuple(jnp.asarray(inp[n]) for n in ("q", "k", "v"))
    (_, want), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(*args)
    want, grads = np.asarray(want), [np.asarray(g) for g in grads]
    got = {n: _assemble([p["ring"][causal][n] for p in probes], coords, {"sp": 1})
           for n in ("out", "dq", "dk", "dv")}
    assert np.abs(got["out"] - want).max() <= FWD_TOL
    plain = np.asarray(jax_reference_attention(*args, causal=causal))
    assert np.abs(got["out"] - plain).max() <= FWD_TOL
    ours = reference_attention(*(torch.from_numpy(inp[n]) for n in ("q", "k", "v")),
                               causal=causal).numpy()
    assert np.abs(ours - plain).max() <= FWD_TOL
    for name, g in zip(("dq", "dk", "dv"), grads):
        assert _rel(got[name], g) <= GRAD_TOL, name


def test_pipeline_against_the_sequential_stack(probes):
    """Two stages, each stage's rows split over dp: the output, dx and the
    stage weights' gradients against the reference's pipeline_apply and
    the stages applied one after the other."""
    inp = ranks.probe_inputs("pipe")
    mesh = jax_make_mesh(**ranks.PIPE_MESH, devices=jax.devices()[:N])

    def block(stage, x):
        h = jax.nn.gelu(jnp.einsum("bsd,df->bsf", x, stage["w1"]))
        return x + jnp.einsum("bsf,fd->bsd", h, stage["w2"])

    def run(x, w1, w2):
        return jax_pipeline_apply({"w1": w1, "w2": w2}, x, mesh, ranks.PIPE_MICROBATCHES, block)

    def loss(*a):
        out = run(*a)
        return (out * inp["g"]).sum(), out

    args = tuple(jnp.asarray(inp[n]) for n in ("x", "w1", "w2"))
    (_, want), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(*args)
    want = np.asarray(want)
    sequential = args[0]
    for s in range(2):
        sequential = block({"w1": args[1][s], "w2": args[2][s]}, sequential)
    assert np.abs(want - np.asarray(sequential)).max() <= FWD_TOL
    coords = [p["pipe"]["coords"] for p in probes]
    for name in ("out", "dx"):
        got = _assemble([p["pipe"][name] for p in probes], coords, {"dp": 0})
        if name == "out":
            assert np.abs(got - want).max() <= FWD_TOL
        else:
            assert _rel(got, grads[0]) <= GRAD_TOL
    for name, g in (("w1", grads[1]), ("w2", grads[2])):
        got = _assemble([p["pipe"][name] for p in probes], coords, {"pp": 0})
        assert _rel(got, g) <= GRAD_TOL, name


@pytest.mark.parametrize("name", sorted(ranks.MOE_MESHES))
def test_moe_with_drops_against_the_reference(probes, name):
    """Tokens split over dp x sp (or dp, with the experts over ep), at a
    capacity that drops tokens on more than one rank: the same routing,
    then the output, the aux loss and the gradients of sum(out * g) + aux
    against the reference's moe_mlp on all the tokens."""
    inp = ranks.probe_inputs("moe")
    results = [p["moe"][name] for p in probes]
    coords = [r["coords"] for r in results]
    split = {"dp": 0, "sp": 1}
    idx, keep = _jax_routing(jnp.asarray(inp["x"]), jnp.asarray(inp["router"]),
                             ranks.MOE_CAPACITY_FACTOR)
    np.testing.assert_array_equal(_assemble([r["expert_idx"] for r in results], coords, split),
                                  idx)
    np.testing.assert_array_equal(_assemble([r["keep"] for r in results], coords, split), keep)
    assert sum(not r["keep"].all() for r in results) > 1

    def run(x, router, w1, w2):
        return jax_moe_mlp(x, router, w1, w2, capacity_factor=ranks.MOE_CAPACITY_FACTOR)

    def loss(*a):
        y, aux = run(*a)
        return (y * inp["g"]).sum() + aux, (y, aux)

    args = tuple(jnp.asarray(inp[n]) for n in ("x", "router", "w1", "w2"))
    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                                        has_aux=True))(*args)
    assert np.abs(_assemble([r["out"] for r in results], coords, split)
                  - np.asarray(out)).max() <= FWD_TOL
    assert all(abs(r["aux"] - float(aux)) <= FWD_TOL for r in results)
    assert _rel(_assemble([r["dx"] for r in results], coords, split), grads[0]) <= GRAD_TOL
    assert all(_rel(r["drouter"], grads[1]) <= GRAD_TOL for r in results)
    for key, g in (("dw1", grads[2]), ("dw2", grads[3])):
        got = _assemble([r[key] for r in results], coords, {"ep": 0})
        assert _rel(got, g) <= GRAD_TOL, key


# -- the mesh -------------------------------------------------------------------


def test_shard_cuts_as_the_specs_say():
    """`shard`, `shard_batch` and `data_parallel_sharding` on rank 7 of a
    (2, 1, 2, 2, 1) mesh (dp 1, tp 1, sp 1), and `replicate` with one
    process (the tree itself)."""
    mesh = port_mesh.Mesh((2, 1, 2, 2, 1), 7, {})
    assert mesh.coords == {"dp": 1, "pp": 0, "tp": 1, "sp": 1, "ep": 0}
    x = np.arange(4 * 6 * 8).reshape(4, 6, 8)
    np.testing.assert_array_equal(port_mesh.shard(mesh, x, (None, "tp")), x[:, 3:])
    np.testing.assert_array_equal(port_mesh.shard(mesh, x, ("dp", "sp")), x[2:, 3:])
    np.testing.assert_array_equal(port_mesh.shard(mesh, x, (None, None, ("tp", "sp"))),
                                  x[:, :, 6:])
    batch_spec, replicated = port_mesh.data_parallel_sharding(mesh)
    np.testing.assert_array_equal(port_mesh.shard(mesh, x, replicated), x)
    got = port_mesh.shard_batch(mesh, {"a": torch.from_numpy(x), "b": [x]})
    assert torch.equal(got["a"], torch.from_numpy(x[2:])) and (got["b"][0] == x[2:]).all()
    assert batch_spec == ("dp",) and mesh.rank_at(dp=0) == 3
    with pytest.raises(ValueError):
        port_mesh.shard(mesh, x[:3], ("dp",))
    tree = {"w": torch.ones(2)}
    assert port_mesh.replicate(mesh, tree)["w"] is tree["w"]



@pytest.mark.parametrize("n,sizes", [
    (4, dict(dp=3)), (4, dict(tp=3)), (8, dict(dp=2, tp=2)), (4, dict(dp=1, tp=2, sp=2)),
    (8, dict(pp=2, ep=2)), (8, dict(batch_size=6)), (8, dict(tp=2, batch_size=6)),
    (6, dict(sp=2, batch_size=4)),
])
def test_mesh_shape_mirrors_the_references_asserts(n, sizes):
    """A shape that does not cover the ranks fails as the reference's
    make_mesh fails; otherwise both give the same axis sizes (the batch
    size capping dp at the largest divisor, the rest left out)."""
    try:
        want = jax_make_mesh(devices=jax.devices()[:n], **sizes).shape
    except AssertionError:
        with pytest.raises(AssertionError):
            port_mesh.mesh_shape(n, **sizes)
        return
    assert port_mesh.mesh_shape(n, **sizes) == tuple(want[a] for a in port_mesh.AXES)
