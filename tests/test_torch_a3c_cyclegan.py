"""The port's A3C and CycleGAN workloads against the JAX package's, on the
CPU.

A3C: the environment's observation and transition equal the
reference's exactly, with the reference's own reset draws fed in (the
port cannot replay threefry); `ActorCritic` with the weights carried by
`convert.a3c_flax_to_state_dict` within 1e-5; one update on the same
trajectory against the reference's `loss_fn` (loss and gradients within
1e-5 relative, parameters after Adam within 1e-6); `rl/main.py` under a
lease with a resume.

CycleGAN: `ConvTranspose` against flax's on the same kernel (the padding
trap); `Generator` and `Discriminator` in f32 and bf16; two steps of
`build_step` against the reference's; the unpaired loaders;
`cyclegan.py` under a lease with a resume (small widths).

Then the card's twins (`cuda` marker): one A3C and one CycleGAN job
dispatched by the real scheduler to the port's daemon, at the trace's
commands. On the card: `python -m pytest --noconftest -m cuda
tests/test_torch_a3c_cyclegan.py -s`.
"""
import functools
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

try:  # the card's machine runs only the `cuda` test, and need not have JAX
    import jax
    import jax.numpy as jnp
    import optax

    from shockwave_tpu.models import a3c as jax_a3c
    from shockwave_tpu.models import data as jax_data
    from shockwave_tpu.models.cyclegan import Discriminator as FlaxDiscriminator
    from shockwave_tpu.models.cyclegan import Generator as FlaxGenerator
    from shockwave_tpu.workloads.cyclegan.cyclegan import build_step as jax_build_step
except ImportError:
    jax = None
from shockwave_tpu_torch import convert
from shockwave_tpu_torch.models import a3c, data
from shockwave_tpu_torch.models.cyclegan import ConvTranspose, Discriminator, Generator
from shockwave_tpu_torch.workloads.cyclegan import cyclegan
from shockwave_tpu_torch.workloads.rl import main as rl_main

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LR = 2e-4


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def numpy_params(module, x, seed=0):
    """A flax parameter tree for `module` on input `x`, drawn with numpy:
    kernels normal over their fan-in, biases and norm offsets normal(0.1),
    norm scales 1 + normal(0.1). Only the shapes come from flax
    (`eval_shape`): compiling its initializers costs seconds a model."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)["params"]

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rs.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape).astype(np.float32)
        return ((name == "scale") + 0.1 * rs.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_env(state):
    return a3c.EnvState(*(torch.from_numpy(np.array(x)).long() for x in
                          (state.ball_y, state.ball_x, state.ball_dx, state.paddle_x)))


def jax_reset_draws(state):
    """The column and dx the reference's env_step draws from each
    environment's key (its auto-reset)."""
    keys = jax.vmap(lambda k: jax.random.split(k, 3))(state.rng)
    col = jax.vmap(lambda k: jax.random.randint(k, (), 0, jax_a3c.GRID_W))(keys[:, 0])
    dx = jax.vmap(lambda k: jax.random.randint(k, (), -1, 2))(keys[:, 1])
    return col, dx


# ---------------------------------------------------------------------------
# A3C.
# ---------------------------------------------------------------------------

def test_env_observe_and_step_equal_the_references():
    """60 steps of 8 environments (several episodes each) under random
    actions: every observation, reward, done and state equal exactly."""
    state = jax_a3c.env_reset(jax.random.PRNGKey(5), 8)
    ours = port_env(state)
    observe, env_step, draws = (jax.jit(f) for f in (jax_a3c.env_observe, jax_a3c.env_step,
                                                      jax_reset_draws))
    actions = np.random.RandomState(0).randint(0, 3, (60, 8))
    dones = 0
    for action in actions:
        assert np.array_equal(a3c.env_observe(ours).numpy(), np.asarray(observe(state)))
        col, dx = (torch.from_numpy(np.array(x)).long() for x in draws(state))
        state, reward, done = env_step(state, jnp.asarray(action, jnp.int32))
        ours, our_reward, our_done = a3c.env_step(ours, torch.from_numpy(action), col, dx)
        assert np.array_equal(our_reward.numpy(), np.asarray(reward))
        assert np.array_equal(our_done.numpy(), np.asarray(done))
        for field in ("ball_y", "ball_x", "ball_dx", "paddle_x"):
            assert np.array_equal(getattr(ours, field).numpy(), np.asarray(getattr(state, field)))
        dones += int(np.asarray(done).sum())
    assert dones >= 8 * 3


def flax_actor_critic(seed=0, batch=4):
    key = jax.random.PRNGKey(seed)
    state = jax_a3c.env_reset(key, batch)
    model = jax_a3c.ActorCritic()
    params = numpy_params(model, jax_a3c.env_observe(state), seed)
    ours = a3c.ActorCritic()
    ours.load_state_dict(convert.a3c_flax_to_state_dict(numpy_tree(params)))
    return model, params, ours, state


def test_actor_critic_matches_within_1e_5():
    model, params, ours, state = flax_actor_critic()
    obs = np.random.RandomState(1).rand(6, 16, 16, 2).astype(np.float32)
    logits, value = model.apply({"params": params}, obs)
    our_logits, our_value = ours(torch.from_numpy(obs))
    np.testing.assert_allclose(our_logits.detach().numpy(), np.asarray(logits), atol=1e-5)
    np.testing.assert_allclose(our_value.detach().numpy(), np.asarray(value), atol=1e-5)


def reference_loss_fn(model, tx):
    """The reference's `loss_fn`, from the closure of the update that
    `build_a3c_update` builds (the JAX package keeps it inside)."""
    update = jax_a3c.build_a3c_update(model, tx).__wrapped__
    cells = dict(zip(update.__code__.co_freevars, (c.cell_contents for c in update.__closure__)))
    return cells["loss_fn"]


def test_one_update_matches_the_references_loss_fn():
    """The same 20 x 4 trajectory (the environment, which equals the
    reference's, under random actions and resets, with the values of
    the converted model) and last value through the reference's
    `loss_fn` and the port's `a3c_loss`, then one Adam step: loss and
    every gradient within 1e-5 relative (to the gradient's largest
    element), the parameters after Adam within 1e-6."""
    model, params, ours, state = flax_actor_critic(seed=2)
    tx = optax.adam(1e-4)
    rng = np.random.RandomState(3)
    env = port_env(state)
    steps = []
    with torch.no_grad():
        for _ in range(20):
            obs = a3c.env_observe(env)
            _, value = ours(obs)
            action = torch.from_numpy(rng.randint(0, 3, 4))
            col, dx = (torch.from_numpy(rng.randint(lo, hi, 4)) for lo, hi in ((0, 16), (-1, 2)))
            env, reward, done = a3c.env_step(env, action, col, dx)
            steps.append((obs, action, reward, done, value))
        _, last_value = ours(a3c.env_observe(env))
    torch_traj = tuple(torch.stack(x) for x in zip(*steps))
    traj = tuple(jnp.asarray(x.numpy()) for x in torch_traj)
    traj = (traj[0], traj[1].astype(jnp.int32)) + traj[2:]

    loss_fn = reference_loss_fn(model, tx)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, traj, jnp.asarray(last_value.numpy()))
    updates, _ = tx.update(grads, tx.init(params), params)
    want_params = convert.a3c_flax_to_state_dict(numpy_tree(optax.apply_updates(params, updates)))
    want_grads = convert.a3c_flax_to_state_dict(numpy_tree(grads))

    optimizer = torch.optim.Adam(ours.parameters(), lr=1e-4)
    our_loss, _ = a3c.a3c_loss(ours, torch_traj, last_value)
    our_loss.backward()
    assert abs(float(our_loss.detach()) - float(loss)) <= 1e-5 * abs(float(loss))
    for name, p in ours.named_parameters():
        scale = float(want_grads[name].abs().max())
        assert float((p.grad - want_grads[name]).abs().max()) <= 1e-5 * max(scale, 1e-12), name
    optimizer.step()
    for name, p in ours.named_parameters():
        assert float((p.detach() - want_params[name]).abs().max()) <= 1e-6, name


@pytest.fixture
def stub_scheduler(monkeypatch):
    """A stub scheduler that grants each InitJob `grant[0]` steps and
    keeps the grant on renewal; the lease env points at it."""
    from shockwave_tpu.runtime.servers import serve_scheduler
    grant = [0]
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    server = serve_scheduler(port, {
        "RegisterWorker": lambda **kw: ([0], 60.0), "Done": lambda *a: None,
        "InitJob": lambda job_id: (grant[0], 1e6, 0.0),
        "UpdateLease": lambda job_id, worker_id, steps, duration, max_steps,
        max_duration, measured_reports=None: (int(max_steps), float(max_duration), 0.0, 1e9),
        "UpdateResourceRequirement": lambda *a: None})
    for key, value in {"SWTPU_JOB_ID": "0", "SWTPU_WORKER_ID": "0", "SWTPU_ROUND_ID": "0",
                       "SWTPU_SCHED_ADDR": "localhost", "SWTPU_SCHED_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)
    yield grant
    server.stop(grace=0)


def leased(main, argv, tmp_path, round_id, monkeypatch, capsys):
    """One in-process dispatch of `main` under the stub's lease; returns
    (job, stdout, the iterator log's last [PROGRESS] steps)."""
    import re
    monkeypatch.setenv("SWTPU_ROUND_ID", str(round_id))
    job = main(argv + ["--device", "cpu", "--enable_lease_iterator",
                       "--checkpoint_dir", str(tmp_path), "--throughput_estimation_interval", "2"])
    out = capsys.readouterr().out
    log = (tmp_path / ".swtpu" / f"round={round_id}" / "worker=0.log").read_text()
    return job, out, int(re.findall(r"\[PROGRESS\] \[STEPS\] (\d+)", log)[-1])


def test_rl_main_runs_exactly_the_granted_ticks_and_resumes(stub_scheduler, tmp_path,
                                                            monkeypatch, capsys):
    argv = ["--env", "PongDeterministic-v4", "--workers", "4", "--amsgrad", "True",
            "--max-steps", "10"]
    stub_scheduler[0] = 6
    job, out, reported = leased(rl_main.main, argv, tmp_path, 0, monkeypatch, capsys)
    assert "TRAINED 6 steps (cumulative 6)" in out and reported == 6 and job.step == 6
    assert np.isfinite(float(job.last_metrics["loss"]))
    from shockwave_tpu_torch.models.train_common import load_checkpoint
    state = load_checkpoint(str(tmp_path / "model.ckpt"), torch.device("cpu"))
    assert state["step"] == 6 and torch.equal(state["rng"], job.gen.get_state())

    stub_scheduler[0] = 4
    resumed, out, reported = leased(rl_main.main, argv, tmp_path, 1, monkeypatch, capsys)
    assert "TRAINED 4 steps (cumulative 10)" in out and reported == 4 and resumed.step == 10
    # The resumed run starts from the saved weights and generator.
    fresh = rl_main.A3CJob(rl_main.build_job(argv + ["--device", "cpu"])[2], torch.device("cpu"))
    fresh.restore(state)
    assert torch.equal(fresh.gen.get_state(), state["rng"])


# ---------------------------------------------------------------------------
# CycleGAN.
# ---------------------------------------------------------------------------

def test_conv_transpose_is_flaxs_same_padding():
    """flax's ConvTranspose((3, 3), strides=2, padding="SAME") on odd and
    even sizes equals the port's ConvTranspose with the converted kernel
    within 1e-5 (f32), and equals conv_transpose2d of the flipped kernel
    cropped by one row and column, not padding=1 with output_padding=1."""
    import flax.linen as nn
    import torch.nn.functional as F
    rs = np.random.RandomState(0)
    for h, w in ((8, 8), (5, 7)):
        x = rs.randn(2, h, w, 6).astype(np.float32)
        layer = nn.ConvTranspose(4, (3, 3), strides=(2, 2), padding="SAME")
        params = {"params": numpy_params(layer, x)}
        want = np.asarray(layer.apply(params, x))
        assert want.shape == (2, 2 * h, 2 * w, 4)
        ours = ConvTranspose(6, 4, dtype=torch.float32)
        converted = convert.cyclegan_flax_to_state_dict(
            {"ConvTranspose_0": numpy_tree(params["params"])})
        ours.load_state_dict({k.removeprefix("ups.0."): v for k, v in converted.items()})
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
        kernel = torch.from_numpy(np.asarray(params["params"]["kernel"]))
        bias = torch.from_numpy(np.asarray(params["params"]["bias"]))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        formula = F.conv_transpose2d(xt, kernel.permute(2, 3, 0, 1).flip(2, 3), bias, stride=2)
        np.testing.assert_allclose(formula[..., :-1, :-1].permute(0, 2, 3, 1).numpy(), want, atol=1e-5)
        torch_habit = F.conv_transpose2d(xt, kernel.permute(2, 3, 0, 1).flip(2, 3), bias,
                                         stride=2, padding=1, output_padding=1)
        assert torch_habit.shape == formula[..., :-1, :-1].shape
        assert float((torch_habit.permute(0, 2, 3, 1) - torch.from_numpy(want)).abs().max()) > 1e-2


@functools.lru_cache(maxsize=None)
def flax_cyclegan(dtype, size=32):
    """flax's Generator (8 features, 1 block) and Discriminator and their
    parameters, initialised once per dtype for the whole file."""
    x = np.zeros((1, size, size, 3), np.float32)
    gen = FlaxGenerator(base_features=8, num_blocks=1, dtype=dtype)
    disc = FlaxDiscriminator(base_features=8, dtype=dtype)
    return gen, numpy_params(gen, x, 1), disc, numpy_params(disc, x, 2)


def port_pair(g_params, d_params, dtype):
    g = Generator(base_features=8, num_blocks=1, dtype=dtype)
    g.load_state_dict(convert.cyclegan_flax_to_state_dict(numpy_tree(g_params)))
    d = Discriminator(base_features=8, dtype=dtype)
    d.load_state_dict(convert.cyclegan_flax_to_state_dict(numpy_tree(d_params)))
    return g, d


# Generator and Discriminator against flax on the same images, (max abs,
# mean abs) error: f32 within (1e-4, 1e-5); bf16 within (1e-1, 1e-2).
# XLA's CPU backend computes flax's bf16 layers in f32 (its outputs equal
# the f32 model's here), while the port rounds every layer's output to
# bf16, as the card does: the bf16 case holds the port's own rounding
# against an f32 computation. An ulp is 2^-8 at 1; nine normalised layers
# add about 1.3 ulps on average and up to 12 at the worst element.
@pytest.mark.parametrize("dtype,tol", [("float32", (1e-4, 1e-5)), ("bfloat16", (1e-1, 1e-2))],
                         ids=["f32", "bf16"])
def test_generator_and_discriminator_match(dtype, tol):
    x = (np.random.RandomState(0).rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    gen, g_params, disc, d_params = flax_cyclegan(getattr(jnp, dtype))
    g, d = port_pair(g_params, d_params, getattr(torch, dtype))
    with torch.no_grad():
        fake = g(torch.from_numpy(x))
        patches = d(torch.from_numpy(x))
    assert fake.dtype == patches.dtype == torch.float32
    assert fake.shape == (2, 32, 32, 3) and patches.shape == (2, 4, 4, 1)
    for ours, want in ((fake, jax.jit(gen.apply)({"params": g_params}, x)),
                       (patches, jax.jit(disc.apply)({"params": d_params}, x))):
        err = np.abs(ours.numpy() - np.asarray(want))
        assert err.max() <= tol[0] and err.mean() <= tol[1], (err.max(), err.mean())


def zero_gradient_bias(model_name, key):
    """A conv bias that an InstanceNorm follows: its gradient is zero in
    exact arithmetic, so Adam moves it by rounding noise in both."""
    if not key.endswith("bias") or "norms" in key:
        return False
    last = ("convs.3.bias",) if model_name.startswith("g") else ("convs.0.bias", "convs.4.bias")
    return key not in last


def test_two_build_step_steps_match_the_references():
    """Two steps of the reference's `build_step` and the port's, in f32,
    from one draw per pair as the mains make it: g_loss and d_loss within
    1e-5 relative; the parameters within 1e-5, except the conv biases an
    InstanceNorm follows (zero gradient, see `zero_gradient_bias`), which
    may differ by no more than Adam's bound on two steps, 2 steps x 2 lr."""
    rs = np.random.RandomState(0)
    real_a = (rs.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    real_b = (rs.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    gen, g_params, disc, d_params = flax_cyclegan(jnp.float32)
    copy = functools.partial(jax.tree_util.tree_map, jnp.copy)
    init = numpy_tree({"g_ab": g_params, "g_ba": g_params, "d_a": d_params, "d_b": d_params})
    g_tx, d_tx = optax.adam(LR, b1=0.5), optax.adam(LR, b1=0.5)
    state = {"g_params": {"g_ab": g_params, "g_ba": copy(g_params)},
             "d_params": {"d_a": d_params, "d_b": copy(d_params)}}
    state.update(g_opt=g_tx.init(state["g_params"]), d_opt=d_tx.init(state["d_params"]),
                 step=jnp.zeros((), jnp.int32))
    step = jax_build_step((gen, gen, disc, disc), g_tx, d_tx)

    models = {name: port_pair(g_params, d_params, torch.float32)[0 if name[0] == "g" else 1]
              for name in ("g_ab", "g_ba", "d_a", "d_b")}
    g_opt = torch.optim.Adam([*models["g_ab"].parameters(), *models["g_ba"].parameters()],
                             lr=LR, betas=(0.5, 0.999))
    d_opt = torch.optim.Adam([*models["d_a"].parameters(), *models["d_b"].parameters()],
                             lr=LR, betas=(0.5, 0.999))
    ours = cyclegan.build_step(tuple(models.values()), g_opt, d_opt)
    for _ in range(2):
        state, metrics = step(state, real_a, real_b)
        our = ours(torch.from_numpy(real_a), torch.from_numpy(real_b))
        for key in ("g_loss", "d_loss"):
            want = float(metrics[key])
            assert abs(float(our[key]) - want) <= 1e-5 * abs(want), key
    final = numpy_tree(state)
    for name, model in models.items():
        want = convert.cyclegan_flax_to_state_dict(final[f"{name[0]}_params"][name])
        for key, value in model.state_dict().items():
            err = float((value - want[key]).abs().max())
            assert err <= (2 * 2 * LR if zero_gradient_bias(name, key) else 1e-5), (name, key, err)


def test_unpaired_batches_and_monet2photo_order_the_references(tmp_path):
    rs = np.random.RandomState(0)
    a = rs.rand(9, 6, 6, 3).astype(np.float32)
    b = rs.rand(7, 6, 6, 3).astype(np.float32)

    def same(ours, ref):
        ours, ref = list(ours), list(ref)
        assert len(ours) == len(ref) > 0
        for (x, y), (u, v) in zip(ours, ref):
            assert np.array_equal(x, u) and np.array_equal(y, v)

    for epoch_loader in ((data.UnpairedBatches(a, b, 2, 6, seed=3),
                          jax_data.UnpairedBatches(a, b, 2, 6, seed=3)),):
        same(*epoch_loader)
        same(*epoch_loader)  # the second epoch reshuffles alike
    # monet2photo.npz, stored as uint8 and resized to the image size.
    np.savez(tmp_path / "monet2photo.npz", A=(a * 255).astype(np.uint8),
             B=(b * 255).astype(np.uint8))
    same(data.monet2photo(2, 4, data_dir=str(tmp_path), seed=1),
         jax_data.monet2photo(2, 4, data_dir=str(tmp_path), seed=1))
    # trainA/ and trainB/ image folders, decoded per batch.
    from PIL import Image
    for domain, images in (("trainA", a), ("trainB", b)):
        (tmp_path / "folders" / domain).mkdir(parents=True)
        for i, image in enumerate(images[:5]):
            Image.fromarray((image * 255).astype(np.uint8)).save(
                tmp_path / "folders" / domain / f"{i}.png")
    same(data.monet2photo(2, 6, data_dir=str(tmp_path / "folders"), seed=2),
         jax_data.monet2photo(2, 6, data_dir=str(tmp_path / "folders"), seed=2))
    # No data: the synthetic fallback.
    ours, ref = data.monet2photo(1, 8, seed=4), jax_data.monet2photo(1, 8, seed=4)
    assert len(ours) == len(ref) and ours.synthetic
    same([next(iter(ours))], [next(iter(ref))])


def test_cyclegan_main_runs_the_granted_steps_and_resumes(stub_scheduler, tmp_path,
                                                          monkeypatch, capsys):
    """The trace's command (small widths, 32 x 32) under a lease of 2
    steps, then a resume granted 1 more to the budget of 3."""
    monkeypatch.setattr(cyclegan, "Generator",
                        functools.partial(Generator, base_features=8, num_blocks=1))
    monkeypatch.setattr(cyclegan, "Discriminator", functools.partial(Discriminator, base_features=8))
    argv = ["--dataset_path", str(tmp_path / "monet2photo"), "--decay_epoch", "0",
            "--img_size", "32", "--n_steps", "3"]
    stub_scheduler[0] = 2
    job, out, reported = leased(cyclegan.main, argv, tmp_path, 0, monkeypatch, capsys)
    assert "TRAINED 2 steps (cumulative 2)" in out and reported == 2 and job.step == 2
    metrics = job.last_metrics
    assert np.isfinite(float(metrics["g_loss"])) and np.isfinite(float(metrics["d_loss"]))
    stub_scheduler[0] = 1
    resumed, out, reported = leased(cyclegan.main, argv, tmp_path, 1, monkeypatch, capsys)
    assert "TRAINED 1 steps (cumulative 3)" in out and reported == 1 and resumed.step == 3


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_h100_daemon_runs_a3c_and_cyclegan(tmp_path):
    """The real scheduler dispatches one A3C job (the trace's command,
    300 ticks) and one CycleGAN job (the trace's command, 60 steps) to
    the port's daemon on the card; both complete with exact
    `total_steps_run`, planned from data/h100_throughputs.json."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from shockwave_tpu.core.job import Job
    from shockwave_tpu.core.job_table import a3c as a3c_template
    from shockwave_tpu.core.job_table import cyclegan as cyclegan_template
    from shockwave_tpu.sched.physical import PhysicalScheduler
    from shockwave_tpu.sched.scheduler import SchedulerConfig
    from shockwave_tpu.solver import get_policy
    from shockwave_tpu_torch.runtime.worker import WorkerDaemon

    def free_port():
        with socket.socket() as s:
            s.bind(("", 0))
            return s.getsockname()[1]

    sched_port, worker_port = free_port(), free_port()
    sched = PhysicalScheduler(
        get_policy("max_min_fairness"),
        throughputs_file=os.path.join(REPO, "data", "h100_throughputs.json"),
        config=SchedulerConfig(time_per_iteration=20.0, max_rounds=40),
        expected_num_workers=1, port=sched_port)
    workloads = os.path.join(REPO, "shockwave_tpu_torch", "workloads")
    daemon = WorkerDaemon(
        worker_type="h100", sched_addr="127.0.0.1", sched_port=sched_port,
        worker_port=worker_port, num_chips=1,
        run_dirs={mode: workloads for mode in ("static", "accordion", "gns", "serving")},
        data_dir=str(tmp_path / "data"), checkpoint_dir=str(tmp_path / "ckpt"))
    budgets = {}
    for template, steps in ((a3c_template(), 300), (cyclegan_template(), 60)):
        job_id = sched.add_job(Job(None, template.model, template.command,
                                   template.working_directory, template.num_steps_arg,
                                   total_steps=steps, duration=100000,
                                   needs_data_dir=template.needs_data_dir))
        budgets[job_id] = steps
    runner = threading.Thread(target=sched.run, daemon=True)
    runner.start()
    start = time.time()
    try:
        while time.time() < start + 600 and len(sched._completed_jobs) < len(budgets):
            time.sleep(0.5)
        assert len(sched._completed_jobs) == len(budgets), "the jobs did not complete"
    finally:
        sched._done_event.set()
        daemon._shutdown()
        daemon.join()
        sched.shutdown()
        sched._server.stop(grace=0)
    for job_id, steps in budgets.items():
        assert sched.acct.total_steps_run[job_id] == steps
    print("h100_a3c_cyclegan:", {str(j): s for j, s in budgets.items()},
          "wall_s", time.time() - start, file=sys.stderr)
