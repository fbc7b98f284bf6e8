"""The port's data-parallel gangs over torch.distributed, on the CPU.

Gang members are this file run as a script (the `__main__` block at the
end), one process per rank, joined over gloo with one torch thread each.

- Two-rank gangs of the small Transformer (target padding ragged, so the
  two ranks' token counts differ), ResNet-18 and the LM take two
  SGD-momentum steps, in `gns` mode, each rank on its half of one seeded
  global batch. They are held against the JAX package's `Trainer` (one
  process, the global batch, weights carried over by `convert.py`) at
  the tolerances `test_torch_train.py` and `test_torch_families.py`
  state, against the port's own one-process step on the global batch
  within f32 rounding, and the two ranks against each other bit for bit.
- GNS's small-batch norm is the reference's norm over the first half of
  the global batch (`B // n_dev` rows).
- The collective backend rule, on a fake store.
- The gang hooks of the port's `LeaseIterator` against the reference's,
  under one fake clock and one fake `gang_allreduce`.
- The JAX package's real `PhysicalScheduler` and the port's daemon with
  two chips run an sf = 2 ResNet-18 job and an sf = 1 job to exact
  `total_steps_run`, both ranks of each dispatch ending at the same step.
"""
import functools
import os
import re
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
THIS_FILE = os.path.abspath(__file__)
GANG = 2
STEPS = 2
# The port's gang against its own one-process step on the global batch:
# the same operations but for the order of the sums (each rank sums its
# half, then the all-reduce adds the halves) and BatchNorm's float64
# statistics from per-rank two-pass moments. f32 rounding: the loss and
# the norms within 1e-5 relative, the running statistics within 1e-5 of
# their scale, and every parameter within 1e-6 absolute (steps of at most
# lr x |g|, rounded in f32; test_torch_train.py's PARAM_ATOL).
PORT_RTOL, PORT_ATOL = 1e-5, 1e-6


def free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


# -- the cases ----------------------------------------------------------------


def transformer_case(rng):
    """test_torch_train.py's small Transformer on a batch of 4 whose
    first two rows (rank 0) carry 12 and 5 target tokens and whose last
    two (rank 1) carry 32 each."""
    import jax
    import jax.numpy as jnp
    import optax

    from shockwave_tpu.models.transformer import Seq2SeqTransformer as FlaxSeq2Seq
    from shockwave_tpu_torch.convert import flax_to_state_dict
    from shockwave_tpu_torch.models.transformer import Seq2SeqTransformer
    from shockwave_tpu_torch.workloads.translation import train
    from test_torch_train import KW, LOSS_RTOL, GSQ_RTOL, PARAM_ATOL

    src = rng.randint(1, 64, (4, 32)).astype(np.int32)
    tgt = rng.randint(1, 64, (4, 33)).astype(np.int32)
    src[1, 24:] = 0
    tgt[0, 13:] = 0
    tgt[1, 6:] = 0
    flax_model = FlaxSeq2Seq(**KW, dtype=jnp.float32)
    variables = flax_model.init(jax.random.PRNGKey(0), src, tgt[:, :-1])

    def jax_loss(params, state, src_tokens, tgt_tokens):
        logits = flax_model.apply({"params": params}, src_tokens, tgt_tokens[:, :-1])
        targets = tgt_tokens[:, 1:]
        mask = (targets != 0).astype(jnp.float32)
        losses = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
        return (losses * mask).sum() / jnp.maximum(mask.sum(), 1.0), {}

    return dict(variables=variables, batch=(src, tgt), jax_loss=jax_loss,
                model=Seq2SeqTransformer(**KW, dtype=torch.float32, use_flash=False),
                loss_fn=train.loss_fn, lr=1e-3,
                tol=dict(loss=LOSS_RTOL, gsq=GSQ_RTOL, atol=PARAM_ATOL),
                to_sd=lambda v: flax_to_state_dict(v["params"]))


def family_case(name):
    def make(rng):
        import test_torch_families as families
        if name == "lm":
            return families.lm_case(rng)
        return families.resnet18_case(rng, "f32")
    return make


CASES = {"transformer": transformer_case, "resnet18": family_case("resnet18_f32"),
         "lm": family_case("lm")}


def as_numpy(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def port_model(case):
    model = case["model"]
    model.load_state_dict(case["to_sd"](as_numpy(case["variables"])))
    return model


# -- the gang run, shared by the parity tests ------------------------------------


def spawn_gang(argv_of_rank, env=None):
    """One process per rank, this file as the script; returns the
    processes."""
    child_env = dict(os.environ, **(env or {}))
    child_env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.dirname(THIS_FILE)])
    return [subprocess.Popen([sys.executable, THIS_FILE, *argv_of_rank(rank)], cwd=REPO,
                             env=child_env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for rank in range(GANG)]


def wait_all(procs, timeout):
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-3000:]
    return outs


@pytest.fixture(scope="module")
def gang_run(tmp_path_factory):
    """Every case's two gang steps, per rank: the metrics of each step
    and the state after them."""
    work = tmp_path_factory.mktemp("gang")
    inputs = {}
    for name, make in CASES.items():
        case = make(np.random.RandomState(0))
        inputs[name] = {"model": port_model(case), "batch": case["batch"],
                        "lr": case["lr"],
                        "loss_fn": (case["loss_fn"].__module__, case["loss_fn"].__name__)}
    torch.save(inputs, work / "inputs.pt")
    port = free_port()
    outs = wait_all(spawn_gang(lambda rank: [
        "member", str(rank), str(port), str(work / "inputs.pt"), str(work / f"rank{rank}.pt")]),
        timeout=240)
    assert all("backend gloo, device cpu" in out for out in outs), outs
    return [torch.load(work / f"rank{rank}.pt", weights_only=False) for rank in range(GANG)]


@functools.lru_cache(maxsize=None)
def reference(family):
    return jax_reference(CASES[family](np.random.RandomState(0)))


def jax_reference(case):
    """The JAX package's Trainer (one process, the global batch) for two
    steps: each step's metrics, the first-half (rank 0) small-batch norm
    at each step's parameters, and the state after the two steps."""
    import jax
    import jax.numpy as jnp
    import optax

    from shockwave_tpu.models import train_common as jax_train_common
    args = types.SimpleNamespace(coordinator=None, num_processes=None, process_id=None)
    batch = case["batch"]
    b = batch[0].shape[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train_common, "enable_compile_cache", lambda *a: None)
        trainer = jax_train_common.Trainer(
            args, case["jax_loss"], jax.tree_util.tree_map(jnp.array, dict(case["variables"])),
            None, mode="static", initial_bs=b, learning_rate=case["lr"])

    @jax.jit
    def small_norm_sq(params, state):
        small = [x[: b // GANG] for x in batch]
        grads = jax.grad(lambda p: case["jax_loss"](p, state, *small)[0])(params)
        return optax.global_norm(grads) ** 2

    state, metrics = trainer.state, []
    for _ in range(STEPS):
        small = float(small_norm_sq(state["params"], state))
        state, m = trainer.train_step(state, *jax.device_put(batch, trainer.batch_sharding))
        metrics.append({"loss": float(m["loss"]), "grad_norm_sq": float(m["grad_norm_sq"]),
                        "grad_norm_sq_small": small})
    return as_numpy(state), metrics


def port_one_process(case):
    """The port's Trainer, one process, the global batch, n_dev = 2 (its
    second backward over the first half gives the small norm)."""
    from shockwave_tpu_torch.models import train_common
    trainer = train_common.Trainer(types.SimpleNamespace(), case["loss_fn"], port_model(case),
                                   None, torch.device("cpu"), learning_rate=case["lr"],
                                   mode="gns", initial_bs=case["batch"][0].shape[0], n_dev=GANG)
    batch = tuple(train_common.upload(x, torch.device("cpu")) for x in case["batch"])
    metrics = [{k: v.item() for k, v in trainer.train_step(*batch).items()}
               for _ in range(STEPS)]
    return trainer.model.state_dict(), metrics


def port_errors(state, want, before):
    """The largest absolute error of any parameter, the largest movement
    of any parameter over the two steps, and each running statistic's
    largest error over its scale."""
    err, moved, stats = 0.0, 0.0, 0.0
    for name, value in want.items():
        diff = (state[name] - value).abs().max().item()
        if "running" in name:
            stats = max(stats, diff / max(value.abs().max().item(), 1.0))
            continue
        err = max(err, diff)
        moved = max(moved, (value - before[name]).abs().max().item())
    return err, moved, stats


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("family", sorted(CASES))
def test_gang_step_is_the_global_batch_step(family, gang_run):
    case = CASES[family](np.random.RandomState(0))
    rank0, rank1 = gang_run
    # The ranks hold one state, bit for bit.
    assert rank0[family]["state"].keys() == rank1[family]["state"].keys()
    for name, value in rank0[family]["state"].items():
        assert torch.equal(value, rank1[family]["state"][name]), name
    assert rank0[family]["metrics"] == rank1[family]["metrics"]
    gang_state, gang = rank0[family]["state"], rank0[family]["metrics"]
    before = case["to_sd"](as_numpy(case["variables"]))

    # The port's own one-process step on the global batch: f32 rounding.
    state, ours = port_one_process(case)
    for mine, want in zip(gang, ours):
        for key in ("loss", "grad_norm_sq", "grad_norm_sq_small"):
            assert mine[key] == pytest.approx(want[key], rel=PORT_RTOL), key
    err, moved, stats = port_errors(gang_state, state, before)
    assert err <= PORT_ATOL and stats <= PORT_RTOL and moved > 10 * PORT_ATOL

    # The JAX package's step on the global batch, at the family's tolerance.
    ref_state, ref = reference(family)
    tol = case["tol"]
    for mine, want in zip(gang, ref):
        assert mine["loss"] == pytest.approx(want["loss"], rel=tol["loss"])
        assert mine["grad_norm_sq"] == pytest.approx(want["grad_norm_sq"], rel=tol["gsq"])
    after = case["to_sd"](ref_state)
    if family == "transformer":
        for name, want in after.items():
            assert (gang_state[name] - want).abs().max().item() < tol["atol"], name
        return
    moves, errs = [], []
    for name, want in after.items():
        err = (gang_state[name] - want).abs()
        if "running" in name:
            assert err.max().item() <= tol["stats"] * max(want.abs().max().item(), 1.0), name
            continue
        move = (want - before[name]).abs()
        assert err.max().item() <= tol["move"] * move.max().item(), name
        moves.append(move.flatten())
        errs.append(err.flatten())
    moved = torch.cat(moves).norm().item()
    assert moved > 0 and torch.cat(errs).norm().item() <= tol["whole"] * moved


@pytest.mark.parametrize("family", sorted(CASES))
def test_gns_small_norm_is_the_references_first_slice(family, gang_run):
    """Rank 0's slice is the reference's `b[:B // n_dev]`: its squared
    gradient norm at each step's parameters, by the reference's own loss,
    is the gang's `grad_norm_sq_small` on every rank."""
    case = CASES[family](np.random.RandomState(0))
    _, ref = reference(family)
    for rank in range(GANG):
        for mine, want in zip(gang_run[rank][family]["metrics"], ref):
            assert mine["grad_norm_sq_small"] == pytest.approx(
                want["grad_norm_sq_small"], rel=case["tol"]["gsq"])
            assert want["grad_norm_sq_small"] != pytest.approx(want["grad_norm_sq"], rel=0.05)


def test_rank0_alone_saves_and_every_rank_loads(gang_run):
    assert len(gang_run[0]["writes"]) == len(CASES) and gang_run[1]["writes"] == []
    for rank in range(GANG):
        assert all(gang_run[rank][family]["restored_equal"] for family in CASES)


def test_both_ranks_get_one_checkpoint_dir(tmp_path):
    """The dispatcher gives the ranks of one job (two RunJobs, two worker
    ids, two chips) one checkpoint directory: the one rank 0 writes and
    every rank loads."""
    from shockwave_tpu_torch.runtime.dispatcher import Dispatcher
    dispatcher = Dispatcher(round_duration=60.0, chip_ids=[0, 1], worker_rpc_client=None,
                            sched_addr="127.0.0.1", sched_port=1, run_dirs={},
                            data_dir="/data", checkpoint_dir=str(tmp_path))
    job = dict(job_id=7, command="python3 main.py --batch_size 128", working_directory="",
               needs_data_dir=False, num_steps_arg="--num_steps", num_steps=10, mode="static")
    commands = [dispatcher._construct_command(
        dict(job, command=f"{job['command']} --coordinator h:1 --num_processes 2 "
                          f"--process_id {rank}"), chip_id=rank, worker_id=3 + rank)
        for rank in range(GANG)]
    dirs = {re.search(r"--checkpoint_dir (\S+)", c).group(1) for c in commands}
    assert dirs == {str(tmp_path / "job_id=7")}


# -- the backend rule -------------------------------------------------------------


class FakeStore:
    def __init__(self, **entries):
        self.entries = {k: v.encode() for k, v in entries.items()}

    def set(self, key, value):
        self.entries[key] = value.encode()

    def get(self, key):
        return self.entries[key]


@pytest.mark.parametrize("mine,peer,backend", [
    (None, None, "gloo"),                       # CPU ranks
    ("GPU-aaaa", "GPU-aaaa", "gloo"),           # two ranks share one card
    ("GPU-aaaa", "GPU-bbbb", "nccl"),           # a card each
])
def test_backend_rule(mine, peer, backend):
    from shockwave_tpu_torch.parallel import mesh
    store = FakeStore() if peer is None else FakeStore(**{"swtpu/device_uuid/1": peer})
    assert mesh.select_backend(store, 0, 2, mine) == backend
    if mine is not None:
        assert store.entries["swtpu/device_uuid/0"] == mine.encode()


@pytest.mark.parametrize("batch,count,sizes", [(4, 2, [2, 2]), (5, 2, [2, 3]),
                                               (5, 4, [1, 1, 1, 2]), (128, 4, [32] * 4)])
def test_local_batch_slices_cover_the_batch(batch, count, sizes):
    """Rank 0 holds `B // n` rows (GNS's small batch); the slices tile the
    batch in order."""
    from shockwave_tpu_torch.parallel import mesh
    slices = [mesh.local_batch_slice(batch, i, count) for i in range(count)]
    assert [s.stop - s.start for s in slices] == sizes
    assert slices[0].start == 0 and slices[-1].stop == batch
    assert all(a.stop == b.start for a, b in zip(slices, slices[1:]))


def test_a_gang_without_its_rendezvous_fails_at_once():
    from shockwave_tpu_torch.parallel import mesh
    with pytest.raises(ValueError, match="--process_id"):
        mesh.maybe_initialize_distributed("127.0.0.1:1", 2, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="--coordinator"):
        mesh.maybe_initialize_distributed(None, 2, 0, torch.device("cpu"))
    mesh.maybe_initialize_distributed(None, 1, None, torch.device("cpu"))  # not a gang
    assert mesh.process_count() == 1 and mesh.backend() is None


# -- the lease iterator's gang hooks ------------------------------------------------


class FakeTime:
    """Stands in for the `time` module inside an iterator module."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


STEP_S, SYNC_S = 1.0, 0.25
# (InitJob grant, UpdateLease answer, gang_sync_every). A fake peer whose
# clock runs 0.5 s ahead (the max) and whose grants are 3/4 of this
# member's (the min).
GANG_CASES = {
    "steps_renewals": ((12, 1e6, 0.0), lambda s, d, ms, md: (ms + 8, md, 0.0, 1e9), 16),
    "duration_expiry": ((10**6, 16.0, 2.0), lambda s, d, ms, md: (ms, md + 8.0, 0.0, 1e9), 4),
    "deadline": ((40, 1e6, 0.0), lambda s, d, ms, md: (ms + 8, md, 100.0, 105.0), 4),
}


def fake_allreduce(calls):
    def allreduce(value, op):
        calls.append((op, float(value)))
        return value + 0.5 if op == "max" else value * 0.75
    return allreduce


def drive_gang_member(module, make_ref, case, port, tmp_path, monkeypatch):
    from shockwave_tpu.runtime.servers import serve_scheduler
    grant, renew, every = GANG_CASES[case]
    rpcs, calls, barriers, syncs = [], [], [], []
    clock = FakeTime()
    real_sync = module._device_sync

    def recording_sync(value):
        syncs.append(None if value is None else float(value))
        if value is not None:
            clock.sleep(SYNC_S)
        real_sync(value)

    monkeypatch.setattr(module, "time", clock)
    monkeypatch.setattr(module, "_device_sync", recording_sync)
    server = serve_scheduler(port, {
        "RegisterWorker": lambda **kw: ([0], 60.0), "Done": lambda *a: None,
        "InitJob": lambda job_id: rpcs.append(("InitJob",)) or grant,
        "UpdateLease": lambda job_id, worker_id, steps, duration, max_steps, max_duration,
        measured_reports=None: rpcs.append(("UpdateLease", steps, duration, max_steps,
                                            max_duration)) or renew(steps, duration,
                                                                    max_steps, max_duration),
    })
    steps = 0
    try:
        it = module.LeaseIterator(list(range(1000)), str(tmp_path), lambda p: None,
                                  lambda p: None, distributed_barrier=lambda: barriers.append(steps),
                                  gang_allreduce=fake_allreduce(calls), gang_sync_every=every)
        while not it.done and steps < 200:
            for _ in it:
                clock.sleep(STEP_S)
                steps += 1
                it.set_sync_ref(make_ref(steps))
    finally:
        server.stop(grace=0)
    if hasattr(it, "close"):
        it.close()
    else:
        import atexit
        for hook in (it._flush_measured_to_log, it._write_info, it._close_log):
            hook()
            atexit.unregister(hook)
    log = (tmp_path / ".swtpu" / "round=0" / "worker=0.log").read_text()
    return {"rpcs": rpcs, "stopped_at": steps, "allreduce": calls, "barriers": barriers,
            "syncs": syncs, "grant": (it._lease.max_steps, it._lease.max_duration),
            "log": [re.sub(r"^\[[0-9: -]+\] ", "", line) for line in log.splitlines()]}


@pytest.mark.parametrize("case", sorted(GANG_CASES))
def test_gang_lease_decisions_match_the_reference(case, tmp_path, monkeypatch):
    from shockwave_tpu.runtime import iterator as ref_iterator
    from shockwave_tpu_torch.runtime import iterator as port_iterator
    port = free_port()
    for key, value in {"SWTPU_JOB_ID": "0", "SWTPU_WORKER_ID": "0", "SWTPU_ROUND_ID": "0",
                       "SWTPU_SCHED_ADDR": "localhost", "SWTPU_SCHED_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)
    for key in ("SWTPU_RUNAHEAD_STEPS", "SWTPU_DEGRADE_FACTOR", "SWTPU_SPAN_SHARD_DIR",
                "SWTPU_HA_ENDPOINT_FILE"):
        monkeypatch.delenv(key, raising=False)
    ref = drive_gang_member(ref_iterator, np.float32, case, port, tmp_path / "ref", monkeypatch)
    ours = drive_gang_member(port_iterator, lambda n: torch.tensor(float(n)), case, port,
                             tmp_path / "port", monkeypatch)
    assert ours == ref
    # The agreed grant is the peer's (min), and the exit waits at the
    # barrier exactly once, at the step it stopped.
    assert ours["barriers"] == [ours["stopped_at"]]
    assert ("min", float(GANG_CASES[case][0][0])) in ours["allreduce"]
    if case == "steps_renewals":
        assert ours["stopped_at"] == ours["grant"][0]  # expiry at the agreed grant
    elif case == "duration_expiry":
        assert ours["stopped_at"] % GANG_CASES[case][2] == 0  # only at a boundary
        assert any(op == "max" for op, _ in ours["allreduce"])
    else:
        assert any(line.startswith("[LEASE] [DEADLINE]") for line in ours["log"])


# -- the real scheduler, the port's daemon, a gang --------------------------------


def iterator_steps(checkpoint_dir, job_id):
    """{(round, worker): the last [PROGRESS] [STEPS] of that dispatch}."""
    swtpu = os.path.join(checkpoint_dir, f"job_id={job_id}", ".swtpu")
    found = {}
    for round_dir in os.listdir(swtpu):
        for name in os.listdir(os.path.join(swtpu, round_dir)):
            with open(os.path.join(swtpu, round_dir, name)) as f:
                steps = re.findall(r"\[PROGRESS\] \[STEPS\] (\d+)", f.read())
            found[(int(round_dir.split("=")[1]), int(name[len("worker="):-len(".log")]))] = \
                int(steps[-1])
    return found


def drive_gang_loopback(tmp_path, worker_type, throughputs, job_type, command,
                        working_directory, run_dir, budgets, round_s, limit_s,
                        chip_ids=None):
    """The real scheduler, planning from data/`throughputs`, and the
    port's daemon with GANG chips (their card ids `chip_ids`, default the
    daemon's own) run one job of each scale factor in `budgets` (scale
    factor -> total steps) to completion. Checks exact `total_steps_run`
    and that both ranks of every gang dispatch stopped at the same step;
    returns the gang's steps per (round, worker) and the wall seconds."""
    from shockwave_tpu.core.job import Job
    from shockwave_tpu.sched import physical
    from shockwave_tpu.sched.physical import PhysicalScheduler
    from shockwave_tpu.sched.scheduler import SchedulerConfig
    from shockwave_tpu.solver import get_policy
    from shockwave_tpu_torch.runtime.worker import WorkerDaemon

    sched_port, worker_port = free_port(), free_port()
    ckpt = str(tmp_path / "ckpt")
    sched = PhysicalScheduler(
        get_policy("max_min_fairness"),
        throughputs_file=os.path.join(REPO, "data", throughputs),
        config=SchedulerConfig(time_per_iteration=round_s, max_rounds=30),
        expected_num_workers=GANG, port=sched_port)
    # The gang's rendezvous port: a free one at or past the scheduler's base.
    coordinator_port = free_port()
    while coordinator_port < physical.BASE_JOB_PORT:
        coordinator_port = free_port()
    sched._port_offset = coordinator_port - physical.BASE_JOB_PORT
    daemon = WorkerDaemon(
        worker_type=worker_type, sched_addr="127.0.0.1", sched_port=sched_port,
        worker_port=worker_port, num_chips=GANG,
        run_dirs={mode: run_dir for mode in ("static", "accordion", "gns", "serving")},
        data_dir=str(tmp_path / "data"), checkpoint_dir=ckpt)
    if chip_ids is not None:
        queue = daemon._dispatcher._chip_queue
        while not queue.empty():
            queue.get()
        for chip_id in chip_ids:
            queue.put(chip_id)
    job_ids = {sf: sched.add_job(Job(
        None, job_type, command, working_directory, "--num_steps", total_steps=steps,
        duration=100000, scale_factor=sf, needs_data_dir=True)) for sf, steps in budgets.items()}
    runner = threading.Thread(target=sched.run, daemon=True)
    start = time.time()
    runner.start()
    try:
        while time.time() < start + limit_s and len(sched._completed_jobs) < len(budgets):
            time.sleep(0.3)
        wall = time.time() - start
        assert len(sched._completed_jobs) == len(budgets), "the jobs did not complete"
    finally:
        sched._done_event.set()
        daemon._shutdown()
        daemon.join()
        sched.shutdown()
        sched._server.stop(grace=0)
    for sf, job_id in job_ids.items():
        assert sched.acct.total_steps_run[job_id] == budgets[sf]
    gang = iterator_steps(ckpt, job_ids[2].integer_job_id())
    rounds = {}
    for (round_id, _), steps in gang.items():
        rounds.setdefault(round_id, []).append(steps)
    # Both ranks of every dispatch ran, and stopped at the same step.
    assert all(len(steps) == GANG and len(set(steps)) == 1 for steps in rounds.values()), gang
    # The scheduler counts each rank's steps: every gang step twice.
    assert sum(steps[0] for steps in rounds.values()) * GANG == budgets[2]
    return gang, wall


@pytest.mark.runtime
@pytest.mark.timeout(240)
def test_scheduler_runs_a_gang_on_the_port_worker(tmp_path):
    command = f"{sys.executable} {THIS_FILE} --data_dir=%s/cifar10 --batch_size 16 --device cpu"
    drive_gang_loopback(tmp_path, "v100", "tacc_throughputs.json", "ResNet-18 (batch size 16)",
                        command, "", REPO, {2: 12, 1: 4}, round_s=6.0, limit_s=200)


@pytest.mark.cuda
def test_h100_scheduler_runs_a_gang_on_the_card(tmp_path, caplog):
    """The same drive on the card: the trace's ResNet-18 command at batch
    128 from the JAX package's job table, resolved under the port's run
    dir, planned from the H100 oracle file (whose sf = 2 row is a prior),
    with both "chips" the one card (the chip machine has one), so the
    ranks take gloo. Run it on the card with `python -m pytest
    --noconftest -m cuda tests/test_torch_gang.py -s`."""
    import json
    import logging

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from shockwave_tpu.core.job_table import resnet18
    template = resnet18(128)
    with caplog.at_level(logging.WARNING):
        gang, wall = drive_gang_loopback(
            tmp_path, "h100", "h100_throughputs.json", template.model, template.command,
            template.working_directory, os.path.join(REPO, "shockwave_tpu_torch", "workloads"),
            {2: 200, 1: 100}, round_s=15.0, limit_s=900, chip_ids=[0] * GANG)
    unprofiled = [r.getMessage() for r in caplog.records
                  if "no profiled throughput" in r.getMessage()]
    assert not unprofiled, unprofiled
    print("h100_gang_loopback:", json.dumps({
        "steps_per_round_and_worker": {f"{r}/{w}": n for (r, w), n in sorted(gang.items())},
        "wall_s": wall}))


# -- the gang members ---------------------------------------------------------------


def member(rank, port, inputs, out):
    """One rank of the parity gang: every case's two steps on its slice."""
    import importlib

    from shockwave_tpu_torch.models import train_common
    from shockwave_tpu_torch.parallel import mesh
    cpu = torch.device("cpu")
    mesh.maybe_initialize_distributed(f"127.0.0.1:{port}", GANG, rank, cpu)
    writes = []
    save = train_common.save_checkpoint
    train_common.save_checkpoint = lambda path, state: writes.append(path) or save(path, state)
    results = {"writes": writes}
    for name, case in torch.load(inputs, weights_only=False).items():
        module, attr = case["loss_fn"]
        loss_fn = getattr(importlib.import_module(module), attr)
        batch = case["batch"]
        trainer = train_common.Trainer(types.SimpleNamespace(), loss_fn, case["model"], None,
                                       cpu, learning_rate=case["lr"], mode="gns",
                                       initial_bs=batch[0].shape[0])
        assert trainer.n_dev == GANG and trainer.rank == rank
        rows = mesh.local_batch_slice(batch[0].shape[0])
        local = tuple(train_common.upload(x[rows], cpu) for x in batch)
        metrics = [{k: v.item() for k, v in trainer.train_step(*local).items()}
                   for _ in range(STEPS)]
        # The gang's checkpoint: rank 0 writes it, every rank reads it.
        path = os.path.join(os.path.dirname(out), f"{name}.ckpt")
        trainer._save(path)
        mesh.barrier()
        restored = trainer._load(path)["params"]
        results[name] = {"metrics": metrics, "state": trainer.model.state_dict(),
                         "restored_equal": all(torch.equal(v, restored[k]) for k, v
                                               in trainer.model.state_dict().items())}
    torch.save(results, out)


def trainer_main():
    """The loopback's job: the port's cifar10 main with a narrow ResNet-18."""
    import functools

    from shockwave_tpu_torch.models.resnet import ResNet18
    from shockwave_tpu_torch.workloads.image_classification.cifar10 import main
    main.ResNet18 = functools.partial(ResNet18, num_filters=4)
    main.main()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    if sys.argv[1] == "member":
        member(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        trainer_main()
