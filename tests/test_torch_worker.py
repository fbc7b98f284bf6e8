"""The port's worker daemon and dispatcher under the unchanged scheduler.

The loopback closes the main path on the CPU: the JAX package's real
`PhysicalScheduler` (in the test process, under the lock sanitizer),
the port's `WorkerDaemon` (in process), and the port's translation
trainer as subprocesses under the port's `LeaseIterator`. The trainer
is this file run as a script (the `__main__` block at the end): the
port's `train.main` at a small width on the CPU, each step padded to
STEP_S so that a lease of a few seconds ends mid-job, as a full-size
step would.

The same drive with fleet tracing on (the acceptance test of the JAX
package's `TestFleetTraceLoopback`, with the port's daemon and trainer):
the scheduler's merged trace chains its round through the daemon's
runjob and launch spans into the trainer's, and the daemon answers
/metrics and /healthz. With tracing off no shard is written.

Then unit tests of the dispatcher against the reference's, and of the
daemon's device count.
"""
import functools
import os
import re
import socket
import sys
import threading
import time

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
THIS_FILE = os.path.abspath(__file__)
STEP_S = 1.0
ROUND_S = 5.0
# One of the two jobs is preempted and resumed by construction. The
# scheduler extends a running job's lease into the next round only when
# its mid-round planning (half way through a round) picks the job again.
# Once the job's InitJob has arrived, its in-flight time counts against
# it, and the other job, which has had no time, wins the next round. So
# the lease of the first job to run ends at the latest with the round
# after the first mid-round that follows its InitJob: 1.5 rounds, 7.5 s,
# in which at most 8 steps of STEP_S start. A budget of 10 steps or more
# cannot finish in that job's first dispatch, whichever job runs first.
BUDGETS = (10, 11)


def free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def dispatched_steps(checkpoint_dir, job_id):
    """Steps of each dispatch of one job, from its iterator logs."""
    swtpu = os.path.join(checkpoint_dir, f"job_id={job_id}", ".swtpu")
    steps = []
    for round_dir in sorted(os.listdir(swtpu)):
        for name in os.listdir(os.path.join(swtpu, round_dir)):
            with open(os.path.join(swtpu, round_dir, name)) as f:
                found = re.findall(r"\[PROGRESS\] \[STEPS\] (\d+)", f.read())
            steps.append(int(found[-1]))
    return steps


def drive_loopback(tmp_path, worker_type, job_type, command,
                   working_directory, run_dir, budgets, round_s, limit_s,
                   throughputs="tacc_throughputs.json", trace_dir=None,
                   obs_port=None, on_complete=None):
    """The real scheduler, planning from the oracle file `throughputs`
    under data/, and the port's daemon (one card) run one job per budget
    to completion; returns the scheduler, the job ids, each job's steps
    per dispatch (from its iterator logs), the RunJobs the daemon
    counted, and the wall seconds. With `trace_dir` both trace into it
    (the scheduler merges the shards at shutdown); `obs_port` starts the
    daemon's /metrics and /healthz, and `on_complete(daemon)` runs once
    the jobs are done, before anything shuts down."""
    from shockwave_tpu.core.job import Job
    from shockwave_tpu.sched.physical import PhysicalScheduler
    from shockwave_tpu.sched.scheduler import SchedulerConfig
    from shockwave_tpu.solver import get_policy
    from shockwave_tpu_torch.obs import get_observability, names
    from shockwave_tpu_torch.runtime.worker import WorkerDaemon

    registry = get_observability().registry
    runjobs_before = registry.value(names.WORKER_JOBS_DISPATCHED_TOTAL)
    sched_port, worker_port = free_port(), free_port()
    ckpt = str(tmp_path / "ckpt")
    sched = PhysicalScheduler(
        get_policy("max_min_fairness"),
        throughputs_file=os.path.join(REPO, "data", throughputs),
        config=SchedulerConfig(time_per_iteration=round_s, max_rounds=40,
                               obs_trace_dir=trace_dir),
        expected_num_workers=1, port=sched_port)
    daemon = WorkerDaemon(
        worker_type=worker_type, sched_addr="127.0.0.1",
        sched_port=sched_port, worker_port=worker_port, num_chips=1,
        run_dirs={mode: run_dir for mode in ("static", "accordion", "gns",
                                             "serving")},
        data_dir=str(tmp_path / "data"), checkpoint_dir=ckpt,
        trace_dir=trace_dir, obs_port=obs_port)
    job_ids = [sched.add_job(Job(
        None, job_type, command, working_directory, "-step",
        total_steps=budget, duration=100000, needs_data_dir=True))
        for budget in budgets]
    start = time.time()
    runner = threading.Thread(target=sched.run, daemon=True)
    runner.start()
    try:
        while (time.time() < start + limit_s
               and len(sched._completed_jobs) < len(budgets)):
            time.sleep(0.3)
        wall = time.time() - start
        assert len(sched._completed_jobs) == len(budgets), "the jobs did not complete"
        if on_complete is not None:
            on_complete(daemon)
    finally:
        sched._done_event.set()
        daemon._shutdown()
        daemon.join()
        sched.shutdown()
        sched._server.stop(grace=0)
    per_dispatch = {j.integer_job_id(): dispatched_steps(ckpt, j.integer_job_id())
                    for j in job_ids}
    runjobs = registry.value(names.WORKER_JOBS_DISPATCHED_TOTAL) - runjobs_before
    return sched, job_ids, per_dispatch, runjobs, wall


def check_exact_steps(sched, job_ids, per_dispatch, runjobs, budgets):
    for job_id, budget in zip(job_ids, budgets):
        assert sched.acct.total_steps_run[job_id] == budget
    for steps, budget in zip(per_dispatch.values(), budgets):
        assert sum(steps) == budget, per_dispatch
    # At least one job was preempted at a lease's end and resumed from
    # its checkpoint in a later dispatch.
    assert any(sum(1 for s in steps if s > 0) >= 2
               for steps in per_dispatch.values()), per_dispatch
    # One RunJob per trainer process, counted by the daemon's registry.
    assert runjobs == sum(len(steps) for steps in per_dispatch.values())


@pytest.mark.runtime
@pytest.mark.timeout(240)
def test_scheduler_dispatches_the_port_trainer_with_exact_steps(tmp_path):
    # The trace's Transformer command (core/job_table.py) with this file
    # as train.py and the CPU asked for.
    command = (f"{sys.executable} {THIS_FILE} "
               "-data %s/translation/multi30k.atok.low.pt -batch_size 16 "
               "-proj_share_weight --device cpu")
    found = drive_loopback(tmp_path, "v100", "Transformer (batch size 16)",
                           command, "", REPO, BUDGETS, ROUND_S, 200)
    check_exact_steps(*found[:4], BUDGETS)


@pytest.mark.cuda
def test_h100_loopback_of_the_trace_command(tmp_path, caplog):
    """The same drive on the card, at full width: the trace's own
    Transformer command from the JAX package's job table, resolved under
    the port's run dir, trained with the CUDA kernels, and planned from
    the port's own measured H100 rates (data/h100_throughputs.json), so
    the scheduler starts the job from a profiled rate, not its default.
    Run it on the card with `python -m pytest --noconftest -m cuda
    tests/test_torch_worker.py -s` (the conftest imports JAX, which the
    card's machine need not have)."""
    import json
    import logging

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from shockwave_tpu.core.job_table import transformer
    template = transformer(64)
    budgets = (300, 200)
    with caplog.at_level(logging.WARNING):
        sched, job_ids, per_dispatch, runjobs, wall = drive_loopback(
            tmp_path, "h100", template.model, template.command,
            template.working_directory,
            os.path.join(REPO, "shockwave_tpu_torch", "workloads"),
            budgets, round_s=15.0, limit_s=900, throughputs="h100_throughputs.json")
    unprofiled = [r.getMessage() for r in caplog.records
                  if "no profiled throughput" in r.getMessage()]
    assert not unprofiled, unprofiled
    check_exact_steps(sched, job_ids, per_dispatch, runjobs, budgets)
    print("h100_loopback:", json.dumps({
        "budgets": budgets, "steps_per_dispatch": per_dispatch,
        "wall_s": wall, "rounds": sched.rounds.num_completed_rounds,
        "timelines": {j.integer_job_id(): sched._job_timelines.get(j.integer_job_id())
                      for j in job_ids}}))


@pytest.mark.cuda
def test_h100_fleet_trace_of_the_trace_command(tmp_path, fresh_process_shard):
    """The traced loopback on the card at full width: the trace's own
    Transformer command, trained with the CUDA kernels, under the real
    scheduler with `obs_trace_dir` and the port's daemon with `trace_dir`
    and `obs_port`; the same merged-trace checks. Run it on the card with
    `python -m pytest --noconftest -m cuda tests/test_torch_worker.py -s`."""
    import json

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from shockwave_tpu.core.job_table import transformer
    template = transformer(64)
    trace_dir = str(tmp_path / "trace")
    found = {}
    budgets = (60,)
    sched, job_ids, per_dispatch, runjobs, wall = drive_loopback(
        tmp_path, "h100", template.model, template.command, template.working_directory,
        os.path.join(REPO, "shockwave_tpu_torch", "workloads"), budgets, round_s=15.0,
        limit_s=600, throughputs="h100_throughputs.json", trace_dir=trace_dir, obs_port=0,
        on_complete=probe_obs_endpoints(found))
    assert sched.acct.total_steps_run[job_ids[0]] == budgets[0]
    spans, starts = check_fleet_trace(trace_dir, job_ids, budgets)
    assert found["metrics"][0] == 200 and found["healthz"][0] == 200
    print("h100_fleet_trace:", json.dumps({
        "steps_per_dispatch": per_dispatch, "runjobs": runjobs, "wall_s": wall,
        "trainer_start_s": starts,
        "ckpt_save_ms": [e["dur"] / 1e3 for e in spans["ckpt-save"]],
        "trainer_ms": [e["dur"] / 1e3 for e in spans["trainer"]]}))


def http_get(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def probe_obs_endpoints(found):
    """on_complete hook: the daemon's /metrics and /healthz, read while it
    still runs, into `found`."""
    from shockwave_tpu_torch.obs import names

    def probe(daemon):
        port = daemon._obs_server.port
        found["metrics"] = http_get(port, "/metrics")
        found["healthz"] = http_get(port, "/healthz")
        found["registry_runjobs"] = daemon._obs.registry.value(
            names.WORKER_JOBS_DISPATCHED_TOTAL)
    return probe


def check_fleet_trace(trace_dir, job_ids, budgets):
    """The JAX package's merged trace of a traced loopback: shards of the
    roles scheduler, worker and trainer; every trainer span of the jobs,
    parented trainer -> launch -> runjob -> runjob-rpc -> round across
    the three processes; a ckpt-save under each trainer span; a
    done-report under each runjob; the trainer spans' steps summing to
    the budgets. Returns the spans by name, and each trainer's start-up
    (its span's start less its launch span's, seconds)."""
    import json

    from shockwave_tpu.obs import names as ref_names
    from shockwave_tpu.obs.merge import parent_chain, spans_by_id
    with open(os.path.join(trace_dir, ref_names.MERGED_TRACE_NAME)) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    assert {e["args"].get("role") for e in events} >= {"scheduler", "worker", "trainer"}
    index = spans_by_id(events)
    children = {}
    for e in events:
        children.setdefault(e["args"].get("parent_id"), []).append(e)
    trainers = [e for e in events if e["name"] == "trainer"]
    assert {t["args"]["job"] for t in trainers} == {j.integer_job_id() for j in job_ids}
    starts = []
    for trainer in trainers:
        chain = parent_chain(index, trainer)
        assert [c["name"] for c in chain] == ["trainer", "launch", "runjob", "runjob-rpc",
                                             "round"]
        assert [c["args"]["role"] for c in chain] == ["trainer", "worker", "worker",
                                                      "scheduler", "scheduler"]
        assert len({c["args"]["trace_id"] for c in chain}) == 1
        starts.append((trainer["ts"] - chain[1]["ts"]) / 1e6)
        saves = [c["name"] for c in children.get(trainer["args"]["span_id"], [])]
        assert "ckpt-save" in saves, saves
        runjob = chain[2]
        reports = [c for c in children.get(runjob["args"]["span_id"], [])
                   if c["name"] == "done-report"]
        assert len(reports) == 1 and reports[0]["args"]["role"] == "worker"
        assert reports[0]["args"]["jobs"] == [trainer["args"]["job"]]
    assert sum(t["args"]["steps"] for t in trainers) == sum(budgets)
    return {name: [e for e in events if e["name"] == name]
            for name in ("round", "runjob", "launch", "trainer", "ckpt-save",
                         "done-report")}, starts


@pytest.fixture
def fresh_process_shard(monkeypatch):
    """The port's per-process span shard starts unset (the daemon under
    test binds it) and is unset again after the test."""
    from shockwave_tpu_torch.runtime import spans
    monkeypatch.setattr(spans, "_SHARD", None)
    monkeypatch.delenv("SWTPU_SPAN_SHARD_DIR", raising=False)


@pytest.mark.runtime
@pytest.mark.timeout(120)
def test_scheduler_merges_one_fleet_trace_across_the_port_processes(
        tmp_path, fresh_process_shard):
    """ACCEPTANCE (the JAX package's TestFleetTraceLoopback with the port's
    daemon and trainer): the real scheduler with `obs_trace_dir` and the
    port's daemon with `trace_dir` run one job to its budget; the
    scheduler's merged trace chains round -> runjob-rpc -> runjob ->
    launch -> trainer across its own, the daemon's and the trainer's
    process, with the trainer's ckpt-save and the daemon's done-report.
    The daemon's /metrics counts the RunJobs and /healthz answers."""
    import json
    trace_dir = str(tmp_path / "trace")
    command = (f"{sys.executable} {THIS_FILE} "
               "-data %s/translation/multi30k.atok.low.pt -batch_size 16 "
               "-proj_share_weight --device cpu")
    found = {}
    budgets = (4,)
    sched, job_ids, per_dispatch, runjobs, _ = drive_loopback(
        tmp_path, "v100", "Transformer (batch size 16)", command, "", REPO, budgets,
        ROUND_S, 90, trace_dir=trace_dir, obs_port=0, on_complete=probe_obs_endpoints(found))
    assert sched.acct.total_steps_run[job_ids[0]] == budgets[0]
    spans, _ = check_fleet_trace(trace_dir, job_ids, budgets)
    assert len(spans["launch"]) == runjobs == sum(len(s) for s in per_dispatch.values())

    status, content_type, body = found["metrics"]
    assert status == 200 and content_type.startswith("text/plain; version=0.0.4")
    assert f"swtpu_worker_jobs_dispatched_total {found['registry_runjobs']:g}" in body
    status, content_type, body = found["healthz"]
    health = json.loads(body)
    assert status == 200 and content_type == "application/json"
    assert health["status"] == "ok" and health["worker_type"] == "v100"
    assert health["worker_ids"] == [0] and health["last_dispatch_age_s"] >= 0


def test_tracing_off_writes_no_shard_and_opens_no_port(tmp_path, fresh_process_shard):
    """Without --trace_dir (and SWTPU_SPAN_SHARD_DIR) the daemon's
    dispatcher gets no shard and launches no span; without --obs_port no
    server thread starts."""
    import threading

    from shockwave_tpu.runtime.servers import serve_scheduler
    from shockwave_tpu_torch.runtime import spans
    from shockwave_tpu_torch.runtime.worker import WorkerDaemon
    sched_port = free_port()
    server = serve_scheduler(sched_port, {"RegisterWorker": lambda **kw: ([0], 60.0),
                                          "Done": lambda *a: None})
    before = {t.name for t in threading.enumerate()}
    try:
        daemon = WorkerDaemon("v100", "127.0.0.1", sched_port, free_port(), 1,
                              run_dirs={}, data_dir=None,
                              checkpoint_dir=str(tmp_path / "ckpt"))
        assert daemon._span_shard is None and daemon._dispatcher._span_shard is None
        assert daemon._obs_server is None and spans.get_shard() is None
        assert "swtpu-obs-http" not in {t.name for t in threading.enumerate()} - before
        daemon._shutdown()
        daemon.join()
    finally:
        server.stop(grace=0)
    assert not any(name.startswith("spans-") for _, _, files in os.walk(tmp_path)
                   for name in files)


JOB = dict(job_id=3, command=("python3 train.py -data %s/translation/"
                              "multi30k.atok.low.pt -batch_size 64 "
                              "-proj_share_weight"),
           working_directory="translation", needs_data_dir=True,
           num_steps_arg="-step", num_steps=10, mode="static")


def dispatchers(tmp_path):
    from shockwave_tpu.runtime.dispatcher import Dispatcher as RefDispatcher
    from shockwave_tpu_torch.runtime.dispatcher import Dispatcher
    kw = dict(round_duration=120.0, chip_ids=[0, 1], worker_rpc_client=None,
              sched_addr="10.0.0.2", sched_port=50070, run_dirs={},
              data_dir="/data", checkpoint_dir=str(tmp_path))
    return RefDispatcher(**kw), Dispatcher(**kw)


def test_job_env_binds_the_cuda_card(tmp_path, monkeypatch):
    for key in ("CUDA_VISIBLE_DEVICES", "JAX_VISIBLE_DEVICES",
                "TPU_VISIBLE_CHIPS", "SWTPU_RPC_DEADLINE_S",
                "SWTPU_RPC_BUDGET_S"):
        monkeypatch.delenv(key, raising=False)
    ref, ours = dispatchers(tmp_path)
    env = ours._job_env(JOB, worker_id=4, round_id=7, chip_id=1)
    ref_env = ref._job_env(JOB, worker_id=4, round_id=7, chip_id=1)
    assert env["CUDA_VISIBLE_DEVICES"] == "1"
    assert "JAX_VISIBLE_DEVICES" not in env and "TPU_VISIBLE_CHIPS" not in env
    # Everything else is the reference's SWTPU_* contract.
    del ref_env["JAX_VISIBLE_DEVICES"], ref_env["TPU_VISIBLE_CHIPS"]
    del env["CUDA_VISIBLE_DEVICES"]
    assert env == ref_env
    assert env["SWTPU_RPC_DEADLINE_S"] == "300.0"


def test_construct_command_is_the_references(tmp_path):
    ref, ours = dispatchers(tmp_path)
    command = ours._construct_command(JOB, chip_id=1, worker_id=4)
    assert command == ref._construct_command(JOB, chip_id=1, worker_id=4)
    assert command.endswith(f"--checkpoint_dir {tmp_path}/job_id=3 "
                            "--enable_lease_iterator")


def test_read_progress_parses_the_port_iterators_log(tmp_path, monkeypatch):
    from shockwave_tpu.runtime.servers import serve_scheduler
    from shockwave_tpu_torch.runtime.iterator import LeaseIterator
    port = free_port()
    server = serve_scheduler(port, {
        "RegisterWorker": lambda **kw: ([0], 60.0), "Done": lambda *a: None,
        "InitJob": lambda job_id: (4, 1e6, 0.0),
        "UpdateLease": lambda *a: (4, 1e6, 0.0, 1e9)})
    ref, ours = dispatchers(tmp_path)
    for key, value in {"SWTPU_JOB_ID": "3", "SWTPU_WORKER_ID": "4",
                       "SWTPU_ROUND_ID": "7", "SWTPU_SCHED_ADDR": "localhost",
                       "SWTPU_SCHED_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)
    it = None
    try:
        it = LeaseIterator(list(range(10)), str(tmp_path / "job_id=3"),
                           None, None)
        assert sum(1 for _ in it) == 4
    finally:
        if it is not None:
            it.close()
        server.stop(grace=0)
    steps, duration, log = ours._read_progress(3, 7, 4)
    assert steps == 4 and duration > 0
    assert (steps, duration, log) == ref._read_progress(3, 7, 4)


def test_no_card_means_no_chips_and_no_daemon(tmp_path, monkeypatch):
    import torch

    from shockwave_tpu_torch.runtime import worker
    monkeypatch.delenv("SWTPU_SPAN_SHARD_DIR", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert worker.detect_num_chips() == 0
    with pytest.raises(RuntimeError, match="no CUDA devices"):
        worker.main(["--sched_addr", "127.0.0.1",
                     "--checkpoint_dir", str(tmp_path)])



if __name__ == "__main__":
    # The loopback's trainer (see the module docstring).
    sys.path.insert(0, REPO)
    import torch

    from shockwave_tpu_torch.models.transformer import Seq2SeqTransformer
    from shockwave_tpu_torch.workloads.translation import train

    torch.set_num_threads(1)
    train.Seq2SeqTransformer = functools.partial(
        Seq2SeqTransformer, dim=32, num_heads=2, num_layers=1, mlp_dim=64)
    loss_fn = train.loss_fn

    def padded_loss_fn(*args):
        time.sleep(STEP_S)
        return loss_fn(*args)

    train.loss_fn = padded_loss_fn
    train.main()
