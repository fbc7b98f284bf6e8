"""The port's LeaseIterator against the JAX package's, decision for
decision.

Both iterators talk to one stub scheduler (the JAX package's
`serve_scheduler`, whose scripted answers are a function of the request
alone) under one fake clock: `time` inside each iterator module is
replaced by an object whose clock the test advances by a fixed amount per
step and per device sync. The reference gets numpy scalars as sync refs,
the port CPU tensors. For each case the two must give the same RPCs with
the same fields, stop at the same step, sync on the same refs, and write
the same iterator log apart from its timestamps.
"""
import atexit
import re
import socket

import numpy as np
import pytest
import torch

from shockwave_tpu.runtime import iterator as ref_iterator
from shockwave_tpu.runtime.servers import serve_scheduler
from shockwave_tpu_torch.runtime import iterator as port_iterator

STEP_S = 1.0    # fake compute per step
SYNC_S = 0.25   # fake device wait per sync on a ref
MAX_STEPS = 60  # the test loop's own bound, past every lease below
TRACEPARENT = "00-" + "a" * 32 + "-" + "b" * 16 + "-01"  # the launch span's


def free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class FakeTime:
    """Stands in for the `time` module inside an iterator module."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


# Each case: (InitJob grant, UpdateLease answer as a function of the
# request, environment, whether the job reports a checkpoint at budget,
# a telemetry line queued before the first step).
CASES = {
    # Steps-based expiry: +10 steps per renewal up to 30.
    "steps_renewals": ((10, 1e6, 0.0),
                       lambda steps, dur, ms, md: (min(ms + 10, 30), 1e6, 0.0, 1e9),
                       {}, False, "sketch-delta"),
    # Duration-based expiry: +5 s per renewal up to 20 s, steps unbounded.
    "duration_expiry": ((1000, 10.0, 2.0),
                        lambda steps, dur, ms, md: (ms, min(md + 5.0, 20.0), 0.0, 1e9),
                        {}, False, None),
    # The scheduler says the job has overrun its deadline at the renewal.
    "deadline": ((10, 1e6, 0.0),
                 lambda steps, dur, ms, md: (ms + 10, 1e6, 100.0, 105.0),
                 {}, False, None),
    # A 4-step run-ahead window on a 20-step final lease.
    "runahead_window": ((20, 1e6, 0.0),
                        lambda steps, dur, ms, md: (ms, md, 0.0, 1e9),
                        {"SWTPU_RUNAHEAD_STEPS": "4"}, False, None),
    # An injected slowdown pads each step to compute / 0.5.
    "degrade_factor": ((1000, 12.0, 0.0),
                       lambda steps, dur, ms, md: (ms, md, 0.0, 1e9),
                       {"SWTPU_DEGRADE_FACTOR": "0.5"}, False, None),
    # The restored checkpoint is already at budget.
    "checkpoint_ahead": ((7, 1e6, 0.0),
                         lambda steps, dur, ms, md: (ms, md, 0.0, 1e9),
                         {}, True, None),
}


def drive(module, make_ref, case, port, tmp_path, monkeypatch, traced=False):
    """One dispatch: construct the iterator, train until it stops, run
    the exit path; returns everything the two packages must agree on.
    `traced`: fleet tracing on, the process shard's clock the fake one,
    the launch context TRACEPARENT in the environment, and a checkpoint
    load before the loop; the shard's spans are returned too."""
    grant, renew, env, ckpt_ahead, telemetry = CASES[case]
    rpcs = []

    def init_job(job_id):
        rpcs.append(("InitJob", job_id.integer_job_id()))
        return grant

    def update_lease(job_id, worker_id, steps, duration, max_steps,
                     max_duration, measured_reports=None):
        rpcs.append(("UpdateLease", job_id.integer_job_id(), worker_id,
                     steps, duration, max_steps, max_duration,
                     measured_reports))
        return renew(steps, duration, max_steps, max_duration)

    clock = FakeTime()
    syncs = []
    real_sync = module._device_sync

    def recording_sync(value):
        syncs.append(None if value is None else float(value))
        if value is not None:
            clock.sleep(SYNC_S)
        real_sync(value)

    monkeypatch.setattr(module, "time", clock)
    monkeypatch.setattr(module, "_device_sync", recording_sync)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    shard = None
    if traced:
        trace_dir = str(tmp_path / "trace")
        shard = module.spans_mod.ShardSpanWriter(trace_dir, role="trainer", clock=clock.time)
        monkeypatch.setattr(module.spans_mod, "_SHARD", shard)
        monkeypatch.setenv("SWTPU_SPAN_SHARD_DIR", trace_dir)
        monkeypatch.setenv("SWTPU_TRACEPARENT", TRACEPARENT)
    server = serve_scheduler(port, {
        "RegisterWorker": lambda **kw: ([0], 60.0),
        "Done": lambda *a: None,
        "InitJob": init_job,
        "UpdateLease": update_lease,
    })
    try:
        it = module.LeaseIterator(
            data_loader=list(range(1000)), checkpoint_dir=str(tmp_path),
            load_checkpoint_func=lambda path: None,
            save_checkpoint_func=lambda path: None)
        if traced:
            clock.sleep(0.5)
            it.load_checkpoint("ckpt")
        if telemetry:
            it.queue_measurement(telemetry)
        if ckpt_ahead:
            clock.sleep(0.5)
            it.report_checkpoint_ahead()
        steps = 0
        # The trainer's loop (models/train_common.Trainer.run).
        while not it.done and steps < MAX_STEPS:
            for _ in it:
                clock.sleep(STEP_S)
                steps += 1
                it.set_sync_ref(make_ref(steps))
                if steps >= MAX_STEPS:
                    break
        it.save_checkpoint("ckpt")
    finally:
        server.stop(grace=0)
    if module is port_iterator:
        it.close()
    else:  # the reference's exit hooks, run now instead of at exit
        hooks = (it._flush_measured_to_log, it._write_info, it._close_log,
                 it._close_trainer_span)
        for hook in hooks:
            hook()
            atexit.unregister(hook)
    log = (tmp_path / ".swtpu" / "round=0" / "worker=0.log").read_text()
    lines = [re.sub(r"^\[[0-9: -]+\] ", "", line) for line in log.splitlines()]
    found = {"rpcs": rpcs, "stopped_at": steps, "done": it.done,
             "syncs": syncs, "log": lines}
    if shard is not None:
        events = shard.tracer.events()
        names = {e["span_id"]: e["name"] for e in events}
        found["spans"] = [(e["name"], e["ts"], e["dur"], e["args"], e["trace_id"],
                           names.get(e["parent_id"], e["parent_id"])) for e in events]
    return found


@pytest.fixture
def iterator_env(monkeypatch):
    for key, value in {"SWTPU_JOB_ID": "0", "SWTPU_WORKER_ID": "0",
                       "SWTPU_ROUND_ID": "0",
                       "SWTPU_SCHED_ADDR": "localhost"}.items():
        monkeypatch.setenv(key, value)
    for key in ("SWTPU_RUNAHEAD_STEPS", "SWTPU_DEGRADE_FACTOR",
                "SWTPU_SPAN_SHARD_DIR", "SWTPU_TRACEPARENT", "SWTPU_HA_ENDPOINT_FILE"):
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


@pytest.mark.parametrize("case", sorted(CASES))
def test_lease_decisions_match_the_reference(case, iterator_env, tmp_path):
    port = free_port()
    iterator_env.setenv("SWTPU_SCHED_PORT", str(port))
    ref = drive(ref_iterator, np.float32, case, port, tmp_path / "ref",
                iterator_env)
    ours = drive(port_iterator, lambda n: torch.tensor(float(n)), case,
                 port, tmp_path / "port", iterator_env)
    assert ours == ref
    # Each case does what it is named for.
    progress = [line for line in ours["log"] if line.startswith("[PROGRESS] [STEPS]")]
    if case == "steps_renewals":
        assert ours["stopped_at"] == 30 and len(ours["rpcs"]) == 4
        assert ours["rpcs"][1][-1] == ["sketch-delta"]
    elif case == "duration_expiry":
        assert 15 < ours["stopped_at"] < 25 and len(ours["rpcs"]) > 2
    elif case == "deadline":
        assert any(line.startswith("[LEASE] [DEADLINE] over deadline")
                   for line in ours["log"])
    elif case == "runahead_window":
        assert ours["stopped_at"] == 20
        assert ours["syncs"][:2] == [4.0, 8.0]  # a batch of 4 drained per sync
    elif case == "degrade_factor":
        # 12 s at 1.5 s per step: the reference pads every other step,
        # since its next step's compute subtracts a pad that the clock
        # reset already left out; the port keeps that arithmetic.
        assert ours["stopped_at"] == 8
    elif case == "checkpoint_ahead":
        assert ours["stopped_at"] == 0 and progress[-1] == "[PROGRESS] [STEPS] 7"
    assert ours["done"]


@pytest.mark.parametrize("case", ["steps_renewals", "duration_expiry", "checkpoint_ahead"])
def test_trainer_spans_match_the_reference(case, iterator_env, tmp_path):
    """With fleet tracing on, both iterators record the same spans under
    one fake clock: a `trainer` span from construction to the lease's
    end, with the reference's args (job, worker, round, steps, done),
    under the launch context from the environment, and `ckpt-load` and
    `ckpt-save` spans under the trainer span (the save after its close)."""
    port = free_port()
    iterator_env.setenv("SWTPU_SCHED_PORT", str(port))
    ref = drive(ref_iterator, np.float32, case, port, tmp_path / "ref", iterator_env,
                traced=True)
    ours = drive(port_iterator, lambda n: torch.tensor(float(n)), case, port,
                 tmp_path / "port", iterator_env, traced=True)
    assert ours == ref
    by_name = {span[0]: span for span in ours["spans"]}
    # Recorded as they close: the trainer span at the lease's end, before
    # the save; a dispatch that never trains closes it at exit.
    assert [span[0] for span in ours["spans"]] == (
        ["ckpt-load", "ckpt-save", "trainer"] if case == "checkpoint_ahead"
        else ["ckpt-load", "trainer", "ckpt-save"])
    trace_id, launch_id = TRACEPARENT.split("-")[1:3]
    trainer = by_name["trainer"]
    assert trainer[3] == {"job": 0, "worker": 0, "round": 0, "steps": ours["stopped_at"]
                          if case != "checkpoint_ahead" else 7, "done": True}
    assert trainer[4:] == (trace_id, launch_id)
    for name in ("ckpt-load", "ckpt-save"):
        assert by_name[name][3] == {"job": 0} and by_name[name][4:] == (trace_id, "trainer")
    if case != "checkpoint_ahead":
        assert by_name["ckpt-save"][1] >= trainer[1] + trainer[2]


def test_cuda_sync_waits_and_cpu_sync_does_nothing():
    reads = []

    class FakeCudaTensor(torch.Tensor):
        @property
        def is_cuda(self):
            return True

        def item(self):
            value = super().item()
            reads.append(value)
            return value

    port_iterator._device_sync(None)
    port_iterator._device_sync(torch.tensor(3.0))
    port_iterator._device_sync(torch.tensor([5.0, 6.0]).as_subclass(FakeCudaTensor))
    assert reads == [5.0]


def test_a_failed_cuda_sync_is_not_swallowed():
    class BrokenCudaTensor(torch.Tensor):
        @property
        def is_cuda(self):
            return True

        def item(self):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        port_iterator._device_sync(torch.tensor(1.0).as_subclass(BrokenCudaTensor))

