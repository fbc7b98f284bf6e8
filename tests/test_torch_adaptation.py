"""The port's dynamic-adaptation path against the JAX package's.

First the monitors: the port's `AccordionMonitor` and `GNSMonitor` and
the reference's, fed the same norm streams, issue the same requests (the
port's as device scalars too, read only where the rule needs them). Then
the scheduler loopback: the JAX package's real `PhysicalScheduler` and
the port's `WorkerDaemon` run a ResNet-18 job in `accordion` mode whose
monitor asks for the big batch; the scheduler rescales the job and
redispatches it at the new batch size, and the step accounting comes out
exact. The trainer is this file run as a script (the `__main__` block at
the end): the port's cifar10 main at a small width on the CPU.
"""
import functools
import logging
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from shockwave_tpu_torch.models import train_common

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
THIS_FILE = os.path.abspath(__file__)


class RecordingIterator:
    def __init__(self):
        self.requests = []

    def update_resource_requirement(self, big_bs, small_bs):
        self.requests.append((big_bs, small_bs))


def reference_monitors():
    from shockwave_tpu.models.train_common import AccordionMonitor, GNSMonitor
    return AccordionMonitor, GNSMonitor


def run_accordion(cls, epochs, launch_bs, max_bs, as_tensor=False):
    """Each epoch's norms through `observe_step`, then `end_epoch`;
    returns the decisions and the requests."""
    it = RecordingIterator()
    mon = cls(it, launch_bs=launch_bs, max_bs=max_bs, threshold=0.5)
    decisions = []
    for norms in epochs:
        for n in norms:
            mon.observe_step(torch.tensor(n, dtype=torch.float32) if as_tensor else n)
        decisions.append(mon.end_epoch())
    return decisions, it.requests


def run_gns(cls, pairs, small_bs, big_bs, max_bs, window, as_tensor=False):
    it = RecordingIterator()
    mon = cls(it, small_bs=small_bs, big_bs=big_bs, max_bs=max_bs, window=window)
    decisions = []
    for small, big in pairs:
        if as_tensor:
            small, big = (torch.tensor(v, dtype=torch.float32) for v in (small, big))
        mon.observe_step(small, big)
        decisions.append(mon.maybe_request_double(big_bs))
    return decisions, it.requests


F32 = np.float32  # device norms are f32: the streams are f32 values

ACCORDION = {
    # The reference's own cases (tests/test_workloads.py), then the other
    # branches: critical at the small batch, stable at the max, and a
    # stream of random epochs.
    "big_when_stable": ([[1.0] * 10, [1.01] * 10], 32, 256),
    "small_when_critical": ([[1.0] * 10, [5.0] * 10], 256, 256),
    "quiet_when_critical_below_max": ([[1.0] * 10, [5.0] * 10], 32, 256),
    "quiet_when_stable_at_max": ([[1.0] * 10, [1.2] * 10], 256, 256),
    "random_epochs": ([list(np.random.RandomState(s).lognormal(0, 0.6, 7).astype(F32))
                       for s in range(12)], 64, 256),
}


@pytest.mark.parametrize("as_tensor", [False, True], ids=["floats", "tensors"])
@pytest.mark.parametrize("case", sorted(ACCORDION))
def test_accordion_requests_are_the_references(case, as_tensor):
    ref_cls, _ = reference_monitors()
    epochs, launch_bs, max_bs = ACCORDION[case]
    epochs = [[float(F32(n)) for n in e] for e in epochs]
    ours = run_accordion(train_common.AccordionMonitor, epochs, launch_bs, max_bs, as_tensor)
    assert ours == run_accordion(ref_cls, epochs, launch_bs, max_bs)
    if case == "big_when_stable":
        assert ours[1] == [(True, False)]


def gns_stream(seed, n, g2, s, small_bs, big_bs):
    """E|G_b|^2 = |G|^2 + S / b, with multiplicative noise, as f32."""
    rng = np.random.RandomState(seed)
    return [(float(F32((g2 + s / small_bs) * rng.lognormal(0, 0.1))),
             float(F32((g2 + s / big_bs) * rng.lognormal(0, 0.1)))) for _ in range(n)]


GNS = {
    "double_when_noise_dominates": ([(101.0, 13.5)] * 5, 4, 32, 256, 5),
    "quiet_when_gradient_dominates": ([(2.0, 1.125)] * 5, 4, 32, 256, 5),
    "quiet_at_max": ([(101.0, 13.5)] * 5, 4, 256, 256, 5),
    "noisy_stream": (gns_stream(0, 40, 1.0, 300.0, 8, 64), 8, 64, 512, 10),
    "one_device": ([(101.0, 101.0)] * 8, 32, 32, 256, 5),
}


@pytest.mark.parametrize("as_tensor", [False, True], ids=["floats", "tensors"])
@pytest.mark.parametrize("case", sorted(GNS))
def test_gns_requests_are_the_references(case, as_tensor):
    _, ref_cls = reference_monitors()
    pairs, small_bs, big_bs, max_bs, window = GNS[case]
    ours = run_gns(train_common.GNSMonitor, pairs, small_bs, big_bs, max_bs, window, as_tensor)
    assert ours == run_gns(ref_cls, pairs, small_bs, big_bs, max_bs, window)
    if case == "double_when_noise_dominates":
        assert ours[1] == [(True, False)]


def test_monitors_read_norms_only_where_the_rule_needs_them(monkeypatch):
    reads = []
    real = train_common._host_floats
    monkeypatch.setattr(train_common, "_host_floats",
                        lambda values: reads.append(len(values)) or real(values))
    norm = torch.tensor(1.0)
    acc = train_common.AccordionMonitor(RecordingIterator(), 32, 256)
    for _ in range(5):
        acc.observe_step(norm)
    assert reads == []
    acc.end_epoch()
    assert reads == [5]  # one read of the epoch's norms

    reads.clear()
    one_device = train_common.GNSMonitor(RecordingIterator(), 32, 32, 256, window=3)
    for _ in range(10):
        one_device.observe_step(norm, norm)
        assert not one_device.maybe_request_double(32)
    assert reads == []  # b_small == b_big: never read

    two_sizes = train_common.GNSMonitor(RecordingIterator(), 4, 32, 256, window=3)
    for _ in range(2):
        two_sizes.observe_step(norm, norm)
        two_sizes.maybe_request_double(32)
    assert reads == []  # the window is not full yet
    two_sizes.observe_step(norm, norm)
    two_sizes.maybe_request_double(32)
    assert reads == [3, 3]


# -- the scheduler loopback ------------------------------------------------------

EPOCH_BATCHES = 3
# "ResNet-18 (batch size 16)" with 3200 steps is 2 epochs of CIFAR-10 at
# 3125 steps each. After the accordion request the scheduler sets the
# batch to ResNet-18's MAX_BS (256: 196 steps an epoch), the budget to
# 200 steps and the steps run to one epoch (196), so the second dispatch
# has 4 steps left.
CPU_JOB = dict(batch=16, total_steps=3200, new_batch=256, new_total=200)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def drive_accordion(tmp_path, monkeypatch, worker_type, command, working_directory,
                    run_dir, job, round_s, limit_s, env):
    """The real scheduler and the port's daemon run one accordion job to
    completion; returns the scheduler, the job id, the batch-size
    requests that reached the scheduler, the RunJob commands (from the
    dispatcher's log), the scheduler's log lines and the wall time."""
    from shockwave_tpu.core.job import Job
    from shockwave_tpu.sched.physical import PhysicalScheduler
    from shockwave_tpu.sched.scheduler import SchedulerConfig
    from shockwave_tpu.solver import get_policy
    from shockwave_tpu_torch.runtime.worker import WorkerDaemon

    received = []
    real = PhysicalScheduler._update_resource_requirement_callback

    def recording(self, job_id, worker_id, big_bs, small_bs):
        received.append((job_id.integer_job_id(), big_bs, small_bs))
        return real(self, job_id, worker_id, big_bs, small_bs)

    # Bound into the scheduler's RPC table when it is constructed.
    monkeypatch.setattr(PhysicalScheduler, "_update_resource_requirement_callback",
                        recording)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    lines = _Lines()
    loggers = [logging.getLogger("shockwave_tpu.sched"),
               logging.getLogger("shockwave_tpu_torch.runtime")]
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.addHandler(lines)
        lg.setLevel(logging.INFO)
    sched_port, worker_port = free_port(), free_port()
    sched = PhysicalScheduler(
        get_policy("max_min_fairness"),
        throughputs_file=os.path.join(REPO, "data", "tacc_throughputs.json"),
        config=SchedulerConfig(time_per_iteration=round_s, max_rounds=40),
        expected_num_workers=1, port=sched_port)
    daemon = WorkerDaemon(
        worker_type=worker_type, sched_addr="127.0.0.1", sched_port=sched_port,
        worker_port=worker_port, num_chips=1,
        run_dirs={mode: run_dir for mode in ("static", "accordion", "gns", "serving")},
        data_dir=str(tmp_path / "data"), checkpoint_dir=str(tmp_path / "ckpt"))
    job_id = sched.add_job(Job(
        None, f"ResNet-18 (batch size {job['batch']})", command, working_directory,
        "--num_steps", total_steps=job["total_steps"], duration=100000,
        needs_data_dir=True, mode="accordion"))
    start = time.time()
    runner = threading.Thread(target=sched.run, daemon=True)
    runner.start()
    try:
        while time.time() < start + limit_s and not sched._completed_jobs:
            time.sleep(0.3)
        wall = time.time() - start
        assert sched._completed_jobs, "the job did not complete"
    finally:
        sched._done_event.set()
        daemon._shutdown()
        daemon.join()
        sched.shutdown()
        sched._server.stop(grace=0)
        for lg, level in zip(loggers, levels):
            lg.removeHandler(lines)
            lg.setLevel(level)
    launches = [ln.split("launching: ", 1)[1] for ln in lines.lines if "launching: " in ln]
    return sched, job_id, received, launches, lines.lines, wall


def check_rescaled(sched, job_id, received, launches, log, job):
    """The accordion round trip: the big-batch request reached the
    scheduler, which logged the rescale and redispatched the job at the
    new batch size, and the job completed at its rescaled budget."""
    assert received == [(job_id.integer_job_id(), True, False)]
    assert any(f"[BS rescale] job {job_id}: bs {job['batch']}->{job['new_batch']}, "
               f"steps -> {job['new_total']}" in ln for ln in log), log[-20:]
    assert len(launches) >= 2, launches
    assert launches[0].split(" --local_rank")[0].endswith(f"--batch_size {job['batch']}")
    assert launches[-1].split(" --local_rank")[0].endswith(f"--batch_size {job['new_batch']}")
    assert f"--num_steps {job['new_total']} " in launches[-1]
    assert sched.acct.total_steps_run[job_id] == job["new_total"]


@pytest.mark.runtime
@pytest.mark.timeout(240)
def test_scheduler_rescales_an_accordion_job_on_the_port_worker(tmp_path, monkeypatch):
    command = (f"{sys.executable} {THIS_FILE} --device cpu "
               f"--data_dir=%s/cifar10 --batch_size {CPU_JOB['batch']}")
    found = drive_accordion(tmp_path, monkeypatch, "v100", command, "", REPO, CPU_JOB,
                            round_s=6.0, limit_s=200,
                            env={"SWTPU_SYNTH_EPOCH_BATCHES": str(EPOCH_BATCHES),
                                 "PYTHONPATH": REPO})
    check_rescaled(*found[:5], CPU_JOB)


@pytest.mark.cuda
def test_h100_accordion_rescale_of_the_trace_command(tmp_path, monkeypatch):
    """The port's counterpart of the TPU-only accordion round trip, on the
    card: the trace's own ResNet-18 command at batch 128 from the JAX
    package's job table, resolved under the port's run dir; the monitor
    asks for the big batch after two 10-batch epochs, and the redispatch
    carries `--batch_size 256`. 400 steps at 128 are two CIFAR-10 epochs
    (391 steps each); at 256 the budget becomes 200 with 196 counted as
    run. Run it on the card with `python -m pytest --noconftest -m cuda
    tests/test_torch_adaptation.py -s`."""
    import json
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from shockwave_tpu.core.job_table import resnet18
    template = resnet18(128)
    job = dict(batch=128, total_steps=400, new_batch=256, new_total=200)
    found = drive_accordion(
        tmp_path, monkeypatch, "h100", template.command, template.working_directory,
        os.path.join(REPO, "shockwave_tpu_torch", "workloads"), job,
        round_s=30.0, limit_s=600, env={"SWTPU_SYNTH_EPOCH_BATCHES": "10"})
    sched, job_id, received, launches, log, wall = found
    print("h100_accordion:", json.dumps({
        "requests": received, "launches": launches, "wall_s": wall,
        "rescale": [ln for ln in log if "[BS rescale]" in ln],
        "timeline": sched._job_timelines.get(job_id.integer_job_id())}))
    check_rescaled(*found[:5], job)


if __name__ == "__main__":
    # The loopback's trainer (see the module docstring); PYTHONPATH holds
    # the repository.
    from shockwave_tpu_torch.models import resnet
    from shockwave_tpu_torch.workloads.image_classification.cifar10 import main

    torch.set_num_threads(1)
    main.ResNet18 = functools.partial(resnet.ResNet18, num_filters=4)
    main.main()
