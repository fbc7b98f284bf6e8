"""Per-worker job dispatcher: launches training processes on CUDA cards.

The port of `shockwave_tpu/runtime/dispatcher.py`. It constructs the
launch command (appending step budget, checkpoint dir, and the
lease-iterator flag), injects the SWTPU_* environment, runs the process,
scrapes progress from the iterator log, and notifies the scheduler.

The one device binding: a chip id is a CUDA device index, and each job
gets exclusive use of its card through CUDA_VISIBLE_DEVICES (where the
reference sets JAX_VISIBLE_DEVICES and TPU_VISIBLE_CHIPS), so the
trainer sees it as `cuda:0`.

With the daemon's span shard (fleet tracing on), each trainer process
gets a `launch` span over its life, under the RunJob's context, and the
launch context and the shard directory are exported into its environment
so that its LeaseIterator continues the trace; the Done report is a
`done-report` span. Each rank of a gang is its own process, with its own
launch span.
"""
from __future__ import annotations

import logging
import os
import queue
import re
import signal
import subprocess
import threading
import time
from typing import Dict, List, Optional

import grpc

from ..obs import names as obs_names
from . import faults
from .resilience import RpcUnavailableError

logger = logging.getLogger("shockwave_tpu_torch.runtime")

_PROGRESS_RE = {
    "steps": re.compile(r"\[PROGRESS\] \[STEPS\] (\d+)"),
    "duration": re.compile(r"\[PROGRESS\] \[DURATION\] ([-+]?\d*\.\d+|\d+)"),
}


class Dispatcher:
    def __init__(self, round_duration: float, chip_ids: List[int],
                 worker_rpc_client, sched_addr: str, sched_port: int,
                 run_dirs: Dict[str, str], data_dir: Optional[str],
                 checkpoint_dir: str, span_shard=None,
                 trace_dir: Optional[str] = None):
        # Fleet tracing (opt-in): the daemon's span shard (see the
        # module docstring).
        self._span_shard = span_shard
        self._trace_dir = trace_dir
        self._round_duration = round_duration
        self._worker_rpc_client = worker_rpc_client
        self._sched_addr = sched_addr
        self._sched_port = sched_port
        self._run_dirs = run_dirs  # mode -> root of training scripts
        self._data_dir = data_dir
        self._checkpoint_dir = checkpoint_dir
        self._chip_queue: "queue.Queue[int]" = queue.Queue()
        for chip_id in chip_ids:
            self._chip_queue.put(chip_id)
        self._lock = threading.Lock()
        self._processes: Dict[int, subprocess.Popen] = {}  # job_id -> proc
        self._shutdown = threading.Event()
        # RunJob is delivered at-least-once (the scheduler retries on
        # UNAVAILABLE, which gRPC can return even after the handler ran):
        # remember accepted (job_ids, worker_id, round_id) triples so a
        # replay cannot spawn a second trainer for the same micro-task.
        self._accepted_dispatches: Dict[tuple, int] = {}  # key -> round_id

    # -- command construction ---------------------------------------------

    def _construct_command(self, job: dict, chip_id: int, worker_id: int) -> str:
        command = job["command"]
        if job["needs_data_dir"] and self._data_dir and "%s" in command:
            command = command % (self._data_dir,)
        command = (
            f"{command} --local_rank {chip_id} "
            f"{job['num_steps_arg']} {job['num_steps']} "
            f"--checkpoint_dir {self._job_checkpoint_dir(job['job_id'])} "
            f"--enable_lease_iterator"
        )
        return command

    def _job_checkpoint_dir(self, job_id: int) -> str:
        path = os.path.join(self._checkpoint_dir, f"job_id={job_id}")
        os.makedirs(path, exist_ok=True)
        return path

    def _job_env(self, job: dict, worker_id: int, round_id: int,
                 chip_id: int) -> dict:
        env = dict(os.environ)
        env.update({
            "SWTPU_JOB_ID": str(job["job_id"]),
            "SWTPU_WORKER_ID": str(worker_id),
            "SWTPU_ROUND_ID": str(round_id),
            "SWTPU_SCHED_ADDR": self._sched_addr,
            "SWTPU_SCHED_PORT": str(self._sched_port),
            # Adaptation mode (static / accordion / gns): Trainer selects
            # its batch-size monitor from this. The reference selects mode
            # by dispatching from a different script tree per mode
            # (runtime/rpc/dispatcher.py:385-390); here one tree serves
            # all modes and the env var switches behavior.
            "SWTPU_MODE": job.get("mode", "static") or "static",
            # Restrict the training process to its card.
            "CUDA_VISIBLE_DEVICES": str(chip_id),
        })
        # RPC deadline for the job's lease iterator: InitJob can
        # legitimately block at the scheduler until the round boundary
        # (early dispatch), so the deadline must cover a full round —
        # and the total retry budget must cover the deadline, or the
        # first expiry would exhaust it and no retry would ever run.
        # Operator-set values win.
        deadline = max(60.0, 2 * self._round_duration + 60.0)
        env.setdefault("SWTPU_RPC_DEADLINE_S", str(deadline))
        env.setdefault("SWTPU_RPC_BUDGET_S", str(1.5 * deadline))
        return env

    # -- progress scraping -------------------------------------------------

    def _read_progress(self, job_id: int, round_id: int, worker_id: int):
        log_path = os.path.join(
            self._job_checkpoint_dir(job_id), ".swtpu",
            f"round={round_id}", f"worker={worker_id}.log")
        steps, duration, lines = 0, 0.0, []
        try:
            with open(log_path) as f:
                for line in f:
                    lines.append(line.rstrip("\n"))
                    if m := _PROGRESS_RE["steps"].search(line):
                        steps = int(m.group(1))
                    if m := _PROGRESS_RE["duration"].search(line):
                        duration = float(m.group(1))
        except FileNotFoundError:
            logger.warning("no iterator log for job %d round %d", job_id, round_id)
        return steps, duration, "\n".join(lines)

    # -- dispatch ----------------------------------------------------------

    def dispatch_jobs(self, jobs: List[dict], worker_id: int, round_id: int,
                      trace_parent=None):
        key = (tuple(j["job_id"] for j in jobs), worker_id, round_id)
        with self._lock:
            if key in self._accepted_dispatches:
                logger.warning("dropping duplicate RunJob %s (retry of an "
                               "already-accepted dispatch)", key)
                return
            self._accepted_dispatches[key] = round_id
            # Bounded memory: anything two rounds stale can no longer be
            # replayed (the scheduler's retry budget is well under two
            # rounds).
            for old in [k for k, r in self._accepted_dispatches.items()
                        if r < round_id - 2]:
                del self._accepted_dispatches[old]
        # Daemon thread, deliberately unreferenced: nothing ever joined
        # the old `_pool` list, so keeping thread handles was dead state
        # mutated concurrently by RunJob handlers (race-detector
        # finding) — removed rather than locked.
        threading.Thread(
            target=self._dispatch_jobs_helper,
            args=(jobs, worker_id, round_id, trace_parent),
            daemon=True).start()

    def _dispatch_jobs_helper(self, jobs: List[dict], worker_id: int,
                              round_id: int, trace_parent=None):
        from . import spans as spans_mod
        chip_id = self._chip_queue.get()
        results = []
        try:
            for job in jobs:
                if faults.get_injector().should_freeze("dispatch"):
                    # Injected wedge: hold the chip, launch nothing,
                    # report nothing — exactly what a hung process looks
                    # like to the scheduler's watchdogs.
                    logger.warning("[job %d] frozen by fault injection",
                                   job["job_id"])
                    self._shutdown.wait()
                    return
                command = self._construct_command(job, chip_id, worker_id)
                env = self._job_env(job, worker_id, round_id, chip_id)
                slowdown = faults.get_injector().slowdown("dispatch")
                if slowdown < 1.0:
                    # Gray-failure drill: the process runs, leases renew,
                    # Ping answers — only step throughput shrinks. The
                    # training side reads this to throttle itself (the
                    # stub workers scale their simulated rate by it).
                    env["SWTPU_DEGRADE_FACTOR"] = f"{slowdown:.6f}"
                launch_span = None
                if self._span_shard is not None:
                    # One `launch` span per trainer process (its whole
                    # lifetime), parented under the RunJob context; the
                    # trainer continues the trace from the env export.
                    launch_span = self._span_shard.open_span(
                        obs_names.SPAN_LAUNCH, parent=trace_parent,
                        job=job["job_id"], round=round_id,
                        worker=worker_id, chip=chip_id)
                    spans_mod.export_trace_env(
                        env, launch_span.context, self._trace_dir)
                cwd = self._run_dirs.get(job["mode"], ".")
                if job["working_directory"]:
                    cwd = os.path.join(cwd, job["working_directory"])
                logger.info("[job %d round %d chip %d] launching: %s",
                            job["job_id"], round_id, chip_id, command)
                start = time.time()
                proc = subprocess.Popen(
                    command, shell=True, cwd=cwd, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    start_new_session=True)
                with self._lock:
                    self._processes[job["job_id"]] = proc
                output, _ = proc.communicate()
                elapsed = time.time() - start
                with self._lock:
                    self._processes.pop(job["job_id"], None)
                steps, duration, iterator_log = self._read_progress(
                    job["job_id"], round_id, worker_id)
                if proc.returncode != 0:
                    logger.error("[job %d] exited %d:\n%s", job["job_id"],
                                 proc.returncode,
                                 output.decode(errors="replace")[-2000:])
                if duration <= 0 and steps > 0:
                    # Iterator made progress but its duration line is
                    # missing; fall back to wall clock. A (0 steps, 0 s)
                    # report must stay zeroed — it is the scheduler's
                    # micro-task-failure signal (reference:
                    # scheduler.py:4536-4568).
                    duration = elapsed
                if launch_span is not None:
                    self._span_shard.close_span(
                        launch_span, steps=steps,
                        returncode=proc.returncode)
                results.append((job["job_id"], steps, duration, iterator_log))
        finally:
            self._chip_queue.put(chip_id)
        from contextlib import nullcontext
        done_span = (self._span_shard.span(
            obs_names.SPAN_DONE_REPORT, parent=trace_parent,
            round=round_id, worker=worker_id,
            jobs=[r[0] for r in results])
            if self._span_shard is not None else nullcontext())
        try:
            with done_span:
                self._worker_rpc_client.notify_done(
                    job_ids=[r[0] for r in results], worker_id=worker_id,
                    num_steps=[r[1] for r in results],
                    execution_times=[r[2] for r in results],
                    iterator_logs=[r[3] for r in results])
            if self._span_shard is not None:
                self._span_shard.flush()
        except (RpcUnavailableError, grpc.RpcError) as e:
            # The scheduler stayed unreachable through the retry budget
            # — and, under control-plane HA, through the whole failover
            # window too (notify_done holds the report and redelivers
            # to a promoted leader re-resolved from the lease file
            # before this path is reached). Progress is durable in the
            # iterator log / checkpoint; the scheduler's round watchdog
            # synthesizes a failed micro-task and requeues the job, so
            # dropping the report is safe — and far better than a
            # dispatch thread wedged forever.
            logger.error("dropping Done report for jobs %s (round %d): %s",
                         [r[0] for r in results], round_id, e)

    # -- control -----------------------------------------------------------

    def kill_job(self, job_id: int, grace_s: float = 15.0):
        with self._lock:
            proc = self._processes.get(job_id)
        if proc is not None and proc.poll() is None:
            logger.info("killing job %d (pid %d)", job_id, proc.pid)
            # SIGTERM first so the job's handler (train_common.parse_args)
            # can run its finally/atexit cleanup: the checkpoint save and
            # the lease's final [PROGRESS] lines.
            try:
                pgid = os.getpgid(proc.pid)
                os.killpg(pgid, signal.SIGTERM)
            except ProcessLookupError:
                return

            def escalate():
                try:
                    proc.wait(timeout=grace_s)
                except subprocess.TimeoutExpired:
                    logger.warning("job %d survived SIGTERM for %.0fs; "
                                   "SIGKILL", job_id, grace_s)
                    try:
                        os.killpg(pgid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                    return
                # The group leader exited, but a forked helper (data
                # loader) may have ignored SIGTERM and still hold the
                # chip. Probe the group: killpg(pgid, 0) succeeds iff
                # members remain (the leader's exit is known, so the
                # pgid cannot have been recycled while the group lives —
                # a pgid persists until its last member dies).
                try:
                    os.killpg(pgid, 0)
                except ProcessLookupError:
                    return  # whole group gone: clean exit
                logger.warning("job %d leader exited but group %d has "
                               "survivors; SIGKILL group", job_id, pgid)
                try:
                    os.killpg(pgid, signal.SIGKILL)
                except ProcessLookupError:
                    pass

            # Escalate off-thread: the KillJob RPC handler (and with it the
            # scheduler's _kill_job, which holds its condition variable
            # across the RPC) must not block for the grace window.
            threading.Thread(target=escalate, daemon=True).start()

    def reset(self):
        with self._lock:
            job_ids = list(self._processes)
        for job_id in job_ids:
            self.kill_job(job_id)

    def shutdown(self):
        self._shutdown.set()
        self.reset()
