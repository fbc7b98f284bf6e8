"""Worker daemon: registers this host's CUDA cards with the scheduler and
dispatches training jobs onto them. The port of
`shockwave_tpu/runtime/worker.py`; the scheduler is the reference's,
unchanged.

Usage (from the repository root, so the default run dir resolves):
    python -m shockwave_tpu_torch.runtime.worker \\
        --worker_type h100 --sched_addr 10.0.0.2 --sched_port 50070 \\
        --worker_port 50061 --checkpoint_dir /nfs/ckpt

The cards are counted with `torch.cuda.device_count()`; with none and no
`--num_chips`, the daemon refuses to start (there is no CPU fallback).
Jobs resolve their trace `working_directory` under the run dirs,
`shockwave_tpu_torch/workloads` by default, which holds every job type
the reference's worker runs: the canonical trace's families
(translation, language_modeling, recommendation,
image_classification/{cifar10,imagenet}), A3C (`rl`), CycleGAN
(`cyclegan`) and the serving replica (`serving`; the `serving` mode
resolves under the static run dir, as in the reference).
A job of scale factor N reaches N of this daemon's cards (or N daemons'
cards) as N RunJobs whose commands carry the gang's rendezvous flags;
each rank gets its own card and the same `--checkpoint_dir`, and the
ranks train as one data-parallel gang (`parallel/mesh.py`). Ranks on
several hosts need a checkpoint root that all of them read, since rank
0 alone writes the gang's checkpoint.
The scheduler plans port workers of type `h100` from
`data/h100_throughputs.json` (`profiling/measure_throughput.py`).
`--obs_port` serves this daemon's `/metrics` and `/healthz`;
`--trace_dir` (or SWTPU_SPAN_SHARD_DIR) writes its span shard, and its
trainers', into the drive's trace directory, where the JAX package's
scheduler merges them with its own (`run_physical.py --trace_dir`).
"""
from __future__ import annotations

import argparse
import logging
import os
import signal
import threading
import time

import grpc

from ..obs import get_observability
from ..obs import names as obs_names
from ..obs.logconfig import LEVELS, setup_logging
from . import resilience
from .clients import WorkerToSchedulerClient
from .dispatcher import Dispatcher
from .servers import get_host_ip, serve_worker

logger = logging.getLogger("shockwave_tpu_torch.runtime")

REGISTER_RETRY_WINDOW_S = 300.0
REGISTER_RETRY_INTERVAL_S = 5.0
RUN_DIR = "shockwave_tpu_torch/workloads"


def detect_num_chips() -> int:
    """CUDA cards visible to this process (0 without a card)."""
    import torch
    return torch.cuda.device_count()


class WorkerDaemon:
    def __init__(self, worker_type: str, sched_addr: str, sched_port: int,
                 worker_port: int, num_chips: int, run_dirs: dict,
                 data_dir: str, checkpoint_dir: str,
                 obs_port: int = None, trace_dir: str = None):
        self._shutdown_event = threading.Event()
        # Written by RunJob handlers (gRPC pool threads), read by the obs
        # exporter's request thread (/healthz).
        self._lock = threading.Lock()
        self._obs = get_observability()
        self._obs_server = None
        if obs_port is not None:
            from ..obs.exporter import ObsHttpServer
            self._obs_server = ObsHttpServer(
                self._obs.registry, health_fn=self._obs_health,
                port=obs_port).start()
        self._worker_type = worker_type
        self._last_dispatch_time = 0.0
        # Fleet tracing (opt-in): this daemon's bounded span shard in
        # the drive's trace directory; scheduler-propagated span
        # contexts (RunJob metadata) parent this daemon's runjob/launch
        # spans, and the dispatcher forwards them into trainers.
        from . import spans
        self._trace_dir = trace_dir or spans.trace_dir_from_env()
        self._span_shard = spans.init_process_shard(self._trace_dir,
                                                    role="worker")
        self._rpc_client = WorkerToSchedulerClient(sched_addr, sched_port)

        # Control-plane HA: reject dispatches from a deposed leader
        # (stale epoch -> FAILED_PRECONDITION via the server fence) and
        # chase a promoted one (advanced epoch -> re-resolve the
        # scheduler endpoint / reset breakers before its work runs).
        self._fence = resilience.EpochFence()

        callbacks = {
            "RunJob": self._run_job,
            "KillJob": self._kill_job,
            "Reset": self._reset,
            "Shutdown": self._shutdown,
        }
        self._server = serve_worker(worker_port, callbacks,
                                    fence=self._fence,
                                    on_epoch_advance=self._on_epoch_advance)

        # Daemons race the scheduler at cluster bring-up (and the
        # scheduler may spend a minute importing before its server
        # listens), so registration retries with backoff instead of
        # dying on the first connection refusal.
        deadline = time.monotonic() + REGISTER_RETRY_WINDOW_S
        while True:
            try:
                worker_ids, round_duration = self._rpc_client.register_worker(
                    worker_type=worker_type, ip_addr=get_host_ip(),
                    port=worker_port, num_chips=num_chips)
                break
            except grpc.RpcError as e:
                # Registration carries a per-attempt deadline, so a
                # stalled (not just absent) scheduler surfaces as
                # DEADLINE_EXCEEDED — retry both transport codes.
                if (not resilience.is_retryable(e)
                        or time.monotonic() >= deadline):
                    # Don't leave the control server listening on a
                    # half-constructed daemon (its handlers dereference
                    # a dispatcher that was never built).
                    self._server.stop(grace=0)
                    raise
                logger.info("scheduler at %s:%d unavailable; retrying",
                            sched_addr, sched_port)
                time.sleep(REGISTER_RETRY_INTERVAL_S)
        logger.info("registered %d chips as workers %s (round %.0fs)",
                    num_chips, worker_ids, round_duration)
        self._worker_ids = worker_ids
        # Done may legitimately block at the scheduler until the round
        # boundary (early finisher); its deadline must cover a round.
        self._rpc_client.stretch_done_deadline(round_duration + 60.0)

        os.makedirs(checkpoint_dir, exist_ok=True)
        self._dispatcher = Dispatcher(
            round_duration, chip_ids=list(range(num_chips)),
            worker_rpc_client=self._rpc_client, sched_addr=sched_addr,
            sched_port=sched_port, run_dirs=run_dirs, data_dir=data_dir,
            checkpoint_dir=checkpoint_dir,
            span_shard=self._span_shard, trace_dir=self._trace_dir)

    def _on_epoch_advance(self, epoch: int) -> None:
        """A new leader's first dispatch reached this daemon: point the
        report channel at it before the dispatched work needs to Done
        (the client also self-heals lazily on its next failure, but the
        eager refresh saves the first post-failover report a full
        failover-retry loop)."""
        logger.warning("leader epoch advanced to %d; re-resolving "
                       "scheduler endpoint", epoch)
        self._rpc_client.refresh_endpoint()

    def _obs_health(self) -> dict:
        with self._lock:
            last_dispatch = self._last_dispatch_time
        return {
            "worker_type": self._worker_type,
            "worker_ids": list(getattr(self, "_worker_ids", [])),
            "leader_epoch_seen": self._fence.epoch,
            "last_dispatch_age_s": round(
                time.time() - last_dispatch, 3)
            if last_dispatch else None,
        }

    def _run_job(self, jobs, worker_id, round_id, trace=None):
        # Worker-side dispatch heartbeat: a daemon that stops receiving
        # RunJobs (partitioned, or starved by the scheduler) shows up as
        # a growing age on this stamp.
        now = time.time()
        with self._lock:
            self._last_dispatch_time = now
        self._obs.inc(obs_names.WORKER_JOBS_DISPATCHED_TOTAL)
        self._obs.set_gauge(obs_names.WORKER_LAST_DISPATCH_TIMESTAMP, now)
        parent, send_ts = trace if trace is not None else (None, None)
        if self._span_shard is not None:
            # The runjob span records this host's RECEIVE stamp beside
            # the scheduler's send stamp — the RPC timestamp pair the
            # merge aligns per-host clocks from. The launch span (the
            # trainer process's lifetime) is the dispatcher's.
            with self._span_shard.span(
                    obs_names.SPAN_RUNJOB, parent=parent,
                    round=round_id, worker=worker_id,
                    jobs=[j["job_id"] for j in jobs],
                    **({"send_ts": send_ts} if send_ts is not None
                       else {})) as ctx:
                self._dispatcher.dispatch_jobs(jobs, worker_id, round_id,
                                               trace_parent=ctx)
        else:
            self._dispatcher.dispatch_jobs(jobs, worker_id, round_id)

    def _kill_job(self, job_id):
        self._dispatcher.kill_job(job_id)

    def _reset(self):
        self._dispatcher.reset()

    def _shutdown(self):
        self._dispatcher.shutdown()
        self._shutdown_event.set()

    def join(self):
        self._shutdown_event.wait()
        self._server.stop(grace=1)
        if self._span_shard is not None:
            from . import spans
            spans.flush()
        if self._obs_server is not None:
            self._obs_server.stop()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--worker_type", "-t", default="h100")
    p.add_argument("--sched_addr", "-i", required=True)
    p.add_argument("--sched_port", "-s", type=int, default=50070)
    p.add_argument("--worker_port", "-w", type=int, default=50061)
    p.add_argument("--num_chips", "-g", type=int, default=None,
                   help="default: torch.cuda.device_count()")
    p.add_argument("--static_run_dir", default=RUN_DIR)
    p.add_argument("--accordion_run_dir", default=RUN_DIR)
    p.add_argument("--gns_run_dir", default=RUN_DIR)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--checkpoint_dir", required=True,
                   help="per-deployment checkpoint root; each daemon needs its own")
    p.add_argument("--obs_port", type=int, default=None,
                   help="serve /metrics + /healthz for this daemon "
                        "(0 = ephemeral port; default disabled)")
    p.add_argument("--trace_dir", default=None,
                   help="directory this daemon (and its trainer "
                        "subprocesses) write span shards into; merge "
                        "with python -m shockwave_tpu.obs.merge "
                        f"(default: ${obs_names.SHARD_DIR_ENV}, else "
                        "disabled)")
    p.add_argument("--log_level", default="info", choices=LEVELS)
    args = p.parse_args(argv)

    setup_logging(args.log_level)

    num_chips = args.num_chips if args.num_chips is not None else detect_num_chips()
    if num_chips <= 0:
        raise RuntimeError("no CUDA devices detected; pass --num_chips")

    daemon = WorkerDaemon(
        worker_type=args.worker_type, sched_addr=args.sched_addr,
        sched_port=args.sched_port, worker_port=args.worker_port,
        num_chips=num_chips,
        run_dirs={"static": args.static_run_dir,
                  "accordion": args.accordion_run_dir,
                  "gns": args.gns_run_dir,
                  # Serving replicas (workloads/serving/serve.py)
                  # live in the same tree as the static training mains.
                  "serving": args.static_run_dir},
        data_dir=args.data_dir, checkpoint_dir=args.checkpoint_dir,
        obs_port=args.obs_port, trace_dir=args.trace_dir)
    signal.signal(signal.SIGINT, lambda s, f: daemon._shutdown())
    daemon.join()


if __name__ == "__main__":
    main()
