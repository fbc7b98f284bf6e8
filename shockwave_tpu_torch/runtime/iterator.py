"""LeaseIterator: the job-side cooperative-preemption runtime, on PyTorch.

The port of `shockwave_tpu/runtime/iterator.py`. It wraps a training
input pipeline; each `next()` accounts one step against a
scheduler-granted lease and renews the lease at 75% consumption. When the
lease expires the iterator raises StopIteration so the training loop can
checkpoint and exit; the worker daemon then reports progress back. The
lease arithmetic, the run-ahead window, the degrade drill, the
checkpoint-ahead reconcile, the measured-telemetry buffer and the log
lines (the `[PROGRESS]` lines the dispatcher scrapes) are the
reference's.

- Eager PyTorch on the card is asynchronous like JAX dispatch: the Python
  loop can run far ahead of the device, and a step's wall time lies
  unless the host waits. The iterator syncs on the caller-provided
  `sync_ref` (the last step's loss) only at lease checks, and bounds
  run-ahead with a sliding window of sync refs, drained in batches: once
  SWTPU_RUNAHEAD_STEPS (default 8) extra steps are queued past the
  window, it blocks on the oldest batch's newest ref, so run-ahead stays
  under twice the window and every renewal (the job's heartbeat) goes
  out on time.
- The device sync is the one intended divergence from the reference:
  `_device_sync` waits with `.item()` on a CUDA tensor (the counterpart
  of the reference's one-scalar `device_get`), does nothing for a CPU
  tensor, and lets a failure propagate. The reference catches it and
  logs a warning; on the card a failed sync is a real fault (a failed
  kernel, a lost device), and catching it would hide the device.
- Gangs (multi-process jobs, `parallel/mesh.py`) get the reference's
  gang hooks: every time-based decision is agreed across the gang at
  `gang_sync_every`-step boundaries (duration by max, grants by min),
  and the exit waits at a barrier so that the gang's checkpoint, which
  rank 0 writes, is consistent. Gangs drop the run-ahead window: the
  boundary sync bounds them, as in the reference.
- Fleet tracing is the reference's: with SWTPU_SPAN_SHARD_DIR set (the
  dispatcher exports it beside the launch span's SWTPU_TRACEPARENT), a
  `trainer` span covers the dispatch from construction to the lease's
  end or `close()`, and the caller's checkpoint functions run under
  `ckpt-load` and `ckpt-save` spans, in this process's span shard.
- Checkpointing is delegated to caller functions.
- Cut to what the port's jobs use: the final `[PROGRESS]` lines are
  always written at close (the reference's default `write_on_close`).

Environment contract (set by the dispatcher):
  SWTPU_JOB_ID, SWTPU_WORKER_ID, SWTPU_ROUND_ID, SWTPU_SCHED_ADDR,
  SWTPU_SCHED_PORT
"""
from __future__ import annotations

import atexit
import collections
import logging
import os
import time
from typing import Any, Callable, Iterable, Optional

import torch

from ..obs import names as obs_names
from . import spans as spans_mod
from .clients import IteratorToSchedulerClient
from .lease import Lease

INFINITY = 1e9
LEASE_UPDATE_FRACTION = 0.75
LOG_FORMAT = "[{asctime}] [{event}] [{status}] {message}"
DATE_FORMAT = "%Y-%m-%d %H:%M:%S"


def _device_sync(value: Any) -> None:
    """Block until the device work producing `value` is complete.

    `value` is the caller's sync ref, the step's loss. On a CUDA tensor,
    reading one element to the host waits for its producer (and, since
    the steps run in order on one stream, for every step before it). A
    CPU tensor or None needs no wait. A CUDA error raised here propagates
    (see the module docstring)."""
    if isinstance(value, torch.Tensor) and value.is_cuda and value.numel():
        value.reshape(-1)[0].item()


class LeaseIterator:
    def __init__(self, data_loader: Iterable, checkpoint_dir: str,
                 load_checkpoint_func: Callable, save_checkpoint_func: Callable,
                 synthetic_data: bool = False,
                 distributed_barrier: Optional[Callable] = None,
                 gang_allreduce: Optional[Callable] = None,
                 gang_sync_every: int = 16):
        """gang_allreduce(value, op) -> float ("max"/"min" across the
        gang) makes every time-based decision step-deterministic for
        multi-process gangs: lease grants are agreed by min at grant
        time, the running duration is agreed by max at `gang_sync_every`
        step boundaries, and time-based expiry/renewal checks only fire
        at those boundaries, so all members take identical control paths
        at identical steps and none enters the exit barrier while a peer
        still issues training collectives. Steps-based checks are
        deterministic already (the scheduler's first-requester-computes
        consensus)."""
        self._data_loader = data_loader
        self._load_checkpoint_func = load_checkpoint_func
        self._save_checkpoint_func = save_checkpoint_func
        # Batch caching is only sound when the loader itself is
        # synthetic; gate here (the loader is in hand) so no caller can
        # collapse a real dataset to one cached batch by passing the
        # CLI flag through unguarded.
        self._synthetic_data = (synthetic_data
                                and getattr(data_loader, "synthetic", True))
        self._distributed_barrier = distributed_barrier
        self._gang_allreduce = gang_allreduce
        self._gang_sync_every = max(int(gang_sync_every), 1)
        # Absolute agreed-duration threshold for the next time-triggered
        # renewal (gang mode replaces the per-step countdown, which
        # drifts epsilon-differently on every member's local clock).
        self._renewal_duration_threshold = INFINITY

        self._job_id = int(os.environ["SWTPU_JOB_ID"])
        self._worker_id = int(os.environ["SWTPU_WORKER_ID"])
        self._round_id = int(os.environ["SWTPU_ROUND_ID"])
        sched_addr = os.environ["SWTPU_SCHED_ADDR"]
        sched_port = int(os.environ["SWTPU_SCHED_PORT"])

        round_dir = os.path.join(checkpoint_dir, ".swtpu",
                                 f"round={self._round_id}")
        os.makedirs(round_dir, exist_ok=True)
        self._log_file = os.path.join(round_dir,
                                      f"worker={self._worker_id}.log")
        self._init_logger()

        # Fleet tracing (opt-in): continue the dispatch's trace inside
        # this training process. The dispatcher exports the launch
        # span's context + the shard directory into the environment
        # (runtime/spans.py); the `trainer` span covers this dispatch's
        # whole lease window and is closed (with the step count) at
        # lease expiry / completion / close / process exit, whichever
        # first.
        self._span_shard = spans_mod.shard_from_env(role="trainer")
        self._trainer_span = None
        self._trainer_ctx = None
        if self._span_shard is not None:
            self._trainer_span = self._span_shard.open_span(
                obs_names.SPAN_TRAINER, parent=spans_mod.from_environ(),
                job=self._job_id, worker=self._worker_id,
                round=self._round_id)
            # Kept past the span's close: the post-lease checkpoint
            # save (the one every dispatch performs) still parents its
            # ckpt-save span here.
            self._trainer_ctx = self._trainer_span.context
            atexit.register(self._close_trainer_span)

        self._rpc = IteratorToSchedulerClient(
            self._job_id, self._worker_id, sched_addr, sched_port)

        self._steps = 0
        self._duration = 0.0
        self._done = False
        # Gray-failure drill hook (runtime/faults.py `degrade` rules):
        # the dispatcher exports SWTPU_DEGRADE_FACTOR when an injected
        # slowdown covers this dispatch, and the iterator honors it by
        # padding each step to compute_time / factor — the process
        # stays fully live (renewals, heartbeats, checkpoints) while
        # its step rate drops to `factor` of normal.
        try:
            self._degrade_factor = min(max(float(
                os.environ.get("SWTPU_DEGRADE_FACTOR", "") or 1.0),
                1e-3), 1.0)
        except ValueError:
            self._degrade_factor = 1.0
        self._last_degrade_sleep = 0.0
        self._sync_ref: Any = None
        # Sliding window bounding async run-ahead (module docstring).
        self._runahead = max(
            int(os.environ.get("SWTPU_RUNAHEAD_STEPS", "8")), 1)
        self._sync_window: "collections.deque" = collections.deque()
        self._last_windowed_ref: Any = None
        self._steps_without_new_ref = 0
        self._warned_static_ref = False
        self._cached_batch = None
        self._lease = Lease(0, 0)
        #: Measured-serving telemetry lines awaiting the next renewal.
        self._measured_buffer: list = []
        self._closed = False
        atexit.register(self.close)
        self._update_lease(init=True)
        self._write_info()
        # Start the clock at construction: shared-filesystem reads before the
        # first step can take tens of seconds and must count against the lease.
        self._prev_time = time.time()

    # -- iteration ---------------------------------------------------------

    def __iter__(self):
        self._iterator = iter(self._data_loader)
        return self

    def __len__(self):
        return len(self._data_loader)

    def set_sync_ref(self, value: Any) -> None:
        """Give the iterator a device value (e.g. the last loss) to sync on
        when honest timing is needed."""
        self._sync_ref = value

    def log_measurement(self, payload: str) -> None:
        """Append one measured-telemetry line to the iterator log. The
        worker daemon ships the whole log back on the Done heartbeat,
        so this is the job->scheduler telemetry channel that needs no
        new RPC field (serving replicas' request-latency sketch deltas;
        the scheduler's log fold routes marked lines to its serving
        tier)."""
        self._logger.info(payload, extra={"event": "SERVING",
                                          "status": "MEASURED"})

    def queue_measurement(self, payload: str) -> None:
        """Buffer one measured-telemetry line for the NEXT lease
        renewal (UpdateLeaseRequest.measured_reports): a sticky serving
        replica can hold one extended lease for its whole life, so
        renewals — not Done — are its per-round channel. Whatever was
        never shipped on a renewal is flushed to the iterator log at
        exit and arrives with Done instead; the consumer dedupes by
        the payload's (round, seq), so double delivery is harmless."""
        self._measured_buffer.append(payload)

    def _flush_measured_to_log(self) -> None:
        """Exit path: unsent measured telemetry rides the Done report's
        log channel (idempotent — the buffer drains)."""
        buffered, self._measured_buffer = self._measured_buffer, []
        for payload in buffered:
            self.log_measurement(payload)

    def __next__(self):
        now = time.time()
        if self._prev_time is None:
            self._prev_time = now
        elapsed = now - self._prev_time
        self._duration += elapsed
        self._prev_time = now

        if self._degrade_factor < 1.0:
            # Injected slowdown: pad the step by compute/factor -
            # compute. The previous pad is subtracted from `elapsed`
            # first, or each round's pad would compound on the last
            # one's instead of on the real compute time.
            compute = max(elapsed - self._last_degrade_sleep, 0.0)
            pause = compute * (1.0 / self._degrade_factor - 1.0)
            if pause > 0:
                time.sleep(pause)
                self._last_degrade_sleep = pause
                slept_until = time.time()
                self._duration += slept_until - self._prev_time
                elapsed += slept_until - self._prev_time
                self._prev_time = slept_until
            else:
                self._last_degrade_sleep = 0.0

        gang = self._gang_allreduce is not None
        if not gang:
            # Bound async run-ahead: enqueue the newest sync ref (the
            # previous step's loss) and block on the ref from `runahead`
            # steps back. Free when the device keeps up; otherwise an
            # honest wait that keeps the step counter, the duration clock,
            # and the queued backlog within `runahead` steps of the device
            # — so lease checks fire on time and a lease-boundary sync
            # never has to drain a deep queue while heartbeats are due.
            # (Gangs get the same bound from their boundary sync below.)
            if (self._sync_ref is not None
                    and self._sync_ref is not self._last_windowed_ref):
                self._sync_window.append(self._sync_ref)
                self._last_windowed_ref = self._sync_ref
                self._steps_without_new_ref = 0
            else:
                # Without a fresh per-step ref the window cannot grow and
                # the run-ahead bound silently disappears — warn once so
                # the caller knows to set_sync_ref every step.
                self._steps_without_new_ref += 1
                if (self._steps_without_new_ref > 2 * self._runahead
                        and not self._warned_static_ref):
                    self._warned_static_ref = True
                    self._logger.warning(
                        "no fresh sync ref for %d steps: async run-ahead "
                        "is unbounded and lease timing/heartbeats may "
                        "degrade; call set_sync_ref(loss) every step",
                        self._steps_without_new_ref)
            if len(self._sync_window) >= 2 * self._runahead:
                # Steps execute in dispatch order (one stream, each step
                # reading the last one's weights), so syncing the newest
                # ref of the drained batch proves everything before it
                # finished: one device round trip per `runahead` steps,
                # with run-ahead in [runahead, 2*runahead).
                newest_drained = None
                while len(self._sync_window) > self._runahead:
                    newest_drained = self._sync_window.popleft()
                _device_sync(newest_drained)
                sync_now = time.time()
                waited = sync_now - self._prev_time
                self._duration += waited
                elapsed += waited  # feeds the renewal countdown below
                self._prev_time = sync_now
        # Gang members only evaluate time-based conditions at shared
        # K-step boundaries, on an agreed (max-allreduced) duration, so
        # the whole gang reaches the same verdict at the same step.
        boundary = (not gang) or (self._steps % self._gang_sync_every == 0)
        if gang and boundary:
            _device_sync(self._sync_ref)
            sync_now = time.time()
            self._duration += sync_now - self._prev_time
            self._prev_time = sync_now
            self._duration = max(
                self._duration,
                float(self._gang_allreduce(self._duration, "max")))

        time_renewal_due = boundary and (
            self._duration >= self._renewal_duration_threshold if gang
            else self._time_until_lease_update <= 0)
        if self._steps_until_lease_update <= 0 or time_renewal_due:
            # Sync outstanding device work so self._duration is honest at the
            # renewal boundary.
            _device_sync(self._sync_ref)
            sync_now = time.time()
            self._duration += sync_now - self._prev_time
            self._prev_time = sync_now
            self._update_lease()

        if ((boundary and self._duration >= self._lease.max_duration)
                or self._steps >= self._lease.max_steps):
            self._done = True
            self._logger.info(
                "%d / %s steps, %.4f / %.4f seconds",
                self._steps, self._lease.max_steps, self._duration,
                self._lease.max_duration,
                extra={"event": "LEASE", "status": "EXPIRED"})
            _device_sync(self._sync_ref)
            self._close_trainer_span()
            if self._distributed_barrier is not None:
                self._distributed_barrier()
            raise StopIteration

        try:
            if self._synthetic_data and self._cached_batch is not None:
                value = self._cached_batch
            else:
                value = next(self._iterator)
                if self._synthetic_data:
                    self._cached_batch = value
            self._steps += 1
        except StopIteration:
            self._write_info()
            raise

        if self._synthetic_data and self._steps % len(self._data_loader) == 0:
            raise StopIteration

        self._steps_until_lease_update -= 1
        self._time_until_lease_update -= elapsed
        return value

    # -- job-side API ------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done

    def complete(self, timeout: bool = False) -> None:
        self._done = True
        self._close_trainer_span()
        self._logger.info("", extra={"event": "LEASE", "status": "COMPLETE"})

    def report_checkpoint_ahead(self) -> None:
        """The restored checkpoint already satisfies the job's FULL step
        budget although this dispatch ran 0 steps: the previous worker
        died after the checkpoint was saved but before its progress
        report reached the scheduler (the failed-in-round synthesis
        reports 0 steps). The scheduler's missing delta is exactly what
        it granted this dispatch (remaining = total - its own count), so
        reporting the initial lease grant reconverges its accounting
        with the durable checkpoint — instead of exiting (0, 0), the
        micro-task-failure signal, every round until the job is dropped.
        """
        self._steps = int(self._lease.max_steps)
        self._duration = max(self._duration, time.time() - self._prev_time,
                             1e-3)
        self._done = True
        self._logger.info(
            "checkpoint already at budget; reporting granted remainder %d",
            self._steps, extra={"event": "LEASE", "status": "CKPT_AHEAD"})

    def update_resource_requirement(self, big_bs: bool, small_bs: bool) -> None:
        """Report a batch-size change request; the job must checkpoint and
        exit."""
        self._done = True
        self._rpc.update_resource_requirement(big_bs, small_bs)

    def _ckpt_span(self, name):
        """Checkpoint spans nest under the trainer span's context —
        which outlives the span's close, because the standard flow is
        lease expiry (span closed) THEN save_checkpoint. No-op context
        without a shard."""
        from contextlib import nullcontext
        if self._span_shard is None or self._trainer_ctx is None:
            return nullcontext()
        return self._span_shard.span(name, parent=self._trainer_ctx,
                                     job=self._job_id)

    def _close_trainer_span(self) -> None:
        """Close (once) the dispatch-lifetime trainer span with the
        final step count; runs at lease exit and again harmlessly from
        close() and atexit for loops that end otherwise."""
        if self._span_shard is None or self._trainer_span is None:
            return
        span, self._trainer_span = self._trainer_span, None
        self._span_shard.close_span(span, steps=self._steps,
                                    done=self._done)

    def load_checkpoint(self, *args, **kwargs):
        self._logger.info("", extra={"event": "LOAD CHECKPOINT", "status": "BEGIN"})
        with self._ckpt_span(obs_names.SPAN_CKPT_LOAD):
            out = self._load_checkpoint_func(*args, **kwargs)
        self._logger.info("", extra={"event": "LOAD CHECKPOINT", "status": "END"})
        return out

    def save_checkpoint(self, *args, **kwargs):
        self._logger.info("", extra={"event": "SAVE CHECKPOINT", "status": "BEGIN"})
        with self._ckpt_span(obs_names.SPAN_CKPT_SAVE):
            out = self._save_checkpoint_func(*args, **kwargs)
        self._logger.info("", extra={"event": "SAVE CHECKPOINT", "status": "END"})
        return out

    def close(self) -> None:
        """The exit path, run once: flush buffered telemetry to the log,
        write the final `[PROGRESS]` lines, close the log and the trainer
        span. Registered with atexit, as the reference's exit hooks are;
        a caller that runs more than one dispatch in one process calls it
        when its loop ends."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.close)
        self._flush_measured_to_log()
        self._write_info()
        self._logger.removeHandler(self._file_handler)
        self._file_handler.close()
        self._close_trainer_span()
        atexit.unregister(self._close_trainer_span)

    # -- lease protocol ----------------------------------------------------

    def _update_lease(self, init: bool = False) -> None:
        if init:
            max_steps, max_duration, extra_time = self._rpc.init()
        else:
            # Piggyback buffered measured-serving telemetry on the
            # renewal; cleared only after the RPC returned (a failed
            # renewal keeps the deltas for the next attempt / the
            # exit-path log flush — the consumer dedupes by seq).
            shipping = list(self._measured_buffer)
            max_steps, max_duration, run_time_so_far, deadline = (
                self._rpc.update_lease(self._steps, self._duration,
                                       self._lease.max_steps,
                                       self._lease.max_duration,
                                       measured_reports=shipping or None))
            del self._measured_buffer[:len(shipping)]
            extra_time = 0.0
            if self._duration + run_time_so_far > deadline:
                # Deadline enforcement: scheduler says we have overrun 1.5x
                # our expected duration; finish now.
                self._logger.info(
                    "over deadline (%.1f + %.1f > %.1f)", self._duration,
                    run_time_so_far, deadline,
                    extra={"event": "LEASE", "status": "DEADLINE"})
                # Gang members reach this with agreed durations at the
                # same step, so all exit together; the barrier keeps the
                # gang checkpoint consistent either way.
                if self._distributed_barrier is not None:
                    self._distributed_barrier()
                self.complete(timeout=True)
                raise StopIteration

        if self._gang_allreduce is not None:
            # Agree the grant across the gang (min is the safe direction:
            # nobody outruns a peer's lease). Steps are already identical
            # via the scheduler's first-requester-computes consensus;
            # durations can differ by RPC-arrival epsilons.
            max_steps = int(self._gang_allreduce(max_steps, "min"))
            max_duration = float(self._gang_allreduce(max_duration, "min"))
            extra_time = float(self._gang_allreduce(extra_time, "min"))

        # Plan the next renewal at LEASE_UPDATE_FRACTION of the new grant; an
        # unchanged grant means this lease is final.
        if max_steps == self._lease.max_steps:
            self._steps_until_lease_update = INFINITY
        else:
            additional = max_steps - self._lease.max_steps
            left = self._lease.max_steps - self._steps
            self._steps_until_lease_update = (
                left + additional * LEASE_UPDATE_FRACTION)
        if max_duration <= self._lease.max_duration:
            self._time_until_lease_update = INFINITY
            self._renewal_duration_threshold = INFINITY
        else:
            additional = max_duration - self._lease.max_duration
            left = self._lease.max_duration - self._duration
            self._time_until_lease_update = (
                left + additional * LEASE_UPDATE_FRACTION + extra_time)
            self._renewal_duration_threshold = (
                self._duration + self._time_until_lease_update)

        self._lease.max_steps = max_steps
        self._lease.max_duration = max_duration + extra_time

    # -- logging -----------------------------------------------------------

    def _init_logger(self):
        self._logger = logging.getLogger(f"lease_iterator.{self._job_id}")
        self._logger.propagate = False
        self._logger.setLevel(logging.DEBUG)
        self._file_handler = logging.FileHandler(self._log_file)
        self._file_handler.setFormatter(
            logging.Formatter(LOG_FORMAT, datefmt=DATE_FORMAT, style="{"))
        self._logger.addHandler(self._file_handler)

    def _write_info(self):
        self._logger.info("%d", self._steps,
                          extra={"event": "PROGRESS", "status": "STEPS"})
        self._logger.info("%f", self._duration,
                          extra={"event": "PROGRESS", "status": "DURATION"})


# Alias for users migrating from the reference framework.
GavelIterator = LeaseIterator
