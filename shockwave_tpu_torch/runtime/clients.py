"""gRPC clients of the job side and the worker daemon: the port's copy
of `WorkerToSchedulerClient` and `IteratorToSchedulerClient` from
`shockwave_tpu/runtime/clients.py` (`SchedulerToWorkerClient` is the
scheduler's and stays in the JAX package).

Every call carries a deadline and rides the resilience layer
(`resilience.py`): bounded exponential-backoff retry on transport
failures. No call in this module can block indefinitely.

Control-plane HA (``SWTPU_HA_ENDPOINT_FILE`` / `endpoint_file`): the
worker->scheduler clients can re-resolve the scheduler endpoint from
the leader lease file across a failover. On a transport failure (or a
fenced ex-leader's FAILED_PRECONDITION), the report is held in the
calling thread and retried against freshly-resolved endpoints for the
failover budget; the per-scheduler circuit breaker fails the dead-
leader window fast and is RESET whenever the endpoint or leader epoch
changes, so the new leader never inherits an open circuit from the
dead one's era. Duplicate delivery stays impossible: the promoted
leader's recovery cleared its dispatch stamps, so a replayed pre-
failover report is rejected by the existing orphan/dedup gates.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import grpc

from .proto import control_pb2 as pb
from .resilience import (CircuitBreaker, RetryPolicy, RpcUnavailableError,
                         call_with_retry, policy_from_env)
from .rpc import Stub

logger = logging.getLogger("shockwave_tpu_torch.runtime")

#: Poll cadence of the worker-side failover retry loop.
FAILOVER_RETRY_INTERVAL_S = 0.25


def _ha_endpoint_file(explicit: Optional[str]) -> Optional[str]:
    if explicit is not None:
        return explicit or None
    return os.environ.get("SWTPU_HA_ENDPOINT_FILE") or None


def _read_endpoint(path: str) -> Optional[Tuple[str, int, int]]:
    """(addr, port, epoch) from a leader lease file, or None when the
    file is absent/unparseable (pre-first-lease bring-up)."""
    try:
        with open(path) as f:
            lease = json.load(f)
        return (str(lease["addr"]), int(lease["port"]),
                int(lease.get("epoch", 0)))
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _read_lease_budget(path: str) -> Optional[float]:
    """The leader-advertised failover_budget_s from the lease file (the
    --ha config's worker-side half arrives through the lease, not the
    environment), or None when absent."""
    try:
        with open(path) as f:
            budget = json.load(f).get("failover_budget_s")
        return None if budget is None else float(budget)
    except (OSError, ValueError, TypeError):
        return None


def _is_fenced_leader_error(error: Exception) -> bool:
    """A FAILED_PRECONDITION from a fenced ex-leader (or a fence
    rejection): the peer is alive but no longer the leader — re-resolve
    instead of retrying the same endpoint."""
    return (isinstance(error, grpc.RpcError)
            and error.code() == grpc.StatusCode.FAILED_PRECONDITION)


#: Worker/iterator -> scheduler: more patient (the scheduler may be
#: solving a MILP), but still bounded.
SCHED_RPC_POLICY = RetryPolicy(deadline_s=30.0, total_budget_s=90.0,
                               max_attempts=4)


class WorkerToSchedulerClient:
    """Worker daemon -> scheduler.

    With an HA endpoint file (explicit or $SWTPU_HA_ENDPOINT_FILE),
    the client re-resolves the scheduler address from the leader lease
    whenever a call fails, carries a per-scheduler-channel circuit
    breaker so the dead-leader window fails fast, and retries held
    reports against the new leader for `failover_budget_s` — the
    "buffered and retried across the failover window" contract."""

    # Endpoint re-resolution state (`_sched_addr`, `_sched_port`,
    # `_channel`, `_stub`, `_epoch`): `_connect`/`refresh_endpoint`
    # rebind these as atomic reference swaps from whichever dispatch or
    # report thread first observes the failover; a concurrent RPC that
    # grabbed the OLD stub fails with UNAVAILABLE on the closed channel
    # and re-enters through the resilience retry loop, which re-reads
    # the fresh endpoint — the failure mode IS the designed failover
    # path. `_done_policy` is rebound once at registration, before
    # dispatch traffic exists.

    def __init__(self, sched_addr: str, sched_port: int,
                 policy: Optional[RetryPolicy] = None,
                 endpoint_file: Optional[str] = None,
                 failover_budget_s: Optional[float] = None):
        self._policy = policy or policy_from_env(SCHED_RPC_POLICY)
        self._done_policy = self._policy
        self._endpoint_file = _ha_endpoint_file(endpoint_file)
        # Failover-budget precedence: explicit constructor arg >
        # leader-advertised lease value (read per call — the lease is
        # the --ha config's delivery channel to workers) >
        # $SWTPU_HA_FAILOVER_BUDGET_S > 30s.
        self._explicit_budget_s = failover_budget_s
        try:
            self._default_budget_s = float(os.environ.get(
                "SWTPU_HA_FAILOVER_BUDGET_S", "30"))
        except ValueError:
            self._default_budget_s = 30.0
        # The breaker only exists for the failover story: without HA,
        # adding one would change long-standing single-leader retry
        # timing the fault suite pins.
        self.breaker: Optional[CircuitBreaker] = (
            CircuitBreaker() if self._endpoint_file else None)
        self._endpoint_lock = threading.Lock()
        self._epoch = 0
        if self._endpoint_file is not None:
            # Seed the epoch cursor from the current lease so the first
            # refresh_endpoint() is a no-op while the leader that
            # spawned us is still it.
            resolved = _read_endpoint(self._endpoint_file)
            if resolved is not None and resolved[:2] == (sched_addr,
                                                         int(sched_port)):
                self._epoch = resolved[2]
        self._connect(sched_addr, sched_port)

    def _connect(self, addr: str, port: int) -> None:
        self._sched_addr = addr
        self._sched_port = int(port)
        self._channel = grpc.insecure_channel(f"{addr}:{port}")
        self._stub = Stub(self._channel, "shockwave_tpu.WorkerToScheduler")

    def refresh_endpoint(self) -> bool:
        """Re-resolve the scheduler endpoint from the leader lease.
        Returns True when the endpoint or leader epoch changed — the
        channel is rebuilt and the breaker RESET (an open circuit is
        evidence about the DEAD leader, not the new one)."""
        if self._endpoint_file is None:
            return False
        resolved = _read_endpoint(self._endpoint_file)
        if resolved is None:
            return False
        addr, port, epoch = resolved
        with self._endpoint_lock:
            changed = ((addr, port) != (self._sched_addr, self._sched_port)
                       or epoch > self._epoch)
            if not changed:
                return False
            logger.warning(
                "scheduler endpoint re-resolved: %s:%d (epoch %d) -> "
                "%s:%d (epoch %d); resetting channel%s",
                self._sched_addr, self._sched_port, self._epoch,
                addr, port, epoch,
                " + breaker" if self.breaker is not None else "")
            old = self._channel
            self._connect(addr, port)
            self._epoch = epoch
            if self.breaker is not None:
                self.breaker.reset()
        try:
            old.close()
        except Exception:  # noqa: BLE001 - best-effort channel cleanup
            logger.debug("closing replaced scheduler channel failed",
                         exc_info=True)
        return True

    def failover_budget_s(self) -> float:
        """How long reports are held across a failover window — the
        leader's lease advertises it (HAConfig.failover_budget_s)."""
        if self._explicit_budget_s is not None:
            return self._explicit_budget_s
        if self._endpoint_file is not None:
            lease_budget = _read_lease_budget(self._endpoint_file)
            if lease_budget is not None:
                return lease_budget
        return self._default_budget_s

    def _call_with_failover(self, do_call, label: str):
        """Run one report RPC, holding it across a failover window:
        on transport failure / open circuit / fenced ex-leader, keep
        re-resolving the endpoint and retrying until the budget runs
        out. Without an endpoint file this is a single attempt (the
        historical behavior)."""
        deadline = time.monotonic() + self.failover_budget_s()
        while True:
            try:
                return do_call()
            except (RpcUnavailableError, grpc.RpcError) as e:
                fenced = _is_fenced_leader_error(e)
                if not (isinstance(e, RpcUnavailableError) or fenced):
                    raise  # the peer answered; its verdict stands
                if (self._endpoint_file is None
                        or time.monotonic() >= deadline):
                    raise
                logger.warning(
                    "%s failed (%s); holding the report and re-resolving "
                    "the scheduler endpoint", label,
                    "fenced leader" if fenced else e)
                time.sleep(FAILOVER_RETRY_INTERVAL_S)
                self.refresh_endpoint()

    def stretch_done_deadline(self, min_deadline_s: float) -> None:
        """Raise Done's deadline floor. The scheduler's Done handler
        legitimately blocks an early finisher until the round boundary,
        so the deadline must cover a full round — the daemon calls this
        once the round duration is known (at registration)."""
        from dataclasses import replace
        if min_deadline_s > self._done_policy.deadline_s:
            self._done_policy = replace(
                self._done_policy, deadline_s=min_deadline_s,
                total_budget_s=max(self._done_policy.total_budget_s,
                                   min_deadline_s * 1.5))

    def register_worker(self, worker_type: str, ip_addr: str, port: int,
                        num_chips: int) -> Tuple[List[int], float]:
        # Single attempt with a deadline: the daemon's bring-up loop owns
        # registration retries (with its own, much longer window).
        response = self._stub.RegisterWorker(pb.RegisterWorkerRequest(
            worker_type=worker_type, ip_addr=ip_addr, port=port,
            num_chips=num_chips), timeout=self._policy.deadline_s)
        if not response.success:
            raise RuntimeError(response.error_message)
        return list(response.worker_ids), response.round_duration

    def notify_done(self, job_ids: Sequence[int], worker_id: int,
                    num_steps: Sequence[int], execution_times: Sequence[float],
                    iterator_logs: Optional[Sequence[str]] = None) -> None:
        # Done is not idempotent (the scheduler aggregates each report
        # into step accounting), so only connection-level failures are
        # retried: a deadline expiry may mean the server is still
        # processing attempt 1, and replaying would double-count.
        # Across an HA failover the report is held and redelivered to
        # the promoted leader — safe even when the dead leader DID
        # process it first, because promotion clears the dispatch
        # stamps and the orphan gate discards the replay.
        request = pb.DoneRequest(
            job_ids=list(job_ids), worker_id=worker_id,
            num_steps=[int(s) for s in num_steps],
            execution_times=list(execution_times),
            iterator_logs=list(iterator_logs or []))
        self._call_with_failover(
            lambda: call_with_retry(
                self._stub.Done, request,
                method="scheduler/Done", policy=self._done_policy,
                breaker=self.breaker,
                retryable=frozenset({grpc.StatusCode.UNAVAILABLE})),
            label=f"Done report for jobs {list(job_ids)}")


class IteratorToSchedulerClient:
    """Training process (lease iterator) -> scheduler. A fresh channel per
    call keeps the client robust to scheduler restarts, as in the reference;
    deadlines + bounded retry keep a dead scheduler from hanging the
    training process inside a lease renewal. With $SWTPU_HA_ENDPOINT_FILE
    set (the dispatcher exports the environment into training processes),
    each call resolves the CURRENT leader from the lease file, so a lease
    renewal lands on the promoted standby without any process restart."""

    def __init__(self, job_id: int, worker_id: int, sched_addr: str,
                 sched_port: int, policy: Optional[RetryPolicy] = None,
                 endpoint_file: Optional[str] = None):
        self._job_id = job_id
        self._worker_id = worker_id
        self._static_target = f"{sched_addr}:{sched_port}"
        self._endpoint_file = _ha_endpoint_file(endpoint_file)
        self._policy = policy or policy_from_env(SCHED_RPC_POLICY)

    def _target(self) -> str:
        if self._endpoint_file is not None:
            resolved = _read_endpoint(self._endpoint_file)
            if resolved is not None:
                return f"{resolved[0]}:{resolved[1]}"
        return self._static_target

    def _stub(self, channel):
        return Stub(channel, "shockwave_tpu.IteratorToScheduler")

    def _call(self, method: str, request):
        with grpc.insecure_channel(self._target()) as channel:
            return call_with_retry(
                getattr(self._stub(channel), method), request,
                method=f"scheduler/{method}", policy=self._policy)

    def init(self) -> Tuple[int, float, float]:
        r = self._call("InitJob", pb.InitJobRequest(
            job_id=self._job_id, worker_id=self._worker_id))
        return r.max_steps, r.max_duration, r.extra_time

    def update_lease(self, steps: int, duration: float, max_steps: int,
                     max_duration: float,
                     measured_reports: Optional[Sequence[str]] = None
                     ) -> Tuple[int, float, float, float]:
        """`measured_reports` piggybacks serving sketch deltas
        (serving/measured.py wire lines) on the renewal heartbeat —
        the per-round telemetry channel for replicas whose extended
        lease means Done only fires at drain."""
        r = self._call("UpdateLease", pb.UpdateLeaseRequest(
            job_id=self._job_id, worker_id=self._worker_id,
            steps=int(steps), duration=duration, max_steps=int(max_steps),
            max_duration=max_duration,
            measured_reports=list(measured_reports or [])))
        return r.max_steps, r.max_duration, r.run_time_so_far, r.deadline

    def update_resource_requirement(self, big_bs: bool, small_bs: bool) -> None:
        self._call("UpdateResourceRequirement",
                   pb.UpdateResourceRequirementRequest(
                       job_id=self._job_id, worker_id=self._worker_id,
                       big_bs=big_bs, small_bs=small_bs))
