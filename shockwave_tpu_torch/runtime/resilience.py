"""RPC resilience: per-call deadlines, bounded retry, circuit breakers.

Every control-plane RPC in this runtime used to block indefinitely on a
dead peer: a worker crash mid-round left the scheduler's dispatch (or a
training job's lease renewal) hung inside a deadline-less gRPC call, and
`_end_round` never regained liveness. This module is the single place
that policy lives:

- `RetryPolicy`: per-attempt deadline + bounded exponential backoff over
  a total wall-clock budget. Backoff applies FULL JITTER (uniform in
  [0, bounded-exponential]) so a healed partition does not turn every
  worker's queued retry into one synchronized storm at the scheduler;
  the jitter RNG is injectable (`call_with_retry(rng=...)` /
  `SWTPU_RPC_JITTER_SEED`) so seeded drills stay deterministic, and the
  deterministic upper bound is unchanged — return-time BOUNDS asserted
  by fault-injection tests still hold.
- `CircuitBreaker`: per-peer-channel failure counter. After
  `failure_threshold` consecutive transport failures the circuit opens
  and calls fail fast (`CircuitOpenError`) for `reset_timeout_s`; the
  first call after that window is a half-open probe whose outcome closes
  or re-opens the circuit. This keeps a dead worker from costing every
  scheduler round a full retry budget.
- `call_with_retry`: drives a gRPC callable under a policy + breaker.

Only transport-level status codes (UNAVAILABLE, DEADLINE_EXCEEDED) are
retried and counted against the breaker; any other status means the peer
is alive and the error is the caller's to handle.

Knobs are also readable from the environment (`SWTPU_RPC_*`) so the
job-side lease iterator — which has no config object — gets deadlines
too (see `policy_from_env`).

The port's copy of `shockwave_tpu/runtime/resilience.py` up to its
gray-failure health scoring (`HostHealth`, `HealthConfig`), which is the
scheduler's and stays in the JAX package.
"""
from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass, replace
from typing import Optional

import grpc

from ..obs import get_observability
from ..obs import names as obs_names

logger = logging.getLogger("shockwave_tpu_torch.runtime")


def _method_label(method: str) -> str:
    """Bounded-cardinality metric label for a call site: the RPC name
    without the peer address (`worker 10.0.0.3:50061/RunJob` ->
    `RunJob`)."""
    return method.rsplit("/", 1)[-1]

#: Transport-level failures: the peer may be dead or unreachable. Anything
#: else (INVALID_ARGUMENT, INTERNAL, ...) proves the peer answered.
RETRYABLE_CODES = frozenset({
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.DEADLINE_EXCEEDED,
})


def is_retryable(error: Exception) -> bool:
    return (isinstance(error, grpc.RpcError)
            and error.code() in RETRYABLE_CODES)


class RpcUnavailableError(RuntimeError):
    """The peer stayed unreachable through the whole retry budget."""

    def __init__(self, method: str, attempts: int, last_code=None):
        super().__init__(
            f"{method} unreachable after {attempts} attempt(s)"
            f" (last status: {last_code})")
        self.method = method
        self.attempts = attempts
        self.last_code = last_code


class CircuitOpenError(RpcUnavailableError):
    """Failed fast: the peer's circuit breaker is open."""

    def __init__(self, method: str):
        RuntimeError.__init__(self, f"{method}: circuit open (peer presumed dead)")
        self.method = method
        self.attempts = 0
        self.last_code = None


@dataclass(frozen=True)
class RetryPolicy:
    #: gRPC deadline applied to every individual attempt.
    deadline_s: float = 20.0
    #: Wall-clock budget across all attempts (including backoff sleeps).
    total_budget_s: float = 60.0
    max_attempts: int = 4
    backoff_base_s: float = 0.25
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 5.0

    def backoff_bound(self, attempt: int) -> float:
        """Deterministic bounded-exponential CEILING of the backoff
        before attempt N+1 (what budget math and test bounds use)."""
        return min(self.backoff_base_s * self.backoff_multiplier ** attempt,
                   self.backoff_max_s)

    def backoff(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        """Backoff before attempt N+1: full jitter, uniform in
        (0, backoff_bound]. Without an RNG the deterministic ceiling is
        returned (legacy behavior; exact-bound tests use this)."""
        bound = self.backoff_bound(attempt)
        if rng is None:
            return bound
        # Floor at 1% of the bound: a zero draw would hammer the peer
        # with a same-instant retry, defeating the backoff entirely.
        return bound * max(rng.random(), 0.01)


def _jitter_seed_from_env() -> Optional[int]:
    raw = os.environ.get("SWTPU_RPC_JITTER_SEED")
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring non-integer SWTPU_RPC_JITTER_SEED=%r "
                       "(backoff jitter falls back to OS entropy)", raw)
        return None


#: Process-wide jitter RNG for retry backoff, seedable through
#: `SWTPU_RPC_JITTER_SEED` (the dispatcher exports env into training
#: processes, so a whole seeded drill gets reproducible retry timing end
#: to end).
_jitter_rng = random.Random(_jitter_seed_from_env())


def policy_from_env(default: RetryPolicy = RetryPolicy()) -> RetryPolicy:
    """RetryPolicy with `SWTPU_RPC_*` environment overrides (the
    dispatcher exports these into training processes, so the lease
    iterator inherits the cluster's RPC budget without a config file)."""

    def _f(name, fallback):
        raw = os.environ.get(name)
        if raw is None or raw == "":
            return fallback
        try:
            return float(raw)
        except ValueError:
            logger.warning("ignoring non-numeric %s=%r", name, raw)
            return fallback

    deadline_s = _f("SWTPU_RPC_DEADLINE_S", default.deadline_s)
    total_budget_s = _f("SWTPU_RPC_BUDGET_S", default.total_budget_s)
    # Invariant: the budget covers at least one full-deadline attempt
    # plus a retry window — otherwise a raised deadline (e.g. the
    # dispatcher's round-scaled export) would silently disable retries.
    total_budget_s = max(total_budget_s, 1.5 * deadline_s)
    return replace(
        default,
        deadline_s=deadline_s,
        total_budget_s=total_budget_s,
        max_attempts=int(_f("SWTPU_RPC_RETRIES", default.max_attempts)),
        backoff_base_s=_f("SWTPU_RPC_BACKOFF_S", default.backoff_base_s),
    )


class CircuitBreaker:
    """Consecutive-transport-failure circuit for one peer channel.

    closed -> (failure_threshold consecutive failures) -> open
    open   -> (reset_timeout_s elapsed) -> half-open: one probe call
    half-open -> success -> closed | failure -> open again
    """

    def __init__(self, failure_threshold: int = 3, reset_timeout_s: float = 10.0,
                 clock=time.monotonic):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._opened_at: float | None = None
        self._half_open_probe_inflight = False

    def allow(self) -> bool:
        """Whether a call may proceed; in half-open, admits one probe."""
        with self._lock:
            if self._opened_at is None:
                return True
            if self._clock() - self._opened_at < self.reset_timeout_s:
                return False
            if self._half_open_probe_inflight:
                return False
            self._half_open_probe_inflight = True
        get_observability().inc(obs_names.BREAKER_TRANSITIONS_TOTAL,
                                to="half_open")
        return True

    def record_success(self) -> None:
        with self._lock:
            was_open = self._opened_at is not None
            self._consecutive_failures = 0
            self._opened_at = None
            self._half_open_probe_inflight = False
        if was_open:
            get_observability().inc(obs_names.BREAKER_TRANSITIONS_TOTAL,
                                    to="closed")

    def reset(self) -> None:
        """Forget all failure history — for ENDPOINT CHANGES, not for
        recoveries. A breaker's failure count is evidence about one
        peer incarnation; when the peer's address or leader epoch
        changes (scheduler failover, worker re-registration), carrying
        an open circuit forward would fail the first calls to the NEW,
        healthy incarnation fast — the stale-breaker pile-up that
        turned every failover into a round of spurious retirements."""
        with self._lock:
            was_open = self._opened_at is not None
            self._consecutive_failures = 0
            self._opened_at = None
            self._half_open_probe_inflight = False
        if was_open:
            get_observability().inc(obs_names.BREAKER_TRANSITIONS_TOTAL,
                                    to="closed")

    def record_failure(self) -> None:
        with self._lock:
            was_open = self._opened_at is not None
            # A failure with a probe in flight is a failed half-open
            # probe re-opening the circuit — a real open transition that
            # must be counted, or a breaker flapping open N times reads
            # as one open event.
            probe_failed = self._half_open_probe_inflight
            self._consecutive_failures += 1
            self._half_open_probe_inflight = False
            if (self._consecutive_failures >= self.failure_threshold
                    or self._opened_at is not None):
                # A half-open probe failure re-opens immediately; restart
                # the reset window from now.
                self._opened_at = self._clock()
            opened = (self._opened_at is not None
                      and (not was_open or probe_failed))
        if opened:
            get_observability().inc(obs_names.BREAKER_TRANSITIONS_TOTAL,
                                    to="open")


#: gRPC metadata key carrying the fenced leader epoch on every
#: scheduler->worker RPC (control-plane HA; see sched/ha.py).
EPOCH_METADATA_KEY = "swtpu-leader-epoch"

#: Fence verdicts (EpochFence.observe).
EPOCH_OK = "ok"
EPOCH_ADVANCED = "advanced"
EPOCH_STALE = "stale"


class EpochFence:
    """Monotonic leader-epoch tracker — the worker-side half of fenced
    failover. Every dispatch-effecting RPC carries the sender's epoch;
    the fence remembers the highest ever seen and classifies each
    arrival: ``ok`` (current leader), ``advanced`` (a new leader's
    first contact — the observer should re-resolve endpoints and reset
    breakers), ``stale`` (a deposed leader that has not noticed its
    fencing — the server MUST reject, or a wedged-but-alive old leader
    could double-dispatch work the new leader also placed)."""

    def __init__(self, initial: int = 0):
        self._lock = threading.Lock()
        self._epoch = int(initial)

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def observe(self, epoch: int) -> str:
        epoch = int(epoch)
        with self._lock:
            if epoch < self._epoch:
                return EPOCH_STALE
            if epoch > self._epoch:
                self._epoch = epoch
                return EPOCH_ADVANCED
            return EPOCH_OK


def call_with_retry(callable_, request, *, method: str,
                    policy: RetryPolicy,
                    breaker: CircuitBreaker | None = None,
                    retryable=RETRYABLE_CODES,
                    clock=time.monotonic, sleep=time.sleep,
                    rng: Optional[random.Random] = None,
                    metadata=None):
    """Invoke a gRPC unary callable under deadline/retry/breaker policy.

    Raises `CircuitOpenError` without touching the network when the
    breaker is open, and `RpcUnavailableError` once the retry budget is
    exhausted; non-retryable RpcErrors propagate unchanged (the peer is
    alive — its answer is the caller's business).

    `retryable` narrows which status codes are retried: non-idempotent
    calls (e.g. Done, whose handler blocks on the round boundary) pass
    {UNAVAILABLE} only, so a deadline expiry — where the server may
    still be processing the first attempt — is never replayed.

    Backoff sleeps draw full jitter from `rng` (default: the process
    RNG, seedable via SWTPU_RPC_JITTER_SEED) so
    many peers retrying the same healed partition fan out instead of
    landing as one synchronized storm. Budget exhaustion is still
    decided against the deterministic `backoff_bound`, keeping the
    worst-case return time independent of the draw.
    """
    start = clock()
    last_code = None
    attempt = 0
    while True:
        if breaker is not None and not breaker.allow():
            raise CircuitOpenError(method)
        remaining = policy.total_budget_s - (clock() - start)
        if attempt > 0 and remaining <= 0:
            get_observability().inc(obs_names.RPC_UNAVAILABLE_TOTAL,
                                    method=_method_label(method))
            raise RpcUnavailableError(method, attempt, last_code)
        deadline = (min(policy.deadline_s, remaining) if attempt > 0
                    else policy.deadline_s)
        kwargs = {"timeout": max(deadline, 0.001)}
        if metadata is not None:
            # Only pass the kwarg when set: fault-test fakes (and some
            # instrumented stubs) accept (request, timeout=...) only.
            kwargs["metadata"] = metadata
        try:
            response = callable_(request, **kwargs)
        except grpc.RpcError as e:
            if not (isinstance(e, grpc.RpcError) and e.code() in retryable):
                # The peer ANSWERED (application-level error): transport
                # is healthy, so close the breaker — critically, this
                # also releases a half-open probe slot, which would
                # otherwise leak and wedge the circuit open forever.
                if breaker is not None:
                    breaker.record_success()
                raise
            last_code = e.code()
            attempt += 1
            if breaker is not None:
                breaker.record_failure()
            backoff = policy.backoff(attempt - 1,
                                     rng if rng is not None else _jitter_rng)
            out_of_budget = ((clock() - start)
                             + policy.backoff_bound(attempt - 1)
                             >= policy.total_budget_s)
            if attempt >= policy.max_attempts or out_of_budget:
                get_observability().inc(obs_names.RPC_UNAVAILABLE_TOTAL,
                                        method=_method_label(method))
                raise RpcUnavailableError(method, attempt, last_code) from e
            get_observability().inc(obs_names.RPC_RETRIES_TOTAL,
                                    method=_method_label(method))
            logger.debug("%s attempt %d failed (%s); retrying in %.2fs",
                         method, attempt, last_code, backoff)
            sleep(backoff)
            continue
        if breaker is not None:
            breaker.record_success()
        return response
