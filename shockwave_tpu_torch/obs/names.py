"""The metric names the port's runtime records: the subset of
`shockwave_tpu/obs/names.py` that `runtime/resilience.py`,
`runtime/servers.py` and `runtime/worker.py` increment, with the same
names, kinds, help texts and label sets, so a later `/metrics` exporter
of the port renders the same series as the reference's.

Conventions: counters end in ``_total``; label sets are small and
bounded (no job ids).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MetricSpec:
    """Declaration of one metric: pure data, no behavior. The registry
    instantiates storage from it on first use."""
    name: str
    kind: str                      # "counter" | "gauge"
    help: str
    labels: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.kind not in ("counter", "gauge"):
            raise ValueError(f"unknown metric kind {self.kind!r}")


def _counter(name, help, labels=()):
    return MetricSpec(name, "counter", help, tuple(labels))


def _gauge(name, help, labels=()):
    return MetricSpec(name, "gauge", help, tuple(labels))


# ----------------------------------------------------------------------
# Control-plane HA (runtime/servers.py)
# ----------------------------------------------------------------------

HA_FENCED_RPCS_TOTAL = _counter(
    "swtpu_ha_fenced_rpcs_total",
    "RPCs rejected by epoch fencing, by side (worker: a stale leader's "
    "dispatch refused; scheduler: a fenced ex-leader refusing reports "
    "so workers re-resolve)", ("side",))

# ----------------------------------------------------------------------
# RPC resilience (runtime/resilience.py)
# ----------------------------------------------------------------------

RPC_RETRIES_TOTAL = _counter(
    "swtpu_rpc_retries_total",
    "Transport-level RPC attempt failures that were retried, by method",
    ("method",))
RPC_UNAVAILABLE_TOTAL = _counter(
    "swtpu_rpc_unavailable_total",
    "RPCs that exhausted their whole retry budget, by method",
    ("method",))
BREAKER_TRANSITIONS_TOTAL = _counter(
    "swtpu_breaker_transitions_total",
    "Circuit-breaker state transitions, by destination state "
    "(open / half_open / closed)", ("to",))

# ----------------------------------------------------------------------
# Worker daemon (runtime/worker.py)
# ----------------------------------------------------------------------

WORKER_JOBS_DISPATCHED_TOTAL = _counter(
    "swtpu_worker_jobs_dispatched_total",
    "RunJob dispatches received by this worker daemon")
WORKER_LAST_DISPATCH_TIMESTAMP = _gauge(
    "swtpu_worker_last_dispatch_timestamp_seconds",
    "Wall-clock time of the last RunJob this daemon received")

#: Environment variable naming the fleet trace's span-shard directory.
#: The port does not trace yet; the worker and the lease iterator refuse
#: a run that asks for it.
SHARD_DIR_ENV = "SWTPU_SPAN_SHARD_DIR"
