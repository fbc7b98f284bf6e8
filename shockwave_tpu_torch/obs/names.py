"""The metric and span names the port's runtime records: the subset of
`shockwave_tpu/obs/names.py` that the port's runtime, obs modules and
profiler use, with the same names, kinds, help texts, label sets and
buckets, so the port's `/metrics` renders the same series as the
reference's and its span shards merge into the reference's fleet trace.

Conventions: counters end in ``_total``; durations are seconds in
histograms named ``*_seconds``; label sets are small and bounded (no job
ids).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MetricSpec:
    """Declaration of one metric: pure data, no behavior. The registry
    instantiates storage from it on first use."""
    name: str
    kind: str                      # "counter" | "gauge" | "histogram"
    help: str
    labels: Tuple[str, ...] = ()
    buckets: Tuple[float, ...] = ()   # histograms only

    def __post_init__(self):
        if self.kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"unknown metric kind {self.kind!r}")
        if self.kind == "histogram" and not self.buckets:
            raise ValueError(f"{self.name}: histogram needs buckets")


#: Default latency buckets: sub-millisecond RPCs through multi-minute
#: solves.
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                   120.0, 300.0)


def _counter(name, help, labels=()):
    return MetricSpec(name, "counter", help, tuple(labels))


def _gauge(name, help, labels=()):
    return MetricSpec(name, "gauge", help, tuple(labels))


def _histogram(name, help, labels=(), buckets=LATENCY_BUCKETS):
    return MetricSpec(name, "histogram", help, tuple(labels),
                      tuple(buckets))


# ----------------------------------------------------------------------
# Round-pipeline phases (Observability.phase)
# ----------------------------------------------------------------------

ROUND_PHASE_SECONDS = _histogram(
    "swtpu_round_phase_seconds",
    "Wall time of each round-pipeline phase (also exported as trace "
    "spans)", ("phase",))


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

# ----------------------------------------------------------------------
# Fleet-wide tracing (obs/propagation.py, obs/shard.py)
# ----------------------------------------------------------------------

TRACE_SHARD_SPANS = _gauge(
    "swtpu_trace_shard_spans",
    "Spans currently buffered in this process's bounded span-shard "
    "ring (worker daemons and trainers write shards into the trace "
    "dir; python -m shockwave_tpu.obs.merge fuses them)")
TRACE_SHARD_FLUSHES_TOTAL = _counter(
    "swtpu_trace_shard_flushes_total",
    "Atomic span-shard file rewrites by this process")

# ----------------------------------------------------------------------
# Offline harnesses (profiling/measure_throughput.py)
# ----------------------------------------------------------------------

PROFILE_MEASURE_SECONDS = _histogram(
    "swtpu_profile_measure_seconds",
    "Throughput-profiler measurement wall time per oracle row "
    "(device timing itself stays core/timing.marginal_step_time)",
    ("family",))

# ----------------------------------------------------------------------
# Span names (tracer): the runtime's fleet-trace spans and the
# profiler's. One round's solve -> dispatch -> launch -> trainer -> done
# chain shares one trace id across the scheduler, worker-daemon and
# trainer processes.
# ----------------------------------------------------------------------

SPAN_PROFILE_MEASURE = "profile-measure"
SPAN_RUNJOB = "runjob"                # worker daemon: RunJob handling
SPAN_LAUNCH = "launch"                # worker daemon: trainer process life
SPAN_DONE_REPORT = "done-report"      # worker daemon: Done RPC back
SPAN_TRAINER = "trainer"              # trainer: lease window (init->exit)
SPAN_CKPT_LOAD = "ckpt-load"          # trainer: checkpoint restore
SPAN_CKPT_SAVE = "ckpt-save"          # trainer: checkpoint save

# ----------------------------------------------------------------------
# Span-context propagation keys and shard filenames: the cross-process
# contract between the scheduler, the worker daemon, the dispatcher and
# the trainer-side LeaseIterator, declared here only.
# ----------------------------------------------------------------------

#: gRPC metadata key carrying the traceparent of the sender's active
#: span on scheduler->worker RPCs (must be lowercase per gRPC).
TRACEPARENT_METADATA_KEY = "swtpu-traceparent"
#: gRPC metadata key carrying the sender's wall-clock send timestamp;
#: paired with the receiver's recv stamp by the merge to align per-host
#: clock offsets.
TRACE_SENDTS_METADATA_KEY = "swtpu-trace-sendts"
#: Environment variable the dispatcher exports into trainer processes:
#: the launch span's traceparent, consumed by the job-side LeaseIterator.
TRACEPARENT_ENV = "SWTPU_TRACEPARENT"
#: Environment variable naming the directory every process writes its
#: bounded span shard into (run_dir of the drive).
SHARD_DIR_ENV = "SWTPU_SPAN_SHARD_DIR"
#: Span-shard filename pattern: spans-<role>-<pid>.json.
SHARD_FILE_PREFIX = "spans-"
SHARD_FILE_SUFFIX = ".json"


def shard_filename(role: str, pid: int) -> str:
    """Canonical shard filename for one process's span shard."""
    return f"{SHARD_FILE_PREFIX}{role}-{int(pid)}{SHARD_FILE_SUFFIX}"


def all_metric_specs():
    """Every MetricSpec declared in this module, in declaration order."""
    return [v for v in globals().values() if isinstance(v, MetricSpec)]
