"""Measured serving telemetry, the replica's side: a copy of
`shockwave_tpu/serving/measured.py` without `ServiceMeasuredState`,
the scheduler-side fold, which stays with the JAX package's scheduler.

- **ArrivalClock** — a seeded Poisson arrival stream drawn from the
  SAME ``serving/load.DiurnalLoad`` curve the simulator and autoscaler
  plan with (Lewis-Shedler thinning against a static rate bound), split
  round-robin across ``num_replicas`` so each replica serves its
  deterministic share. Pure function of (load spec, seed): no wall
  clocks, no unseeded RNG.
- **ReplicaMeter** — the per-replica virtual queue: each physical
  decode step contributes its *measured* wall duration; the meter
  admits pending synthetic arrivals (up to the batch size), stamps each
  request's admission->last-token latency on the virtual service clock,
  and accumulates samples into a mergeable ``obs/quantiles``
  QuantileSketch plus tokens/requests/busy counters. ``take_delta()``
  yields the compact payload a replica ships on its heartbeats.

Report lines ride the lease-renewal heartbeat
(``UpdateLeaseRequest.measured_reports``), with unsent deltas flushed to
the iterator log at exit and arriving with Done; deltas carry a (round,
seq) stamp so the scheduler's tier dedupes double delivery.
``encode_report`` / ``find_reports`` define the line format, marked by
``MEASURED_REPORT_MARKER``; the encoding is byte-identical to the JAX
package's.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..obs.quantiles import QuantileSketch
from .load import DiurnalLoad

#: Wire version of the Done-heartbeat measured payload.
REPORT_VERSION = 1
#: Substring marking a measured-telemetry line in the iterator log
#: (the scheduler's log fold routes these to the serving tier instead
#: of the job timeline).
MEASURED_REPORT_MARKER = "SWTPU-SERVING-MEASURED "


def derive_arrival_seed(spike_seed: Optional[int],
                        replica_index: int) -> int:
    """Deterministic per-replica arrival seed from the service's spike
    seed (0 when the trace carries none) and the replica index — every
    dispatch of replica k replays the same synthetic request stream."""
    base = int(spike_seed or 0)
    return (base * 1000003 + int(replica_index) * 7919) % (2 ** 31 - 1)


def _max_rate_bound(load: DiurnalLoad) -> float:
    """A static upper bound on load.rate(t): day-curve peak times the
    worst concurrent spike-multiplier product (spike intervals swept at
    their boundary points)."""
    day_max = max(load.peak_rps, load.base_rps)
    if not load.spikes:
        return day_max
    bounds = sorted({s.start for s in load.spikes}
                    | {s.start + s.duration for s in load.spikes})
    worst = 1.0
    for t in bounds:
        mult = 1.0
        for s in load.spikes:
            if s.active(t):
                mult *= s.multiplier
        worst = max(worst, mult)
    return day_max * worst


class ArrivalClock:
    """Seeded Poisson arrivals over a DiurnalLoad, filtered to one
    replica's round-robin share. Yields service-relative arrival times
    in increasing order; exhausts at ``horizon_s``."""

    def __init__(self, load: DiurnalLoad, seed: int, horizon_s: float,
                 replica_index: int = 0, num_replicas: int = 1,
                 phase_s: float = 0.0):
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        self.load = load
        self.horizon_s = float(horizon_s)
        self.replica_index = int(replica_index) % int(num_replicas)
        self.num_replicas = int(num_replicas)
        self.phase_s = float(phase_s)
        # One shared stream per service seed: every replica draws the
        # SAME global arrival sequence (thinning consumes RNG draws in
        # lockstep), then keeps the indices assigned to it — so the
        # union over replicas is exactly the service's Poisson stream.
        self._rng = np.random.RandomState(int(seed))
        self._rate_bound = max(_max_rate_bound(load), 1e-9)
        self._t = 0.0
        self._global_index = 0

    def __iter__(self) -> Iterator[float]:
        return self

    def __next__(self) -> float:
        while True:
            self._t += float(self._rng.exponential(1.0 / self._rate_bound))
            if self._t >= self.horizon_s:
                raise StopIteration
            accept = (float(self._rng.random_sample()) * self._rate_bound
                      < self.load.rate(self._t + self.phase_s))
            if not accept:
                continue
            index = self._global_index
            self._global_index += 1
            if index % self.num_replicas == self.replica_index:
                return self._t


class ReplicaMeter:
    """Virtual request queue driven by measured decode-step durations.

    The meter keeps TWO clocks on one timeline: ``wall``, the measured
    time the replica has actually spent (every step advances it by the
    step's duration), and ``clock``, the service clock (the completion
    stamp of the last served batch). A step picks up to ``batch_size``
    requests that have arrived by its service start, runs for the
    measured duration, and completes them all at the step's end — the
    admission->last-token latency of request i is ``completion -
    arrival_i``. Crucially the service clock can never outrun the
    wall: a chip faster than the arrival rate IDLES (the step serves
    nothing) instead of consuming future arrivals early — otherwise a
    fast replica would "serve" hours of the request stream in seconds
    and report fictitious zero-latency samples."""

    def __init__(self, arrivals: Iterator[float], batch_size: int,
                 tokens_per_request: int):
        self._arrivals = iter(arrivals)
        self.batch_size = max(int(batch_size), 1)
        self.tokens_per_request = max(int(tokens_per_request), 1)
        self.wall = 0.0          # measured replica time spent
        self.clock = 0.0         # service clock (last batch completion)
        self._pending: List[float] = []
        self._stream_done = False
        self._span_start = 0.0   # wall at the last take_delta
        self._delta_sketch = QuantileSketch()
        self._delta_requests = 0
        self._delta_tokens = 0
        self._delta_busy_s = 0.0
        self._delta_span_s = 0.0

    def _pull_arrivals(self, until: float) -> None:
        """Keep at most one lookahead arrival beyond `until` buffered."""
        while not self._stream_done and (not self._pending
                                         or self._pending[-1] <= until):
            try:
                self._pending.append(next(self._arrivals))
            except StopIteration:
                self._stream_done = True
                return

    @property
    def exhausted(self) -> bool:
        """The arrival stream is drained and nothing is queued."""
        self._pull_arrivals(self.wall)
        return self._stream_done and not self._pending

    def idle_to_next_arrival(self) -> bool:
        """Virtual-time callers ONLY (the calibration replay owns its
        timeline): jump the wall forward to the next pending arrival
        instead of polling through the idle gap step by step. Returns
        False when the stream is drained. The physical replica never
        calls this — its wall is real time."""
        self._pull_arrivals(self.wall)
        if self._stream_done and not self._pending:
            return False
        if self._pending and self._pending[0] > self.wall:
            self.wall = self._pending[0]
        return True

    def step(self, duration_s: float) -> int:
        """Account one measured decode step; returns requests completed
        (0 for an idle step — nothing had arrived by the measured
        wall — or a drained stream)."""
        duration_s = max(float(duration_s), 0.0)
        self.wall += duration_s
        self._delta_span_s = self.wall - self._span_start
        self._pull_arrivals(self.wall)
        if not self._pending or self._pending[0] > self.wall:
            return 0                 # idle (or drained): nothing to serve
        start = max(self.clock, self._pending[0])
        ready = 0
        while (ready < len(self._pending) and ready < self.batch_size
               and self._pending[ready] <= start):
            ready += 1
        admitted = self._pending[:ready]
        del self._pending[:ready]
        completion = start + duration_s
        self.clock = completion
        for arrival in admitted:
            self._delta_sketch.add(completion - arrival)
        self._delta_requests += len(admitted)
        self._delta_tokens += len(admitted) * self.tokens_per_request
        self._delta_busy_s += duration_s
        return len(admitted)

    @property
    def pending_delta_requests(self) -> int:
        return self._delta_requests

    def take_delta(self) -> Optional[dict]:
        """The compact heartbeat payload since the last take (None when
        nothing was measured)."""
        if self._delta_requests == 0:
            return None
        delta = {
            "v": REPORT_VERSION,
            "sketch": self._delta_sketch.to_payload(),
            "requests": self._delta_requests,
            "tokens": self._delta_tokens,
            "busy_s": round(self._delta_busy_s, 6),
            "span_s": round(self._delta_span_s, 6),
        }
        self._span_start = self.wall
        self._delta_sketch = QuantileSketch()
        self._delta_requests = 0
        self._delta_tokens = 0
        self._delta_busy_s = 0.0
        self._delta_span_s = 0.0
        return delta


# ----------------------------------------------------------------------
# Heartbeat line format (iterator log -> Done RPC -> scheduler fold)
# ----------------------------------------------------------------------

def encode_report(delta: dict) -> str:
    """One measured-telemetry log line (canonical JSON after the
    marker, so identical deltas encode byte-identically)."""
    return MEASURED_REPORT_MARKER + json.dumps(
        delta, sort_keys=True, separators=(",", ":"))


def find_reports(lines: "list[str] | str") -> List[dict]:
    """Extract every measured payload from iterator-log content;
    malformed payloads are skipped (telemetry must never fail the
    Done path)."""
    if isinstance(lines, str):
        lines = lines.splitlines()
    out: List[dict] = []
    for line in lines:
        marker = line.find(MEASURED_REPORT_MARKER)
        if marker < 0:
            continue
        try:
            payload = json.loads(line[marker
                                      + len(MEASURED_REPORT_MARKER):])
        except ValueError:
            continue
        if isinstance(payload, dict) and payload.get("v") == REPORT_VERSION:
            out.append(payload)
    return out


__all__ = ["ArrivalClock", "ReplicaMeter", "derive_arrival_seed",
           "encode_report", "find_reports", "MEASURED_REPORT_MARKER",
           "REPORT_VERSION"]
