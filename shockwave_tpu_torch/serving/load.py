"""Diurnal / bursty request-load model for serving services (a copy of
`shockwave_tpu/serving/load.py`).

Request arrivals are Poisson with a time-varying rate: a sinusoidal
day-curve between `base_rps` (trough) and `peak_rps` (peak) modulated by
multiplicative traffic spikes — either explicit (start, duration,
multiplier) triples from the trace, or drawn deterministically from a
seed (`seeded_spikes`). Everything here is a pure function of (spec,
time): the simulator, the autoscaler, and the analytic latency model
all read the same curve, so SLO attainment is evaluated
deterministically (bit-identical replays).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Spike:
    """One multiplicative traffic burst, offsets relative to service
    start."""
    start: float
    duration: float
    multiplier: float

    def active(self, t: float) -> bool:
        return self.start <= t < self.start + self.duration


def seeded_spikes(seed: int, lifetime_s: float, num_spikes: int,
                  multiplier: float, duration_s: float) -> Tuple[Spike, ...]:
    """Deterministic spike draw: starts uniform over the middle of the
    service lifetime (never in the last 10% — a spike the service
    retires under says nothing about the autoscaler)."""
    if num_spikes <= 0:
        return ()
    rng = np.random.RandomState(seed)
    starts = np.sort(rng.uniform(0.05, 0.85, size=num_spikes)) * lifetime_s
    return tuple(Spike(float(s), float(duration_s), float(multiplier))
                 for s in starts)


class DiurnalLoad:
    """lambda(t): requests/s at `t` seconds after service start."""

    def __init__(self, base_rps: float, peak_rps: float, period_s: float,
                 phase_s: float = 0.0, spikes: Sequence[Spike] = ()):
        if base_rps < 0 or peak_rps < base_rps:
            raise ValueError(
                f"need 0 <= base_rps <= peak_rps, got {base_rps}/{peak_rps}")
        self.base_rps = float(base_rps)
        self.peak_rps = float(peak_rps)
        self.period_s = float(period_s)
        self.phase_s = float(phase_s)
        self.spikes = tuple(spikes)

    def rate(self, t: float) -> float:
        """Instantaneous arrival rate. With phase 0 the service starts
        at the trough and peaks half a period in."""
        if self.period_s > 0:
            swing = (self.peak_rps - self.base_rps) * 0.5
            day = self.base_rps + swing * (
                1.0 - math.cos(2.0 * math.pi
                               * (t + self.phase_s) / self.period_s))
        else:
            day = self.base_rps
        mult = 1.0
        for spike in self.spikes:
            if spike.active(t):
                mult *= spike.multiplier
        return day * mult

    def mean_rate(self, t0: float, t1: float, samples: int = 16) -> float:
        """Mean rate over [t0, t1), midpoint-sampled (deterministic)."""
        if t1 <= t0:
            return self.rate(t0)
        step = (t1 - t0) / samples
        return sum(self.rate(t0 + (i + 0.5) * step)
                   for i in range(samples)) / samples

    def peak_rate(self, t0: float, t1: float, samples: int = 16) -> float:
        """Max sampled rate over [t0, t1) — what the autoscaler
        provisions for, so a spike starting mid-round is already covered
        at the round's dispatch."""
        if t1 <= t0:
            return self.rate(t0)
        step = (t1 - t0) / samples
        edges = [self.rate(t0), self.rate(t1 - 1e-9)]
        return max(edges + [self.rate(t0 + (i + 0.5) * step)
                            for i in range(samples)])

    def offered(self, t0: float, t1: float, samples: int = 16) -> float:
        """Expected requests arriving in [t0, t1)."""
        return self.mean_rate(t0, t1, samples) * max(t1 - t0, 0.0)


__all__ = ["Spike", "seeded_spikes", "DiurnalLoad"]
