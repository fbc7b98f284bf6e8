"""What a serving replica needs of `shockwave_tpu/serving/`, copied:

- `load` — the deterministic diurnal/bursty request-rate curves;
- `measured` — the replica's measured request clock and the wire format
  of its telemetry.

The tier, the autoscaler and the analytic latency model are the
scheduler's and stay in the JAX package.
"""
from .load import DiurnalLoad, Spike, seeded_spikes
from .measured import (ArrivalClock, ReplicaMeter, derive_arrival_seed,
                       encode_report, find_reports)

__all__ = ["ArrivalClock", "DiurnalLoad", "ReplicaMeter", "Spike",
           "derive_arrival_seed", "encode_report", "find_reports",
           "seeded_spikes"]
