"""The clock adapter of the port's observability (a copy of
`shockwave_tpu/obs/clock.py`).

Every obs component (registry, tracer, shard writer) takes its clock by
injection; this module is the only place in `shockwave_tpu_torch/obs/`
that reads a real clock, as in the reference.
"""
from __future__ import annotations

import time
from typing import Callable

#: A clock is any zero-arg callable returning seconds as a float.
Clock = Callable[[], float]


def wall_clock() -> float:
    """Wall-clock seconds (epoch). The default clock for physical-mode
    components; timestamps line up with log lines and journal records."""
    return time.time()


def perf_clock() -> float:
    """High-resolution monotonic seconds, for benchmark harnesses where
    durations matter and absolute timestamps do not."""
    return time.perf_counter()
