"""Observability for the port's runtime: the process-global metrics
registry behind `get_observability()` (the part of
`shockwave_tpu/obs/__init__.py` the job side and the worker daemon use).

Span tracing and the ``/metrics`` exporter are not ported yet (ROADMAP.md
Queue 1 item 3, fleet tracing and /metrics for the port). Recording is
always on: the reference's ``SWTPU_OBS=0`` switch comes with the exporter
that reads what is recorded.
"""
from __future__ import annotations

import threading
from typing import Optional

from . import names
from .registry import MetricsRegistry

__all__ = ["Observability", "MetricsRegistry", "names", "get_observability"]

_GLOBAL_LOCK = threading.Lock()
_GLOBAL: Optional["Observability"] = None


class Observability:
    """One registry plus the delegates instrumentation call sites use."""

    def __init__(self):
        self.registry = MetricsRegistry()
        self.inc = self.registry.inc
        self.set_gauge = self.registry.set_gauge


def get_observability() -> Observability:
    """Process-global Observability (job-side runtime and the worker
    daemon)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = Observability()
        return _GLOBAL
