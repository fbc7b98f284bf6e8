"""Observability for the port's runtime (the part of
`shockwave_tpu/obs/__init__.py` the worker daemon, the job side and the
profiler use): a metrics registry and a span tracer around one injected
clock, served by `exporter.ObsHttpServer` (``/metrics``, ``/healthz``).
Fleet tracing across processes is `obs/propagation.py` and
`obs/shard.py`, driven from `runtime/spans.py`.

``SWTPU_OBS=0`` disables recording globally, as in the reference.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional

from . import names
from .clock import Clock, wall_clock
from .registry import MetricsRegistry
from .tracing import Tracer

__all__ = ["Observability", "MetricsRegistry", "Tracer", "names",
           "get_observability", "obs_enabled_by_env"]

_GLOBAL_LOCK = threading.Lock()
_GLOBAL: Optional["Observability"] = None


def obs_enabled_by_env() -> bool:
    return os.environ.get("SWTPU_OBS", "1") not in ("", "0")


class Observability:
    """One registry + one tracer sharing an injected clock, plus the
    delegates instrumentation call sites use."""

    def __init__(self, clock: Optional[Clock] = None,
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = obs_enabled_by_env()
        self.enabled = enabled
        self.clock: Clock = clock or wall_clock
        self.registry = MetricsRegistry(clock=self.clock, enabled=enabled)
        self.tracer = Tracer(clock=self.clock, enabled=enabled)
        self.inc = self.registry.inc
        self.set_gauge = self.registry.set_gauge
        self.observe = self.registry.observe
        self.timed = self.registry.timed
        self.span = self.tracer.span

    @contextmanager
    def phase(self, name: str, parent=None, **args):
        """A round-pipeline phase: one trace span plus one observation
        into the shared phase histogram, so the trace timeline and the
        /metrics scrape tell the same story. `parent` splices the span
        under a remote/manual SpanContext."""
        if not self.enabled:
            yield None
            return
        t0 = self.clock()
        with self.tracer.span(name, parent=parent, **args) as ctx:
            try:
                yield ctx
            finally:
                self.registry.observe(names.ROUND_PHASE_SECONDS,
                                      max(self.clock() - t0, 0.0),
                                      phase=name)


def get_observability() -> Observability:
    """Process-global wall-clock Observability (job-side runtime, the
    worker daemon and the profiler)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = Observability()
        return _GLOBAL
