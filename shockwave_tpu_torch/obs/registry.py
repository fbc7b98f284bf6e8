"""Thread-safe metrics registry: labeled counters, gauges and
fixed-bucket histograms (a copy of `shockwave_tpu/obs/registry.py`:
`render_prometheus` gives the reference's text for the same calls).

Design points:

- **Specs, not strings.** Every instrument is declared once in
  `obs/names.py` as a `MetricSpec`; call sites pass the spec object.
  The registry materializes storage lazily on first use and rejects a
  second spec with the same name but a different shape.
- **Injected clock.** `timed()` measures with the registry's clock; no
  wall-clock reads happen in this module.
- **Leaf lock.** One plain `threading.Lock` guards all storage and is
  never held across a call into other code. (The reference wraps its
  lock for its concurrency sanitizer, which lives in the JAX package.)
- **Fail loud on misuse, never on recording.** Wrong kind / wrong label
  set raises (these are programming errors the tests catch); recording
  itself never raises.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from .clock import Clock, wall_clock
from .names import MetricSpec


class _Histogram:
    """Fixed-bucket histogram data for one label combination."""

    __slots__ = ("bucket_counts", "sum", "count")

    def __init__(self, nbuckets: int):
        self.bucket_counts = [0] * (nbuckets + 1)   # + the +Inf bucket
        self.sum = 0.0
        self.count = 0


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(value: float) -> str:
    """Prometheus sample value: integral values render without the
    trailing .0 noise, everything else as repr (full precision)."""
    f = float(value)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    def __init__(self, clock: Optional[Clock] = None, enabled: bool = True):
        self._clock: Clock = clock or wall_clock
        self._enabled = enabled
        self._specs: Dict[str, MetricSpec] = {}
        # Scalar storage (counters + gauges): name -> {label_values: v}.
        self._scalars: Dict[str, Dict[Tuple[str, ...], float]] = {}
        self._hists: Dict[str, Dict[Tuple[str, ...], _Histogram]] = {}
        self._lock = threading.Lock()

    @property
    def clock(self) -> Clock:
        return self._clock

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- spec/label plumbing -------------------------------------------

    def _resolve(self, spec: MetricSpec, kind: str,
                 labels: dict) -> Tuple[str, Tuple[str, ...]]:
        """Validate kind/labels and return (name, label-value key). Call
        with the lock held."""
        if spec.kind != kind:
            raise ValueError(
                f"{spec.name} is a {spec.kind}, not a {kind}")
        known = self._specs.get(spec.name)
        if known is None:
            self._specs[spec.name] = spec
        elif known is not spec and known != spec:
            raise ValueError(
                f"metric {spec.name!r} redeclared with a different shape")
        if len(labels) != len(spec.labels):
            raise ValueError(
                f"{spec.name}: labels {sorted(labels)} != declared "
                f"{sorted(spec.labels)}")
        try:
            return spec.name, tuple(str(labels[k]) for k in spec.labels)
        except KeyError:
            raise ValueError(
                f"{spec.name}: labels {sorted(labels)} != declared "
                f"{sorted(spec.labels)}") from None

    # -- recording ------------------------------------------------------

    def inc(self, spec: MetricSpec, amount: float = 1.0, **labels) -> None:
        if not self._enabled:
            return
        if amount < 0:
            raise ValueError(f"{spec.name}: counters only go up")
        with self._lock:
            name, key = self._resolve(spec, "counter", labels)
            series = self._scalars.setdefault(name, {})
            series[key] = series.get(key, 0.0) + amount

    def set_gauge(self, spec: MetricSpec, value: float, **labels) -> None:
        if not self._enabled:
            return
        with self._lock:
            name, key = self._resolve(spec, "gauge", labels)
            self._scalars.setdefault(name, {})[key] = float(value)

    def observe(self, spec: MetricSpec, value: float, **labels) -> None:
        if not self._enabled:
            return
        with self._lock:
            name, key = self._resolve(spec, "histogram", labels)
            series = self._hists.setdefault(name, {})
            hist = series.get(key)
            if hist is None:
                hist = series[key] = _Histogram(len(spec.buckets))
            v = float(value)
            for i, bound in enumerate(spec.buckets):
                if v <= bound:
                    hist.bucket_counts[i] += 1
                    break
            else:
                hist.bucket_counts[-1] += 1
            hist.sum += v
            hist.count += 1

    @contextmanager
    def timed(self, spec: MetricSpec, **labels):
        """Observe the clock delta across the block into a histogram."""
        if not self._enabled:
            yield
            return
        t0 = self._clock()
        try:
            yield
        finally:
            self.observe(spec, max(self._clock() - t0, 0.0), **labels)

    # -- reading (tests, reports, exporter) -----------------------------

    def value(self, spec: MetricSpec, **labels) -> float:
        """Current counter/gauge value (0.0 when never recorded)."""
        with self._lock:
            _, key = self._resolve(spec, spec.kind, labels)
            return self._scalars.get(spec.name, {}).get(key, 0.0)

    def histogram_stats(self, spec: MetricSpec,
                        **labels) -> Tuple[int, float]:
        """(count, sum) of a histogram series ((0, 0.0) if unrecorded)."""
        with self._lock:
            _, key = self._resolve(spec, "histogram", labels)
            hist = self._hists.get(spec.name, {}).get(key)
            return (hist.count, hist.sum) if hist else (0, 0.0)

    def snapshot(self) -> dict:
        """All recorded series as plain data (dump/debug helper)."""
        with self._lock:
            out: dict = {}
            for name, series in self._scalars.items():
                spec = self._specs[name]
                out[name] = {
                    "kind": spec.kind,
                    "series": {key: v for key, v in series.items()}}
            for name, series in self._hists.items():
                spec = self._specs[name]
                out[name] = {
                    "kind": "histogram",
                    "series": {key: {"count": h.count, "sum": h.sum,
                                     "buckets": list(h.bucket_counts)}
                               for key, h in series.items()}}
            return out

    # -- Prometheus text exposition ------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4 of every recorded
        series (specs touched but never recorded render header-only)."""
        with self._lock:
            lines: List[str] = []
            for name in sorted(self._specs):
                spec = self._specs[name]
                lines.append(f"# HELP {name} {spec.help}")
                lines.append(f"# TYPE {name} {spec.kind}")
                if spec.kind == "histogram":
                    for key, hist in sorted(
                            self._hists.get(name, {}).items()):
                        base = dict(zip(spec.labels, key))
                        cum = 0
                        for bound, n in zip(spec.buckets,
                                            hist.bucket_counts):
                            cum += n
                            lines.append(self._sample(
                                f"{name}_bucket",
                                dict(base, le=_fmt(bound)), cum))
                        lines.append(self._sample(
                            f"{name}_bucket", dict(base, le="+Inf"),
                            hist.count))
                        lines.append(self._sample(f"{name}_sum", base,
                                                  hist.sum))
                        lines.append(self._sample(f"{name}_count", base,
                                                  hist.count))
                else:
                    for key, v in sorted(
                            self._scalars.get(name, {}).items()):
                        lines.append(self._sample(
                            name, dict(zip(spec.labels, key)), v))
            return "\n".join(lines) + "\n"

    @staticmethod
    def _sample(name: str, labels: dict, value: float) -> str:
        if labels:
            body = ",".join(f'{k}="{_escape_label(v)}"'
                            for k, v in labels.items())
            return f"{name}{{{body}}} {_fmt(value)}"
        return f"{name} {_fmt(value)}"
