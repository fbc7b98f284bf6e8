"""Thread-safe metrics registry: labeled counters and gauges (the part
of `shockwave_tpu/obs/registry.py` the port's runtime records into).

- **Specs, not strings.** Every instrument is declared once in
  `obs/names.py` as a `MetricSpec`; call sites pass the spec object.
  The registry materializes storage lazily on first use and rejects a
  second spec with the same name but a different shape.
- **Leaf lock.** One plain `threading.Lock` guards all storage and is
  never held across a call into other code. (The reference wraps its
  lock for its concurrency sanitizer, which lives in the JAX package;
  the port uses plain locks.)
- **Fail loud on misuse, never on recording.** Wrong kind / wrong label
  set raises; recording itself never raises.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

from .names import MetricSpec


class MetricsRegistry:
    def __init__(self):
        self._specs: Dict[str, MetricSpec] = {}
        # name -> {label_values: value}
        self._scalars: Dict[str, Dict[Tuple[str, ...], float]] = {}
        self._lock = threading.Lock()

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

    def inc(self, spec: MetricSpec, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{spec.name}: counters only go up")
        with self._lock:
            name, key = self._resolve(spec, "counter", labels)
            series = self._scalars.setdefault(name, {})
            series[key] = series.get(key, 0.0) + amount

    def set_gauge(self, spec: MetricSpec, value: float, **labels) -> None:
        with self._lock:
            name, key = self._resolve(spec, "gauge", labels)
            self._scalars.setdefault(name, {})[key] = float(value)

    def value(self, spec: MetricSpec, **labels) -> float:
        """Current counter/gauge value (0.0 when never recorded)."""
        with self._lock:
            _, key = self._resolve(spec, spec.kind, labels)
            return self._scalars.get(spec.name, {}).get(key, 0.0)
