"""Mergeable fixed-log-bucket quantile sketch for measured latencies (a
copy of `shockwave_tpu/obs/quantiles.py`: the same buckets and the same
byte-canonical encoding).

The serving tier needs per-replica request-latency quantiles that can be
shipped as compact deltas on the existing Done heartbeats and folded
per-service on the scheduler — across any number of replicas, arriving
in any order, possibly duplicating a round boundary. A fixed bucket
layout makes that algebra exact:

- every process maps a latency to the same bucket index
  (``floor(log(v / MIN_VALUE) / log(GAMMA))``, clamped), so a sketch is
  just ``{bucket_index: count}``;
- **merge is integer addition per bucket** — associative, commutative,
  and lossless, so the merged quantile is independent of shard arrival
  order (asserted byte-for-byte by the tests and the calibration CI
  gate);
- quantiles are read as the upper edge of the bucket holding the
  ``ceil(q * n)``-th sample — deterministic, with bounded relative
  error ``GAMMA - 1`` (~5%) over [MIN_VALUE, MAX_VALUE].

The sketch is pure data + arithmetic: no clocks (values are measured by
the caller against its own timebase), no RNG, no floats in the
serialized form except the two counters — ``encode()`` emits canonical
JSON (sorted buckets, integer counts) so two equal sketches are
byte-equal, which is what lets CI ``cmp`` calibration artifacts.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional, Tuple

#: Bucket geometry: shared by every producer and consumer (a layout
#: change is a wire-format change; bump VERSION with it).
MIN_VALUE = 1e-4          # 0.1 ms: below this, latency is bucket 0
MAX_VALUE = 1e4           # beyond ~2.7 h everything lands in the top bucket
GAMMA = 1.05              # per-bucket growth => <=5% relative error
VERSION = 1

_LOG_GAMMA = math.log(GAMMA)
#: Highest regular bucket index (values above MAX_VALUE clamp here).
MAX_BUCKET = int(math.ceil(math.log(MAX_VALUE / MIN_VALUE) / _LOG_GAMMA))


def bucket_index(value: float) -> int:
    """The fixed bucket of `value` (clamped to [0, MAX_BUCKET])."""
    if value <= MIN_VALUE:
        return 0
    idx = int(math.floor(math.log(value / MIN_VALUE) / _LOG_GAMMA))
    return min(max(idx, 0), MAX_BUCKET)


def bucket_upper(index: int) -> float:
    """Upper edge of bucket `index` — the value a quantile read
    reports (an over-estimate by at most GAMMA-1 relative)."""
    return MIN_VALUE * GAMMA ** (index + 1)


class QuantileSketch:
    """One mergeable latency distribution: {bucket: count} + sum."""

    __slots__ = ("buckets", "count", "total")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0    # sum of raw values (mean readback)

    def add(self, value: float) -> None:
        idx = bucket_index(value)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.total += float(value)

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold `other` into this sketch (exact: integer bucket adds)."""
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        return self

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile (upper bucket edge), or None when empty."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {q}")
        if self.count == 0:
            return None
        rank = max(int(math.ceil(q * self.count)), 1)
        seen = 0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= rank:
                return bucket_upper(idx)
        return bucket_upper(MAX_BUCKET)   # unreachable; defensive

    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    # -- wire format ----------------------------------------------------

    def to_payload(self) -> dict:
        """Plain-data form: sorted [index, count] pairs (JSON keys must
        be strings, and sorted pairs keep encodings canonical)."""
        return {
            "v": VERSION,
            "b": [[idx, self.buckets[idx]] for idx in sorted(self.buckets)],
            "n": self.count,
            "s": round(self.total, 9),
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "QuantileSketch":
        if payload.get("v") != VERSION:
            raise ValueError(
                f"quantile sketch version {payload.get('v')!r} != {VERSION}")
        sketch = cls()
        for idx, n in payload.get("b", []):
            if n < 0:
                raise ValueError("negative bucket count")
            sketch.buckets[int(idx)] = sketch.buckets.get(int(idx), 0) + int(n)
        sketch.count = int(payload.get("n", 0))
        sketch.total = float(payload.get("s", 0.0))
        if sketch.count != sum(sketch.buckets.values()):
            raise ValueError("bucket counts disagree with sample count")
        return sketch

    def encode(self) -> str:
        """Canonical (byte-deterministic) JSON encoding."""
        return json.dumps(self.to_payload(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def decode(cls, text: str) -> "QuantileSketch":
        return cls.from_payload(json.loads(text))

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, QuantileSketch)
                and self.buckets == other.buckets
                and self.count == other.count
                and round(self.total, 9) == round(other.total, 9))

    def __repr__(self) -> str:
        return (f"QuantileSketch(n={self.count}, "
                f"p50={self.quantile(0.5)}, p99={self.quantile(0.99)})")


def merge_all(sketches: Iterable[QuantileSketch]) -> QuantileSketch:
    """Fold any number of sketches into a fresh one (order-free)."""
    out = QuantileSketch()
    for sketch in sketches:
        out.merge(sketch)
    return out


def quantiles(sketch: QuantileSketch,
              qs: Tuple[float, ...] = (0.5, 0.99)) -> List[Optional[float]]:
    return [sketch.quantile(q) for q in qs]


__all__ = ["QuantileSketch", "merge_all", "quantiles", "bucket_index",
           "bucket_upper", "MIN_VALUE", "MAX_VALUE", "GAMMA", "MAX_BUCKET",
           "VERSION"]
