"""Cross-process span context: the fleet-trace propagation primitive (a
copy of `shockwave_tpu/obs/propagation.py`; the wire format, the metadata
keys and the environment names are the reference's, so the JAX package's
scheduler and the port's worker and trainers share one trace).

A `SpanContext` is a (trace_id, span_id) pair in the W3C traceparent
shape (``00-<32 hex>-<16 hex>-01``). One round's
solve -> dispatch -> launch -> trainer-step -> Done chain shares a
single trace id across three or more processes:

- the scheduler opens a per-round root context and nests its phase and
  per-dispatch RPC spans under it (obs/tracing.py keeps the in-process
  parent stack);
- every scheduler->worker RunJob carries the active span's traceparent
  as gRPC metadata (`names.TRACEPARENT_METADATA_KEY` — the same channel
  the HA epoch fence rides) plus a send timestamp for clock alignment;
- the worker daemon adopts it as the remote parent of its `runjob` /
  `launch` spans, and the dispatcher forwards the launch context into
  the trainer subprocess as `names.TRACEPARENT_ENV` (the
  SWTPU_DEGRADE_FACTOR pattern);
- the job-side LeaseIterator adopts the env context for its `trainer`
  span, written into the process's span shard (obs/shard.py) and fused
  back into one timeline by the JAX package's
  ``python -m shockwave_tpu.obs.merge``.

Ids are generated from one `os.urandom` seed per process plus a
counter — no wall-clock reads (obs-discipline), no per-span entropy
syscall on the hot path, and no cross-process collisions.
"""
from __future__ import annotations

import itertools
import os
import re
from dataclasses import dataclass
from typing import Iterable, Optional, Tuple

from . import names

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")

#: Per-process id material: 12 random bytes (24 hex) for the trace-id
#: head, 4 (8 hex) for the span-id head; the tail is a counter.
_TRACE_BASE = os.urandom(12).hex()
_SPAN_BASE = os.urandom(4).hex()
_COUNTER = itertools.count(1)


@dataclass(frozen=True)
class SpanContext:
    """One span's identity within a trace. Immutable and hashable so it
    can ride thread-local stacks, RPC metadata and env vars alike."""
    trace_id: str
    span_id: str


def new_trace_id() -> str:
    return f"{_TRACE_BASE}{next(_COUNTER) & 0xFFFFFFFF:08x}"


def new_span_id() -> str:
    return f"{_SPAN_BASE}{next(_COUNTER) & 0xFFFFFFFF:08x}"


def new_root_context() -> SpanContext:
    return SpanContext(trace_id=new_trace_id(), span_id=new_span_id())


def child_context(parent: SpanContext) -> SpanContext:
    """A fresh span id inside the parent's trace."""
    return SpanContext(trace_id=parent.trace_id, span_id=new_span_id())


def format_traceparent(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """Parse a traceparent string; malformed input yields None (a
    telemetry channel must never take a dispatch down)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    return SpanContext(trace_id=m.group(1), span_id=m.group(2))


# -- gRPC metadata ------------------------------------------------------

def rpc_metadata(ctx: Optional[SpanContext],
                 send_ts: Optional[float] = None) -> Tuple[Tuple[str, str], ...]:
    """Metadata entries carrying `ctx` (and the sender's clock) on an
    RPC; empty when tracing is off so fenceless historical behavior is
    byte-identical."""
    if ctx is None:
        return ()
    entries = [(names.TRACEPARENT_METADATA_KEY, format_traceparent(ctx))]
    if send_ts is not None:
        entries.append((names.TRACE_SENDTS_METADATA_KEY,
                        repr(float(send_ts))))
    return tuple(entries)


def from_rpc_metadata(metadata: Optional[Iterable[Tuple[str, str]]]
                      ) -> Tuple[Optional[SpanContext], Optional[float]]:
    """(remote parent context, sender send-timestamp) from invocation
    metadata; (None, None) when absent or malformed."""
    ctx, send_ts = None, None
    for key, value in (metadata or ()):
        if key == names.TRACEPARENT_METADATA_KEY:
            ctx = parse_traceparent(value)
        elif key == names.TRACE_SENDTS_METADATA_KEY:
            try:
                send_ts = float(value)
            except (TypeError, ValueError):
                send_ts = None
    return ctx, send_ts


# -- environment (dispatcher -> trainer subprocess) ---------------------

def to_environ(ctx: Optional[SpanContext], env: dict) -> dict:
    """Export `ctx` into a subprocess environment dict (in place)."""
    if ctx is not None:
        env[names.TRACEPARENT_ENV] = format_traceparent(ctx)
    return env


def from_environ(environ=None) -> Optional[SpanContext]:
    source = os.environ if environ is None else environ
    return parse_traceparent(source.get(names.TRACEPARENT_ENV))
