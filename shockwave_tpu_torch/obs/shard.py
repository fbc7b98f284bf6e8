"""Per-process span shards: how worker daemons and trainers get their
spans into the fleet trace (a copy of `shockwave_tpu/obs/shard.py`). The
files are the reference's byte for byte in shape, so the JAX package's
scheduler merges the port's shards beside its own with its unchanged
`obs/merge.py`.

The scheduler's tracer lives in one long-lived process; the rest of a
round's story happens in worker daemons and short-lived trainer
subprocesses. Each of those keeps a bounded in-memory ring of spans
(the same `Tracer`) and periodically rewrites ONE shard file —
``spans-<role>-<pid>.json`` in the drive's trace directory — via
`core/durable_io.write_text_atomic`, so a reader never sees a torn
shard and a crashed process leaves its last complete flush behind.
The JAX package's ``python -m shockwave_tpu.obs.merge`` fuses every
shard in a directory
into a single Perfetto/Chrome trace, aligning per-host clocks from the
RPC send/recv timestamp pairs the spans carry.

The clock is injected (obs/clock.py) and every timestamp a shard span
carries is stamped HERE — runtime modules call `open_span`/`close_span`
and never read a wall clock for span purposes.
"""
from __future__ import annotations

import json
import os
import socket
from typing import Optional

from . import names
from .clock import Clock, wall_clock
from .propagation import SpanContext
from .tracing import Tracer

#: Shard rings are small: a worker daemon emits a handful of spans per
#: dispatch, a trainer a handful per lifetime.
DEFAULT_MAX_SPANS = 20_000

SHARD_SCHEMA = 1


class OpenSpan:
    """Handle for a span whose lifetime does not nest lexically (a
    trainer's whole lease window, a dispatcher's process launch)."""

    __slots__ = ("name", "t0", "context", "parent", "args")

    def __init__(self, name: str, t0: float, context: SpanContext,
                 parent: Optional[SpanContext], args: dict):
        self.name = name
        self.t0 = t0
        self.context = context
        self.parent = parent
        self.args = args


class ShardSpanWriter:
    """A Tracer plus the atomic shard-file flush, for one process."""

    def __init__(self, directory: str, role: str,
                 clock: Optional[Clock] = None,
                 max_spans: int = DEFAULT_MAX_SPANS, obs=None,
                 host: Optional[str] = None, pid: Optional[int] = None):
        self.directory = directory
        self.role = role
        self._clock: Clock = clock or wall_clock
        self.tracer = Tracer(clock=self._clock, max_events=max_spans)
        self._obs = obs
        self._pid = os.getpid() if pid is None else int(pid)
        self._host = host if host is not None else socket.gethostname()
        self.path = os.path.join(directory,
                                 names.shard_filename(role, self._pid))
        os.makedirs(directory, exist_ok=True)

    # -- span recording -------------------------------------------------

    def span(self, name: str, parent: Optional[SpanContext] = None,
             **args):
        """Context-manager span (delegates to the tracer)."""
        return self.tracer.span(name, parent=parent, **args)

    def open_span(self, name: str, parent: Optional[SpanContext] = None,
                  **args) -> OpenSpan:
        """Begin a non-lexical span; stamp its start with the injected
        clock. Close with `close_span` (or it is lost, by design — a
        crash mid-span has no honest duration)."""
        from .propagation import child_context, new_root_context
        ctx = child_context(parent) if parent else new_root_context()
        return OpenSpan(name, self._clock(), ctx, parent, dict(args))

    def close_span(self, span: OpenSpan, **more_args) -> None:
        args = dict(span.args)
        args.update(more_args)
        self.tracer.record_span(
            span.name, ts=span.t0, dur=self._clock() - span.t0,
            context=span.context, parent=span.parent, **args)

    # -- flush ----------------------------------------------------------

    def flush(self) -> Optional[str]:
        """Atomically rewrite the shard file from the current ring.
        Returns the path (None when there is nothing to write). Cheap
        enough to call per dispatch: shards are bounded and the write
        is one buffered JSON dump + rename."""
        events = self.tracer.events()
        if not events:
            return None
        payload = shard_payload(self.role, self._pid, self._host,
                                events)
        from ..core.durable_io import write_text_atomic
        write_text_atomic(self.path, json.dumps(payload))
        if self._obs is not None:
            from . import names as obs_names
            self._obs.inc(obs_names.TRACE_SHARD_FLUSHES_TOTAL)
            self._obs.set_gauge(obs_names.TRACE_SHARD_SPANS, len(events))
        return self.path


def shard_payload(role: str, pid: int, host: str,
                  events: list) -> dict:
    """The ONE serialization of tracer events into a shard file's JSON
    shape — shared by ShardSpanWriter.flush and export_tracer_shard so
    the scheduler shard can never fork shape from worker/trainer
    shards. `tid` rides along: per-thread tracks must survive into the
    merge (concurrent dispatch threads on one daemon)."""
    return {
        "schema": SHARD_SCHEMA,
        "role": role,
        "pid": int(pid),
        "host": host,
        "spans": [
            {"name": e["name"], "ts": e["ts"], "dur": e["dur"],
             "tid": e.get("tid", 0),
             "trace_id": e.get("trace_id"),
             "span_id": e.get("span_id"),
             "parent_id": e.get("parent_id"),
             "args": e.get("args") or {}}
            for e in events],
    }


def export_tracer_shard(directory: str, role: str, tracer,
                        obs=None, host: Optional[str] = None,
                        pid: Optional[int] = None) -> Optional[str]:
    """Dump an EXISTING tracer's ring as a shard file (the scheduler's
    collection path: its spans already live in the scheduler tracer).
    Returns the shard path (None when the ring is empty)."""
    events = tracer.events()
    if not events:
        return None
    the_pid = os.getpid() if pid is None else int(pid)
    payload = shard_payload(
        role, the_pid,
        host if host is not None else socket.gethostname(), events)
    path = os.path.join(directory, names.shard_filename(role, the_pid))
    os.makedirs(directory, exist_ok=True)
    from ..core.durable_io import write_text_atomic
    write_text_atomic(path, json.dumps(payload))
    if obs is not None:
        obs.inc(names.TRACE_SHARD_FLUSHES_TOTAL)
        obs.set_gauge(names.TRACE_SHARD_SPANS, len(events))
    return path


def load_shard(path: str) -> Optional[dict]:
    """Read one shard file; None when unreadable/foreign (a torn or
    alien file must not sink the merge)."""
    try:
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict) or "spans" not in payload:
        return None
    return payload


def discover_shards(directory: str):
    """Shard paths in `directory`, sorted by filename (deterministic
    merge order)."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return []
    return sorted(
        os.path.join(directory, name) for name in entries
        if name.startswith(names.SHARD_FILE_PREFIX)
        and name.endswith(names.SHARD_FILE_SUFFIX))
