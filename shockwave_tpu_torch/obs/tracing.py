"""Nestable span tracer with Chrome-trace (Perfetto) JSON export (a copy
of `shockwave_tpu/obs/tracing.py`; its lock is a plain `threading.Lock`,
since the reference's lock sanitizer lives in the JAX package).

Spans are recorded as complete ("ph": "X") events keyed by thread id, so
nesting falls out of the viewer's per-track stacking. Since the fleet-
tracing work each span additionally carries an explicit identity — a
(trace_id, span_id, parent_id) triple (obs/propagation.SpanContext) —
maintained on a per-thread parent stack, so parent links survive
export, shard files and the cross-process merge, where per-track
stacking cannot reach. A remote parent (another process's span,
arriving via RPC metadata or the dispatcher's env export) is spliced in
with ``span(..., parent=ctx)``. The event buffer is a bounded ring
(oldest spans drop first) so a long-lived scheduler cannot grow without
bound.

The clock is injected (see obs/clock.py): under the simulator's virtual
clock the trace is laid out in simulated seconds; under wall clocks it
lines up with logs and journal records. Export is plain
``json.dump`` — traces are telemetry, not durable state.

View an exported trace in ``chrome://tracing`` / https://ui.perfetto.dev,
or summarize it with the JAX package's ``python -m shockwave_tpu.obs.report
<trace>``.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from contextlib import contextmanager
from typing import List, Optional

from .clock import Clock, wall_clock
from .propagation import SpanContext, new_span_id, new_trace_id

#: Default ring size: a 360 s-round physical run emits ~10 spans/round
#: plus one per journal fsync; 200k events covers days of rounds.
DEFAULT_MAX_EVENTS = 200_000


class Tracer:
    def __init__(self, clock: Optional[Clock] = None, enabled: bool = True,
                 max_events: int = DEFAULT_MAX_EVENTS):
        self._clock: Clock = clock or wall_clock
        self._enabled = enabled
        self._events: "deque[dict]" = deque(maxlen=max_events)
        self._lock = threading.Lock()
        # Per-thread stack of open SpanContexts (parent links).
        self._tls = threading.local()

    # Rides inside pickled scheduler objects (simulation checkpoints);
    # locks are recreated on load.
    def __getstate__(self):
        state = dict(self.__dict__)
        del state["_lock"]
        del state["_tls"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self._tls = threading.local()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_context(self) -> Optional[SpanContext]:
        """The innermost open span on THIS thread, or None."""
        stack = self._stack()
        return stack[-1] if stack else None

    def _enter_context(self,
                       parent: Optional[SpanContext]) -> SpanContext:
        if parent is None:
            parent = self.current_context()
        if parent is None:
            ctx = SpanContext(trace_id=new_trace_id(),
                              span_id=new_span_id())
        else:
            ctx = SpanContext(trace_id=parent.trace_id,
                              span_id=new_span_id())
        self._tls.parent_of = getattr(self._tls, "parent_of", {})
        self._tls.parent_of[ctx.span_id] = (parent.span_id
                                            if parent else None)
        self._stack().append(ctx)
        return ctx

    @contextmanager
    def span(self, name: str, parent: Optional[SpanContext] = None,
             **args):
        """Record one span covering the block; yields its SpanContext
        (None when disabled) so callers can propagate it across a
        process boundary. `parent` splices a REMOTE parent in; without
        it the enclosing span on this thread is the parent. `args` must
        be JSON-serializable; they land in the trace event's `args` and
        are what the report CLI groups by (e.g. ``round=N``)."""
        if not self._enabled:
            yield None
            return
        t0 = self._clock()
        ctx = self._enter_context(parent)
        try:
            yield ctx
        finally:
            t1 = self._clock()
            stack = self._stack()
            if stack and stack[-1] is ctx:
                stack.pop()
            parent_id = self._tls.parent_of.pop(ctx.span_id, None)
            event = {"name": name, "ts": t0, "dur": max(t1 - t0, 0.0),
                     "tid": threading.get_ident(),
                     "trace_id": ctx.trace_id, "span_id": ctx.span_id,
                     "parent_id": parent_id, "args": args}
            with self._lock:
                self._events.append(event)

    def record_span(self, name: str, ts: float, dur: float,
                    context: Optional[SpanContext] = None,
                    parent: Optional[SpanContext] = None,
                    **args) -> Optional[SpanContext]:
        """Record one span with explicit timestamps — for spans whose
        lifetime does not nest lexically (e.g. the scheduler's whole-
        round root span, closed a phase at a time). `context` pins the
        span's identity (so children created earlier can already have
        linked to it); otherwise a fresh one is allocated under
        `parent`. Returns the span's context (None when disabled)."""
        if not self._enabled:
            return None
        if context is None:
            trace = parent.trace_id if parent else new_trace_id()
            context = SpanContext(trace_id=trace, span_id=new_span_id())
        event = {"name": name, "ts": float(ts),
                 "dur": max(float(dur), 0.0),
                 "tid": threading.get_ident(),
                 "trace_id": context.trace_id,
                 "span_id": context.span_id,
                 "parent_id": parent.span_id if parent else None,
                 "args": args}
        with self._lock:
            self._events.append(event)
        return context

    def events(self) -> List[dict]:
        """Snapshot of recorded spans, oldest first."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    @staticmethod
    def event_args(event: dict) -> dict:
        """An event's args with its span identity folded in — the shape
        every export path (Chrome trace, shards) serializes."""
        args = dict(event.get("args") or {})
        for key in ("trace_id", "span_id", "parent_id"):
            if event.get(key) is not None:
                args[key] = event[key]
        return args

    def export_chrome_trace(self, path: str) -> str:
        """Write the buffer as Chrome-trace JSON; returns `path`. Span
        identities ride in each event's args, so parent links survive
        the export (and the merge CLI can walk them)."""
        pid = os.getpid()
        trace = {
            "displayTimeUnit": "ms",
            "traceEvents": [
                {"name": e["name"], "ph": "X", "cat": "swtpu",
                 "ts": e["ts"] * 1e6, "dur": e["dur"] * 1e6,
                 "pid": pid, "tid": e["tid"],
                 "args": self.event_args(e)}
                for e in self.events()],
        }
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        return path
