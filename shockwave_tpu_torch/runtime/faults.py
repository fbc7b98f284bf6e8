"""Deterministic fault-injection harness for the physical runtime: the
port's copy of `shockwave_tpu/runtime/faults.py`, whole.

Tests (and chaos drills) need to make a specific RPC fail, a specific
worker vanish, or a specific dispatch wedge — at an exact, repeatable
point, not by `sleep`-based luck. Rules are matched by method name at
two chokepoints:

- every server-side RPC handler (`rpc.generic_handler` calls
  `fire(service/method, context)` before the real handler), and
- the worker dispatcher (`dispatcher._dispatch_jobs_helper` consults
  `should_freeze("dispatch")` per job).

Actions:
- ``drop``       abort the RPC with UNAVAILABLE (connection-level failure
                 from the client's point of view; exercises retry paths).
- ``blackhole``  hold the RPC for ``delay_s`` (default 60 s) and then
                 abort — a client without a deadline would hang; a client
                 with one observes DEADLINE_EXCEEDED at its own budget.
- ``delay``      sleep ``delay_s`` then answer normally.
- ``freeze``     dispatcher only: launch nothing and report nothing for
                 the job, holding the chip — a wedged process.
- ``degrade``    dispatcher only: a multiplicative slowdown (``factor``
                 in (0, 1], default 0.1) — NOT a freeze. The worker
                 stays live (Ping answers, leases renew) but every
                 dispatched job runs at ``factor`` of its speed: the
                 gray-failure the quarantine layer exists to catch.
                 The dispatcher exports the factor to the training
                 process as ``SWTPU_DEGRADE_FACTOR`` and the job-side
                 LeaseIterator honors it by padding each step to
                 compute/factor (real trainers genuinely slow down).

Each rule fires for matching calls number ``after`` .. ``after+times-1``
(per-rule call counter, so a test can say "drop the first two Done RPCs
then behave"). ``times=None`` means forever.

Configuration: programmatic via ``install()`` / ``clear()`` from tests,
or the ``SWTPU_FAULTS`` environment variable (a JSON list of rule
dicts) for subprocess workers, parsed once at first use.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import grpc

logger = logging.getLogger("shockwave_tpu_torch.runtime")

ACTIONS = ("drop", "blackhole", "delay", "freeze", "degrade")


@dataclass
class FaultRule:
    #: Method to match: bare name ("Done"), full path
    #: ("shockwave_tpu.WorkerToScheduler/Done"), "dispatch", or "*".
    method: str
    action: str = "drop"
    delay_s: float = 0.0
    #: degrade only: multiplicative execution-speed factor in (0, 1].
    factor: float = 0.1
    #: Apply to at most this many matching calls (None = every call).
    times: Optional[int] = None
    #: Skip this many matching calls before the rule starts firing.
    after: int = 0
    _matched: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"expected one of {ACTIONS}")
        if self.action == "degrade" and not 0.0 < self.factor <= 1.0:
            raise ValueError(f"degrade factor must be in (0, 1], got "
                             f"{self.factor!r}")

    def matches(self, method: str) -> bool:
        if self.method == "*":
            return True
        return self.method == method or method.endswith("/" + self.method)

    def should_fire(self) -> bool:
        """Advance this rule's call counter; True when this call is in
        the rule's [after, after+times) firing window."""
        n = self._matched
        self._matched += 1
        if n < self.after:
            return False
        return self.times is None or n < self.after + self.times


class FaultInjector:
    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[FaultRule] = []
        self.fired: List[tuple] = []  # (method, action) log for assertions

    def install(self, rules) -> None:
        """Replace the active rule set (list of FaultRule or rule dicts)."""
        parsed = [r if isinstance(r, FaultRule) else FaultRule(**r)
                  for r in rules]
        with self._lock:
            self._rules = parsed
            self.fired = []

    def clear(self) -> None:
        with self._lock:
            self._rules = []

    def active(self) -> bool:
        with self._lock:
            return bool(self._rules)

    def _next_action(self, method: str, actions) -> Optional[FaultRule]:
        """First matching rule whose action the calling chokepoint can
        apply. Rules with inapplicable actions are skipped WITHOUT
        advancing their firing window — a wildcard drop rule must not be
        silently consumed (and logged as fired) by a dispatch hook that
        can only freeze, or vice versa."""
        with self._lock:
            for rule in self._rules:
                if rule.action not in actions or not rule.matches(method):
                    continue
                if rule.should_fire():
                    self.fired.append((method, rule.action))
                    return rule
        return None

    def fire(self, method: str, context=None) -> None:
        """Server-side hook: maybe delay/abort the RPC named `method`."""
        rule = self._next_action(method, ("drop", "blackhole", "delay"))
        if rule is None:
            return
        logger.warning("fault injection: %s on %s", rule.action, method)
        if rule.action == "delay":
            time.sleep(rule.delay_s)
            return
        if rule.action == "blackhole":
            time.sleep(rule.delay_s if rule.delay_s > 0 else 60.0)
        if context is not None:
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"fault injection ({rule.action})")
        else:  # no grpc context (direct-call tests): surface as RpcError
            raise _InjectedRpcError(method, rule.action)

    def should_freeze(self, method: str) -> bool:
        """Dispatcher-side hook: True when this dispatch must wedge."""
        rule = self._next_action(method, ("freeze",))
        if rule is None:
            return False
        logger.warning("fault injection: freezing dispatch of %s", method)
        return True

    def slowdown(self, method: str) -> float:
        """Dispatcher-side hook: multiplicative slowdown factor for this
        execution (1.0 = full speed). Each matching degrade rule's
        firing window advances once per call; overlapping rules
        compound, like stacked throttling causes would."""
        factor = 1.0
        with self._lock:
            for rule in self._rules:
                if rule.action != "degrade" or not rule.matches(method):
                    continue
                if rule.should_fire():
                    self.fired.append((method, rule.action))
                    factor *= rule.factor
        if factor < 1.0:
            logger.warning("fault injection: degrading %s to %.3fx speed",
                           method, factor)
        return factor


class _InjectedRpcError(grpc.RpcError):
    def __init__(self, method: str, action: str):
        super().__init__(f"fault injection: {action} on {method}")
        self._code = grpc.StatusCode.UNAVAILABLE

    def code(self):
        return self._code


_injector: Optional[FaultInjector] = None
_injector_lock = threading.Lock()


def get_injector() -> FaultInjector:
    """Process-wide injector; seeds rules from $SWTPU_FAULTS on first use."""
    global _injector
    with _injector_lock:
        if _injector is None:
            _injector = FaultInjector()
            raw = os.environ.get("SWTPU_FAULTS")
            if raw:
                try:
                    _injector.install(json.loads(raw))
                    logger.warning("fault injection active from SWTPU_FAULTS")
                except (ValueError, TypeError) as e:
                    logger.error("bad SWTPU_FAULTS (%s); ignoring", e)
        return _injector
