"""Runtime-side span emission: the one place the port's worker daemon,
dispatcher and job-side LeaseIterator touch the fleet-trace machinery (a
copy of `shockwave_tpu/runtime/spans.py`).

This module owns the per-process `ShardSpanWriter` (obs/shard.py) and
the remote-parent plumbing (obs/propagation.py); the runtime modules
call its helpers and never read a wall clock for span purposes — every
span timestamp is stamped inside the shard writer by its injected
clock.

Tracing is opt-in per process: without a trace directory (the
`names.SHARD_DIR_ENV` environment variable, or an explicit
``--trace_dir``) every helper degrades to a no-op and the runtime
behaves as it does without tracing: no shard, no thread, no file.
"""
from __future__ import annotations

import atexit
import logging
import os
import threading
from typing import Optional

from ..obs import names
from ..obs.propagation import (SpanContext, from_environ, from_rpc_metadata,
                               to_environ)
from ..obs.shard import OpenSpan, ShardSpanWriter

logger = logging.getLogger("shockwave_tpu_torch.runtime")

_LOCK = threading.Lock()
_SHARD: Optional[ShardSpanWriter] = None

__all__ = ["SpanContext", "OpenSpan", "from_environ", "from_rpc_metadata",
           "to_environ", "init_process_shard", "shard_from_env",
           "get_shard", "trace_dir_from_env", "export_trace_env",
           "flush"]


def trace_dir_from_env() -> Optional[str]:
    return os.environ.get(names.SHARD_DIR_ENV) or None


def init_process_shard(directory: Optional[str],
                       role: str) -> Optional[ShardSpanWriter]:
    """Create (once) this process's span shard under `directory`; None
    disables tracing for the process. Flushed at exit so a clean
    process never loses its tail spans."""
    global _SHARD
    if directory is None:
        return None
    with _LOCK:
        if _SHARD is None:
            try:
                _SHARD = ShardSpanWriter(directory, role=role)
            except OSError as e:
                logger.warning("span shard disabled: cannot create %s "
                               "(%s)", directory, e)
                return None
            atexit.register(flush)
        elif os.path.abspath(_SHARD.directory) != os.path.abspath(
                directory):
            # Singleton-per-process by design (the atexit flush and the
            # env contract both assume one shard); a second caller with
            # a DIFFERENT directory keeps writing into the first one —
            # say so instead of silently dropping its drive's spans.
            logger.warning(
                "process span shard already bound to %s; ignoring "
                "request for %s (one shard per process)",
                _SHARD.directory, directory)
        return _SHARD


def shard_from_env(role: str) -> Optional[ShardSpanWriter]:
    """Process shard from the dispatcher-exported environment (trainer
    subprocesses), or None when tracing is off."""
    return init_process_shard(trace_dir_from_env(), role)


def get_shard() -> Optional[ShardSpanWriter]:
    return _SHARD


def export_trace_env(env: dict, ctx: Optional[SpanContext],
                     trace_dir: Optional[str]) -> dict:
    """Export the launch span's context + the shard directory into a
    trainer subprocess environment (in place; no-ops when tracing is
    off)."""
    to_environ(ctx, env)
    if trace_dir is not None:
        env[names.SHARD_DIR_ENV] = trace_dir
    return env


def flush() -> None:
    """Flush the process shard (atexit hook; safe to call any time)."""
    shard = _SHARD
    if shard is None:
        return
    try:
        shard.flush()
    except OSError as e:
        logger.warning("span shard flush failed: %s", e)
