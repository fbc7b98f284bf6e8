"""The worker daemon's gRPC server: the port's copy of `serve_worker`,
`_fenced` and `get_host_ip` from `shockwave_tpu/runtime/servers.py`
(`serve_scheduler` is the scheduler's and stays in the JAX package).

`serve_worker` hosts SchedulerToWorker on each worker daemon. Callback
dicts carry plain-Python payloads; proto (de)serialization stays inside
this module.
"""
from __future__ import annotations

import logging
import socket
from concurrent import futures
from typing import Callable, Dict

import grpc

from ..obs import get_observability
from ..obs import names as obs_names
from ..obs.propagation import from_rpc_metadata
from .proto import control_pb2 as pb
from .resilience import EPOCH_ADVANCED, EPOCH_METADATA_KEY, EPOCH_STALE
from .rpc import generic_handler

logger = logging.getLogger("shockwave_tpu_torch.runtime")


def _metadata_epoch(context) -> int | None:
    """The sender's leader epoch from invocation metadata, or None when
    absent (HA disabled — every RPC passes unfenced)."""
    for key, value in (context.invocation_metadata() or ()):
        if key == EPOCH_METADATA_KEY:
            try:
                return int(value)
            except ValueError:
                return None
    return None


def _fenced(fn, fence, on_epoch_advance=None):
    """Wrap a dispatch-effecting worker handler with the epoch fence:
    a stale leader epoch is REJECTED (FAILED_PRECONDITION — the deposed
    leader treats it as its own fencing signal), an advanced one is
    adopted (and the observer re-resolves its scheduler endpoint /
    resets breakers before the new leader's work runs)."""

    def handler(request, context):
        epoch = _metadata_epoch(context)
        if epoch is not None:
            verdict = fence.observe(epoch)
            if verdict == EPOCH_STALE:
                get_observability().inc(obs_names.HA_FENCED_RPCS_TOTAL,
                                        side="worker")
                logger.warning(
                    "rejecting RPC from stale leader epoch %d (current "
                    "epoch %d)", epoch, fence.epoch)
                context.abort(
                    grpc.StatusCode.FAILED_PRECONDITION,
                    f"stale leader epoch {epoch} (worker has seen "
                    f"{fence.epoch}); you have been superseded")
            if verdict == EPOCH_ADVANCED and on_epoch_advance is not None:
                try:
                    on_epoch_advance(epoch)
                except Exception:  # noqa: BLE001 - the refresh is an
                    # optimization; the RPC itself must still run
                    logger.exception("epoch-advance callback failed")
        return fn(request, context)
    return handler


def get_host_ip() -> str:
    try:
        return socket.gethostbyname(socket.gethostname())
    except socket.gaierror:
        return "127.0.0.1"


def serve_worker(port: int, callbacks: Dict[str, Callable],
                 max_workers: int = 16, fence=None,
                 on_epoch_advance: Callable[[int], None] = None
                 ) -> grpc.Server:
    """Start the worker-side server (non-blocking); returns the server.

    With a `fence` (resilience.EpochFence), every dispatch-effecting
    handler (RunJob / KillJob / Reset / Shutdown) rejects RPCs carrying
    a leader epoch lower than the highest this worker has seen —
    fencing a deposed leader out of double-dispatching. Ping stays
    unfenced: liveness probes must answer whoever asks (a fenced old
    leader probing the fleet is harmless; a standby probing before its
    first dispatch is essential)."""

    def run_job(request, context):
        jobs = [
            dict(job_id=j.job_id, command=j.command,
                 working_directory=j.working_directory,
                 needs_data_dir=j.needs_data_dir,
                 num_steps_arg=j.num_steps_arg, num_steps=j.num_steps,
                 mode=j.mode)
            for j in request.jobs
        ]
        # Fleet tracing: the scheduler's span context (traceparent and
        # send-timestamp metadata) becomes the parent of the runjob span.
        callbacks["RunJob"](
            jobs, request.worker_id, request.round_id,
            trace=from_rpc_metadata(context.invocation_metadata()))
        return pb.Empty()

    def kill_job(request, context):
        callbacks["KillJob"](request.job_id)
        return pb.Empty()

    def reset(request, context):
        callbacks["Reset"]()
        return pb.Empty()

    def shutdown(request, context):
        callbacks["Shutdown"]()
        return pb.Empty()

    def ping(request, context):
        # Liveness probe: answering at all is the signal. An optional
        # callback lets the daemon surface health state in the future.
        cb = callbacks.get("Ping")
        if cb is not None:
            cb()
        return pb.Empty()

    guard = ((lambda fn: _fenced(fn, fence, on_epoch_advance))
             if fence is not None else (lambda fn: fn))
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((
        generic_handler("shockwave_tpu.SchedulerToWorker", {
            "RunJob": guard(run_job),
            "KillJob": guard(kill_job),
            "Reset": guard(reset),
            "Shutdown": guard(shutdown),
            "Ping": ping,
        }),
    ))
    server.add_insecure_port(f"[::]:{port}")
    server.start()
    logger.info("worker control server listening on %d", port)
    return server
