"""gRPC service bindings without protoc's grpc plugin.

Service/method tables are declared once; `make_stub` builds a client-side
callable stub and `generic_handler` a server-side handler from the same
table, so the two can never drift apart.

`generic_handler` is also the single server-side chokepoint for the
fault-injection harness (`faults.py`): every handler consults the active
injector before running, so tests can drop / blackhole / delay any RPC
method deterministically.
"""
from __future__ import annotations

from typing import Callable, Dict

import grpc

from . import faults
from .proto import control_pb2 as pb

SERVICES: Dict[str, Dict[str, tuple]] = {
    "shockwave_tpu.WorkerToScheduler": {
        "RegisterWorker": (pb.RegisterWorkerRequest, pb.RegisterWorkerResponse),
        "Done": (pb.DoneRequest, pb.Empty),
    },
    "shockwave_tpu.SchedulerToWorker": {
        "RunJob": (pb.RunJobRequest, pb.Empty),
        "KillJob": (pb.KillJobRequest, pb.Empty),
        "Reset": (pb.Empty, pb.Empty),
        "Shutdown": (pb.Empty, pb.Empty),
        # Liveness probe: answered by the worker server itself, carrying
        # no payload — the scheduler's heartbeat monitor calls it with a
        # short deadline when piggybacked heartbeats go stale.
        "Ping": (pb.Empty, pb.Empty),
    },
    "shockwave_tpu.IteratorToScheduler": {
        "InitJob": (pb.InitJobRequest, pb.InitJobResponse),
        "UpdateLease": (pb.UpdateLeaseRequest, pb.UpdateLeaseResponse),
        "UpdateResourceRequirement": (pb.UpdateResourceRequirementRequest, pb.Empty),
    },
}


class Stub:
    """Client stub exposing one attribute per RPC method."""

    def __init__(self, channel: grpc.Channel, service: str):
        for method, (req_cls, resp_cls) in SERVICES[service].items():
            callable_ = channel.unary_unary(
                f"/{service}/{method}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString,
            )
            setattr(self, method, callable_)


def _with_fault_hook(fn: Callable, full_method: str) -> Callable:
    def handler(request, context):
        injector = faults.get_injector()
        if injector.active():
            injector.fire(full_method, context)  # may sleep or abort
        return fn(request, context)
    return handler


def generic_handler(service: str, implementations: Dict[str, Callable]):
    """Build a grpc generic handler from {method_name: fn(request, context)}."""
    method_handlers = {}
    for method, fn in implementations.items():
        req_cls, resp_cls = SERVICES[service][method]
        method_handlers[method] = grpc.unary_unary_rpc_method_handler(
            _with_fault_hook(fn, f"{service}/{method}"),
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
    return grpc.method_handlers_generic_handler(service, method_handlers)
