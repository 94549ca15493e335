"""The GPU kubelet plugin's health probe and its gRPC health service.

The counterpart of the JAX package's ``plugins/tpu_kubelet_plugin/
healthcheck.py`` (itself the analogue of the reference's optional health
service, ``cmd/gpu-kubelet-plugin/health.go:51-149``): the standard
``grpc.health.v1`` protocol over a unix socket or TCP, wire-compatible with
``grpc-health-probe`` and kubelet gRPC probes. The two protocol messages
are built at run time with ``google.protobuf.proto_builder`` (no codegen),
with the canonical field numbers (service=1, status=1 — an int32 field
serializes identically to the enum on the wire).

``grpc`` and ``google.protobuf`` are imported only when a server starts or
a client checks: a machine without them runs the plugin with
``--healthcheck-addr ""``, and a plugin asked for the server there refuses
to start (``require_grpc``).
"""

from __future__ import annotations

import functools
import logging
from collections import OrderedDict
from concurrent import futures
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)

SERVICE_NAME = "grpc.health.v1.Health"

# HealthCheckResponse.ServingStatus values (grpc.health.v1).
STATUS_UNKNOWN = 0
STATUS_SERVING = 1
STATUS_NOT_SERVING = 2


def require_grpc(flag: str = "--healthcheck-addr") -> None:
    """Raise SystemExit naming ``flag`` when ``grpc`` or
    ``google.protobuf`` cannot be imported: a health server that was asked
    for is never left out quietly."""
    try:
        import grpc  # noqa: F401
        from google.protobuf import proto_builder  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            f"{flag}: the gRPC health server needs the grpc and protobuf "
            f"packages ({e}); pass {flag} \"\" to run without it") from e


@functools.lru_cache(maxsize=None)
def _messages() -> tuple[Any, Any]:
    """(HealthCheckRequest, HealthCheckResponse), built once."""
    from google.protobuf import descriptor_pb2, proto_builder

    fd = descriptor_pb2.FieldDescriptorProto
    request = proto_builder.MakeSimpleProtoClass(
        OrderedDict([("service", fd.TYPE_STRING)]),
        full_name="gpu_dra.grpc_health.v1.HealthCheckRequest")
    response = proto_builder.MakeSimpleProtoClass(
        OrderedDict([("status", fd.TYPE_INT32)]),
        full_name="gpu_dra.grpc_health.v1.HealthCheckResponse")
    return request, response


class HealthcheckServer:
    """Serves Health/Check; ``probe`` returns the ServingStatus (as
    :func:`driver_probe` does), and a probe that raises reads
    NOT_SERVING."""

    def __init__(self, probe: Callable[[], int], address: str):
        self.probe = probe
        self.address = address
        self._server = None
        self._executor: Optional[futures.ThreadPoolExecutor] = None

    def _check(self, request, context):
        _, response = _messages()
        resp = response()
        try:
            resp.status = int(self.probe())
        except Exception:  # noqa: BLE001 — a crashing probe is NOT_SERVING
            logger.exception("health probe failed")
            resp.status = STATUS_NOT_SERVING
        return resp

    def start(self) -> "HealthcheckServer":
        import grpc

        request, response = _messages()
        self._executor = futures.ThreadPoolExecutor(max_workers=2)
        server = grpc.server(self._executor)
        handler = grpc.method_handlers_generic_handler(SERVICE_NAME, {
            "Check": grpc.unary_unary_rpc_method_handler(
                self._check,
                request_deserializer=request.FromString,
                response_serializer=response.SerializeToString,
            ),
        })
        server.add_generic_rpc_handlers((handler,))
        # Modern grpcio raises on bind failure; older versions return 0
        # (unix-socket success returns 1) — never claim to serve unbound.
        if server.add_insecure_port(self.address) == 0:
            raise RuntimeError(f"healthcheck cannot bind {self.address}")
        server.start()
        self._server = server
        logger.info("healthcheck serving on %s", self.address)
        return self

    def stop(self) -> None:
        """Stop serving (in-flight checks get 1 s) and end the handler
        threads."""
        if self._server is not None:
            self._server.stop(grace=1.0).wait(timeout=5.0)
        if self._executor is not None:
            self._executor.shutdown(wait=True)


def check_health(address: str, timeout: float = 5.0) -> int:
    """Client side: returns the ServingStatus (the grpc-health-probe role)."""
    import grpc

    request, response = _messages()
    with grpc.insecure_channel(address) as channel:
        call = channel.unary_unary(
            f"/{SERVICE_NAME}/Check",
            request_serializer=request.SerializeToString,
            response_deserializer=response.FromString,
        )
        return call(request(), timeout=timeout).status


def driver_probe(driver, drainer=None,
                 fenced: Optional[Callable[[], bool]] = None) -> int:
    """SERVING iff the plugin is registered with the kubelet and its
    checkpoint is readable, no drain is in flight (``drainer.draining``:
    a node mid-drain is deliberately NOT_SERVING so orchestration holds
    off until the device rejoins) and the fence gate ``fenced`` (a node
    healing from a partition, docs/self-healing.md "Whole-node repair")
    does not read True. Anything that raises — a corrupt checkpoint, a
    crashing gate — reads NOT_SERVING.

    Uses the flock-free checkpoint read: probes run against a ~5 s kubelet
    deadline and must not queue behind a prepare holding the node flock —
    a busy plugin is a healthy plugin."""
    try:
        if not driver.helper.is_registered:
            return STATUS_NOT_SERVING
        driver.state.prepared_claims_nolock()  # raises on corrupt state
        if drainer is not None and drainer.draining:
            return STATUS_NOT_SERVING
        if fenced is not None and fenced():
            return STATUS_NOT_SERVING
    except Exception:  # noqa: BLE001 — a crashing probe is NOT_SERVING
        logger.exception("health probe failed")
        return STATUS_NOT_SERVING
    return STATUS_SERVING
