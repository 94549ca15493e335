"""The GPU kubelet plugin's health probe.

The probe of the JAX package's ``plugins/tpu_kubelet_plugin/healthcheck.py``
(itself the analogue of the reference's ``cmd/gpu-kubelet-plugin/
health.go:121-149``), as a plain function that returns the
``grpc.health.v1`` ServingStatus value. The gRPC server that serves it
there is not ported: this package imports no ``grpc``.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

logger = logging.getLogger(__name__)

# HealthCheckResponse.ServingStatus values (grpc.health.v1).
STATUS_UNKNOWN = 0
STATUS_SERVING = 1
STATUS_NOT_SERVING = 2


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
