"""client-go-style Event recording against the fake apiserver.

The reference driver leans on ``record.EventRecorder`` for its operator
story: every notable claim/domain transition leaves a durable ``Event``
object that ``kubectl describe`` surfaces next to the involved object.
This module is that analogue for the in-memory API: a
:class:`EventRecorder` that writes **deduplicated, count-aggregated**
Event objects into ``FakeClient`` — the first occurrence creates the
Event, repeats bump ``count``/``lastTimestamp`` in place (client-go's
EventCorrelator behavior), so a prepare failing 500 times under churn is
one Event with ``count: 500``, not 500 objects.

Recording is **fire-and-forget**: an Event write must never fail or slow
the operation it describes, so every API error (including injected
faults from the chaos tier) is retried a few times and then logged and
dropped. The chaos oracle (``stresslab.run_claim_churn``) depends on the
bounded retry: an injected-failure claim must still end up with its
``PrepareFailed`` Event even when the fault plan is also hitting the
API verbs.

Reasons are declared as module constants so driverlint DL206 can
statically demand that every emitted reason is documented in
docs/observability.md (the DL203/DL205 cross-artifact pattern).
"""

from __future__ import annotations

import logging

from k8s_dra_driver_tpu_torch.pkg import sanitizer
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)

# -- the reason catalog (docs/observability.md, "Event reasons") -------------
# Every REASON_* constant here is the single source of truth DL206 checks
# against the docs; emit sites reference the constants, never raw strings.

REASON_PREPARE_FAILED = "PrepareFailed"
REASON_UNPREPARE_FAILED = "UnprepareFailed"
REASON_PREPARE_ABORTED = "PrepareAborted"
REASON_DOMAIN_READY = "DomainReady"
REASON_DOMAIN_NOT_READY = "DomainNotReady"
# Self-healing pipeline (docs/self-healing.md): taint → drain → repair →
# rejoin on the node side, drain → reallocate on the cluster side.
REASON_DEVICE_TAINTED = "DeviceTainted"
REASON_CLAIM_DRAINED = "ClaimDrained"
REASON_DEVICE_REJOINED = "DeviceRejoined"
REASON_CLAIM_REALLOCATED = "ClaimReallocated"
REASON_REALLOCATION_FAILED = "ReallocationFailed"
# Fleet telemetry (docs/observability.md, "Fleet telemetry"): SLO
# burn-rate alert transitions from pkg/slo.py's multi-window engine.
REASON_SLO_BURN_RATE_HIGH = "SloBurnRateHigh"
REASON_SLO_BURN_RATE_CLEARED = "SloBurnRateCleared"
# Node failure domains (docs/self-healing.md, "Whole-node repair"):
# lease-expiry cordon pipeline from pkg/nodelease.py.
REASON_NODE_CORDONED = "NodeCordoned"
REASON_NODE_UNCORDONED = "NodeUncordoned"
REASON_NODE_FENCED = "NodeFenced"
# Defragmentation (docs/performance.md, "Topology-aware allocation"):
# the SLO-driven planner's migration hints and scored preemptions.
REASON_DEFRAG_PLANNED = "DefragPlanned"
REASON_CLAIM_PREEMPTED = "ClaimPreempted"

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"

#: dedup-cache entries kept per recorder (LRU); a busy node churns many
#: distinct (object, reason) pairs, and the cache must not grow with them.
DEFAULT_CACHE_SIZE = 1024

#: bounded write retries — enough to ride out an injected rate fault or a
#: transient conflict, small enough that recording can never stall a
#: prepare for long.
WRITE_RETRIES = 5


def involved_object_ref(obj: dict[str, Any]) -> dict[str, Any]:
    """The ``involvedObject`` stanza for an API object."""
    meta = obj.get("metadata") or {}
    return {
        "apiVersion": obj.get("apiVersion", "v1"),
        "kind": obj.get("kind", ""),
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", ""),
        "uid": meta.get("uid", ""),
    }


class EventRecorder:
    """Writes Events about API objects on behalf of one component.

    ``client`` only needs the FakeClient verb surface (create/get/update/
    try_get) — the HTTP client works identically. ``host`` names the node
    for ``source.host`` (kubelet plugins); controllers leave it empty.
    """

    def __init__(self, client, component: str, host: str = "",
                 clock: Callable[[], float] = time.time,
                 cache_size: int = DEFAULT_CACHE_SIZE):
        self.client = client
        self.component = component
        self.host = host
        self.clock = clock
        self._mu = sanitizer.new_lock("EventRecorder._mu")
        # (kind, ns, name, uid, reason, type) -> (event name, event ns).
        # Message is deliberately NOT in the key: failure messages vary
        # per attempt and would defeat aggregation; the stored Event keeps
        # the newest message alongside the running count.
        self._cache: OrderedDict[tuple, tuple[str, str]] = OrderedDict()
        self._cache_size = cache_size

    # -- public surface ------------------------------------------------------

    def event(self, obj: dict[str, Any], reason: str, message: str,
              type_: str = TYPE_NORMAL) -> None:
        """Record an event about ``obj`` (an API object dict)."""
        self.event_for_ref(involved_object_ref(obj), reason, message, type_)

    def event_for_claim_ref(self, ref, reason: str, message: str,
                            type_: str = TYPE_WARNING) -> None:
        """Record against a ``ClaimRef`` — the unprepare paths only hold
        (uid, name, namespace), the claim object itself may be gone."""
        self.event_for_ref({
            "apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaim",
            "name": ref.name,
            "namespace": ref.namespace,
            "uid": ref.uid,
        }, reason, message, type_)

    def event_for_ref(self, involved: dict[str, Any], reason: str,
                      message: str, type_: str = TYPE_NORMAL) -> None:
        """The core path. Never raises; bounded retries then a log line."""
        try:
            self._record(involved, reason, message, type_)
        except Exception:  # noqa: BLE001 — recording must never fail the
            # operation it describes; the log line is the residue.
            logger.warning("event recorder: dropping %s/%s event for %s/%s",
                           type_, reason, involved.get("namespace", ""),
                           involved.get("name", ""), exc_info=True)

    # -- internals -----------------------------------------------------------

    def _key(self, involved: dict[str, Any], reason: str,
             type_: str) -> tuple:
        return (involved.get("kind", ""), involved.get("namespace", ""),
                involved.get("name", ""), involved.get("uid", ""),
                reason, type_)

    def _cache_get(self, key: tuple) -> Optional[tuple[str, str]]:
        with self._mu:
            entry = self._cache.get(key)
            if entry is not None:
                self._cache.move_to_end(key)
            return entry

    def _cache_put(self, key: tuple, name: str, namespace: str) -> None:
        with self._mu:
            self._cache[key] = (name, namespace)
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)

    def _cache_drop(self, key: tuple) -> None:
        with self._mu:
            self._cache.pop(key, None)

    def _record(self, involved: dict[str, Any], reason: str, message: str,
                type_: str) -> None:
        key = self._key(involved, reason, type_)
        last_err: Optional[BaseException] = None
        for _ in range(WRITE_RETRIES):
            cached = self._cache_get(key)
            try:
                if cached is not None and self._bump(cached, message):
                    return
                if cached is not None:
                    # The cached Event vanished (GC'd, deleted): recreate.
                    self._cache_drop(key)
                self._create(key, involved, reason, message, type_)
                return
            except Exception as e:  # noqa: BLE001 — bounded retry below
                last_err = e
                time.sleep(0.002)
        raise last_err  # type: ignore[misc] — caught by event_for_ref

    def _bump(self, cached: tuple[str, str], message: str) -> bool:
        """count++ / lastTimestamp / newest message on the cached Event.
        Returns False when the Event no longer exists (caller recreates).
        Conflicts re-read inside the retry loop above."""
        name, namespace = cached
        ev = self.client.try_get("Event", name, namespace)
        if ev is None:
            return False
        ev["count"] = int(ev.get("count", 1)) + 1
        ev["lastTimestamp"] = self.clock()
        ev["message"] = message
        self.client.update(ev)
        return True

    def _create(self, key: tuple, involved: dict[str, Any], reason: str,
                message: str, type_: str) -> None:
        now = self.clock()
        namespace = involved.get("namespace", "") or "default"
        name = f"{involved.get('name', 'object')}.{uuid.uuid4().hex[:12]}"
        self.client.create({
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": name, "namespace": namespace},
            "involvedObject": dict(involved),
            "reason": reason,
            "message": message,
            "type": type_,
            "count": 1,
            "firstTimestamp": now,
            "lastTimestamp": now,
            "source": {"component": self.component,
                       **({"host": self.host} if self.host else {})},
            "reportingComponent": self.component,
        })
        self._cache_put(key, name, namespace)


def list_events(client, namespace: Optional[str] = None,
                involved_name: Optional[str] = None,
                reason: Optional[str] = None) -> list[dict[str, Any]]:
    """Query helper for tests and the chaos oracle: Events filtered by
    involved-object name and/or reason."""
    out = []
    for ev in client.list("Event", namespace):
        if reason is not None and ev.get("reason") != reason:
            continue
        if involved_name is not None and (
                (ev.get("involvedObject") or {}).get("name")
                != involved_name):
            continue
        out.append(ev)
    return out
