"""Orphan GC: children and node labels that outlive their ComputeDomain.

Copied from the JAX package's ``plugins/compute_domain_controller/
cleanup.py``. The analogue of the reference's generic cleanup manager +
periodic stale-label sweep (``cmd/compute-domain-controller/
cleanup.go:35-140``: every tracked
object type is scanned for a ComputeDomain reference whose CD no longer
exists, and a per-type callback removes the orphan; ``node.go:41-167``: the
node-label variant, also kicked on-demand at every reconcile via
``RemoveStaleComputeDomainLabelsAsync``).

Orphans arise when finalizer-ordered teardown is interrupted (controller
crash between child deletion and finalizer release, force-deleted CDs,
etc.). The sweep is idempotent and cheap, so it runs periodically AND can be
kicked synchronously from the reconcile path.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from k8s_dra_driver_tpu_torch.api.computedomain import (
    KIND_CLIQUE,
    KIND_COMPUTE_DOMAIN,
    NODE_LABEL_CD,
)
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import NotFoundError, Obj

logger = logging.getLogger(__name__)

# cleanup.go:30 — reference sweeps every 10 minutes.
DEFAULT_SWEEP_INTERVAL = 600.0

#: child kinds scanned for orphaned ComputeDomain owner references
_CHILD_KINDS = ("DaemonSet", "ResourceClaimTemplate")


def _owned_cd_uid(obj: Obj) -> str:
    for ref in obj["metadata"].get("ownerReferences") or []:
        if ref.get("kind") == KIND_COMPUTE_DOMAIN:
            return ref.get("uid", "")
    return ""


class CleanupManager:
    """Periodic + on-demand sweep of ComputeDomain orphans."""

    def __init__(self, client: FakeClient, namespace: Optional[str] = None,
                 interval: float = DEFAULT_SWEEP_INTERVAL,
                 min_gap: float = 0.0,
                 metrics=None):
        """``namespace`` scopes the CHILD scan (None = all namespaces —
        required for the multi-namespace layout where DaemonSets/cliques
        live in the driver namespace and workload RCTs with the users).
        CD existence checks are always cluster-wide: a child whose owner
        exists ANYWHERE is never an orphan, regardless of scan scope.
        ``min_gap``: minimum seconds between consecutive sweeps. Every
        successful reconcile kicks the sweep, and a sweep is a full-store
        LIST of five kinds — under a reconcile storm (or N active-active
        replicas each kicking their own manager) back-to-back sweeps
        contribute nothing but LIST load. Kicks inside the gap coalesce
        into the one sweep that runs when it expires; 0 keeps the
        immediate-sweep behavior.
        ``metrics``: optional ControllerMetrics for sweep counters."""
        self.client = client
        self.namespace = namespace
        self.interval = interval
        self.min_gap = min_gap
        self.metrics = metrics
        self._last_sweep = 0.0
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "CleanupManager":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="cd-cleanup", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def kick(self) -> None:
        """Request an immediate sweep (the EnqueueCleanup analogue,
        cleanup.go:84-94 — at most one extra sweep is ever queued)."""
        self._kick.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(timeout=self.interval)
            if self._stop.is_set():
                return
            # Debounce: wait out the remainder of min_gap first, THEN
            # clear the kick — every kick landing meanwhile is absorbed
            # by the sweep about to run, not queued behind it.
            gap = self.min_gap - (time.monotonic() - self._last_sweep)
            if gap > 0 and self._stop.wait(gap):
                return
            self._kick.clear()
            try:
                self.sweep_once()
            except Exception:  # noqa: BLE001 — sweep must never kill the loop
                logger.exception("orphan sweep failed; will retry")
            self._last_sweep = time.monotonic()

    # -- the sweep ----------------------------------------------------------

    def _live_cd_uids(self) -> set[str]:
        # Cluster-wide on purpose: see __init__ docstring.
        return {cd["metadata"]["uid"]
                for cd in self.client.list(KIND_COMPUTE_DOMAIN)}

    def _cd_exists(self, uid: str) -> bool:
        """Point re-check immediately before a delete: the live-uid snapshot
        is taken before the child listings, so a CD created in between would
        otherwise see its fresh children reaped as orphans (TOCTOU)."""
        return any(cd["metadata"]["uid"] == uid
                   for cd in self.client.list(KIND_COMPUTE_DOMAIN))

    def sweep_once(self) -> dict[str, int]:
        """One full sweep; returns per-category removal counts (for tests
        and observability)."""
        live = self._live_cd_uids()
        removed = {"children": 0, "cliques": 0, "labels": 0}

        for kind in _CHILD_KINDS:
            for obj in self.client.list(kind, self.namespace):
                uid = _owned_cd_uid(obj)
                if not uid or uid in live:
                    continue
                if self._cd_exists(uid):
                    continue  # CD created after the snapshot; not an orphan
                try:
                    self.client.delete(
                        kind, obj["metadata"]["name"],
                        obj["metadata"].get("namespace", ""))
                    removed["children"] += 1
                    logger.info("swept orphaned %s %s (CD %s gone)",
                                kind, obj["metadata"]["name"], uid)
                except NotFoundError:
                    pass

        # Cliques are named "<cdUID>.<cliqueID>" (cdclique.go:277) and also
        # carry owner refs; accept either signal.
        for clique in self.client.list(KIND_CLIQUE, self.namespace):
            uid = _owned_cd_uid(clique) or \
                clique["metadata"]["name"].partition(".")[0]
            if uid in live or self._cd_exists(uid):
                continue
            try:
                self.client.delete(
                    KIND_CLIQUE, clique["metadata"]["name"],
                    clique["metadata"].get("namespace", ""))
                removed["cliques"] += 1
            except NotFoundError:
                pass

        # Stale node labels (node.go:162-167): a label pointing at a dead CD
        # would keep attracting that CD's (equally dead) DaemonSet pods and
        # block the node from ever looking clean.
        for node in self.client.list("Node"):
            uid = (node["metadata"].get("labels") or {}).get(NODE_LABEL_CD)
            if not uid or uid in live:
                continue
            if self._cd_exists(uid):
                continue
            self.client.patch_labels(
                "Node", node["metadata"]["name"], {NODE_LABEL_CD: None})
            removed["labels"] += 1
            logger.info("swept stale CD label from node %s (CD %s gone)",
                        node["metadata"]["name"], uid)

        if self.metrics is not None:
            for category, n in removed.items():
                if n:
                    self.metrics.orphans_swept_total.inc(n, category=category)
        return removed
