"""Stale-claim GC: self-initiated unprepare of orphaned checkpoint entries.

Copied from the JAX package's ``plugins/tpu_kubelet_plugin/cleanup.py``:
the sweep the ComputeDomain plugin's GC extends (the GPU plugin's own
wiring waits with its ``main.py``). The analogue of the reference's
``CheckpointCleanupManager`` (``cmd/gpu-kubelet-plugin/cleanup.go:
40-282``): periodically (default
10 min) find checkpointed claims parked in PrepareStarted and validate them
against the API server by name+namespace (a cheap Get; never an
all-namespace UID list). A claim is stale when the object is gone or its
UID changed (same name re-created). Stale claims get a self-initiated
unprepare through the normal path, which removes them from the checkpoint
and deletes their CDI spec.

No lock is held during discovery: the authoritative staleness source is the
API server, and the actual unprepare takes the flock itself. Missing a
racing claim just defers it to the next sweep.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from k8s_dra_driver_tpu_torch.k8sclient.client import FakeClient
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_STARTED,
)

logger = logging.getLogger(__name__)

DEFAULT_SWEEP_INTERVAL = 600.0  # 10 min (cleanup.go:34)


class CheckpointCleanupManager:
    def __init__(
        self,
        client: FakeClient,
        state,                  # DeviceState or CdDeviceState
        interval: float = DEFAULT_SWEEP_INTERVAL,
    ):
        self.client = client
        self.state = state
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one sweep (exposed for deterministic tests) -------------------------

    def cleanup_once(self) -> list[str]:
        """Returns the claim UIDs unprepared as stale."""
        # Expired PrepareAborted tombstones (drained claims whose stale-
        # retry window has passed, docs/self-healing.md) ride the same
        # periodic sweep — the deleteExpiredPrepareAbortedClaims analogue.
        if hasattr(self.state, "delete_expired_aborted"):
            try:
                self.state.delete_expired_aborted()
            except Exception as e:  # noqa: BLE001 — retry next sweep
                logger.warning("stale-claim sweep: aborted-tombstone GC "
                               "failed (will retry): %s", e)
        try:
            prepared = self.state.prepared_claims()
        except Exception as e:  # noqa: BLE001
            logger.warning("stale-claim sweep: cannot read checkpoint: %s", e)
            return []
        started = {uid: pc for uid, pc in prepared.items()
                   if pc.state == STATE_PREPARE_STARTED}
        logger.debug("stale-claim sweep: %d/%d claims in PrepareStarted",
                     len(started), len(prepared))
        removed: list[str] = []
        for uid, pc in started.items():
            if self._is_stale(uid, pc):
                logger.info("stale-claim sweep: unpreparing stale claim "
                            "%s/%s (%s)", pc.namespace, pc.name, uid)
                try:
                    self.state.unprepare(ClaimRef(
                        uid=uid, name=pc.name, namespace=pc.namespace))
                    removed.append(uid)
                except Exception as e:  # noqa: BLE001 — retry next sweep
                    logger.warning("stale-claim sweep: unprepare of %s "
                                   "failed (will retry): %s", uid, e)
        return removed

    def _is_stale(self, uid: str, pc) -> bool:
        if not pc.name:
            # Legacy checkpoint entry without name/namespace: cannot be
            # validated cheaply — skip (cleanup.go:150-157).
            logger.debug("stale-claim sweep: skip %s (no name recorded)", uid)
            return False
        try:
            obj = self.client.try_get("ResourceClaim", pc.name, pc.namespace)
        except Exception as e:  # noqa: BLE001 — transient API error
            # Not authoritative evidence of staleness; retry next sweep.
            logger.warning("stale-claim sweep: lookup of %s/%s failed "
                           "(retry next sweep): %s", pc.namespace, pc.name, e)
            return False
        if obj is None:
            return True
        if obj["metadata"].get("uid") != uid:
            # Same name, different UID: the original was deleted and
            # re-created — the checkpointed claim is stale.
            return True
        return False

    # -- loop ----------------------------------------------------------------

    def start(self) -> "CheckpointCleanupManager":
        self._thread = threading.Thread(
            target=self._run, name="checkpoint-cleanup", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.cleanup_once()
            except Exception:  # noqa: BLE001 — the sweeper must never die
                logger.exception("stale-claim sweep crashed; continuing")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
