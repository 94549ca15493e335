"""CD-plugin checkpoint GC: stale PrepareStarted claims + expired
PrepareAborted tombstones.

Copied from the JAX package's ``plugins/compute_domain_kubelet_plugin/
cleanup.py``: the analogue of ``cmd/compute-domain-kubelet-plugin/
cleanup.go:61-149``, the shared stale-claim sweep (same contract as the GPU
plugin's manager) plus the CD-specific periodic deletion of expired
PrepareAborted entries.
"""

from __future__ import annotations

import logging

from k8s_dra_driver_tpu_torch.k8sclient.client import FakeClient
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.device_state import (
    CdDeviceState,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.cleanup import (
    DEFAULT_SWEEP_INTERVAL,
    CheckpointCleanupManager,
)

logger = logging.getLogger(__name__)


class CdCheckpointCleanupManager(CheckpointCleanupManager):
    """The GPU plugin's stale-claim sweep, extended with aborted-entry
    expiry. ``cleanup_once`` first drops expired tombstones (so they are
    not mistaken for live PrepareStarted claims), then runs the standard
    staleness validation against the API server."""

    def __init__(
        self,
        client: FakeClient,
        state: CdDeviceState,
        interval: float = DEFAULT_SWEEP_INTERVAL,
    ):
        super().__init__(client, state, interval)
        self.state: CdDeviceState = state

    def cleanup_once(self) -> list[str]:
        try:
            expired = self.state.delete_expired_aborted()
        except Exception as e:  # noqa: BLE001 — sweep must continue
            logger.warning("aborted-entry expiry failed: %s", e)
            expired = []
        stale = super().cleanup_once()
        return expired + stale
