"""Node-scope cordon helpers shared by the kubelet plugins.

The two functions of the JAX package's ``pkg/nodelease.py`` that the GPU
plugin's driver calls: the cordon taint applied at resource generation,
and the work list of a node-scope drain. The node lease itself, fencing
and the voluntary-cordon surface wait for the remediation slice.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

#: NoSchedule taint key stamped on every published device of a cordoned
#: node.
TAINT_KEY_CORDON = "gpu.nvidia.com/cordon"
#: Cordon reason of a voluntary (operator-requested) cordon.
CORDON_REQUESTED = "requested"


def apply_cordon_taint(devices, reason: str) -> None:
    """Append the NoSchedule cordon taint to every published Device that
    lacks one — the generate-time half of a node-scope cordon."""
    from k8s_dra_driver_tpu_torch.kubeletplugin.types import DeviceTaint

    cordon = DeviceTaint(key=TAINT_KEY_CORDON, value=reason,
                         effect="NoSchedule")
    for d in devices:
        if all(t.key != TAINT_KEY_CORDON for t in d.taints or []):
            d.taints = list(d.taints or []) + [cordon]


def live_prepared_refs(state) -> list:
    """Every non-tombstoned prepared claim in a plugin's checkpoint as
    ClaimRefs — the node-scope drain's work list. An unreadable checkpoint
    returns an empty list (the request paths already fail loudly; the
    drain work list just retries next poll)."""
    from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
        STATE_PREPARE_ABORTED,
    )

    try:
        prepared = state.prepared_claims_nolock()
    except Exception:  # noqa: BLE001
        logger.warning("live_prepared_refs: checkpoint unreadable")
        return []
    return [ClaimRef(uid=uid, name=pc.name, namespace=pc.namespace)
            for uid, pc in sorted(prepared.items())
            if pc.state != STATE_PREPARE_ABORTED]
