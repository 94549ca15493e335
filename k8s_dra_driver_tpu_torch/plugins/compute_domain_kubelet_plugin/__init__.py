"""ComputeDomain DRA kubelet plugin (the node half of multi-node jobs) —
driver name ``compute-domain.nvidia.com``.

The counterpart of the JAX package's ``compute_domain_kubelet_plugin`` (the
reference's ``cmd/compute-domain-kubelet-plugin``): channel devices are
rendezvous slots that inject the node's torch.distributed rendezvous env
(``MASTER_ADDR``, ``MASTER_PORT``, ``NNODES``, ``NODE_RANK``) instead of
IMEX device nodes; the daemon device bootstraps the per-CD rendezvous
daemon with a per-domain directory.

The rule the plugin keeps, as the GPU plugin does: a claim's status entry of
this driver with ``Ready: True`` on device D implies that the node's
checkpoint holds the claim as ``PrepareCompleted`` with D. The claim watcher
publishes and restores Ready through ``CdDeviceState.while_prepared`` (the
checkpoint check and the write under the claim's flight lock), and
``CdDriver.drain_claim`` retracts Ready (reason ``Drained``) under that lock
before it undoes the channel or daemon devices and commits the tombstone.
"""

from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.cleanup import (
    CdCheckpointCleanupManager,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.computedomain import (
    MASTER_PORT,
    ComputeDomainManager,
    DaemonSettings,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.device_state import (
    PREPARE_ABORTED_TTL,
    CdDeviceState,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.devices import (
    CD_DRIVER_NAME,
    CHANNEL_TYPE,
    DAEMON_DEVICE_NAME,
    DAEMON_TYPE,
    DEFAULT_CHANNEL_COUNT,
    AllocatableDevice,
    channel_device_name,
    enumerate_devices,
    published_devices,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.driver import (
    CdDriver,
    CdDriverConfig,
)

__all__ = [
    "CD_DRIVER_NAME",
    "CHANNEL_TYPE",
    "DAEMON_DEVICE_NAME",
    "DAEMON_TYPE",
    "DEFAULT_CHANNEL_COUNT",
    "MASTER_PORT",
    "PREPARE_ABORTED_TTL",
    "AllocatableDevice",
    "CdCheckpointCleanupManager",
    "CdDeviceState",
    "CdDriver",
    "CdDriverConfig",
    "ComputeDomainManager",
    "DaemonSettings",
    "channel_device_name",
    "enumerate_devices",
    "published_devices",
]
