"""Allocatable device model for the ComputeDomain kubelet plugin.

Copied from the JAX package's ``plugins/compute_domain_kubelet_plugin/
devices.py``: the analogue of the reference's CD device model
(``cmd/compute-domain-kubelet-plugin/nvlib.go:168``
enumerateComputeDomainChannels, ``allocatable.go:23-58``, ``driver.go:
46-58`` computeDomainPublishedDevices). Every node synthesizes N
**channel** devices plus one **daemon** device. Only channel 0 is
advertised in the node ResourceSlice (higher channels exist for
AllocationMode=All injection, not for scheduling), and the daemon device is
omitted when rendezvous is host-managed (daemon claims are invalid there).

GPU mapping: the reference's IMEX channel is a cross-node memory-export
slot backed by ``/dev/nvidia-caps-imex-channels/channelN``; here a channel
is a rendezvous slot with no device node of its own. What a workload
container needs from its channel is its node's torch.distributed
rendezvous (``MASTER_ADDR``, ``MASTER_PORT``, ``NNODES``, ``NODE_RANK``),
injected at prepare time from clique membership.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from k8s_dra_driver_tpu_torch.gpulib.chip import NodeGpuInfo
from k8s_dra_driver_tpu_torch.kubeletplugin.types import Device

CD_DRIVER_NAME = "compute-domain.nvidia.com"

CHANNEL_TYPE = "channel"
DAEMON_TYPE = "daemon"

DAEMON_DEVICE_NAME = "daemon"

# Synthetic rendezvous-slot count per node. The reference reads its channel
# count from the nvidia-caps-imex-channels major in /proc/devices
# (nvlib.go:366); these channels are bookkeeping only, so the count is a
# driver constant (large enough that AllocationMode=All is meaningful).
DEFAULT_CHANNEL_COUNT = 64


def channel_device_name(channel_id: int) -> str:
    return f"channel-{channel_id}"


@dataclass(frozen=True)
class AllocatableDevice:
    """One allocatable CD device: a channel slot or the daemon singleton."""

    name: str
    type: str                    # CHANNEL_TYPE | DAEMON_TYPE
    channel_id: int = -1         # valid for channels

    def to_device(self, info: Optional[NodeGpuInfo]) -> Device:
        attrs = {"type": self.type}
        if self.type == CHANNEL_TYPE:
            attrs["channelID"] = self.channel_id
        if info is not None:
            # Clique identity attributes let CEL selectors (and debuggers)
            # tell the NVLink domains and nodes apart; ``gpuCount`` stands
            # where the TPU device carries its slice topology.
            attrs["cliqueID"] = info.domain_clique_id
            attrs["gpuCount"] = info.num_gpus
            attrs["hostIndex"] = info.host_index
        return Device(name=self.name, attributes=attrs)


def enumerate_devices(
    channel_count: int = DEFAULT_CHANNEL_COUNT,
) -> dict[str, AllocatableDevice]:
    """All allocatable devices on this node, keyed by name."""
    out: dict[str, AllocatableDevice] = {}
    for i in range(channel_count):
        d = AllocatableDevice(
            name=channel_device_name(i), type=CHANNEL_TYPE, channel_id=i)
        out[d.name] = d
    out[DAEMON_DEVICE_NAME] = AllocatableDevice(
        name=DAEMON_DEVICE_NAME, type=DAEMON_TYPE)
    return out


def published_devices(
    allocatable: dict[str, AllocatableDevice],
    info: Optional[NodeGpuInfo],
    host_managed: bool,
) -> list[Device]:
    """The subset advertised in the node ResourceSlice
    (computeDomainPublishedDevices, driver.go:46-58): channel 0 only, and
    no daemon device under host-managed rendezvous."""
    out: list[Device] = []
    for d in allocatable.values():
        if d.type == CHANNEL_TYPE and d.channel_id != 0:
            continue
        if host_managed and d.type == DAEMON_TYPE:
            continue
        out.append(d.to_device(info))
    return out
