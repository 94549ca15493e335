"""GPU device model.

The counterpart of the JAX package's ``tpulib/chip.py`` (itself the
analogue of the reference's ``cmd/gpu-kubelet-plugin/deviceinfo.go:36-118``
GpuInfo): one physical GPU with its identities — UUID, node-local index,
device minor, PCI address — the hardware envelope of its product, and its
health. Containers address a GPU through ``/dev/nvidia<minor>`` plus
``CUDA_VISIBLE_DEVICES``. MIG instances are not modelled yet.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

#: PCI vendor id of NVIDIA functions.
NVIDIA_PCI_VENDOR = 0x10DE


@dataclass(frozen=True)
class GpuSpec:
    """One GPU product's published envelope."""

    product_name: str        # as the driver reports it (NVML / /proc)
    architecture: str
    memory_bytes: int        # device memory as the driver reports its total
    sm_count: int
    compute_capability: tuple[int, int]
    nvlink_links: int        # fourth-generation NVLink links per GPU
    nvlink_gbps_per_link: float  # one direction, GB/s
    pci_device_ids: tuple[int, ...]

    @property
    def compute_capability_str(self) -> str:
        return ".".join(str(v) for v in self.compute_capability)


class GpuType(enum.Enum):
    """GPU products this library knows the envelope of."""

    H100_SXM_80GB = "h100-sxm-80gb"

    @property
    def spec(self) -> GpuSpec:
        return _GPU_SPECS[self]

    @staticmethod
    def parse(s: str) -> "GpuType":
        try:
            return GpuType(s.lower())
        except ValueError:
            raise ValueError(f"unknown GPU type {s!r}; want one of "
                             f"{[t.value for t in GpuType]}") from None

    @staticmethod
    def from_product_name(name: str) -> "GpuType":
        for t, spec in _GPU_SPECS.items():
            if name.strip() == spec.product_name:
                return t
        raise ValueError(
            f"no GPU spec for product {name!r}; known: "
            + ", ".join(repr(s.product_name) for s in _GPU_SPECS.values()))

    @staticmethod
    def from_pci_device(device_id: int) -> "GpuType":
        for t, spec in _GPU_SPECS.items():
            if device_id in spec.pci_device_ids:
                return t
        raise ValueError(
            f"no GPU spec for PCI device 0x{device_id:04x}; known: "
            + ", ".join(f"0x{d:04x} ({t.value})" for t, s in _GPU_SPECS.items()
                        for d in s.pci_device_ids))


# H100 SXM5 80GB, from NVIDIA's public H100 datasheet and whitepaper: 80 GB
# HBM3 (the driver reports a total of 81559 MiB), 132 SMs, compute
# capability 9.0, 18 NVLink links carrying 900 GB/s per GPU counted in
# both directions, so 25 GB/s per link in one. PCI device id 0x2330, the
# PCI ID database's entry for the H100 SXM5 80GB (10de:2330).
_GPU_SPECS: dict[GpuType, GpuSpec] = {
    GpuType.H100_SXM_80GB: GpuSpec(
        product_name="NVIDIA H100 80GB HBM3", architecture="Hopper",
        memory_bytes=81559 << 20, sm_count=132, compute_capability=(9, 0),
        nvlink_links=18, nvlink_gbps_per_link=25.0,
        pci_device_ids=(0x2330,)),
}


class HealthState(enum.Enum):
    HEALTHY = "Healthy"
    UNHEALTHY = "Unhealthy"
    UNKNOWN = "Unknown"


@dataclass
class GpuHealth:
    """Per-GPU health snapshot (the NVML XID/event state consumed by the
    reference's ``device_health.go:103-273``)."""

    state: HealthState = HealthState.HEALTHY
    reason: str = ""
    xid_errors: int = 0


@dataclass
class GpuInfo:
    """One physical GPU — the GpuInfo of ``deviceinfo.go:36-71``."""

    index: int                      # node-local index, in PCI bus order
    uuid: str                       # "GPU-<uuid>", as the driver reports it
    minor: int                      # /dev/nvidia<minor>
    gpu_type: GpuType
    pci_address: str = ""           # PCI BDF, e.g. "0000:18:00.0"
    numa_node: int = -1
    pci_device_id: int = 0
    product_name: str = ""
    memory_bytes: int = 0
    driver_version: str = ""
    device_paths: list[str] = field(default_factory=list)  # /dev/nvidia<minor>
    health: GpuHealth = field(default_factory=GpuHealth)
    # Which node of a multi-node mock cluster holds the GPU (published as
    # the ``hostIndex`` attribute); -1 where no cluster layout says.
    host_index: int = -1

    @property
    def spec(self) -> GpuSpec:
        return self.gpu_type.spec

    @property
    def canonical_name(self) -> str:
        """DRA device name of the full GPU: ``gpu-<index>``."""
        return f"gpu-{self.index}"


@dataclass(frozen=True)
class NodeGpuInfo:
    """Node-level facts: the GPUs' product and the NVLink domain they
    share (the TPU package's SliceTopologyInfo counterpart). ``clique_id``
    is ``<clusterUUID>.<cliqueId>`` of the NVSwitch fabric, or "" when the
    node reports none. ``clique_hosts`` nodes share the clique (1 on an HGX
    H100, where the fabric ends at the node) and this node is
    ``host_index`` among them."""

    node_uuid: str                  # stable identity of this node's GPU set
    num_gpus: int
    gpu_type: GpuType
    clique_id: str = ""
    backend: str = ""               # which enumeration produced the GPUs
    host_index: int = 0
    clique_hosts: int = 1

    @property
    def domain_clique_id(self) -> str:
        """The clique a ComputeDomain daemon on this node joins: the NVLink
        domain's ``clique_id``, or, on a node that reports none, the node
        itself (``<node_uuid>.0``). Ranks rendezvous over the network
        whatever the NVLink reach, so every node has a clique."""
        return self.clique_id or f"{self.node_uuid}.0"
