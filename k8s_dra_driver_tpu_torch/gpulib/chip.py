"""GPU device model.

The counterpart of the JAX package's ``tpulib/chip.py`` (itself the
analogue of the reference's ``cmd/gpu-kubelet-plugin/deviceinfo.go:36-118``
GpuInfo): one physical GPU with its identities — UUID, node-local index,
device minor, PCI address — the hardware envelope of its product, and its
health. Containers address a GPU through ``/dev/nvidia<minor>`` plus
``CUDA_VISIBLE_DEVICES``.

Two partial views of a GPU sit beside it, the counterparts of the JAX
package's ``SubsliceInfo`` and ``VfioChipInfo``: a MIG instance
(:class:`MigDeviceInfo`), one placement of a profile of the GPU's
:data:`MIG_PROFILES` table, and a GPU bound to ``vfio-pci`` for
passthrough (:class:`VfioGpuInfo`).
"""

from __future__ import annotations

import enum
import re
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


#: Memory slices of a MIG-capable GPU: a placement's start and size count
#: them, and the KEP-4815 counters draw one unit per slice.
MIG_MEMORY_SLICES = 8
#: Compute slices of a MIG-capable GPU.
MIG_COMPUTE_SLICES = 7


@dataclass(frozen=True)
class MigProfile:
    """One GPU-instance profile: its name, the placement starts the driver
    accepts, its size in memory slices and its compute slices. ``nvml_index``
    is the profile's ``NVML_GPU_INSTANCE_PROFILE_*`` constant (nvml.h), the
    argument of ``nvmlDeviceGetGpuInstanceProfileInfo``.
    ``media_extensions`` marks the ``+me`` profile, whose instance takes
    the GPU's media engines, so the GPU holds at most one of them."""

    name: str
    starts: tuple[int, ...]
    size: int
    compute_slices: int
    nvml_index: int
    media_extensions: bool = False

    def memory_bytes(self, gpu_memory_bytes: int) -> int:
        """Its share of the GPU's memory: ``size`` of the eight slices."""
        return gpu_memory_bytes * self.size // MIG_MEMORY_SLICES


# The H100 80GB's GPU-instance profiles and placements, from NVIDIA's
# Multi-Instance GPU User Guide ("Supported MIG Profiles", H100 80GB):
# placement starts and size in memory slices out of 8, compute slices out
# of 7. The NVML constants: 1_SLICE 0, 2_SLICE 1, 3_SLICE 2, 4_SLICE 3,
# 7_SLICE 4, 1_SLICE_REV1 7 (the 1g.10gb+me: media extensions, one
# instance per GPU), 1_SLICE_REV2 9 (the 1g.20gb).
MIG_PROFILES: dict[GpuType, tuple[MigProfile, ...]] = {
    GpuType.H100_SXM_80GB: (
        MigProfile("1g.10gb", starts=(0, 1, 2, 3, 4, 5, 6), size=1,
                   compute_slices=1, nvml_index=0),
        MigProfile("1g.10gb+me", starts=(0, 1, 2, 3, 4, 5, 6), size=1,
                   compute_slices=1, nvml_index=7, media_extensions=True),
        MigProfile("1g.20gb", starts=(0, 2, 4, 6), size=2, compute_slices=1,
                   nvml_index=9),
        MigProfile("2g.20gb", starts=(0, 2, 4), size=2, compute_slices=2,
                   nvml_index=1),
        MigProfile("3g.40gb", starts=(0, 4), size=4, compute_slices=3,
                   nvml_index=2),
        MigProfile("4g.40gb", starts=(0,), size=4, compute_slices=4,
                   nvml_index=3),
        MigProfile("7g.80gb", starts=(0,), size=8, compute_slices=7,
                   nvml_index=4),
    ),
}


def mig_profile(gpu_type: GpuType, name: str) -> MigProfile:
    """The profile ``name`` of ``gpu_type``; ValueError naming the known
    ones when there is none."""
    for p in MIG_PROFILES.get(gpu_type, ()):
        if p.name == name:
            return p
    raise ValueError(f"no MIG profile {name!r} for {gpu_type.value}; known: "
                     f"{[p.name for p in MIG_PROFILES.get(gpu_type, ())]}")


class HealthState(enum.Enum):
    HEALTHY = "Healthy"
    UNHEALTHY = "Unhealthy"
    UNKNOWN = "Unknown"


@dataclass
class GpuHealth:
    """Per-GPU health snapshot (the NVML XID/event state consumed by the
    reference's ``device_health.go:103-273``): critical XID errors and
    double-bit ECC errors seen since the GPU was last repaired."""

    state: HealthState = HealthState.HEALTHY
    reason: str = ""
    xid_errors: int = 0
    ecc_errors: int = 0


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
    # MIG mode is on (NVML's current mode; the procfs backend cannot read
    # it and reports off): only then are MIG devices published for it.
    mig_enabled: bool = False

    @property
    def spec(self) -> GpuSpec:
        return self.gpu_type.spec

    @property
    def canonical_name(self) -> str:
        """DRA device name of the full GPU: ``gpu-<index>``."""
        return f"gpu-{self.index}"


def mig_profile_label(profile: str) -> str:
    """The profile as a device name spells it: a DNS label allows only
    ``[a-z0-9-]``, so ``3g.40gb`` → ``3g40gb``, ``1g.10gb+me`` →
    ``1g10gbme``."""
    return re.sub(r"[^a-z0-9]", "", profile.lower())


#: The spelling in a device name → the profile's published name, over
#: every product's table.
MIG_PROFILE_BY_LABEL: dict[str, str] = {
    mig_profile_label(p.name): p.name
    for ps in MIG_PROFILES.values() for p in ps}


def mig_device_name(gpu_index: int, profile: str, start: int,
                    size: int) -> str:
    """DRA device name of a MIG placement, a DNS label:
    ``gpu-<index>-mig-<profile label>-<start>-<size>`` (the reference's
    canonical MIG name, ``mig.go:111-116``), e.g. ``gpu-0-mig-3g40gb-0-4``."""
    return f"gpu-{gpu_index}-mig-{mig_profile_label(profile)}-{start}-{size}"


@dataclass
class MigDeviceInfo:
    """One MIG instance — the MigDeviceInfo of ``deviceinfo.go:75-99``, the
    JAX package's ``SubsliceInfo`` counterpart: a GPU instance of
    ``profile`` at memory slices ``[start, start + size)`` of its parent,
    with one compute instance over all of it. ``caps_minors`` are the
    minors of the instance's two ``/dev/nvidia-caps/nvidia-cap<K>`` nodes
    (the GPU instance's and the compute instance's access)."""

    parent_index: int
    parent_uuid: str
    parent_minor: int
    profile: str
    start: int
    size: int
    gi_id: int = -1
    ci_id: int = -1
    uuid: str = ""                  # "MIG-<uuid>"
    caps_minors: tuple[int, ...] = ()

    @property
    def caps_paths(self) -> list[str]:
        return [f"/dev/nvidia-caps/nvidia-cap{m}" for m in self.caps_minors]

    def to_dict(self) -> dict:
        """The checkpoint's record of the instance."""
        return {"profile": self.profile, "parentUUID": self.parent_uuid,
                "placementStart": self.start, "placementSize": self.size,
                "giID": self.gi_id, "ciID": self.ci_id, "uuid": self.uuid,
                "capsMinors": list(self.caps_minors)}


@dataclass
class VfioGpuInfo:
    """A GPU bound to vfio-pci for VM passthrough — the VfioDeviceInfo of
    ``deviceinfo.go:101-118``. Such a GPU has left the NVIDIA driver, so
    its PCI address is its identity; ``index`` is its position in the vfio
    scan and names the device only."""

    index: int
    pci_address: str
    gpu_type: GpuType
    pci_device_id: int = 0
    numa_node: int = -1
    iommu_group: int = -1

    @property
    def canonical_name(self) -> str:
        return f"vfio-gpu-{self.index}"


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
