"""Published DRA devices of the GPU kubelet plugin: GPUs, MIG placements
over KEP-4815 shared counters, and vfio-bound GPUs.

The counterpart of the JAX package's ``plugins/tpu_kubelet_plugin/
partitions.py`` (the reference's ``cmd/gpu-kubelet-plugin/partitions.go:
70-232``, SharedCounters per GPU: the memory slices each MIG profile
consumes). The node's counter set has one unit counter per (GPU, memory
slice). A whole GPU draws all eight counters of its GPU, and every placement
of the MIG profile table (``gpulib.chip.MIG_PROFILES``) is a device drawing
the counters of the slices it covers. Whole GPUs and MIG devices draw from
the same counters, so the scheduler can never hand out overlapping
placements, nor a placement on an exclusively claimed GPU: overlap is
impossible by construction. The ``1g.10gb+me`` placements also draw their
GPU's one media counter: the GPU's media engines go to one such instance
(NVIDIA's MIG User Guide), so the scheduler hands out at most one a GPU.

MIG devices also carry the geometry the allocator's topology-aware
placement reads (``shape`` ``1x<size>`` and ``origin`` ``<gpu>-<start>``):
the node is a 2-D mesh of GPUs by memory slices, each placement an aligned
box in it. The compute slices a profile takes are not a counter: the
table's memory placements alone keep any set of disjoint placements within
a GPU's seven compute slices (``tests/test_torch_mig.py`` proves it).
"""

from __future__ import annotations

from k8s_dra_driver_tpu_torch.gpulib.chip import (
    MIG_MEMORY_SLICES,
    MIG_PROFILES,
    GpuInfo,
    VfioGpuInfo,
    mig_device_name,
)
from k8s_dra_driver_tpu_torch.gpulib.device_lib import semver_driver_version
from k8s_dra_driver_tpu_torch.kubeletplugin.types import (
    CounterConsumption,
    CounterSet,
    Device,
    VersionStr,
)

# Device "type" attribute values (deviceinfo.go:36 GpuDeviceType).
DEVICE_TYPE_GPU = "gpu"
DEVICE_TYPE_MIG = "mig"
DEVICE_TYPE_VFIO = "vfio-gpu"

# DeviceClass names (the reference's deployments/helm deviceclass-*.yaml;
# the JAX package's DEVICE_CLASS_TPU / DEVICE_CLASS_SUBSLICE) and the
# selector each class carries.
DEVICE_CLASS_GPU = "gpu.nvidia.com"
DEVICE_CLASS_MIG = "mig.nvidia.com"
DEVICE_CLASS_VFIO = "vfio.gpu.nvidia.com"
DEVICE_CLASS_SELECTORS = {
    DEVICE_CLASS_GPU: f"device.attributes['type'] == '{DEVICE_TYPE_GPU}'",
    DEVICE_CLASS_MIG: f"device.attributes['type'] == '{DEVICE_TYPE_MIG}'",
    DEVICE_CLASS_VFIO: f"device.attributes['type'] == '{DEVICE_TYPE_VFIO}'",
}

COUNTER_SET_NAME = "gpu-memory-slices"


def slice_counter_name(gpu_index: int, memory_slice: int) -> str:
    return f"gpu{gpu_index}-mem{memory_slice}"


def media_counter_name(gpu_index: int) -> str:
    return f"gpu{gpu_index}-media"


def _has_media_profile(gpu: GpuInfo) -> bool:
    return any(p.media_extensions for p in MIG_PROFILES.get(gpu.gpu_type, ()))


def memory_slice_counter_set(gpus: list[GpuInfo]) -> CounterSet:
    """One unit counter per (GPU, memory slice) of the node, and one per
    GPU whose MIG table has a media-extensions profile, for its media
    engines."""
    counters = {slice_counter_name(g.index, s): 1 for g in gpus
                for s in range(MIG_MEMORY_SLICES)}
    counters.update({media_counter_name(g.index): 1 for g in gpus
                     if _has_media_profile(g)})
    return CounterSet(name=COUNTER_SET_NAME, counters=counters)


def _draw(gpu_index: int, start: int, size: int,
          media: bool = False) -> list[CounterConsumption]:
    counters = {slice_counter_name(gpu_index, s): 1
                for s in range(start, start + size)}
    if media:
        counters[media_counter_name(gpu_index)] = 1
    return [CounterConsumption(COUNTER_SET_NAME, counters)]


def _gpu_attrs(gpu: GpuInfo, list_type_attrs: bool = False) -> dict:
    spec = gpu.spec
    cc = spec.compute_capability
    attrs = {
        "type": DEVICE_TYPE_GPU,
        "uuid": gpu.uuid,
        "productName": gpu.product_name or spec.product_name,
        "index": gpu.index,
        "minor": gpu.minor,
        # Version-typed, so CEL compares them with semver():
        # device.attributes['cudaComputeCapability'].compareTo(
        # semver("9.0.0")) >= 0.
        "cudaComputeCapability": VersionStr(f"{cc[0]}.{cc[1]}.0"),
    }
    version = semver_driver_version(gpu.driver_version)
    if version:
        attrs["driverVersion"] = VersionStr(version)
    if gpu.pci_address:
        attrs["pciAddress"] = gpu.pci_address
    if gpu.host_index >= 0:
        attrs["hostIndex"] = gpu.host_index
    if gpu.numa_node >= 0:
        # KEP-6072: the list form expresses "all NUMA nodes this device is
        # local to"; a single-element list is the valid encoding.
        attrs["numaNode"] = ([gpu.numa_node] if list_type_attrs
                             else gpu.numa_node)
    return attrs


def _gpu_memory(gpu: GpuInfo) -> int:
    return gpu.memory_bytes or gpu.spec.memory_bytes


def full_gpu_device(gpu: GpuInfo, with_counters: bool = False,
                    list_type_attrs: bool = False) -> Device:
    """A whole GPU as a DRA device. With counters (partitionable mode) it
    draws all eight memory-slice counters of its GPU, so no MIG placement
    can overlap it, and carries the geometry of its row of the mesh.
    ``list_type_attrs`` = the DRAListTypeAttributes gate."""
    attrs = _gpu_attrs(gpu, list_type_attrs)
    if with_counters:
        attrs.update(_geometry(gpu.index, 0, MIG_MEMORY_SLICES))
    return Device(
        name=gpu.canonical_name,
        attributes=attrs,
        capacity={"memory": _gpu_memory(gpu)},
        consumes_counters=(_draw(gpu.index, 0, MIG_MEMORY_SLICES)
                           if with_counters else []),
    )


def _geometry(gpu_index: int, start: int, size: int) -> dict:
    """The box of memory slices in the node's GPU × slice mesh that the
    allocator's geometry index reads."""
    return {"shape": f"1x{size}", "origin": f"{gpu_index}-{start}"}


def mig_devices(gpus: list[GpuInfo]) -> list[Device]:
    """Every placement of every profile of the MIG table on each GPU whose
    MIG mode is on, in table order (26 devices an H100 with its whole GPU:
    7 + 7 + 4 + 3 + 2 + 1 + 1 placements). A media-extensions placement
    carries ``mediaExtensions`` and draws its GPU's media counter."""
    out: list[Device] = []
    for g in gpus:
        if not g.mig_enabled:
            continue
        for p in MIG_PROFILES.get(g.gpu_type, ()):
            for start in p.starts:
                out.append(Device(
                    name=mig_device_name(g.index, p.name, start, p.size),
                    attributes={
                        "type": DEVICE_TYPE_MIG,
                        "profile": p.name,
                        "parentUUID": g.uuid,
                        "parentIndex": g.index,
                        "placementStart": start,
                        "placementSize": p.size,
                        "productName": g.product_name
                        or g.spec.product_name,
                        **({"mediaExtensions": True}
                           if p.media_extensions else {}),
                        **_geometry(g.index, start, p.size),
                    },
                    capacity={"memory": p.memory_bytes(_gpu_memory(g))},
                    consumes_counters=_draw(g.index, start, p.size,
                                            p.media_extensions),
                ))
    return out


def vfio_gpu_device(v: VfioGpuInfo) -> Device:
    """A GPU already bound to vfio-pci, published as a passthrough device
    (the companion-VFIO-device pattern, nvlib.go:660-694): it has left the
    NVIDIA driver, so it is outside the counters and no MIG placement can
    overlap it."""
    attrs = {
        "type": DEVICE_TYPE_VFIO,
        "productName": v.gpu_type.spec.product_name,
        "pciAddress": v.pci_address,
    }
    if v.iommu_group >= 0:
        attrs["iommuGroup"] = v.iommu_group
    if v.numa_node >= 0:
        attrs["numaNode"] = v.numa_node
    return Device(name=v.canonical_name, attributes=attrs,
                  capacity={"memory": v.gpu_type.spec.memory_bytes})
