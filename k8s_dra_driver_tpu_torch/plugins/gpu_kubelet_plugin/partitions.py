"""Published DRA devices of the GPU kubelet plugin.

The counterpart of the JAX package's ``plugins/tpu_kubelet_plugin/
partitions.py`` (``full_chip_device``, ``_chip_attrs``), cut to whole GPUs:
one device per GPU, named ``gpu-<index>``, with the attributes a selector
matches on (the reference's ``deviceinfo.go:170-294``) and its memory as
capacity. MIG devices and the KEP-4815 counters they draw wait.
"""

from __future__ import annotations

from k8s_dra_driver_tpu_torch.gpulib.chip import GpuInfo
from k8s_dra_driver_tpu_torch.gpulib.device_lib import semver_driver_version
from k8s_dra_driver_tpu_torch.kubeletplugin.types import Device, VersionStr

# Device "type" attribute value (deviceinfo.go:36 GpuDeviceType).
DEVICE_TYPE_GPU = "gpu"


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


def full_gpu_device(gpu: GpuInfo, list_type_attrs: bool = False) -> Device:
    """A whole GPU as a DRA device. ``list_type_attrs`` = the
    DRAListTypeAttributes gate."""
    return Device(
        name=gpu.canonical_name,
        attributes=_gpu_attrs(gpu, list_type_attrs),
        capacity={"memory": gpu.memory_bytes or gpu.spec.memory_bytes},
    )
