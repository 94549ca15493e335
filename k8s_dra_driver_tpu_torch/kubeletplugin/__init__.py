"""DRA kubelet-plugin helper layer.

The analogue of the upstream ``k8s.io/dynamic-resource-allocation/
kubeletplugin`` + ``resourceslice`` helpers the reference builds on
(``cmd/gpu-kubelet-plugin/driver.go:131-149,462-501``): a typed DRA device
model, ResourceSlice publication with pool-generation bookkeeping, the
plugin-side Prepare/Unprepare dispatch interface, and (because this repo
carries its own test substrate instead of a real scheduler) a structured
allocator that binds ResourceClaims against published slices, including
KEP-4815 shared-counter accounting.
"""

from k8s_dra_driver_tpu_torch.kubeletplugin.types import (
    ClaimRef,
    CounterConsumption,
    CounterSet,
    Device,
    DeviceTaint,
    DriverResources,
    Pool,
    PreparedDeviceRef,
    PrepareResult,
    Slice,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.helper import Helper
from k8s_dra_driver_tpu_torch.kubeletplugin.allocator import AllocationError, Allocator

__all__ = [
    "ClaimRef", "CounterConsumption", "CounterSet", "Device", "DeviceTaint",
    "DriverResources", "Pool", "PreparedDeviceRef", "PrepareResult", "Slice",
    "Helper", "Allocator", "AllocationError",
]
