"""GPU device library: the GPU device model and its enumeration (the JAX
package's ``tpulib`` counterpart), plus the mesh geometry the allocator's
topology-aware placement uses (``topology``)."""

from k8s_dra_driver_tpu_torch.gpulib.chip import (
    GpuHealth,
    GpuInfo,
    GpuSpec,
    GpuType,
    HealthState,
    NodeGpuInfo,
)
from k8s_dra_driver_tpu_torch.gpulib.device_lib import (
    DeviceLib,
    EnumerationError,
    MockDeviceLib,
    SysfsDeviceLib,
    new_device_lib,
)

__all__ = ["GpuHealth", "GpuInfo", "GpuSpec", "GpuType", "HealthState",
           "NodeGpuInfo", "DeviceLib", "EnumerationError", "MockDeviceLib",
           "SysfsDeviceLib", "new_device_lib"]
