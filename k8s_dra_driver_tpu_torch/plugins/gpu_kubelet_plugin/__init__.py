"""GPU DRA kubelet plugin — driver name ``gpu.nvidia.com``.

The counterpart of the JAX package's ``tpu_kubelet_plugin`` (the
reference's ``cmd/gpu-kubelet-plugin``): one per node, it enumerates the
GPUs, publishes them in a ResourceSlice (whole, and under ``DynamicMIG``
every MIG placement over shared counters; under ``PassthroughSupport`` the
vfio-bound ones), and implements the crash-consistent Prepare/Unprepare
state machine over a checksummed checkpoint, with CDI injection of
``/dev/nvidia<minor>`` (and a MIG instance's ``nvidia-caps`` nodes, or a
passthrough GPU's ``/dev/vfio`` node) and ``CUDA_VISIBLE_DEVICES``. Its health monitor (``health``) taints a faulted
GPU on the published slice, its drain surface serves the drain controller,
and ``healthcheck.driver_probe`` is its health probe.
"""

from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.driver import (
    DriverConfig,
    GpuDriver,
)

__all__ = ["GpuDriver", "DriverConfig"]
