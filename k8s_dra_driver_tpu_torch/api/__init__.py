"""Driver API group ``resource.nvidia.com/v1beta1``: the opaque device
configs a GPU or ComputeDomain claim may carry, with strict decoding, and
the ComputeDomain and ComputeDomainClique types (``api.computedomain``)."""

from k8s_dra_driver_tpu_torch.api.configs import (
    ComputeDomainChannelConfig,
    ComputeDomainDaemonConfig,
    ConfigError,
    GpuConfig,
    decode_opaque_config,
    strict_decode,
)

__all__ = ["ComputeDomainChannelConfig", "ComputeDomainDaemonConfig",
           "ConfigError", "GpuConfig", "decode_opaque_config",
           "strict_decode"]
