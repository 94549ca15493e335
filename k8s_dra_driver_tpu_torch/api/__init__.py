"""Driver API group ``resource.nvidia.com/v1beta1``: the opaque device
configs a GPU claim may carry, with strict decoding."""

from k8s_dra_driver_tpu_torch.api.configs import (
    ConfigError,
    GpuConfig,
    decode_opaque_config,
    strict_decode,
)

__all__ = ["ConfigError", "GpuConfig", "decode_opaque_config",
           "strict_decode"]
