"""ComputeDomain cluster controller (``cmd/compute-domain-controller``)."""

from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.controller import (
    ComputeDomainController,
)

__all__ = ["ComputeDomainController"]
