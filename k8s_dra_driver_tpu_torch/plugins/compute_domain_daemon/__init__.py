"""Per-ComputeDomain node daemon (``cmd/compute-domain-daemon`` analogue)."""

from k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon.daemon import (
    ComputeDomainDaemon,
)

__all__ = ["ComputeDomainDaemon"]
