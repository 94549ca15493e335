"""In-memory fake Kubernetes API: the substrate the GPU kubelet plugin,
its claim watcher and the allocator run against.

Copied from the JAX package's ``k8sclient``: objects are plain dicts in the
standard k8s shape, stored with uid + resourceVersion bookkeeping,
optimistic concurrency, finalizer-aware deletion, label-selector lists,
watch/informer support, and the per-node partition gate; and its HTTP
transport (``httpapi``: the REST API server, its client and the wire codec),
so that the binaries of separate processes share one cluster state.
"""

from k8s_dra_driver_tpu_torch.k8sclient.client import (
    AlreadyExistsError,
    ConflictError,
    ExpiredError,
    FakeClient,
    NotFoundError,
    PartitionedClient,
    PartitionError,
    PartitionGate,
    Watch,
)
from k8s_dra_driver_tpu_torch.k8sclient.informer import Informer

__all__ = [
    "AlreadyExistsError", "ConflictError", "ExpiredError", "FakeClient",
    "NotFoundError", "PartitionedClient", "PartitionError", "PartitionGate",
    "Watch", "Informer",
]
