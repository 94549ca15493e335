"""ComputeDomain + ComputeDomainClique CRD types.

Copied from the JAX package's ``api/computedomain.py`` under the port's API
group: the analogue of the reference's CRDs (``api/nvidia.com/resource/
v1beta1/computedomain.go:39-143``, ``computedomainclique.go:30-72``). A
ComputeDomain aggregates ``numNodes`` GPU nodes; the per-CD daemon
publishes its rendezvous record — {hostname, address, worker index, clique
id} — to a ComputeDomainClique object, and each workload container
receives the torch.distributed rendezvous of its node (``MASTER_ADDR``,
``MASTER_PORT``, ``NNODES``, ``NODE_RANK``) instead of IMEX channel device
nodes. A clique is an NVLink domain: one HGX H100 node, or the nodes of a
multi-node NVLink domain (``<clusterUUID>.<cliqueId>``, SURVEY.md §2.6).

Objects are dict-shaped (the fake-API convention); this module provides
constructors and typed accessors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from k8s_dra_driver_tpu_torch.k8sclient.client import Obj, new_object

API_VERSION = "resource.nvidia.com/v1beta1"
KIND_COMPUTE_DOMAIN = "ComputeDomain"
KIND_CLIQUE = "ComputeDomainClique"

# Status values (computedomain.go:106-117 analogue).
STATUS_READY = "Ready"
STATUS_NOT_READY = "NotReady"

# Finalizer + label keys (cmd/compute-domain-controller/computedomain.go:54-61).
FINALIZER = "resource.nvidia.com/computeDomain"
NODE_LABEL_CD = "resource.nvidia.com/computeDomain"
NODE_LABEL_CLIQUE = "resource.nvidia.com/clique"

ALLOCATION_MODE_SINGLE = "Single"
ALLOCATION_MODE_ALL = "All"


def new_compute_domain(
    name: str,
    namespace: str = "default",
    num_nodes: int = 1,
    channel_template_name: str = "",
    allocation_mode: str = ALLOCATION_MODE_SINGLE,
) -> Obj:
    """A ComputeDomain of ``num_nodes`` nodes whose workload claims come
    from the ResourceClaimTemplate ``channel_template_name`` (default
    ``<name>-channel``). The JAX package's ``topology`` (a TPU slice shape)
    has no GPU counterpart."""
    spec: dict[str, Any] = {
        "numNodes": num_nodes,
        "channel": {
            "resourceClaimTemplate": {
                "name": channel_template_name or f"{name}-channel"},
            "allocationMode": allocation_mode,
        },
    }
    return new_object(KIND_COMPUTE_DOMAIN, name, namespace,
                      api_version=API_VERSION, spec=spec)


def cd_num_nodes(cd: Obj) -> int:
    return int((cd.get("spec") or {}).get("numNodes", 1))


def cd_channel_template_name(cd: Obj) -> str:
    return ((cd.get("spec") or {}).get("channel") or {}).get(
        "resourceClaimTemplate", {}).get("name", "")


def cd_allocation_mode(cd: Obj) -> str:
    return ((cd.get("spec") or {}).get("channel") or {}).get(
        "allocationMode", ALLOCATION_MODE_SINGLE)


def cd_status(cd: Obj) -> str:
    return (cd.get("status") or {}).get("status", STATUS_NOT_READY)


@dataclass
class DaemonInfo:
    """One daemon's rendezvous record inside a clique
    (ComputeDomainDaemonInfo, computedomainclique.go:52-72). The record
    keeps every key of the JAX package's; ``coords`` stays empty for GPUs
    and ``topology`` holds the node's GPU count."""

    node_name: str
    hostname: str = ""
    ip_address: str = ""
    clique_id: str = ""          # NVLink domain: <clusterUUID>.<cliqueId>
    index: int = -1              # stable worker index within the clique
    status: str = STATUS_NOT_READY
    coords: str = ""
    topology: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "nodeName": self.node_name,
            "hostname": self.hostname,
            "ipAddress": self.ip_address,
            "cliqueID": self.clique_id,
            "index": self.index,
            "status": self.status,
            "coords": self.coords,
            "topology": self.topology,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "DaemonInfo":
        return DaemonInfo(
            node_name=d.get("nodeName", ""),
            hostname=d.get("hostname", ""),
            ip_address=d.get("ipAddress", ""),
            clique_id=d.get("cliqueID", ""),
            index=int(d.get("index", -1)),
            status=d.get("status", STATUS_NOT_READY),
            coords=d.get("coords", ""),
            topology=d.get("topology", ""),
        )


def clique_name(cd_uid: str, clique_id: str) -> str:
    """``<cdUID>.<cliqueID>`` (cdclique.go:277 naming)."""
    return f"{cd_uid}.{clique_id}"


def new_clique(cd_uid: str, clique_id: str, namespace: str = "default",
               owner_cd_name: str = "") -> Obj:
    obj = new_object(KIND_CLIQUE, clique_name(cd_uid, clique_id), namespace,
                     api_version=API_VERSION, daemons=[])
    if owner_cd_name:
        obj["metadata"]["ownerReferences"] = [{
            "apiVersion": API_VERSION, "kind": KIND_COMPUTE_DOMAIN,
            "name": owner_cd_name, "uid": cd_uid}]
    return obj


def clique_daemons(clique: Obj) -> list[DaemonInfo]:
    return [DaemonInfo.from_dict(d) for d in clique.get("daemons") or []]
