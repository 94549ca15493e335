"""Node-side ComputeDomain manager: labels, readiness gating, worker env.

Copied from the JAX package's ``plugins/compute_domain_kubelet_plugin/
computedomain.py``: the analogue of the reference's node-side CD manager
(``cmd/compute-domain-kubelet-plugin/computedomain.go``): ``AddNodeLabel``
:372 (the label that *attracts* the per-CD DaemonSet to this node),
``AssertComputeDomainReady`` :298 (gates channel prepare until this node's
daemon reports Ready — via the clique object when the ComputeDomainCliques
gate is on, via ``Status.Nodes`` otherwise), ``AssertComputeDomainNamespace``
:356, ``SetGPUCliqueLabel`` :429, and the per-CD settings directory
(``ComputeDomainDaemonSettings.Prepare`` :258).

The heart of the domain: ``worker_env`` computes the node's
torch.distributed rendezvous from clique membership — torchrun's per-node
names, where the JAX package sets ``TPU_WORKER_ID``,
``TPU_WORKER_HOSTNAMES`` and ``TPU_TOPOLOGY``:

- ``MASTER_ADDR``: the address of the daemon whose worker rank is 0;
- ``MASTER_PORT``: the rendezvous port, :data:`MASTER_PORT` unless the
  plugin is configured otherwise;
- ``NNODES``: the number of nodes in the domain;
- ``NODE_RANK``: this node's rank in the global ``(clique_id, index)``
  order.

A process on the node with local rank ``r`` of ``n`` is then global rank
``NODE_RANK * n + r`` of ``NNODES * n``.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path
from typing import Optional

from k8s_dra_driver_tpu_torch.api.computedomain import (
    KIND_CLIQUE,
    KIND_COMPUTE_DOMAIN,
    NODE_LABEL_CD,
    NODE_LABEL_CLIQUE,
    STATUS_READY,
    DaemonInfo,
    clique_daemons,
    clique_name,
)
from k8s_dra_driver_tpu_torch.gpulib.chip import NodeGpuInfo
from k8s_dra_driver_tpu_torch.k8sclient.client import (
    FakeClient,
    NotFoundError,
    Obj,
)
from k8s_dra_driver_tpu_torch.pkg import durability
from k8s_dra_driver_tpu_torch.pkg.errors import PermanentError
from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    COMPUTE_DOMAIN_CLIQUES,
    FeatureGates,
    new_feature_gates,
)

logger = logging.getLogger(__name__)

#: torchrun's default rendezvous port, handed to every worker of a domain.
MASTER_PORT = 29500

# Operator-provided rendezvous file for host-managed mode (the analogue of
# the host nvidia-imex daemon's socket, nvlib.go:401 checkHostIMEXReady):
# {"hostnames": ["h0", "h1", ...], "workerIds": {"h1": 1, ...}}; the first
# hostname is the rank-0 node's address.
HOST_RENDEZVOUS_FILENAME = "host-rendezvous.json"


def rendezvous_env(master_addr: str, master_port: int, nnodes: int,
                   node_rank: int) -> dict[str, str]:
    """The four variables a channel claim sets in its container."""
    return {"MASTER_ADDR": master_addr, "MASTER_PORT": str(master_port),
            "NNODES": str(nnodes), "NODE_RANK": str(node_rank)}


class ComputeDomainManager:
    def __init__(
        self,
        client: FakeClient,
        node_name: str,
        node_info: NodeGpuInfo,
        namespace: Optional[str] = None,
        gates: Optional[FeatureGates] = None,
        domains_root: str = "",
        driver_namespace: Optional[str] = None,
        master_port: int = MASTER_PORT,
    ):
        """``driver_namespace``: where the controller parks cliques in the
        multi-namespace layout — lets lookups stay namespaced O(1) gets
        instead of cluster-wide LIST fallbacks."""
        self.client = client
        self.node_name = node_name
        self.node_info = node_info
        self.namespace = namespace
        self.driver_namespace = driver_namespace
        self.gates = gates or new_feature_gates()
        self.master_port = master_port
        # Per-CD working dirs (the /var/lib/kubelet/plugins/<driver>/domains
        # analogue, computedomain.go:228-246); mounted into daemon pods.
        self.domains_root = Path(domains_root) if domains_root else None

    @property
    def clique_id(self) -> str:
        return self.node_info.domain_clique_id

    # -- CD lookup ------------------------------------------------------------

    def get_compute_domain(self, cd_uid: str) -> Optional[Obj]:
        """Find the CD by UID (the informer-by-UID mutation cache analogue —
        the fake client has no UID index, so scan)."""
        for cd in self.client.list(KIND_COMPUTE_DOMAIN, self.namespace):
            if cd["metadata"].get("uid") == cd_uid:
                return cd
        return None

    def require_compute_domain(self, cd_uid: str) -> Obj:
        """One fetch per prepare attempt. Not-found is RETRYABLE: the
        claim's Prepare can outrun this plugin's view of a just-created CD
        (informer lag), and the workqueue re-asserts."""
        cd = self.get_compute_domain(cd_uid)
        if cd is None:
            raise RuntimeError(f"ComputeDomain not found (yet): {cd_uid}")
        return cd

    @staticmethod
    def assert_namespace(cd: Obj, claim_namespace: str) -> None:
        """A claim may only reference a CD in its own namespace — crossing
        namespaces would leak another tenant's rendezvous identity
        (AssertComputeDomainNamespace, computedomain.go:356-370)."""
        if cd["metadata"].get("namespace", "") != claim_namespace:
            raise PermanentError(
                "the ResourceClaim's namespace is different than the "
                "ComputeDomain's namespace")

    # -- node labels ----------------------------------------------------------

    def add_node_label(self, cd_uid: str) -> None:
        """Label this node as belonging to the CD; a node can belong to at
        most one CD at a time (AddNodeLabel, computedomain.go:372-400)."""
        node = self.client.get("Node", self.node_name)
        current = (node["metadata"].get("labels") or {}).get(NODE_LABEL_CD)
        if current is not None and current != cd_uid:
            raise RuntimeError(
                f"node {self.node_name} already labeled for ComputeDomain "
                f"{current}; refusing to relabel for {cd_uid}")
        if current == cd_uid:
            return
        self.client.patch_labels("Node", self.node_name,
                                 {NODE_LABEL_CD: cd_uid})

    def remove_node_label(self, cd_uid: str) -> None:
        """Remove the label iff it still points at this CD
        (RemoveNodeLabel, computedomain.go:402-427)."""
        try:
            node = self.client.get("Node", self.node_name)
        except NotFoundError:
            return
        if (node["metadata"].get("labels") or {}).get(NODE_LABEL_CD) != cd_uid:
            return
        self.client.patch_labels("Node", self.node_name, {NODE_LABEL_CD: None})

    def set_clique_label(self) -> None:
        """Publish this node's clique as a label (SetGPUCliqueLabel,
        computedomain.go:429): lets operators and selectors group nodes by
        NVLink domain."""
        try:
            self.client.patch_labels(
                "Node", self.node_name, {NODE_LABEL_CLIQUE: self.clique_id})
        except NotFoundError:
            logger.warning("clique label: node %s not registered",
                           self.node_name)

    # -- readiness gating ------------------------------------------------------

    def assert_ready(self, cd: Obj) -> None:
        """Gate channel prepare on THIS node's daemon being Ready in the CD
        (AssertComputeDomainReady, computedomain.go:298-354). Raises a
        retryable error — the 45 s workqueue keeps re-asserting while the
        controller's DaemonSet lands and the daemon comes up."""
        if self.gates.enabled(COMPUTE_DOMAIN_CLIQUES):
            if self._node_ready_in_clique(cd):
                return
        # Fall through to the status path either way: CDs created before the
        # cliques gate flipped keep working (isCurrentNodeReady semantics).
        if self._node_ready_in_status(cd):
            return
        raise RuntimeError(
            f"current node {self.node_name} not ready in ComputeDomain "
            f"{cd['metadata']['name']}")

    def _node_ready_in_clique(self, cd: Obj) -> bool:
        mine = self._my_clique_entry(cd)
        return mine is not None and mine.status == STATUS_READY

    def _node_ready_in_status(self, cd: Obj) -> bool:
        for n in (cd.get("status") or {}).get("nodes") or []:
            if n.get("nodeName") == self.node_name:
                return n.get("status") == STATUS_READY
        return False

    def _clique_namespaces(self, cd: Obj) -> list[str]:
        """Where cliques may live, most likely first: the configured driver
        namespace (multi-namespace layout, cdclique.go:52), else co-located
        with the CD."""
        out = []
        if self.driver_namespace:
            out.append(self.driver_namespace)
        cd_ns = cd["metadata"].get("namespace", "")
        if cd_ns not in out:
            out.append(cd_ns)
        return out

    def _get_clique(self, cd: Obj) -> Optional[Obj]:
        """Namespaced O(1) gets against the known locations; the
        cluster-wide by-name scan is a last resort for deployments that set
        neither knob consistently (names embed the CD uid, so the scan is
        unambiguous, just expensive)."""
        name = clique_name(cd["metadata"]["uid"], self.clique_id)
        for ns in self._clique_namespaces(cd):
            found = self.client.try_get(KIND_CLIQUE, name, ns)
            if found is not None:
                return found
        if self.driver_namespace:
            return None  # configured layouts never need the wide scan
        for clique in self.client.list(KIND_CLIQUE):
            if clique["metadata"]["name"] == name:
                return clique
        return None

    def _my_clique_entry(self, cd: Obj) -> Optional[DaemonInfo]:
        clique = self._get_clique(cd)
        if clique is None:
            return None
        for d in clique_daemons(clique):
            if d.node_name == self.node_name:
                return d
        return None

    # -- worker rendezvous env (the IMEX channel-injection analogue) ----------

    def worker_env(self, cd: Obj) -> dict[str, str]:
        """The torch.distributed rendezvous of a workload container on this
        node, from clique membership (gate on) or ``Status.Nodes`` (gate
        off): ``MASTER_ADDR`` is rank 0's daemon address, ``NODE_RANK``
        this node's place in the global order, ``NNODES`` the domain's
        size. Every node sorts the same entries, so the ranks agree."""
        cd_uid = cd["metadata"].get("uid", "")
        entries = self._rendezvous_entries(cd)
        want = int((cd.get("spec") or {}).get("numNodes", 1))
        not_ready = [d.node_name for d in entries if d.status != STATUS_READY]
        if len(entries) < want or not_ready:
            # A partial node list would start the ranks with mismatched
            # world sizes across nodes (some train, the rest hang);
            # retryable until ALL numNodes daemons are Ready.
            raise RuntimeError(
                f"ComputeDomain {cd_uid}: {len(entries)}/{want} daemons "
                f"registered, not ready: {not_ready} — rendezvous incomplete")
        # Global ordering across cliques: (clique, index). A CD spans one
        # clique per HGX node, or one multi-node NVLink domain; per-clique
        # indices then repeat across cliques, so they cannot be ranks
        # directly — but duplicates WITHIN one clique are daemon
        # misconfiguration (two daemons claiming one host slot).
        by_index = sorted(entries, key=lambda d: (d.clique_id, d.index))
        keys = [(d.clique_id, d.index) for d in by_index]
        if len(set(keys)) != len(keys):
            raise RuntimeError(
                f"ComputeDomain {cd_uid}: duplicate worker indices within a "
                f"clique: {keys}")
        mine_rank = next((i for i, d in enumerate(by_index)
                          if d.node_name == self.node_name), None)
        if mine_rank is None:
            raise RuntimeError(
                f"node {self.node_name} has no rendezvous entry in "
                f"ComputeDomain {cd_uid}")
        # The rank within the global ordering, not the raw clique index: a
        # CD on hosts {2,3} of a larger NVLink domain still yields ranks
        # {0,1}, and a CD over several cliques one contiguous rank space.
        head = by_index[0]
        return rendezvous_env(
            head.ip_address or head.hostname or head.node_name,
            self.master_port, len(by_index), mine_rank)

    def _rendezvous_entries(self, cd: Obj) -> list[DaemonInfo]:
        if self.gates.enabled(COMPUTE_DOMAIN_CLIQUES):
            # ALL cliques of the CD, not just this node's: a CD may span
            # several cliques, and the node list must cover every node (the
            # controller's buildNodesFromCliques aggregation).
            uid = cd["metadata"].get("uid", "")
            daemons: list[DaemonInfo] = []
            # Cliques live with the daemons; search the known namespaces
            # (driver ns first in multi-namespace layouts) with the uid
            # prefix scoping the match to THIS CD.
            for clique_ns in self._clique_namespaces(cd):
                for clique in self.client.list(KIND_CLIQUE, clique_ns):
                    if clique["metadata"]["name"].startswith(f"{uid}."):
                        daemons.extend(clique_daemons(clique))
                if daemons:
                    break
            if daemons:
                return daemons
        return [DaemonInfo.from_dict(n)
                for n in (cd.get("status") or {}).get("nodes") or []]

    # -- host-managed rendezvous ----------------------------------------------

    def host_rendezvous_env(self) -> dict[str, str]:
        """Host-managed mode: the operator (not this driver) runs the
        rendezvous machinery and drops a file with the node layout — the
        analogue of checking the host nvidia-imex daemon's socket
        (nvlib.go:401-434). Retryable errors until the file is valid."""
        if self.domains_root is None:
            raise PermanentError(
                "host-managed rendezvous requires a domains root directory")
        path = self.domains_root / HOST_RENDEZVOUS_FILENAME
        try:
            doc = json.loads(path.read_text())
        except FileNotFoundError as e:
            raise RuntimeError(
                f"host rendezvous file {path} not present (is the "
                "host-managed rendezvous service running?)") from e
        except json.JSONDecodeError as e:
            raise RuntimeError(f"host rendezvous file {path}: {e}") from e
        hostnames = doc.get("hostnames") or []
        if not isinstance(hostnames, list) or not hostnames:
            raise RuntimeError(f"host rendezvous file {path}: no hostnames")
        worker_ids = doc.get("workerIds") or {}
        if self.node_name in worker_ids:
            try:
                worker_id = int(worker_ids[self.node_name])
            except (TypeError, ValueError) as e:
                # Malformed config cannot heal between retries.
                raise PermanentError(
                    f"host rendezvous file {path}: workerIds"
                    f"[{self.node_name!r}] = {worker_ids[self.node_name]!r} "
                    "is not an integer") from e
        elif self.node_name in hostnames:
            worker_id = hostnames.index(self.node_name)
        else:
            raise RuntimeError(
                f"host rendezvous file {path}: node {self.node_name} not "
                "listed")
        if not 0 <= worker_id < len(hostnames):
            # An out-of-range rank would fail the workload's process-group
            # start; refuse at prepare time where the operator can see it.
            raise PermanentError(
                f"host rendezvous file {path}: workerIds[{self.node_name!r}]"
                f" = {worker_id} out of range for {len(hostnames)} hostnames")
        return rendezvous_env(str(hostnames[0]), self.master_port,
                              len(hostnames), worker_id)

    # -- per-CD daemon settings (ComputeDomainDaemonSettings :228-283) --------

    def daemon_settings(self, cd_uid: str) -> "DaemonSettings":
        if self.domains_root is None:
            raise PermanentError(
                "daemon prepare requires a domains root directory")
        return DaemonSettings(self.domains_root / cd_uid, cd_uid)


class DaemonSettings:
    """Per-CD working directory handed to the daemon pod: scratch space for
    rendezvous artifacts, mounted read-write at a stable container path."""

    CONTAINER_MOUNT = "/compute-domain"

    def __init__(self, root_dir: Path, cd_uid: str):
        self.root_dir = root_dir
        self.cd_uid = cd_uid

    def prepare(self) -> None:
        self.root_dir.mkdir(parents=True, exist_ok=True)
        # A marker the daemon can verify at startup (the COMPUTE_DOMAIN_UUID
        # CDI-edit validation analogue, cmd/compute-domain-daemon/main.go:212).
        marker = self.root_dir / "domain.json"
        durability.atomic_publish(marker, json.dumps({"uid": self.cd_uid}),
                                  tmp=marker.with_suffix(".tmp"))

    def unprepare(self) -> None:
        """Deliberately keeps the directory: a force-deleted daemon pod may
        race its replacement for the same CD (the reference defers removal
        to the cleanup loop for the same reason, computedomain.go:270-283)."""

    def destroy(self) -> None:
        shutil.rmtree(self.root_dir, ignore_errors=True)

    @property
    def mounts(self) -> list[tuple[str, str]]:
        return [(str(self.root_dir), self.CONTAINER_MOUNT)]
