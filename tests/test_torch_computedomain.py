"""The port's ComputeDomain rendezvous held against the JAX package's.

``ComputeDomainManager.worker_env`` of both packages reads the same
ComputeDomain and cliques (each in its own fake API server) for every node
of a layout: one clique, several cliques, and one clique per node (HGX
H100), through the cliques gate and through ``status.nodes``. The port's
torchrun names map onto the JAX package's: ``NODE_RANK`` is
``TPU_WORKER_ID``, ``MASTER_ADDR`` is ``TPU_WORKER_HOSTNAMES[0]`` and
``NNODES`` its length. Every refusal (a daemon not Ready, fewer daemons
than ``numNodes``, a duplicate index in a clique, a node with no entry)
raises the same retryable error in both, and so do the host-managed
rendezvous file's. Also here: the API types against the JAX package's, and
the mock's two multi-node layouts.
"""

import json

import pytest

from k8s_dra_driver_tpu.api import computedomain as jax_api
from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxClient
from k8s_dra_driver_tpu.pkg.errors import PermanentError as JaxPermanent
from k8s_dra_driver_tpu.pkg.featuregates import (
    new_feature_gates as jax_gates,
)
from k8s_dra_driver_tpu.plugins.compute_domain_kubelet_plugin import (
    ComputeDomainManager as JaxManager,
)
from k8s_dra_driver_tpu.tpulib import MockDeviceLib as TpuMock
from k8s_dra_driver_tpu_torch.api import computedomain as api
from k8s_dra_driver_tpu_torch.entry import expected_node_ranks
from k8s_dra_driver_tpu_torch.gpulib import MockDeviceLib
from k8s_dra_driver_tpu_torch.gpulib.device_lib import DGX_H100_256_NODES
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.pkg.errors import PermanentError
from k8s_dra_driver_tpu_torch.pkg.featuregates import new_feature_gates
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin import (
    MASTER_PORT,
    ComputeDomainManager,
)

READY, NOT_READY = api.STATUS_READY, api.STATUS_NOT_READY

# Layouts: (node, clique, index, status) per daemon, in insertion order.
LAYOUTS = {
    "one-clique": [("n2", "cA", 2, READY), ("n0", "cA", 0, READY),
                   ("n1", "cA", 1, READY)],
    "indices-2-3": [("n0", "cA", 2, READY), ("n1", "cA", 3, READY)],
    "several-cliques": [("n3", "cB", 0, READY), ("n0", "cA", 0, READY),
                        ("n1", "cA", 1, READY), ("n2", "cC", 0, READY)],
    "clique-per-node": [(f"n{i}", c, 0, READY) for i, c in
                        enumerate(("cD", "cB", "cA", "cC"))],
}
# Refusals: the layout, numNodes, and the node asking.
REFUSALS = {
    "not-ready": ([("n0", "cA", 0, READY), ("n1", "cA", 1, NOT_READY)],
                  2, "n0"),
    "incomplete": ([("n0", "cA", 0, READY)], 2, "n0"),
    "duplicate-index": ([("n0", "cA", 0, READY), ("n1", "cA", 0, READY)],
                        2, "n0"),
    "no-entry": ([("n0", "cA", 0, READY), ("n1", "cB", 0, READY)], 2,
                 "n9"),
}


class _Side:
    """One package's client, manager factory and CD: the same objects built
    by each package's own constructors."""

    def __init__(self, jax: bool, daemons, num_nodes: int, cliques: bool):
        mod = jax_api if jax else api
        self.client = (JaxClient if jax else FakeClient)()
        self.cd = self.client.create(mod.new_compute_domain(
            "cd", num_nodes=num_nodes))
        uid = self.cd["metadata"]["uid"]
        self.gates = (jax_gates if jax else new_feature_gates)(
            f"ComputeDomainCliques={str(cliques).lower()}")
        infos = [mod.DaemonInfo(node_name=n, hostname=f"{n}.example",
                                clique_id=c, index=i, status=s).to_dict()
                 for n, c, i, s in daemons]
        if cliques:
            for cid in dict.fromkeys(c for _, c, _, _ in daemons):
                obj = mod.new_clique(uid, cid, "default", owner_cd_name="cd")
                obj["daemons"] = [d for d in infos if d["cliqueID"] == cid]
                self.client.create(obj)
        else:
            cd = self.client.get("ComputeDomain", "cd", "default")
            cd["status"] = {"status": NOT_READY, "nodes": infos}
            self.client.update_status(cd)
        self.jax = jax

    def env(self, node: str) -> dict:
        cd = self.client.get("ComputeDomain", "cd", "default")
        if self.jax:
            m = JaxManager(self.client, node,
                           TpuMock("v5e-16", host_index=0).slice_info(),
                           gates=self.gates)
        else:
            m = ComputeDomainManager(
                self.client, node, MockDeviceLib("h100-8").node_info(),
                gates=self.gates)
        return m.worker_env(cd)


@pytest.mark.parametrize("cliques", [True, False],
                         ids=["cliques", "status-nodes"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_worker_env_matches_jax(layout, cliques):
    daemons = LAYOUTS[layout]
    jax_side = _Side(True, daemons, len(daemons), cliques)
    port_side = _Side(False, daemons, len(daemons), cliques)
    ranks = set()
    for node, _, _, _ in daemons:
        want = jax_side.env(node)
        got = port_side.env(node)
        hosts = want["TPU_WORKER_HOSTNAMES"].split(",")
        assert got == {"MASTER_ADDR": hosts[0],
                       "MASTER_PORT": str(MASTER_PORT),
                       "NNODES": str(len(hosts)),
                       "NODE_RANK": want["TPU_WORKER_ID"]}, node
        assert hosts[int(got["NODE_RANK"])] == f"{node}.example"
        ranks.add(int(got["NODE_RANK"]))
    assert ranks == set(range(len(daemons)))


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    daemons, num_nodes, node = REFUSALS[case]
    messages = []
    for jax in (True, False):
        side = _Side(jax, daemons, num_nodes, cliques=True)
        with pytest.raises(RuntimeError) as e:
            side.env(node)
        assert not isinstance(e.value, (JaxPermanent, PermanentError))
        # The same reason in the same words, up to the CD's uid.
        messages.append(str(e.value).replace(side.cd["metadata"]["uid"],
                                             "<uid>"))
    assert messages[1] == messages[0]


def test_master_addr_is_the_rank0_daemons_address():
    # A daemon that reports an address hands it out; the hostname is the
    # fallback, as in the JAX list of hostnames.
    side = _Side(False, LAYOUTS["several-cliques"], 4, cliques=True)
    uid = side.cd["metadata"]["uid"]
    clique = side.client.get("ComputeDomainClique", f"{uid}.cA", "default")
    clique["daemons"][0]["ipAddress"] = "10.0.0.7"
    side.client.update(clique)
    for node in ("n0", "n1", "n2", "n3"):
        assert side.env(node)["MASTER_ADDR"] == "10.0.0.7"


def test_master_port_is_the_plugins_setting():
    side = _Side(False, LAYOUTS["one-clique"], 3, cliques=True)
    m = ComputeDomainManager(side.client, "n1",
                             MockDeviceLib("h100-8").node_info(),
                             gates=side.gates, master_port=41000)
    env = m.worker_env(side.client.get("ComputeDomain", "cd", "default"))
    assert env["MASTER_PORT"] == "41000" and env["NODE_RANK"] == "1"


# Host-managed rendezvous files: (document, node) → the JAX package's env
# or its error, and the port's.
HOST_FILES = [
    ({"hostnames": ["h0", "h1", "h2"]}, "h1"),
    ({"hostnames": ["h0", "h1"], "workerIds": {"node-x": 1}}, "node-x"),
    ({"hostnames": ["h0", "h1"], "workerIds": {"node-x": "one"}}, "node-x"),
    ({"hostnames": ["h0", "h1"], "workerIds": {"node-x": 5}}, "node-x"),
    ({"hostnames": ["h0", "h1"]}, "elsewhere"),
    ({"hostnames": []}, "h0"),
    (None, "h0"),
]


@pytest.mark.parametrize("doc,node", HOST_FILES)
def test_host_rendezvous_file_matches_jax(tmp_path, doc, node):
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
        if doc is not None:
            (tmp_path / sub / "host-rendezvous.json").write_text(
                json.dumps(doc))
    jax_m = JaxManager(JaxClient(), node,
                       TpuMock("v5e-16", host_index=0).slice_info(),
                       domains_root=str(tmp_path / "jax"))
    port_m = ComputeDomainManager(FakeClient(), node,
                                  MockDeviceLib("h100-8").node_info(),
                                  domains_root=str(tmp_path / "port"))
    results = []
    for m in (jax_m, port_m):
        try:
            results.append(m.host_rendezvous_env())
        except (RuntimeError, JaxPermanent, PermanentError) as e:
            results.append(e)
    want, got = results
    if isinstance(want, Exception):
        # Refused alike: retryable in both, or permanent in both.
        assert isinstance(got, Exception), got
        assert isinstance(got, PermanentError) == isinstance(
            want, JaxPermanent), (got, want)
        return
    hosts = want["TPU_WORKER_HOSTNAMES"].split(",")
    assert got == {
        "MASTER_ADDR": hosts[0], "MASTER_PORT": str(MASTER_PORT),
        "NNODES": str(len(hosts)), "NODE_RANK": want["TPU_WORKER_ID"]}


class TestApiTypes:
    def test_compute_domain_matches_jax_but_the_group(self):
        kwargs = dict(namespace="team", num_nodes=4,
                      channel_template_name="chan", allocation_mode="All")
        want = jax_api.new_compute_domain("dom", **kwargs)
        got = api.new_compute_domain("dom", **kwargs)
        assert want.pop("apiVersion") == "resource.tpu.google.com/v1beta1"
        assert got.pop("apiVersion") == "resource.nvidia.com/v1beta1"
        assert got == want
        for fn in ("cd_num_nodes", "cd_channel_template_name",
                   "cd_allocation_mode", "cd_status"):
            assert getattr(api, fn)(got) == getattr(jax_api, fn)(want), fn

    def test_daemon_info_round_trips_the_jax_record(self):
        record = jax_api.DaemonInfo(
            node_name="n", hostname="h", ip_address="10.0.0.1",
            clique_id="c.0", index=3, status=READY).to_dict()
        info = api.DaemonInfo.from_dict(record)
        assert info.to_dict() == record
        assert api.DaemonInfo.from_dict({}).to_dict() == \
            jax_api.DaemonInfo.from_dict({}).to_dict()

    def test_clique_matches_jax_but_the_group(self):
        want = jax_api.new_clique("uid", "c.0", "ns", owner_cd_name="dom")
        got = api.new_clique("uid", "c.0", "ns", owner_cd_name="dom")
        for obj in (want, got):
            obj.pop("apiVersion")
            obj["metadata"]["ownerReferences"][0].pop("apiVersion")
        assert got == want
        assert api.clique_name("uid", "c.0") == jax_api.clique_name(
            "uid", "c.0")


class TestMockLayouts:
    @pytest.mark.parametrize("profile", ["h100-8", "dgx-h100-256"])
    def test_each_host_has_its_own_gpus(self, profile):
        libs = [MockDeviceLib(profile, host_index=h) for h in range(4)]
        uuids = [g.uuid for lib in libs for g in lib.enumerate_gpus()]
        assert len(uuids) == len(set(uuids)) == 32
        for h, lib in enumerate(libs):
            assert {g.host_index for g in lib.enumerate_gpus()} == {h}
            assert lib.node_info().host_index == h

    def test_hgx_nodes_are_cliques_of_one(self):
        infos = [MockDeviceLib("h100-8", host_index=h).node_info()
                 for h in range(4)]
        assert len({i.clique_id for i in infos}) == 4
        assert {i.clique_hosts for i in infos} == {1}
        # Node 0 is the single-node mock as it always was.
        assert MockDeviceLib("h100-8").enumerate_gpus() == [
            g.__class__(**{**g.__dict__, "host_index": -1})
            for g in MockDeviceLib("h100-8", host_index=0).enumerate_gpus()]

    def test_nvlink_domain_nodes_share_one_clique(self):
        infos = [MockDeviceLib("dgx-h100-256", host_index=h).node_info()
                 for h in range(DGX_H100_256_NODES)]
        assert len({i.clique_id for i in infos}) == 1
        assert {i.clique_hosts for i in infos} == {DGX_H100_256_NODES}
        with pytest.raises(ValueError, match="nodes 0..31"):
            MockDeviceLib("dgx-h100-256", host_index=DGX_H100_256_NODES)

    def test_a_node_without_a_clique_is_its_own(self):
        info = MockDeviceLib({**MockDeviceLib("h100-8").profile,
                              "clique_id": ""}).node_info()
        assert info.clique_id == ""
        assert info.domain_clique_id == f"{info.node_uuid}.0"

    @pytest.mark.parametrize("profile,n", [("h100-8", 2), ("h100-8", 4),
                                           ("dgx-h100-256", 4)])
    def test_expected_ranks_are_a_permutation(self, profile, n):
        ranks = expected_node_ranks(n, profile)
        assert sorted(ranks) == list(range(n))
        if profile == "dgx-h100-256":
            assert ranks == list(range(n))   # one clique: by host index
