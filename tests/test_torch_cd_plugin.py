"""The port's ComputeDomain kubelet plugin and daemon.

The scenarios of ``tests/test_cd_plugin.py``, on the port's mock nodes:
device publication, the codependent channel-prepare flow (label →
DaemonSet → daemon Ready → rendezvous env), PrepareAborted tombstones and
their TTL, channel exclusivity, a crash mid-prepare and restart, drain,
reboot invalidation, daemon prepare, host-managed rendezvous, the daemons'
index collisions and their own pod's readiness. Most run on two nodes of
``dgx-h100-256`` (one NVLink domain, so one clique, as the JAX tests' two
``v5e-16`` hosts); the rendezvous scenarios also run on ``h100-8``, where
each node is a clique of its own. ``TestAgainstJax`` drives the same flow
through both packages and holds the outcomes and the env against each
other.
"""

import json
import threading
import time

import pytest

from k8s_dra_driver_tpu.api.computedomain import (
    new_compute_domain as jax_new_compute_domain,
)
from k8s_dra_driver_tpu.api.configs import API_VERSION as JAX_API_VERSION
from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxClient
from k8s_dra_driver_tpu.kubeletplugin import Allocator as JaxAllocator
from k8s_dra_driver_tpu.pkg.errors import is_permanent as jax_is_permanent
from k8s_dra_driver_tpu.plugins.compute_domain_daemon import (
    ComputeDomainDaemon as JaxDaemon,
)
from k8s_dra_driver_tpu.plugins.compute_domain_kubelet_plugin import (
    CdDriver as JaxCdDriver,
    CdDriverConfig as JaxCdDriverConfig,
)
from k8s_dra_driver_tpu.tpulib import MockDeviceLib as TpuMock
from k8s_dra_driver_tpu_torch.api.computedomain import (
    NODE_LABEL_CD,
    NODE_LABEL_CLIQUE,
    STATUS_NOT_READY,
    STATUS_READY,
    clique_daemons,
    new_clique,
    new_compute_domain,
)
from k8s_dra_driver_tpu_torch.api.configs import API_VERSION
from k8s_dra_driver_tpu_torch.cdi.spec import claim_spec_env
from k8s_dra_driver_tpu_torch.entry import expected_node_ranks
from k8s_dra_driver_tpu_torch.gpulib import MockDeviceLib
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg import faultpoints
from k8s_dra_driver_tpu_torch.pkg.bootid import ENV_ALT_BOOT_ID_PATH
from k8s_dra_driver_tpu_torch.pkg.errors import is_permanent
from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    HOST_MANAGED_RENDEZVOUS,
    new_feature_gates,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon import (
    ComputeDomainDaemon,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin import (
    CD_DRIVER_NAME,
    MASTER_PORT,
    CdCheckpointCleanupManager,
    CdDriver,
    CdDriverConfig,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_ABORTED,
    STATE_PREPARE_COMPLETED,
    STATE_PREPARE_STARTED,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    OverlapError,
)

DEVICE_CLASS_CHANNEL = "compute-domain-default-channel.nvidia.com"
DEVICE_CLASS_DAEMON = "compute-domain-daemon.nvidia.com"
DOMAIN = "dgx-h100-256"    # two nodes of one NVLink domain: one clique
LAYOUTS = ["dgx-h100-256", "h100-8"]


def _classes(client):
    for name, kind in ((DEVICE_CLASS_CHANNEL, "channel"),
                       (DEVICE_CLASS_DAEMON, "daemon")):
        client.create(new_object("DeviceClass", name, spec={"selectors": [
            {"cel": {"expression": f"device.attributes['type'] == '{kind}'"}}
        ]}))


def make_cluster(tmp_path, profile=DOMAIN):
    """Two nodes node-0/node-1 of ``profile``, one CD driver per node, and
    a ComputeDomain 'cd' with numNodes=2."""
    client = FakeClient()
    for node in ("node-0", "node-1"):
        client.create(new_object("Node", node))
    _classes(client)
    cd = client.create(new_compute_domain("cd", num_nodes=2))
    drivers = [CdDriver(client, CdDriverConfig(
        node_name=f"node-{h}", state_dir=str(tmp_path / f"state-{h}"),
        cdi_root=str(tmp_path / f"cdi-{h}"), env={}, retry_timeout=0.4),
        device_lib=MockDeviceLib(profile, host_index=h)).start()
        for h in (0, 1)]
    return client, drivers, cd


@pytest.fixture()
def cluster(tmp_path):
    return make_cluster(tmp_path)


def start_daemon(client, host, cd, profile=DOMAIN, ip=""):
    d = ComputeDomainDaemon(
        client=client, device_lib=MockDeviceLib(profile, host_index=host),
        cd_uid=cd["metadata"]["uid"], cd_name=cd["metadata"]["name"],
        node_name=f"node-{host}", hostname=f"host-{host}.example",
        ip_address=ip)
    d.sync_once()
    return d


def channel_spec(cd, node=None, api_version=API_VERSION,
                 driver=CD_DRIVER_NAME, channel_class=DEVICE_CLASS_CHANNEL):
    selectors = ["device.attributes['type'] == 'channel'"]
    if node is not None:
        selectors.append(f"device.attributes['hostIndex'] == {node}")
    return {"devices": {
        "requests": [{"name": "channel", "exactly": {
            "deviceClassName": channel_class,
            "allocationMode": "ExactCount", "count": 1,
            "selectors": [{"cel": {"expression": s}} for s in selectors],
        }}],
        "config": [{"requests": ["channel"], "opaque": {
            "driver": driver,
            "parameters": {
                "apiVersion": api_version,
                "kind": "ComputeDomainChannelConfig",
                "domainID": cd["metadata"]["uid"],
                "allocationMode": "Single"}}}],
    }}


def make_channel_claim(client, name, cd, node=None, namespace="default"):
    return client.create(new_object(
        "ResourceClaim", name, namespace, api_version="resource.k8s.io/v1",
        spec=channel_spec(cd, node)))


def make_daemon_claim(client, name, cd, node, namespace="default"):
    spec = {"devices": {
        "requests": [{"name": "daemon", "exactly": {
            "deviceClassName": DEVICE_CLASS_DAEMON,
            "allocationMode": "ExactCount", "count": 1,
            "selectors": [{"cel": {"expression":
                f"device.attributes['hostIndex'] == {node}"}}],
        }}],
        "config": [{"requests": ["daemon"], "opaque": {
            "driver": CD_DRIVER_NAME,
            "parameters": {
                "apiVersion": API_VERSION,
                "kind": "ComputeDomainDaemonConfig",
                "domainID": cd["metadata"]["uid"]}}}],
    }}
    return client.create(new_object(
        "ResourceClaim", name, namespace,
        api_version="resource.k8s.io/v1", spec=spec))


def prepare(client, driver, name, namespace="default"):
    claim = Allocator(client).allocate(
        client.get("ResourceClaim", name, namespace))
    results = driver.prepare_resource_claims([claim])
    return claim, results[claim["metadata"]["uid"]]


def claim_env(driver, uid):
    return claim_spec_env(driver.cdi.read_claim_spec(uid))


class TestPublication:
    @pytest.mark.parametrize("profile", LAYOUTS)
    def test_channel0_and_daemon_published(self, tmp_path, profile):
        client, drivers, _ = make_cluster(tmp_path, profile)
        slices = [s for s in client.list("ResourceSlice")
                  if s["spec"]["driver"] == CD_DRIVER_NAME]
        assert len(slices) == 2
        for s in slices:
            devs = {d["name"]: d for d in s["spec"]["devices"]}
            # Only channel-0 is advertised (driver.go:46-58); higher
            # channels exist for AllocationMode=All injection only.
            assert set(devs) == {"channel-0", "daemon"}
            host = int(s["spec"]["nodeName"][-1])
            info = MockDeviceLib(profile, host_index=host).node_info()
            assert devs["channel-0"]["attributes"] == {
                "type": {"string": "channel"}, "channelID": {"int": 0},
                "cliqueID": {"string": info.clique_id},
                "gpuCount": {"int": 8}, "hostIndex": {"int": host}}

    def test_host_managed_omits_daemon_device(self, tmp_path):
        client = FakeClient()
        client.create(new_object("Node", "node-0"))
        cfg = CdDriverConfig(
            node_name="node-0",
            state_dir=str(tmp_path / "s"), cdi_root=str(tmp_path / "c"),
            feature_gates=new_feature_gates(f"{HOST_MANAGED_RENDEZVOUS}=true"),
            env={}, retry_timeout=0.2)
        CdDriver(client, cfg, device_lib=MockDeviceLib("h100-8")).start()
        names = {d["name"]
                 for s in client.list("ResourceSlice")
                 for d in s["spec"]["devices"]}
        assert names == {"channel-0"}

    @pytest.mark.parametrize("profile", LAYOUTS)
    def test_clique_label_set_at_startup(self, tmp_path, profile):
        client, _, _ = make_cluster(tmp_path, profile)
        for h in (0, 1):
            node = client.get("Node", f"node-{h}")
            assert node["metadata"]["labels"][NODE_LABEL_CLIQUE] == \
                MockDeviceLib(profile, host_index=h).node_info().clique_id


class TestChannelPrepare:
    @pytest.mark.parametrize("profile", LAYOUTS)
    def test_blocked_until_ready_then_env_injected(self, tmp_path, profile):
        client, drivers, cd = make_cluster(tmp_path, profile)
        make_channel_claim(client, "wl0", cd, node=0)
        # No daemon ready yet → retries exhaust the (shortened) budget, but
        # the node label was applied (that's what ATTRACTS the DaemonSet).
        claim, result = prepare(client, drivers[0], "wl0")
        assert result.error is not None
        assert not is_permanent(result.error)
        node = client.get("Node", "node-0")
        assert node["metadata"]["labels"][NODE_LABEL_CD] == \
            cd["metadata"]["uid"]

        # Both nodes' daemons come up and report Ready into their cliques.
        start_daemon(client, 0, cd, profile)
        start_daemon(client, 1, cd, profile)

        claim, result = prepare(client, drivers[0], "wl0")
        assert result.error is None
        env = claim_env(drivers[0], claim["metadata"]["uid"])
        rank0 = expected_node_ranks(2, profile).index(0)
        assert env == {
            "MASTER_ADDR": f"host-{rank0}.example",
            "MASTER_PORT": str(MASTER_PORT), "NNODES": "2",
            "NODE_RANK": str(expected_node_ranks(2, profile)[0]),
            "COMPUTE_DOMAIN_UUID": cd["metadata"]["uid"],
            "COMPUTE_DOMAIN_CHANNELS": "0"}

    @pytest.mark.parametrize("profile", LAYOUTS)
    def test_node_rank_follows_the_clique_order(self, tmp_path, profile):
        client, drivers, cd = make_cluster(tmp_path, profile)
        start_daemon(client, 0, cd, profile)
        start_daemon(client, 1, cd, profile)
        ranks = []
        for h in (0, 1):
            make_channel_claim(client, f"wl{h}", cd, node=h)
            claim, result = prepare(client, drivers[h], f"wl{h}")
            assert result.error is None
            ranks.append(int(claim_env(drivers[h],
                                       claim["metadata"]["uid"])
                             ["NODE_RANK"]))
        assert ranks == expected_node_ranks(2, profile)
        if profile == DOMAIN:
            assert ranks == [0, 1]     # one clique: by host index

    def test_master_addr_is_the_daemons_address(self, cluster):
        client, drivers, cd = cluster
        start_daemon(client, 0, cd, ip="127.0.0.1")
        start_daemon(client, 1, cd, ip="127.0.0.2")
        make_channel_claim(client, "wl", cd, node=1)
        claim, result = prepare(client, drivers[1], "wl")
        assert result.error is None
        assert claim_env(drivers[1], claim["metadata"]["uid"])[
            "MASTER_ADDR"] == "127.0.0.1"

    def test_codependent_retry_succeeds_within_budget(self, cluster):
        """The 45 s loop in miniature: prepare spins while a concurrent
        'DaemonSet' brings the daemon up mid-retry (driver.go:178-207)."""
        client, drivers, cd = cluster
        drivers[0].config.retry_timeout = 5.0
        make_channel_claim(client, "wl2", cd, node=0)
        start_daemon(client, 1, cd)

        def bring_up():
            time.sleep(0.4)
            start_daemon(client, 0, cd)

        t = threading.Thread(target=bring_up)
        t.start()
        claim, result = prepare(client, drivers[0], "wl2")
        t.join()
        assert result.error is None

    def test_partial_clique_blocks_prepare(self, cluster):
        """Only one of two daemons registered: the env would start a
        1-node world for a 2-node domain — must stay retryably blocked
        until ALL numNodes daemons are Ready."""
        client, drivers, cd = cluster
        start_daemon(client, 0, cd)  # node-1's daemon never arrives
        make_channel_claim(client, "wlp", cd, node=0)
        _, result = prepare(client, drivers[0], "wlp")
        assert result.error is not None
        assert not is_permanent(result.error)
        assert "rendezvous incomplete" in str(result.error)

    def test_unprepare_of_started_claim_removes_label(self, cluster):
        """Prepare fails at the readiness gate (claim in PrepareStarted,
        node already labeled); unprepare must remove the label or the node
        is permanently stuck on this CD."""
        client, drivers, cd = cluster
        make_channel_claim(client, "wls", cd, node=0)
        claim, result = prepare(client, drivers[0], "wls")
        assert result.error is not None
        uid = claim["metadata"]["uid"]
        assert client.get("Node", "node-0")["metadata"]["labels"][
            NODE_LABEL_CD] == cd["metadata"]["uid"]
        drivers[0].unprepare_resource_claims(
            [ClaimRef(uid=uid, name="wls", namespace="default")])
        node = client.get("Node", "node-0")
        assert NODE_LABEL_CD not in node["metadata"]["labels"]

    def test_namespace_mismatch_is_permanent(self, cluster):
        client, drivers, cd = cluster
        client.create(new_object("Namespace", "other"))
        make_channel_claim(client, "wl3", cd, node=0, namespace="other")
        _, result = prepare(client, drivers[0], "wl3", namespace="other")
        assert result.error is not None and is_permanent(result.error)

    def test_channel_exclusivity(self, cluster):
        client, drivers, cd = cluster
        start_daemon(client, 0, cd)
        start_daemon(client, 1, cd)
        make_channel_claim(client, "wl4", cd, node=0)
        _, r1 = prepare(client, drivers[0], "wl4")
        assert r1.error is None
        # A second claim prepared against the same channel slot (scheduler
        # race / force-delete artifact) must be refused.
        make_channel_claim(client, "wl5", cd, node=0)
        c2 = client.get("ResourceClaim", "wl5", "default")
        c2.setdefault("status", {})["allocation"] = {"devices": {"results": [{
            "request": "channel", "driver": CD_DRIVER_NAME,
            "pool": "node-0", "device": "channel-0"}],
            "config": (client.get("ResourceClaim", "wl4", "default")
                       ["status"]["allocation"]["devices"]["config"])}}
        client.update_status(c2)
        res = drivers[0].prepare_resource_claims(
            [client.get("ResourceClaim", "wl5", "default")])
        # The overlap refusal is retryable by design (the transient
        # unprepare-window flavor); here it exhausts the budget and
        # surfaces as the overlap error.
        assert isinstance(res[c2["metadata"]["uid"]].error, OverlapError)

    def test_unprepare_removes_node_label(self, cluster):
        client, drivers, cd = cluster
        start_daemon(client, 0, cd)
        start_daemon(client, 1, cd)
        make_channel_claim(client, "wl6", cd, node=0)
        claim, result = prepare(client, drivers[0], "wl6")
        assert result.error is None
        uid = claim["metadata"]["uid"]
        drivers[0].unprepare_resource_claims(
            [ClaimRef(uid=uid, name="wl6", namespace="default")])
        node = client.get("Node", "node-0")
        assert NODE_LABEL_CD not in node["metadata"]["labels"]
        assert drivers[0].cdi.read_claim_spec(uid) is None
        assert uid not in drivers[0].state.prepared_claims()


class TestRestartRecovery:
    def test_crash_between_checkpoint_and_cdi_write_then_restart(
            self, cluster):
        """The plugin dies after the PrepareStarted checkpoint (node
        already labeled) but before the CDI spec lands. A restarted plugin
        must regenerate the spec on re-prepare, and unprepare must clean
        the checkpoint, the spec, AND the node label."""
        client, drivers, cd = cluster
        start_daemon(client, 0, cd)
        start_daemon(client, 1, cd)
        make_channel_claim(client, "wl-crash", cd, node=0)
        claim = Allocator(client).allocate(
            client.get("ResourceClaim", "wl-crash", "default"))
        uid = claim["metadata"]["uid"]

        with faultpoints.injected("cdi.write=crash-nth:1"):
            with pytest.raises(faultpoints.FaultCrash):
                drivers[0].prepare_resource_claims([claim])
        assert drivers[0].state.prepared_claims()[uid].state == \
            STATE_PREPARE_STARTED
        assert drivers[0].cdi.read_claim_spec(uid) is None
        assert client.get("Node", "node-0")["metadata"]["labels"][
            NODE_LABEL_CD] == cd["metadata"]["uid"]

        # "Restart": a fresh plugin process over the same state dir.
        driver2 = CdDriver(client, drivers[0].config,
                           device_lib=MockDeviceLib(
                               DOMAIN, host_index=0)).start()
        r = driver2.prepare_resource_claims([claim])[uid]
        assert r.error is None
        assert driver2.state.prepared_claims()[uid].state == \
            STATE_PREPARE_COMPLETED
        assert driver2.cdi.read_claim_spec(uid) is not None  # regenerated

        errs = driver2.unprepare_resource_claims(
            [ClaimRef(uid=uid, name="wl-crash", namespace="default")])
        assert errs[uid] is None
        assert driver2.state.prepared_claims() == {}
        assert driver2.cdi.read_claim_spec(uid) is None
        labels = client.get("Node", "node-0")["metadata"].get("labels") or {}
        assert NODE_LABEL_CD not in labels


class TestPrepareAbortedTTL:
    def _park_in_started(self, client, driver, cd):
        """Drive a claim into PrepareStarted by preparing with no daemon
        ready (the readiness gate fails after the Started checkpoint)."""
        make_channel_claim(client, "stuck", cd, node=0)
        claim, result = prepare(client, driver, "stuck")
        assert result.error is not None
        uid = claim["metadata"]["uid"]
        assert driver.state.prepared_claims()[uid].state == \
            STATE_PREPARE_STARTED
        return claim, uid

    def test_unprepare_of_started_leaves_tombstone(self, cluster):
        client, drivers, cd = cluster
        claim, uid = self._park_in_started(client, drivers[0], cd)
        drivers[0].unprepare_resource_claims(
            [ClaimRef(uid=uid, name="stuck", namespace="default")])
        pc = drivers[0].state.prepared_claims()[uid]
        assert pc.state == STATE_PREPARE_ABORTED
        assert pc.aborted_expiry > time.time()

    def test_stale_prepare_retry_rejected(self, cluster):
        client, drivers, cd = cluster
        claim, uid = self._park_in_started(client, drivers[0], cd)
        drivers[0].unprepare_resource_claims(
            [ClaimRef(uid=uid, name="stuck", namespace="default")])
        # Daemons come up AFTER the abort: a stale retry of the same claim
        # version must NOT resurrect state (device_state.go:206-208).
        start_daemon(client, 0, cd)
        start_daemon(client, 1, cd)
        res = drivers[0].prepare_resource_claims(
            [client.get("ResourceClaim", "stuck", "default")])
        err = res[uid].error
        assert err is not None and is_permanent(err)

    def test_second_unprepare_is_noop(self, cluster):
        client, drivers, cd = cluster
        claim, uid = self._park_in_started(client, drivers[0], cd)
        ref = ClaimRef(uid=uid, name="stuck", namespace="default")
        drivers[0].unprepare_resource_claims([ref])
        out = drivers[0].unprepare_resource_claims([ref])
        assert out[uid] is None
        assert drivers[0].state.prepared_claims()[uid].state == \
            STATE_PREPARE_ABORTED

    def test_ttl_expiry_unblocks_new_prepare(self, cluster):
        client, drivers, cd = cluster
        claim, uid = self._park_in_started(client, drivers[0], cd)
        drivers[0].unprepare_resource_claims(
            [ClaimRef(uid=uid, name="stuck", namespace="default")])
        assert drivers[0].state.delete_expired_aborted() == []
        # Past TTL: the GC drops the tombstone and a fresh prepare works.
        future = time.time() + drivers[0].state.aborted_ttl + 1
        assert drivers[0].state.delete_expired_aborted(now=future) == [uid]
        start_daemon(client, 0, cd)
        start_daemon(client, 1, cd)
        res = drivers[0].prepare_resource_claims(
            [client.get("ResourceClaim", "stuck", "default")])
        assert res[uid].error is None

    def test_cleanup_manager_expires_tombstones(self, cluster):
        client, drivers, cd = cluster
        claim, uid = self._park_in_started(client, drivers[0], cd)
        drivers[0].state.aborted_ttl = 0.0  # tombstone expires immediately
        drivers[0].unprepare_resource_claims(
            [ClaimRef(uid=uid, name="stuck", namespace="default")])
        assert drivers[0].state.prepared_claims()[uid].state == \
            STATE_PREPARE_ABORTED
        removed = CdCheckpointCleanupManager(
            client, drivers[0].state).cleanup_once()
        assert uid in removed
        assert uid not in drivers[0].state.prepared_claims()

    def test_cleanup_manager_unprepares_stale_started_claims(self, cluster):
        # The GPU plugin's stale-claim sweep under the CD plugin: a claim
        # parked in PrepareStarted whose API object is gone is unprepared
        # (tombstoned, its node label unwound).
        client, drivers, cd = cluster
        claim, uid = self._park_in_started(client, drivers[0], cd)
        client.delete("ResourceClaim", "stuck", "default")
        removed = CdCheckpointCleanupManager(
            client, drivers[0].state).cleanup_once()
        assert removed == [uid]
        assert drivers[0].state.prepared_claims()[uid].state == \
            STATE_PREPARE_ABORTED
        node = client.get("Node", "node-0")
        assert NODE_LABEL_CD not in node["metadata"]["labels"]


class TestDrain:
    def _completed_channel(self, client, drivers, cd):
        start_daemon(client, 0, cd)
        start_daemon(client, 1, cd)
        make_channel_claim(client, "wl-drain", cd, node=0)
        claim, result = prepare(client, drivers[0], "wl-drain")
        assert result.error is None
        return claim, claim["metadata"]["uid"]

    def test_drain_completed_claim_tombstones_and_unwinds(self, cluster):
        client, drivers, cd = cluster
        claim, uid = self._completed_channel(client, drivers, cd)
        ref = ClaimRef(uid=uid, name="wl-drain", namespace="default")
        assert drivers[0].drain_claim(ref, reason="node repair")
        pc = drivers[0].state.prepared_claims()[uid]
        assert pc.state == STATE_PREPARE_ABORTED
        assert pc.aborted_expiry > time.time()
        assert uid not in drivers[0].cdi.list_claim_uids()
        node = client.get("Node", "node-0")
        assert NODE_LABEL_CD not in (node["metadata"].get("labels") or {})
        assert not drivers[0].drain_claim(ref)
        res = drivers[0].prepare_resource_claims(
            [client.get("ResourceClaim", "wl-drain", "default")])
        err = res[uid].error
        assert err is not None and is_permanent(err)

    def test_adopt_boot_id_moves_checkpoint_epoch(self, cluster, tmp_path):
        client, drivers, cd = cluster
        claim, uid = self._completed_channel(client, drivers, cd)
        drivers[0].adopt_boot_id("post-repair-boot")
        assert drivers[0].state.node_boot_id == "post-repair-boot"
        cfg = CdDriverConfig(
            node_name="node-0", state_dir=str(tmp_path / "state-0"),
            cdi_root=str(tmp_path / "cdi-0"),
            env={ENV_ALT_BOOT_ID_PATH: str(tmp_path / "nope")},
            retry_timeout=0.4)
        restarted = CdDriver(client, cfg, device_lib=MockDeviceLib(
            DOMAIN, host_index=0))
        cp = restarted.state.checkpoints.read()
        assert cp.node_boot_id == "post-repair-boot"
        assert uid in cp.prepared_claims

    def test_cordon_withdraws_the_nodes_devices(self, cluster):
        client, drivers, _ = cluster

        def taints():
            s = next(s for s in client.list("ResourceSlice")
                     if s["spec"]["nodeName"] == "node-0")
            return [d.get("taints") for d in s["spec"]["devices"]]

        assert not any(taints())
        assert drivers[0].set_cordon("repair") and drivers[0].cordoned
        assert all(taints())
        assert drivers[0].clear_cordon() and not any(taints())


class TestRebootAndInformerLag:
    def test_reboot_invalidation_unwinds_node_label(self, cluster, tmp_path):
        client, drivers, cd = cluster
        start_daemon(client, 0, cd)
        start_daemon(client, 1, cd)
        make_channel_claim(client, "wlr", cd, node=0)
        claim, result = prepare(client, drivers[0], "wlr")
        assert result.error is None
        assert client.get("Node", "node-0")["metadata"]["labels"][
            NODE_LABEL_CD] == cd["metadata"]["uid"]
        boot_file = tmp_path / "boot_id"
        boot_file.write_text("post-reboot-boot-id\n")
        CdDriver(client, CdDriverConfig(
            node_name="node-0", state_dir=str(tmp_path / "state-0"),
            cdi_root=str(tmp_path / "cdi-0"),
            env={ENV_ALT_BOOT_ID_PATH: str(boot_file)}, retry_timeout=0.3),
            device_lib=MockDeviceLib(DOMAIN, host_index=0)).start()
        node = client.get("Node", "node-0")
        assert NODE_LABEL_CD not in node["metadata"]["labels"]

    def test_node_rank_is_rank_not_raw_index(self, cluster):
        """A CD on nodes whose clique indices are {2,3} of a larger NVLink
        domain still hands out ranks {0,1}."""
        client, drivers, cd = cluster
        uid = cd["metadata"]["uid"]
        clique_id = drivers[0].cd_manager.clique_id
        clique = new_clique(uid, clique_id, "default", owner_cd_name="cd")
        clique["daemons"] = [
            {"nodeName": "node-0", "hostname": "h2", "cliqueID": clique_id,
             "index": 2, "status": STATUS_READY},
            {"nodeName": "node-1", "hostname": "h3", "cliqueID": clique_id,
             "index": 3, "status": STATUS_READY},
        ]
        client.create(clique)
        cd = client.get("ComputeDomain", "cd", "default")
        env0 = drivers[0].cd_manager.worker_env(cd)
        env1 = drivers[1].cd_manager.worker_env(cd)
        assert (env0["NODE_RANK"], env1["NODE_RANK"]) == ("0", "1")
        assert env0["MASTER_ADDR"] == env1["MASTER_ADDR"] == "h2"

    def test_multi_clique_cd_merges_worker_list(self, cluster):
        """A CD spanning two cliques yields one contiguous rank space
        covering all nodes, ordered by (clique, index)."""
        client, drivers, cd = cluster
        uid = cd["metadata"]["uid"]
        cd4 = client.get("ComputeDomain", "cd", "default")
        cd4["spec"]["numNodes"] = 4
        client.update(cd4)
        local = drivers[0].cd_manager.clique_id
        other = "0" + local[1:] if local[0] != "0" else "1" + local[1:]
        for cid, names in ((local, ("node-0", "node-1")),
                           (other, ("node-2", "node-3"))):
            c = new_clique(uid, cid, "default", owner_cd_name="cd")
            c["daemons"] = [{"nodeName": n, "hostname": n, "cliqueID": cid,
                             "index": i, "status": STATUS_READY}
                            for i, n in enumerate(names)]
            client.create(c)
        cd = client.get("ComputeDomain", "cd", "default")
        order = (["node-2", "node-3", "node-0", "node-1"] if other < local
                 else ["node-0", "node-1", "node-2", "node-3"])
        for h in (0, 1):
            env = drivers[h].cd_manager.worker_env(cd)
            assert env["NNODES"] == "4"
            assert env["MASTER_ADDR"] == order[0]
            assert env["NODE_RANK"] == str(order.index(f"node-{h}"))

    def test_cd_not_found_is_retryable(self, cluster):
        """A claim can reach Prepare before the plugin's view contains the
        just-created CD (informer lag): must retry, not fail terminally."""
        client, drivers, _ = cluster
        ghost = {"metadata": {"uid": "11111111-2222-3333-4444-555555555555",
                              "name": "ghost", "namespace": "default"}}
        client.create(new_object(
            "ResourceClaim", "wlg", "default",
            api_version="resource.k8s.io/v1", spec=channel_spec(ghost, 0)))
        _, result = prepare(client, drivers[0], "wlg")
        assert result.error is not None
        assert not is_permanent(result.error)


class TestDaemonPrepare:
    def test_daemon_claim_creates_domain_dir(self, cluster):
        client, drivers, cd = cluster
        make_daemon_claim(client, "dmn", cd, node=0)
        claim, result = prepare(client, drivers[0], "dmn")
        assert result.error is None
        uid_cd = cd["metadata"]["uid"]
        settings = drivers[0].cd_manager.daemon_settings(uid_cd)
        marker = settings.root_dir / "domain.json"
        assert json.loads(marker.read_text())["uid"] == uid_cd
        spec = drivers[0].cdi.read_claim_spec(claim["metadata"]["uid"])
        dev = spec["devices"][0]
        env = dict(e.split("=", 1) for e in dev["containerEdits"]["env"])
        assert env["COMPUTE_DOMAIN_UUID"] == uid_cd
        assert env["COMPUTE_DOMAIN_NAME"] == "cd"
        mounts = dev["containerEdits"]["mounts"]
        assert mounts[0]["containerPath"] == "/compute-domain"

    def test_idempotent_prepare(self, cluster):
        client, drivers, cd = cluster
        make_daemon_claim(client, "dmn2", cd, node=0)
        claim, r1 = prepare(client, drivers[0], "dmn2")
        r2 = drivers[0].prepare_resource_claims(
            [client.get("ResourceClaim", "dmn2", "default")])
        ref1 = r1.devices[0]
        ref2 = r2[claim["metadata"]["uid"]].devices[0]
        assert ref1.cdi_device_ids == ref2.cdi_device_ids


class TestHostManaged:
    @pytest.fixture()
    def hm_cluster(self, tmp_path):
        client = FakeClient()
        client.create(new_object("Node", "node-0"))
        _classes(client)
        cd = client.create(new_compute_domain("cd", num_nodes=2))
        cfg = CdDriverConfig(
            node_name="node-0",
            state_dir=str(tmp_path / "s"), cdi_root=str(tmp_path / "c"),
            feature_gates=new_feature_gates(f"{HOST_MANAGED_RENDEZVOUS}=true"),
            env={}, retry_timeout=0.3)
        driver = CdDriver(
            client, cfg, device_lib=MockDeviceLib("h100-8")).start()
        return client, driver, cd

    def test_channel_uses_host_rendezvous_file(self, hm_cluster):
        client, driver, cd = hm_cluster
        make_channel_claim(client, "wl", cd)
        # Without the operator file the prepare is retryable-blocked.
        _, result = prepare(client, driver, "wl")
        assert result.error is not None and not is_permanent(result.error)
        rdv = driver.cd_manager.domains_root
        rdv.mkdir(parents=True, exist_ok=True)
        (rdv / "host-rendezvous.json").write_text(json.dumps({
            "hostnames": ["head-node", "node-0"]}))
        claim, result = prepare(client, driver, "wl")
        assert result.error is None
        env = claim_env(driver, claim["metadata"]["uid"])
        assert (env["MASTER_ADDR"], env["NNODES"], env["NODE_RANK"]) == \
            ("head-node", "2", "1")
        # Host-managed prepare must NOT label the node (no DaemonSet to
        # attract).
        node = client.get("Node", "node-0")
        assert NODE_LABEL_CD not in (node["metadata"].get("labels") or {})

    def test_daemon_claim_rejected(self, hm_cluster):
        client, driver, cd = hm_cluster
        config = [{"requests": ["daemon"], "opaque": {
            "driver": CD_DRIVER_NAME, "parameters": {
                "apiVersion": API_VERSION,
                "kind": "ComputeDomainDaemonConfig",
                "domainID": cd["metadata"]["uid"]}}}]
        client.create(new_object(
            "ResourceClaim", "dmn", "default",
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [
                {"name": "daemon", "exactly": {
                    "deviceClassName": DEVICE_CLASS_DAEMON,
                    "allocationMode": "ExactCount", "count": 1}}],
                "config": config}}))
        # Daemon devices are unpublished in host-managed mode; hand-craft
        # an allocation to simulate a stale claim reaching Prepare.
        c = client.get("ResourceClaim", "dmn", "default")
        c.setdefault("status", {})["allocation"] = {"devices": {
            "results": [{"request": "daemon", "driver": CD_DRIVER_NAME,
                         "pool": "node-0", "device": "daemon"}],
            "config": config}}
        client.update_status(c)
        res = driver.prepare_resource_claims(
            [client.get("ResourceClaim", "dmn", "default")])
        err = res[c["metadata"]["uid"]].error
        assert err is not None and is_permanent(err)


class TestDaemonIndexCollision:
    """In an NVLink domain a daemon's index is its host index; a duplicate
    fails at the SOURCE (the publishing daemon goes NotReady on a
    conflict-free index) instead of corrupting the clique."""

    def _imposter(self, client, cd):
        return ComputeDomainDaemon(
            client=client, device_lib=MockDeviceLib(DOMAIN, host_index=0),
            cd_uid=cd["metadata"]["uid"], cd_name=cd["metadata"]["name"],
            node_name="node-imposter", hostname="imposter.example")

    def test_second_daemon_with_same_host_index_stays_not_ready(
            self, cluster):
        client, _, cd = cluster
        start_daemon(client, 0, cd)
        mine = self._imposter(client, cd).sync_once()
        assert mine.status == STATUS_NOT_READY
        assert mine.index != 0  # parked on a conflict-free index
        clique = client.list("ComputeDomainClique")[0]
        by_index = {}
        for d in clique_daemons(clique):
            assert d.index not in by_index, "duplicate index published"
            by_index[d.index] = d
        assert by_index[0].node_name == "node-0"
        assert by_index[0].status == STATUS_READY

    def test_parked_imposter_does_not_squat_legit_index(self, cluster):
        """The imposter parks OUTSIDE [0, clique_hosts), so the real node-1
        daemon still claims index 1 and goes Ready."""
        client, _, cd = cluster
        start_daemon(client, 0, cd)
        parked = self._imposter(client, cd).sync_once()
        assert parked.index >= 32  # dgx-h100-256: 32 nodes in the domain
        legit = start_daemon(client, 1, cd).sync_once()
        assert legit.index == 1 and legit.status == STATUS_READY

    def test_conflict_clears_when_holder_withdraws(self, cluster):
        client, _, cd = cluster
        d0 = start_daemon(client, 0, cd)
        dup = self._imposter(client, cd)
        assert dup.sync_once().status == STATUS_NOT_READY
        d0.withdraw()  # the real holder leaves (reconfigured)
        mine = dup.sync_once()
        assert mine.index == 0 and mine.status == STATUS_READY

    def test_hgx_nodes_each_take_index_0_of_their_own_clique(self, tmp_path):
        client, _, cd = make_cluster(tmp_path, "h100-8")
        for h in (0, 1):
            mine = start_daemon(client, h, cd, "h100-8").sync_once()
            assert mine.index == 0 and mine.status == STATUS_READY
            assert mine.topology == "8"
        assert len(client.list("ComputeDomainClique")) == 2


class TestDaemonHealth:
    def test_an_unhealthy_gpu_keeps_the_daemon_not_ready(self, cluster):
        client, _, cd = cluster
        lib = MockDeviceLib(DOMAIN, host_index=0)
        d = ComputeDomainDaemon(
            client=client, device_lib=lib, cd_uid=cd["metadata"]["uid"],
            cd_name="cd", node_name="node-0")
        lib.set_unhealthy(3, reason="xid 79")
        assert d.sync_once().status == STATUS_NOT_READY
        lib.set_healthy(3)
        assert d.sync_once().status == STATUS_READY

    def test_sync_failures_back_off_and_count(self, cluster):
        client, _, cd = cluster
        d = ComputeDomainDaemon(
            client=client, device_lib=MockDeviceLib(DOMAIN, host_index=0),
            cd_uid=cd["metadata"]["uid"], cd_name="cd", node_name="node-0")
        gauge = d.metrics.sync_consecutive_failures

        def wait(cond):
            deadline = time.monotonic() + 5.0
            while not cond():
                assert time.monotonic() < deadline
                time.sleep(0.01)

        d.start(interval=0.02)
        try:
            with faultpoints.injected("cd.daemon.sync=every:1"):
                wait(lambda: d.sync_consecutive_failures >= 2)
                assert gauge.value(node="node-0") >= 1
            wait(lambda: d.sync_consecutive_failures == 0)
        finally:
            d.stop()
        assert gauge.value(node="node-0") == 0
        # stop() withdrew the entry.
        assert client.list("ComputeDomainClique")[0]["daemons"] == []


class TestDaemonPodReadiness:
    """The daemon's own-pod watcher (podmanager.go:35-150 analogue): the
    kubelet's Ready condition is authoritative over local self-assessment."""

    def _pod(self, client, ready):
        pod = client.try_get("Pod", "daemon-pod", "default")
        if pod is None:
            pod = client.create(new_object("Pod", "daemon-pod", "default"))
        pod["status"] = {"conditions": [
            {"type": "Ready", "status": "True" if ready else "False"}]}
        return client.update_status(pod)

    def _wait_status(self, client, want):
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            clique = client.list("ComputeDomainClique")[0]
            mine = next(x for x in clique_daemons(clique)
                        if x.node_name == "node-0")
            if mine.status == want:
                return
            time.sleep(0.02)
        pytest.fail(f"entry never became {want}")

    def test_pod_readiness_gates_published_status(self, cluster):
        client, _, cd = cluster
        self._pod(client, ready=False)
        d = ComputeDomainDaemon(
            client=client, device_lib=MockDeviceLib(DOMAIN, host_index=0),
            cd_uid=cd["metadata"]["uid"], cd_name=cd["metadata"]["name"],
            node_name="node-0", pod_name="daemon-pod")
        d.start(interval=0.1)
        try:
            assert d.sync_once().status == STATUS_NOT_READY
            self._pod(client, ready=True)
            self._wait_status(client, STATUS_READY)
            self._pod(client, ready=False)
            self._wait_status(client, STATUS_NOT_READY)
        finally:
            d.stop()

    def test_no_pod_name_means_local_health_only(self, cluster):
        client, _, cd = cluster
        d = ComputeDomainDaemon(
            client=client, device_lib=MockDeviceLib(DOMAIN, host_index=0),
            cd_uid=cd["metadata"]["uid"], cd_name=cd["metadata"]["name"],
            node_name="node-0")
        assert d.sync_once().status == STATUS_READY


class TestAgainstJax:
    """The same two-node flow through both packages: the JAX plugin on two
    ``v5e-16`` hosts and the port's on two ``dgx-h100-256`` nodes, one
    clique each. Every step ends alike, and each node's channel env maps
    onto the JAX package's."""

    def _jax_side(self, tmp_path):
        client = JaxClient()
        for node in ("node-0", "node-1"):
            client.create(new_object("Node", node))
        cd = client.create(jax_new_compute_domain("cd", num_nodes=2))
        drivers = [JaxCdDriver(client, JaxCdDriverConfig(
            node_name=f"node-{h}", state_dir=str(tmp_path / f"js-{h}"),
            cdi_root=str(tmp_path / f"jc-{h}"), env={}, retry_timeout=0.4),
            device_lib=TpuMock("v5e-16", host_index=h)).start()
            for h in (0, 1)]

        def daemon(h):
            JaxDaemon(client=client,
                      device_lib=TpuMock("v5e-16", host_index=h),
                      cd_uid=cd["metadata"]["uid"], cd_name="cd",
                      node_name=f"node-{h}",
                      hostname=f"host-{h}.example").sync_once()
        return client, drivers, cd, daemon, JaxAllocator, jax_is_permanent

    def _port_side(self, tmp_path):
        client, drivers, cd = make_cluster(tmp_path / "port")

        def daemon(h):
            start_daemon(client, h, cd)
        return client, drivers, cd, daemon, Allocator, is_permanent

    def _flow(self, side, jax):
        client, drivers, cd, daemon, alloc, permanent = side
        kw = dict(api_version=JAX_API_VERSION,
                  driver="compute-domain.tpu.google.com",
                  channel_class="compute-domain-default-channel."
                                "tpu.google.com") if jax else {}
        if jax:
            for cls, kind in ((kw["channel_class"], "channel"),):
                client.create(new_object("DeviceClass", cls, spec={
                    "selectors": [{"cel": {"expression":
                        f"device.attributes['type'] == '{kind}'"}}]}))
        steps, envs = [], []
        claims = [alloc(client).allocate(client.create(new_object(
            "ResourceClaim", f"wl{h}", "default",
            api_version="resource.k8s.io/v1",
            spec=channel_spec(cd, h, **kw)))) for h in (0, 1)]
        uid0 = claims[0]["metadata"]["uid"]
        err = drivers[0].prepare_resource_claims([claims[0]])[uid0].error
        steps.append(("refused", err is not None, permanent(err)))
        labels = client.get("Node", "node-0")["metadata"].get("labels", {})
        steps.append(("labelled", any(
            v == cd["metadata"]["uid"] for v in labels.values())))
        daemon(0)
        err = drivers[0].prepare_resource_claims([claims[0]])[uid0].error
        steps.append(("partial", err is not None, permanent(err)))
        daemon(1)
        for h, claim in enumerate(claims):
            uid = claim["metadata"]["uid"]
            err = drivers[h].prepare_resource_claims([client.get(
                "ResourceClaim", f"wl{h}", "default")])[uid].error
            steps.append((f"prepared{h}", err))
            envs.append(claim_env(drivers[h], uid))
        for h, claim in enumerate(claims):
            ref = ClaimRef(uid=claim["metadata"]["uid"], name=f"wl{h}",
                           namespace="default")
            errs = drivers[h].unprepare_resource_claims([ref])
            steps.append((f"unprepared{h}", errs[ref.uid]))
        labels = client.get("Node", "node-0")["metadata"].get("labels", {})
        steps.append(("unlabelled", not any(
            v == cd["metadata"]["uid"] for v in labels.values())))
        return steps, envs

    def test_flow_and_env_match_jax(self, tmp_path):
        jax_steps, jax_envs = self._flow(self._jax_side(tmp_path), True)
        port_steps, port_envs = self._flow(self._port_side(tmp_path), False)
        assert port_steps == jax_steps
        assert [s[1:] for s in port_steps[:3]] == [(True, False), (True,),
                                                   (True, False)]
        for want, got in zip(jax_envs, port_envs):
            hosts = want["TPU_WORKER_HOSTNAMES"].split(",")
            assert (got["MASTER_ADDR"], got["NNODES"], got["NODE_RANK"]) \
                == (hosts[0], str(len(hosts)), want["TPU_WORKER_ID"])
            assert got["COMPUTE_DOMAIN_CHANNELS"] == \
                want["TPU_COMPUTE_DOMAIN_CHANNELS"]


def test_the_smokes_phase_on_a_mock_node(tmp_path, monkeypatch, capsys):
    """``chip_smoke.phase_computedomain`` as the card runs it, on a mock
    node of eight GPUs: refused before Ready, prepared after, the env of a
    one-node domain, and a teardown that leaves nothing."""
    import chip_smoke
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    env, teardown = chip_smoke.phase_computedomain(
        "mock", MockDeviceLib("h100-8"), str(tmp_path))
    assert {k: env[k] for k in ("MASTER_ADDR", "MASTER_PORT", "NNODES",
                                "NODE_RANK")} == {
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(MASTER_PORT),
        "NNODES": "1", "NODE_RANK": "0"}
    teardown()
    out = capsys.readouterr().out
    assert "cd_ready_ms=" in out and "channel_ready_ms=" in out
    assert "residue=[]" in out
