"""The GPU port's node failure domains: liveness leases and node epochs,
the cluster-side fence → cordon → drain → uncordon pipeline, partition
fencing on the client surface, the node-side voluntary cordon drain, fence
cleanup on the GPU plugin, and chaos coverage for the leader elector.

The scenarios of the JAX package's ``tests/test_nodelease.py``, every
class, on the port's ``h100-8`` mock; ``TestAgainstJax`` drives one
seeded lease expiry → fence → cordon → uncordon through both packages.
"""

import json
import time

import numpy as np
import pytest

from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxFakeClient
from k8s_dra_driver_tpu.k8sclient.client import new_object as jax_new_object
from k8s_dra_driver_tpu.pkg import nodelease as jax_nodelease
from k8s_dra_driver_tpu.pkg.events import list_events as jax_list_events
from k8s_dra_driver_tpu.pkg.metrics import NodeMetrics as JaxNodeMetrics

from k8s_dra_driver_tpu_torch.k8sclient import (
    FakeClient,
    PartitionedClient,
    PartitionError,
    PartitionGate,
)
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
    ANN_DRAIN,
    ClaimReallocator,
    DrainController,
)
from k8s_dra_driver_tpu_torch.pkg import bootid, faultpoints, nodelease
from k8s_dra_driver_tpu_torch.pkg.events import (
    REASON_NODE_CORDONED,
    REASON_NODE_FENCED,
    REASON_NODE_UNCORDONED,
    list_events,
)
from k8s_dra_driver_tpu_torch.pkg.metrics import NodeMetrics
from k8s_dra_driver_tpu_torch.pkg.nodelease import (
    ANN_CORDON,
    KIND_LEASE,
    LEASE_NAMESPACE,
    TAINT_KEY_CORDON,
    NodeLeaseHeartbeat,
    NodeLifecycleController,
    clear_cordon_request,
    fence_cleanup_for,
    next_node_epoch,
    node_lease_name,
    request_cordon,
    scraper_staleness_signal,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.election import (
    LeaderElector,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.healthcheck import (
    STATUS_SERVING,
    driver_probe,
)
from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib

DRIVER = "gpu.nvidia.com"


def _lease(client, node):
    return client.try_get(KIND_LEASE, node_lease_name(node),
                          LEASE_NAMESPACE)


# --------------------------------------------------------------------------
# Node epochs
# --------------------------------------------------------------------------

class TestNodeEpoch:
    def test_bumps_on_every_restart_and_persists(self, tmp_path):
        sd = str(tmp_path / "state")
        e1, _ = next_node_epoch(sd)
        e2, _ = next_node_epoch(sd)
        e3, _ = next_node_epoch(sd)
        assert (e1, e2, e3) == (1, 2, 3)
        with open(tmp_path / "state" / "node-epoch.json") as f:
            assert json.load(f)["epoch"] == 3

    def test_no_state_dir_starts_at_one(self):
        epoch, _ = next_node_epoch(None)
        assert epoch == 1

    def test_torn_file_recovers(self, tmp_path):
        sd = str(tmp_path)
        (tmp_path / "node-epoch.json").write_text("{torn")
        epoch, _ = next_node_epoch(sd)
        assert epoch == 1
        assert next_node_epoch(sd)[0] == 2

    def test_records_boot_id(self, tmp_path):
        boot = tmp_path / "boot"
        boot.write_text("boot-A\n")
        env = {bootid.ENV_ALT_BOOT_ID_PATH: str(boot)}
        _, got = next_node_epoch(str(tmp_path / "sd"), env)
        assert got == "boot-A"


# --------------------------------------------------------------------------
# Heartbeat
# --------------------------------------------------------------------------

class TestHeartbeat:
    def test_creates_then_renews(self):
        client = FakeClient()
        clock = [100.0]
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                clock=lambda: clock[0],
                                metrics=NodeMetrics())
        assert hb.renew_once()
        spec = _lease(client, "n0")["spec"]
        assert spec["holderIdentity"] == "n0"
        assert spec["nodeEpoch"] == 1
        assert spec["renewTime"] == 100.0
        clock[0] = 105.0
        assert hb.renew_once()
        assert _lease(client, "n0")["spec"]["renewTime"] == 105.0
        assert hb.renewals == 2
        assert hb.metrics.lease_renewals_total.value(node="n0") == 2

    def test_epoch_tie_after_torn_write_converges_to_max(self):
        """Two writers of the same per-node lease (the GPU and CD plugin
        mains) with different epochs: the LARGER epoch wins on both
        sides, so a torn write can never see-saw the lease epoch."""
        client = FakeClient()
        a = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0)
        b = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0)
        b.epoch = 7  # the companion restarted more often
        assert a.renew_once()
        assert b.renew_once()
        assert _lease(client, "n0")["spec"]["nodeEpoch"] == 7
        assert a.renew_once()  # a adopts rather than rolling back
        assert a.epoch == 7
        assert _lease(client, "n0")["spec"]["nodeEpoch"] == 7

    def test_suspect_when_renewals_stop(self):
        client = FakeClient()
        clock = [0.0]
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=5.0,
                                clock=lambda: clock[0])
        assert hb.renew_once()
        assert not hb.suspect
        clock[0] += 5.1  # no renew landed for > lease_duration
        assert hb.suspect

    def test_start_does_synchronous_first_renew(self):
        client = FakeClient()
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=5.0,
                                renew_interval=60.0).start()
        try:
            assert _lease(client, "n0") is not None
            assert not hb.suspect
        finally:
            hb.stop()


# --------------------------------------------------------------------------
# Fencing
# --------------------------------------------------------------------------

def _stamp_fence(client, node, epoch=1):
    lease = _lease(client, node)
    lease["spec"]["fencedEpoch"] = epoch
    client.update(lease)


class TestFencing:
    def test_fence_detected_cleanup_runs_then_cleared(self):
        client = FakeClient()
        cleaned = []
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                fence_cleanup=lambda: cleaned.append(1))
        assert hb.renew_once()
        _stamp_fence(client, "n0")
        assert hb.renew_once()
        assert cleaned == [1]
        assert not hb.fenced
        assert hb.fence_recoveries == 1
        assert "fencedEpoch" not in _lease(client, "n0")["spec"]

    def test_cleanup_failure_keeps_fence_standing(self):
        client = FakeClient()

        def boom():
            raise RuntimeError("still partitioned from the checkpoint?")

        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                fence_cleanup=boom)
        assert hb.renew_once()
        _stamp_fence(client, "n0")
        assert hb.renew_once()
        assert hb.fenced
        assert hb.fence_recoveries == 0
        assert _lease(client, "n0")["spec"]["fencedEpoch"] == 1

    def test_restart_during_partition_still_fenced_until_cleared(self,
                                                                 tmp_path):
        """The fence is an acknowledgment protocol, not an epoch
        comparison: a plugin that RESTARTED during the partition renews
        with a bumped epoch — newer than fencedEpoch — and must STILL be
        fenced until its cleanup runs, because the stale checkpoint
        state survived the restart too."""
        client = FakeClient()
        sd = str(tmp_path / "state")
        hb1 = NodeLeaseHeartbeat(client, "n0", state_dir=sd,
                                 lease_duration=10.0)
        assert hb1.renew_once()
        _stamp_fence(client, "n0", epoch=hb1.epoch)
        # Restart: new heartbeat, bumped epoch, but NO cleanup hook —
        # without an ack the fence must stand.
        hb2 = NodeLeaseHeartbeat(client, "n0", state_dir=sd,
                                 lease_duration=10.0)
        assert hb2.epoch > hb1.epoch
        assert hb2.renew_once()
        assert hb2.fenced
        assert "fencedEpoch" in _lease(client, "n0")["spec"]
        # With a cleanup hook the NEXT renewal acks and clears it.
        hb2.fence_cleanup = lambda: None
        assert hb2.renew_once()
        assert not hb2.fenced
        assert "fencedEpoch" not in _lease(client, "n0")["spec"]

    def test_fence_requires_every_renewing_identity_to_ack(self):
        """Production shape: the GPU and CD plugins each run their own
        heartbeat with a cleanup covering only their own driver. The
        controller stamps the renewing identities at fence time, and the
        FIRST plugin back must not clear the fence out from under its
        sibling's still-dirty checkpoints — fencedEpoch falls off only
        when the LAST identity acks."""
        client = FakeClient()
        gpu_clean, cd_clean = [], []
        gpu = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                 identity="gpu-kubelet-plugin",
                                 fence_cleanup=lambda: gpu_clean.append(1))
        cd = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                identity="compute-domain-kubelet-plugin",
                                fence_cleanup=lambda: cd_clean.append(1))
        assert gpu.renew_once()
        assert cd.renew_once()
        # Controller-style fence: identities snapshotted from renewers.
        lease = _lease(client, "n0")
        lease["spec"]["fencedEpoch"] = 1
        lease["spec"]["fencedIdentities"] = sorted(
            lease["spec"]["renewers"])
        client.update(lease)
        # GPU back first: its cleanup ran and IT may serve again, but
        # the fence stands for the CD plugin.
        assert gpu.renew_once()
        assert gpu_clean == [1]
        assert not gpu.fenced
        spec = _lease(client, "n0")["spec"]
        assert spec["fencedEpoch"] == 1
        assert spec["fencedIdentities"] == ["compute-domain-kubelet-plugin"]
        # CD back: last ack drops the fence entirely.
        assert cd.renew_once()
        assert cd_clean == [1]
        assert not cd.fenced
        spec = _lease(client, "n0")["spec"]
        assert "fencedEpoch" not in spec
        assert "fencedIdentities" not in spec

    def test_lost_create_race_takes_update_path_immediately(self):
        """The plugin that loses the lease-creation race must renew via
        the update path in the SAME round — not start life suspect
        (claim loop deferring, NOT_SERVING) for a whole renew interval."""
        client = FakeClient()

        class RacingClient:
            """First try_get sees no lease; a companion creates it just
            before our create lands — the classic cold-start race."""

            def __init__(self, inner):
                self._inner = inner
                self._first = True

            def try_get(self, kind, name, namespace=""):
                if self._first:
                    self._first = False
                    return None
                return self._inner.try_get(kind, name, namespace)

            def __getattr__(self, name):
                return getattr(self._inner, name)

        winner = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                    identity="gpu-kubelet-plugin")
        assert winner.renew_once()
        loser = NodeLeaseHeartbeat(RacingClient(client), "n0",
                                   lease_duration=10.0,
                                   identity="compute-domain-kubelet-plugin")
        assert loser.renew_once()  # one round, despite the lost race
        assert not loser.suspect
        assert set(_lease(client, "n0")["spec"]["renewers"]) == {
            "gpu-kubelet-plugin", "compute-domain-kubelet-plugin"}

    def test_clear_fence_idempotent(self):
        client = FakeClient()
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0)
        assert hb.renew_once()
        assert hb.clear_fence()  # nothing stamped: moot, not an error
        _stamp_fence(client, "n0")
        assert hb.clear_fence()
        assert hb.clear_fence()
        assert "fencedEpoch" not in _lease(client, "n0")["spec"]


# --------------------------------------------------------------------------
# Partitioned client
# --------------------------------------------------------------------------

class TestPartitionedClient:
    def test_gate_severs_every_verb_and_is_injected(self):
        client = FakeClient()
        client.create(new_object("Node", "n0"))
        gate = PartitionGate()
        pc = PartitionedClient(client, "n0", gate=gate)
        assert pc.get("Node", "n0")  # healthy passthrough
        gate.partition("n0")
        for call in (lambda: pc.get("Node", "n0"),
                     lambda: pc.list("Node"),
                     lambda: pc.create(new_object("Node", "n1")),
                     lambda: pc.update(client.get("Node", "n0")),
                     lambda: pc.delete("Node", "n0"),
                     lambda: pc.watch("Node")):
            with pytest.raises(PartitionError) as ei:
                call()
            assert faultpoints.is_injected(ei.value)
        gate.heal("n0")
        assert pc.get("Node", "n0")

    def test_partition_only_cuts_its_own_node(self):
        client = FakeClient()
        client.create(new_object("Node", "n0"))
        gate = PartitionGate()
        pc0 = PartitionedClient(client, "n0", gate=gate)
        pc1 = PartitionedClient(client, "n1", gate=gate)
        gate.partition("n0")
        with pytest.raises(PartitionError):
            pc0.get("Node", "n0")
        assert pc1.get("Node", "n0")  # the other node keeps its network

    def test_live_watch_dies_when_partitioned(self):
        client = FakeClient()
        gate = PartitionGate()
        pc = PartitionedClient(client, "n0", gate=gate)
        w = pc.watch("Node")
        client.create(new_object("Node", "n0"))
        ev = w.next(timeout=1.0)
        assert ev is not None and ev.type == "ADDED"
        gate.partition("n0")
        assert w.next(timeout=0.1) is None
        assert not w.alive  # the informer's reconnect path takes over

    def test_fault_point_schedule_fires(self):
        """The ``k8sclient.partition`` point in schedule position
        (DL205): one scheduled hit fails one verb on a wrapped client,
        gate or no gate."""
        client = FakeClient()
        client.create(new_object("Node", "n0"))
        pc = PartitionedClient(client, "n0")
        with faultpoints.injected("k8sclient.partition=nth:1"):
            with pytest.raises(PartitionError):
                pc.get("Node", "n0")
            assert pc.get("Node", "n0")  # hit 2: healed


# --------------------------------------------------------------------------
# Node lifecycle controller
# --------------------------------------------------------------------------

def _cluster(n_devices=2):
    """FakeClient + lease + Node + slice + one allocated claim on n0."""
    client = FakeClient()
    client.create(new_object("Node", "n0"))
    client.create({
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
        "metadata": {"name": "s0"},
        "spec": {"driver": DRIVER, "nodeName": "n0",
                 "pool": {"name": "n0", "generation": 1,
                          "resourceSliceCount": 1},
                 "devices": [{"name": f"gpu-{i}"}
                             for i in range(n_devices)]}})
    client.create(new_object(
        "ResourceClaim", "c0", "default",
        api_version="resource.k8s.io/v1",
        status={"allocation": {"devices": {"results": [
            {"driver": DRIVER, "pool": "n0", "device": "gpu-0"}]}}}))
    return client


class TestNodeLifecycleController:
    def test_fresh_lease_never_cordoned(self):
        client = _cluster()
        clock = [0.0]
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                clock=lambda: clock[0])
        assert hb.renew_once()
        ctl = NodeLifecycleController(client, clock=lambda: clock[0])
        clock[0] += 9.0
        assert ctl.poll_once() == {"cordoned": 0, "uncordoned": 0}
        assert ctl.cordoned_nodes() == []

    def test_clock_skew_future_renewtime_tolerated(self):
        """A renewTime ahead of the controller's clock (node clock skew)
        reads as freshly renewed — no crash, no instant cordon."""
        client = _cluster()
        clock = [100.0]
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                clock=lambda: clock[0] + 30.0)  # skewed
        assert hb.renew_once()
        ctl = NodeLifecycleController(client, clock=lambda: clock[0])
        assert ctl.poll_once() == {"cordoned": 0, "uncordoned": 0}
        clock[0] += 14.0  # still inside 1.5x duration RELATIVE TO skew
        assert ctl.poll_once()["cordoned"] == 0

    def test_cordon_pipeline_end_to_end(self):
        client = _cluster()
        clock = [0.0]
        metrics = NodeMetrics()
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                clock=lambda: clock[0])
        assert hb.renew_once()
        ctl = NodeLifecycleController(client, clock=lambda: clock[0],
                                      metrics=metrics)
        clock[0] += 16.0  # > 1.5 x 10
        assert ctl.poll_once()["cordoned"] == 1
        assert ctl.cordoned_nodes() == ["n0"]
        # Fence stamped with the node's epoch.
        assert _lease(client, "n0")["spec"]["fencedEpoch"] == hb.epoch
        # Every device tainted NoSchedule.
        for dev in client.get("ResourceSlice", "s0")["spec"]["devices"]:
            assert any(t["key"] == TAINT_KEY_CORDON
                       and t["effect"] == "NoSchedule"
                       for t in dev["taints"])
        # Node annotated; claim handed to the reallocator.
        assert ANN_CORDON in client.get("Node", "n0")["metadata"][
            "annotations"]
        assert ANN_DRAIN in client.get("ResourceClaim", "c0", "default")[
            "metadata"]["annotations"]
        # Events + metric.
        assert list_events(client, reason=REASON_NODE_FENCED)
        assert list_events(client, reason=REASON_NODE_CORDONED)
        assert metrics.cordons_total.value(reason="node-lost") == 1

    def test_double_cordon_is_idempotent(self):
        client = _cluster()
        clock = [0.0]
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                clock=lambda: clock[0])
        assert hb.renew_once()
        ctl = NodeLifecycleController(client, clock=lambda: clock[0])
        clock[0] += 16.0
        assert ctl.poll_once()["cordoned"] == 1
        # Replay the whole cordon against already-cordoned state (the
        # crashed-mid-cordon poll retry path).
        st = ctl._nodes["n0"]
        ctl._cordon("n0", _lease(client, "n0")["spec"], st)
        dev = client.get("ResourceSlice", "s0")["spec"]["devices"][0]
        assert len([t for t in dev["taints"]
                    if t["key"] == TAINT_KEY_CORDON]) == 1
        anns = client.get("Node", "n0")["metadata"]["annotations"]
        assert list(anns) == [ANN_CORDON]
        # The original fence stamp survives the replay.
        assert _lease(client, "n0")["spec"]["fencedEpoch"] == hb.epoch

    def test_uncordon_requires_renewal_and_fence_clear(self):
        client = _cluster()
        clock = [0.0]
        metrics = NodeMetrics()
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                clock=lambda: clock[0])
        assert hb.renew_once()
        ctl = NodeLifecycleController(client, clock=lambda: clock[0],
                                      metrics=metrics)
        clock[0] += 16.0
        assert ctl.poll_once()["cordoned"] == 1
        # Heartbeat resumes (no cleanup hook yet): fence stands, so the
        # node must NOT be uncordoned on renewal alone.
        assert hb.renew_once()
        assert hb.fenced
        assert ctl.poll_once()["uncordoned"] == 0
        assert ctl.cordoned_nodes() == ["n0"]
        # Cleanup ack: fence cleared → uncordon on the next poll.
        hb.fence_cleanup = lambda: None
        assert hb.renew_once()
        assert not hb.fenced
        assert ctl.poll_once()["uncordoned"] == 1
        assert ctl.cordoned_nodes() == []
        for dev in client.get("ResourceSlice", "s0")["spec"]["devices"]:
            assert not any(t.get("key") == TAINT_KEY_CORDON
                           for t in dev.get("taints") or [])
        assert ANN_CORDON not in (client.get("Node", "n0")["metadata"]
                                  .get("annotations") or {})
        assert list_events(client, reason=REASON_NODE_UNCORDONED)
        assert metrics.fence_seconds.count(node="n0") == 1

    def test_repair_hook_called_until_truthy_then_stops(self):
        client = _cluster()
        clock = [0.0]
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                clock=lambda: clock[0])
        assert hb.renew_once()
        calls = []

        def repair(node):
            calls.append(node)
            return len(calls) >= 2  # pending once, then done

        ctl = NodeLifecycleController(client, clock=lambda: clock[0],
                                      repair=repair)
        clock[0] += 16.0
        ctl.poll_once()   # cordon
        ctl.poll_once()   # repair attempt 1 (pending)
        ctl.poll_once()   # repair attempt 2 (done)
        ctl.poll_once()   # repair_needed cleared: no more calls
        assert calls == ["n0", "n0"]

    def test_scrape_staleness_corroborates_never_decides(self):
        """A stale scrape target tightens detection to one lease
        duration; a stale target with a FRESH lease never cordons."""
        client = _cluster()
        clock = [0.0]
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                clock=lambda: clock[0])
        assert hb.renew_once()
        stale = [True]
        ctl = NodeLifecycleController(
            client, clock=lambda: clock[0],
            scrape_stale=lambda node: stale[0])
        # Fresh lease + stale scrape: never sufficient alone.
        assert ctl.poll_once()["cordoned"] == 0
        # Lease expired 1.2x (inside the uncorroborated 1.5x window):
        # the corroborated factor (1.0) cordons NOW...
        clock[0] += 12.0
        uncorroborated = NodeLifecycleController(
            client, clock=lambda: clock[0])
        assert uncorroborated.poll_once()["cordoned"] == 0
        assert ctl.poll_once()["cordoned"] == 1

    def test_uncordon_preserves_operator_cordon_request(self):
        """An operator's standing voluntary cordon (requested BEFORE the
        node died, so the node-lost cordon kept the annotation) must
        survive the lifecycle uncordon — explicit operator intent is
        never erased by automation."""
        client = _cluster()
        clock = [0.0]
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                clock=lambda: clock[0])
        assert hb.renew_once()
        assert request_cordon(client, "n0")  # operator intent
        ctl = NodeLifecycleController(client, clock=lambda: clock[0])
        clock[0] += 16.0
        assert ctl.poll_once()["cordoned"] == 1
        hb.fence_cleanup = lambda: None
        assert hb.renew_once()
        assert ctl.poll_once()["uncordoned"] == 1
        anns = client.get("Node", "n0")["metadata"].get("annotations") or {}
        assert ANN_CORDON in anns  # the request stands
        assert json.loads(anns[ANN_CORDON])["reason"] == \
            nodelease.CORDON_REQUESTED
        # Cordon taints still come off: only the annotation is preserved.
        for dev in client.get("ResourceSlice", "s0")["spec"]["devices"]:
            assert not any(t.get("key") == TAINT_KEY_CORDON
                           for t in dev.get("taints") or [])

    def test_controller_restart_adopts_existing_cordon(self):
        """A controller restarted in the heal window (node cordoned by a
        previous incarnation, lease renewing again) must adopt the
        durable cordon state and run the uncordon — not orphan it."""
        client = _cluster()
        clock = [0.0]
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                clock=lambda: clock[0])
        assert hb.renew_once()
        first = NodeLifecycleController(client, clock=lambda: clock[0])
        clock[0] += 16.0
        assert first.poll_once()["cordoned"] == 1
        # The node heals; the controller process restarts (fresh state).
        hb.fence_cleanup = lambda: None
        assert hb.renew_once()
        assert not hb.fenced
        restarted = NodeLifecycleController(client, clock=lambda: clock[0])
        assert restarted.poll_once()["uncordoned"] == 1
        assert ANN_CORDON not in (client.get("Node", "n0")["metadata"]
                                  .get("annotations") or {})
        for dev in client.get("ResourceSlice", "s0")["spec"]["devices"]:
            assert not any(t.get("key") == TAINT_KEY_CORDON
                           for t in dev.get("taints") or [])

    def test_controller_restart_mid_heal_with_fence_still_standing(self):
        """Restart while the lease renews but the fence is NOT yet
        cleared: the adopted cordon must wait for the fence, exactly as
        the original controller would."""
        client = _cluster()
        clock = [0.0]
        hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                                clock=lambda: clock[0])
        assert hb.renew_once()
        first = NodeLifecycleController(client, clock=lambda: clock[0])
        clock[0] += 16.0
        assert first.poll_once()["cordoned"] == 1
        assert hb.renew_once()  # renewing again, fence stands (no hook)
        restarted = NodeLifecycleController(client, clock=lambda: clock[0])
        assert restarted.poll_once() == {"cordoned": 0, "uncordoned": 0}
        assert restarted.cordoned_nodes() == ["n0"]  # adopted, waiting
        hb.fence_cleanup = lambda: None
        assert hb.renew_once()
        assert restarted.poll_once()["uncordoned"] == 1

    def test_scraper_staleness_signal_adapter(self):
        class FakeScraper:
            def target_report(self):
                return [{"name": "n0", "stale": True},
                        {"name": "n1", "stale": False}]

        sig = scraper_staleness_signal(FakeScraper())
        assert sig("n0") is True
        assert sig("n1") is False
        assert sig("unknown") is False


# --------------------------------------------------------------------------
# Fence cleanup on the GPU plugin
# --------------------------------------------------------------------------

def _gpu_stack(tmp_path, client=None):
    client = client or FakeClient()
    if client.try_get("DeviceClass", "gpu.nvidia.com") is None:
        client.create(new_object(
            "DeviceClass", "gpu.nvidia.com",
            spec={"selectors": [{"cel": {
                "expression": "device.attributes['type'] == 'gpu'"}}]}))
    client.create(new_object("Node", "node-a"))
    driver = GpuDriver(client, DriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "state"),
        cdi_root=str(tmp_path / "cdi"), env={}, retry_timeout=1.0,
    ), device_lib=MockDeviceLib("h100-8")).start()
    return client, driver


def _make_prepared(client, driver, alloc, name):
    claim = client.create(new_object(
        "ResourceClaim", name, "default",
        api_version="resource.k8s.io/v1",
        spec={"devices": {"requests": [{
            "name": "gpu", "exactly": {
                "deviceClassName": "gpu.nvidia.com",
                "allocationMode": "ExactCount", "count": 1}}]}}))
    allocated = alloc.allocate(claim, node="node-a")
    uid = allocated["metadata"]["uid"]
    res = driver.prepare_resource_claims([allocated])[uid]
    assert res.error is None
    return allocated


class TestFenceCleanup:
    def test_unprepares_moved_claims_keeps_live_ones(self, tmp_path):
        client, driver = _gpu_stack(tmp_path)
        alloc = Allocator(client)
        moved = _make_prepared(client, driver, alloc, "moved")
        kept = _make_prepared(client, driver, alloc, "kept")
        gone = _make_prepared(client, driver, alloc, "gone")
        # "moved": the reallocator re-bound it to another node while we
        # were partitioned. "gone": deleted outright.
        fresh = client.get("ResourceClaim", "moved", "default")
        fresh["status"]["allocation"]["devices"]["results"] = [
            {"driver": DRIVER, "pool": "node-b", "device": "gpu-0"}]
        client.update_status(fresh)
        client.delete("ResourceClaim", "gone", "default")

        fence_cleanup_for(driver, client)()

        prepared = driver.state.prepared_claims_nolock()
        assert kept["metadata"]["uid"] in prepared
        assert moved["metadata"]["uid"] not in prepared
        assert gone["metadata"]["uid"] not in prepared
        assert set(driver.cdi.list_claim_uids()) == {
            kept["metadata"]["uid"]}

    def test_replaced_uid_is_stale(self, tmp_path):
        """Same name, different uid (delete + recreate while gone): the
        checkpointed prepare belongs to the OLD uid and must go."""
        client, driver = _gpu_stack(tmp_path)
        alloc = Allocator(client)
        old = _make_prepared(client, driver, alloc, "c")
        client.delete("ResourceClaim", "c", "default")
        client.create(new_object(
            "ResourceClaim", "c", "default",
            api_version="resource.k8s.io/v1",
            status={"allocation": {"devices": {"results": [
                {"driver": DRIVER, "pool": "node-a",
                 "device": "gpu-0"}]}}}))
        fence_cleanup_for(driver, client)()
        assert old["metadata"]["uid"] not in \
            driver.state.prepared_claims_nolock()


# --------------------------------------------------------------------------
# Voluntary cordon: node-scope drain through the DrainController
# --------------------------------------------------------------------------

class TestVoluntaryCordon:
    def test_request_cordon_drains_node_then_uncordons(self, tmp_path):
        client, driver = _gpu_stack(tmp_path)
        alloc = Allocator(client)
        claim = _make_prepared(client, driver, alloc, "held")
        drainer = DrainController(client, driver, poll_interval=0.05)
        def probe():
            return driver_probe(driver, drainer=drainer) == STATUS_SERVING

        assert probe()

        assert request_cordon(client, "node-a")
        counts = drainer.poll_once()
        assert counts["drained"] == 1
        assert drainer.draining and drainer.node_draining
        assert not probe()  # NOT_SERVING while node-draining
        assert driver.cordoned
        # Every published device carries the cordon taint.
        for slc in client.list("ResourceSlice"):
            for dev in slc["spec"]["devices"]:
                assert any(t["key"] == TAINT_KEY_CORDON
                           for t in dev.get("taints") or [])
        # The drained claim is tombstoned and handed to the reallocator.
        anns = client.get("ResourceClaim", "held", "default")[
            "metadata"]["annotations"]
        assert ANN_DRAIN in anns
        assert claim["metadata"]["uid"] not in {
            uid for uid, pc in
            driver.state.prepared_claims_nolock().items()
            if pc.state == "PrepareCompleted"}

        # Operator clears the request: devices rejoin, serving resumes.
        assert clear_cordon_request(client, "node-a")
        drainer.poll_once()
        assert not drainer.node_draining
        assert not driver.cordoned
        assert probe()
        for slc in client.list("ResourceSlice"):
            for dev in slc["spec"]["devices"]:
                assert not any(t.get("key") == TAINT_KEY_CORDON
                               for t in dev.get("taints") or [])
        assert list_events(client, reason=REASON_NODE_CORDONED)
        assert list_events(client, reason=REASON_NODE_UNCORDONED)

    def test_request_cordon_overwrites_node_lost_annotation(self):
        """An operator cordoning an already node-lost-cordoned node must
        have the request RECORDED (the node-lost annotation is
        automation's, the request is intent that outlives the heal) —
        not silently dropped behind a success return."""
        client = FakeClient()
        client.create(new_object("Node", "n0"))
        request_cordon(client, "n0", reason=nodelease.CORDON_NODE_LOST)
        assert request_cordon(client, "n0")
        ann = nodelease.cordon_annotation(client, "n0")
        assert ann["reason"] == nodelease.CORDON_REQUESTED
        # Idempotent: a standing request is never re-stamped.
        before = client.get("Node", "n0")["metadata"]["annotations"]
        assert request_cordon(client, "n0")
        assert client.get("Node", "n0")["metadata"]["annotations"] == before

    def test_idempotent_while_requested(self, tmp_path):
        client, driver = _gpu_stack(tmp_path)
        drainer = DrainController(client, driver, poll_interval=0.05)
        request_cordon(client, "node-a")
        drainer.poll_once()
        drainer.poll_once()  # steady state: no flapping republished taints
        assert drainer.node_drains == 1
        assert driver.cordoned

    def test_cordoned_node_excluded_from_allocation(self, tmp_path):
        client, driver = _gpu_stack(tmp_path)
        drainer = DrainController(client, driver, poll_interval=0.05)
        request_cordon(client, "node-a")
        drainer.poll_once()
        alloc = Allocator(client)
        claim = client.create(new_object(
            "ResourceClaim", "c", "default",
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{
                "name": "gpu", "exactly": {
                    "deviceClassName": "gpu.nvidia.com",
                    "allocationMode": "ExactCount", "count": 1}}]}}))
        from k8s_dra_driver_tpu_torch.kubeletplugin import AllocationError
        with pytest.raises(AllocationError):
            alloc.allocate(claim, node="node-a")

    def test_uncordon_retries_after_failed_republish(self, tmp_path):
        """A clear_cordon whose republish fails (restoring the driver's
        cordon flag) must be retried on the next poll — the uncordon is
        driven by the drivers' cordon state, not a consumed edge."""
        client, driver = _gpu_stack(tmp_path)
        drainer = DrainController(client, driver, poll_interval=0.05)
        request_cordon(client, "node-a")
        drainer.poll_once()
        assert driver.cordoned
        clear_cordon_request(client, "node-a")
        real = driver.republish
        calls = [0]

        def flaky_republish():
            calls[0] += 1
            if calls[0] == 1:
                raise RuntimeError("transient publish failure")
            real()

        driver.republish = flaky_republish
        drainer.poll_once()  # uncordon attempt: republish fails
        assert driver.cordoned  # flag restored by clear_cordon
        drainer.poll_once()  # RETRIED despite the consumed edge
        assert not driver.cordoned
        for slc in client.list("ResourceSlice"):
            for dev in slc["spec"]["devices"]:
                assert not any(t.get("key") == TAINT_KEY_CORDON
                               for t in dev.get("taints") or [])

    def test_node_lost_annotation_is_not_a_voluntary_drain(self, tmp_path):
        """A controller-written node-lost cordon is the fence path's
        business — the node-side controller must not ALSO start a
        voluntary drain when it comes back and reads the annotation."""
        client, driver = _gpu_stack(tmp_path)
        drainer = DrainController(client, driver, poll_interval=0.05)
        request_cordon(client, "node-a",
                       reason=nodelease.CORDON_NODE_LOST)
        drainer.poll_once()
        assert not drainer.node_draining
        assert not driver.cordoned


# --------------------------------------------------------------------------
# Fence gate on the claim loop
# --------------------------------------------------------------------------

class TestClaimLoopFenceGate:
    def test_fenced_loop_defers_until_cleared(self, tmp_path):
        client, driver = _gpu_stack(tmp_path)
        fenced = [True]
        loop = NodePrepareLoop(client, driver, DRIVER, "node-a",
                               namespace="default", retry_delay=0.05,
                               fence=lambda: fenced[0]).start()
        try:
            alloc = Allocator(client)
            claim = client.create(new_object(
                "ResourceClaim", "c", "default",
                api_version="resource.k8s.io/v1",
                spec={"devices": {"requests": [{
                    "name": "gpu", "exactly": {
                        "deviceClassName": "gpu.nvidia.com",
                        "allocationMode": "ExactCount", "count": 1}}]}}))
            alloc.allocate(claim, reserved_for=[
                {"resource": "pods", "name": "p"}], node="node-a")
            uid = client.get("ResourceClaim", "c",
                             "default")["metadata"]["uid"]
            time.sleep(0.3)
            assert uid not in driver.state.prepared_claims_nolock()
            fenced[0] = False  # fence cleanup done: the retry acts
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if uid in driver.state.prepared_claims_nolock():
                    break
                time.sleep(0.02)
            assert uid in driver.state.prepared_claims_nolock()
        finally:
            loop.stop()


# --------------------------------------------------------------------------
# Election chaos (satellite): the elector under verb faults + partition
# --------------------------------------------------------------------------

class TestElectionChaos:
    def _elector(self, client, ident, clock):
        return LeaderElector(
            client, "election-chaos", ident,
            lease_duration=10.0, renew_deadline=6.0, retry_period=1.0,
            clock=lambda: clock[0])

    def test_verb_faults_never_two_leaders(self):
        """Seeded API-verb chaos over many rounds: leadership may bounce
        but is NEVER held by two candidates at once, and a candidate
        holds it again within a lease duration once injection stops."""
        client = FakeClient()
        clock = [0.0]
        a = self._elector(client, "a", clock)
        b = self._elector(client, "b", clock)
        with faultpoints.injected(
                "k8sclient.fake.mutate=rate:0.3;"
                "k8sclient.fake.read=rate:0.2", seed=11):
            for _ in range(120):
                clock[0] += 1.0
                a.run_once()
                b.run_once()
                assert not (a.is_leader and b.is_leader)
        # Chaos over: steady single leadership within one lease duration.
        for _ in range(11):
            clock[0] += 1.0
            a.run_once()
            b.run_once()
            assert not (a.is_leader and b.is_leader)
        assert a.is_leader or b.is_leader

    def test_partition_transfers_leadership_within_bound(self):
        """Partition the leader's client: it must step down within its
        renew deadline (BEFORE the lease expires — no overlap window)
        and the follower must acquire within the lease duration + one
        retry period of the partition starting."""
        client = FakeClient()
        clock = [0.0]
        gate = PartitionGate()
        a = LeaderElector(
            PartitionedClient(client, "ctrl-a", gate=gate),
            "election-part", "a",
            lease_duration=10.0, renew_deadline=6.0, retry_period=1.0,
            clock=lambda: clock[0])
        b = LeaderElector(
            client, "election-part", "b",
            lease_duration=10.0, renew_deadline=6.0, retry_period=1.0,
            clock=lambda: clock[0])
        a.run_once()
        b.run_once()
        assert a.is_leader and not b.is_leader
        gate.partition("ctrl-a")
        t_part = clock[0]
        transferred_at = None
        for _ in range(14):
            clock[0] += 1.0
            a.run_once()
            b.run_once()
            assert not (a.is_leader and b.is_leader)
            if a.is_leader:
                # Still inside a's renew deadline — the lease must also
                # still be live, so b must not have stolen it.
                assert clock[0] - t_part <= a.renew_deadline + 1.0
            if b.is_leader and transferred_at is None:
                transferred_at = clock[0]
        assert transferred_at is not None, "leadership never transferred"
        assert transferred_at - t_part <= 10.0 + 1.0  # duration + retry
        # Heal: a rejoins as a FOLLOWER, no takeover, still one leader.
        gate.heal("ctrl-a")
        for _ in range(5):
            clock[0] += 1.0
            a.run_once()
            b.run_once()
            assert not (a.is_leader and b.is_leader)
        assert b.is_leader and not a.is_leader

    def test_elector_survives_partition_fault_point(self):
        """The `k8sclient.partition` point in schedule position against
        the elector's own client: a single severed round neither crashes
        the elector nor forfeits leadership (inside the renew deadline).
        """
        client = FakeClient()
        clock = [0.0]
        pc = PartitionedClient(client, "ctrl-a")
        a = LeaderElector(pc, "election-fp", "a",
                          lease_duration=10.0, renew_deadline=6.0,
                          retry_period=1.0, clock=lambda: clock[0])
        a.run_once()
        assert a.is_leader
        with faultpoints.injected("k8sclient.partition=nth:1"):
            clock[0] += 1.0
            a.run_once()  # severed round: tolerated
            assert a.is_leader
            clock[0] += 1.0
            a.run_once()  # hit 2: healed, renews
            assert a.is_leader


# --------------------------------------------------------------------------
# Heartbeat + lifecycle + reallocator: partition leg in miniature
# --------------------------------------------------------------------------

class TestPartitionFencingEndToEnd:
    def test_partition_cordon_realloc_heal_rejoin(self, tmp_path):
        """The whole partition story against one real node stack plus a
        healthy second pool, driven deterministically (no loop threads):
        partition → lease expires → fence + cordon + drain-annotate →
        reallocator moves the claim → heal → fence cleanup unprepares
        the stale checkpoint → fence cleared → uncordon."""
        client = FakeClient()
        gate = PartitionGate()
        node_client = PartitionedClient(client, "node-a", gate=gate)
        _, driver = _gpu_stack(tmp_path, client=client)
        # Rewire the driver's own API surface through the partition.
        driver.helper.client = node_client
        driver.events.client = node_client
        # A second, healthy node for the reallocator to land on.
        client.create({
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
            "metadata": {"name": "node-b-slice"},
            "spec": {"driver": DRIVER, "nodeName": "node-b",
                     "pool": {"name": "node-b", "generation": 1,
                              "resourceSliceCount": 1},
                     "devices": [{"name": "gpu-0", "attributes": {
                         "type": {"string": "gpu"},
                         "index": {"int": 0}}}]}})
        alloc = Allocator(client)
        claim = _make_prepared(client, driver, alloc, "c")
        uid = claim["metadata"]["uid"]

        clock = [0.0]
        hb = NodeLeaseHeartbeat(node_client, "node-a", lease_duration=10.0,
                                clock=lambda: clock[0],
                                fence_cleanup=fence_cleanup_for(
                                    driver, node_client))
        assert hb.renew_once()
        ctl = NodeLifecycleController(client, clock=lambda: clock[0])
        realloc = ClaimReallocator(client, retry_delay=0.05)

        gate.partition("node-a")
        with pytest.raises(PartitionError):
            hb.renew_once()
        clock[0] += 16.0
        assert ctl.poll_once()["cordoned"] == 1
        # The reallocator (informer-less here: fed directly) re-binds
        # the drain-annotated claim onto node-b.
        realloc._on_claim(client.get("ResourceClaim", "c", "default"))
        assert realloc.reconcile_once() == 1
        moved = client.get("ResourceClaim", "c", "default")
        results = moved["status"]["allocation"]["devices"]["results"]
        assert results[0]["pool"] == "node-b"
        # Still checkpointed on the dead node — exempt only because the
        # node is fenced; cleanup must reap it on heal.
        assert uid in driver.state.prepared_claims_nolock()

        gate.heal("node-a")
        assert hb.renew_once()  # observes the fence, cleans up, clears
        assert not hb.fenced
        assert hb.fence_recoveries == 1
        assert uid not in driver.state.prepared_claims_nolock()
        assert driver.cdi.list_claim_uids() == []
        assert ctl.poll_once()["uncordoned"] == 1
        assert ctl.cordoned_nodes() == []


# --------------------------------------------------------------------------
# Against the JAX package
# --------------------------------------------------------------------------

def _lease_scenario(nl, client, mk, metrics, list_ev, driver, seed):
    """A seeded lease expiry → fence → cordon → uncordon on node n0 with
    one allocated claim: renewals, a silent gap past the lost factor,
    the heartbeat back without and then with its cleanup, and the
    controller's polls in between. Returns what each step showed."""
    rng = np.random.default_rng(seed)
    n_dev = int(rng.integers(1, 5))
    client.create(mk("Node", "n0"))
    client.create({
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
        "metadata": {"name": "s0"},
        "spec": {"driver": driver, "nodeName": "n0",
                 "pool": {"name": "n0", "generation": 1,
                          "resourceSliceCount": 1},
                 "devices": [{"name": f"dev-{i}"} for i in range(n_dev)]}})
    client.create(mk(
        "ResourceClaim", "c0", "default", api_version="resource.k8s.io/v1",
        status={"allocation": {"devices": {"results": [
            {"driver": driver, "pool": "n0", "device": "dev-0"}]}}}))
    clock = [100.0]
    hb = nl.NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                               clock=lambda: clock[0], metrics=metrics(),
                               identity="plugin")
    ctl = nl.NodeLifecycleController(client, clock=lambda: clock[0],
                                     metrics=metrics())
    steps = []

    def snap(what):
        spec = client.get("Lease", "node-n0", nl.LEASE_NAMESPACE)["spec"]
        devs = client.get("ResourceSlice", "s0")["spec"]["devices"]
        anns = client.get("Node", "n0")["metadata"].get("annotations") or {}
        claim_anns = client.get("ResourceClaim", "c0", "default")[
            "metadata"].get("annotations") or {}
        steps.append({
            "what": what, "fenced": spec.get("fencedEpoch"),
            "ids": spec.get("fencedIdentities"), "hb_fenced": hb.fenced,
            "taints": sorted(t["key"].split("/")[1] for d in devs
                             for t in d.get("taints") or []),
            "cordon": sorted(k.split("/")[1] for k in anns),
            "claim": sorted(k.split("/")[1] for k in claim_anns),
            "cordoned": ctl.cordoned_nodes()})

    for _ in range(int(rng.integers(1, 4))):
        assert hb.renew_once()
        clock[0] += float(rng.uniform(1, 9))
        steps.append(ctl.poll_once())
    snap("renewing")
    clock[0] += 15.0 + float(rng.uniform(0.5, 5))
    steps.append(ctl.poll_once())
    snap("lost")
    assert hb.renew_once()
    steps.append(ctl.poll_once())
    snap("back, fence standing")
    hb.fence_cleanup = lambda: None
    assert hb.renew_once()
    steps.append(ctl.poll_once())
    snap("cleaned up")
    reasons = [e["reason"] for e in sorted(
        list_ev(client), key=lambda e: int(e["metadata"]["resourceVersion"]))]
    return steps, reasons, hb.renewals, hb.fence_recoveries


class TestAgainstJax:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_lease_expiry_fence_cordon_uncordon(self, seed):
        port = _lease_scenario(nodelease, FakeClient(), new_object,
                               NodeMetrics, list_events, DRIVER, seed)
        jax = _lease_scenario(jax_nodelease, JaxFakeClient(),
                              jax_new_object, JaxNodeMetrics,
                              jax_list_events, "tpu.google.com", seed)
        assert port == jax
        steps = port[0]
        lost = next(s for s in steps if s.get("what") == "lost")
        assert lost["taints"] and lost["cordon"] == ["cordon"]
        assert lost["claim"] == ["drain"] and lost["cordoned"] == ["n0"]
        assert steps[-1]["cordoned"] == [] and steps[-1]["taints"] == []
        assert port[1] == ["NodeFenced", "NodeCordoned", "NodeUncordoned"]
