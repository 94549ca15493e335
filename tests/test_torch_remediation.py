"""The GPU port's self-healing remediation: taint → drain → repair →
rejoin → reallocate.

The scenarios of the JAX package's ``tests/test_remediation.py`` (every
class but its soak smoke) on the port's ``h100-8`` mock: the drain
controller and claim reallocator end to end, taint mid-prepare, recovery
before the drain, a crash mid-drain, the ``PrepareAborted`` tombstone, the
drain order, the drain-aware health probe, the fault points in schedule
position, and the same-device reallocation the claim watcher resolves.
``TestAgainstJax`` drives one seeded fault → taint → drain → repair →
rejoin → reallocate scenario through both packages and compares the taint
keys, the Event reasons in order, the claim annotations and the counters.
"""

import threading
import time

import numpy as np
import pytest

from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxFakeClient
from k8s_dra_driver_tpu.k8sclient.client import new_object as jax_new_object
from k8s_dra_driver_tpu.kubeletplugin import Allocator as JaxAllocator
from k8s_dra_driver_tpu.kubeletplugin.claimwatcher import (
    NodePrepareLoop as JaxNodePrepareLoop,
)
from k8s_dra_driver_tpu.kubeletplugin import remediation as jax_remediation
from k8s_dra_driver_tpu.pkg import bootid as jax_bootid
from k8s_dra_driver_tpu.pkg.events import list_events as jax_list_events
from k8s_dra_driver_tpu.pkg.metrics import (
    RemediationMetrics as JaxRemediationMetrics,
)
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import (
    DriverConfig as JaxDriverConfig,
)
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import TpuDriver
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin.health import (
    attach_health_monitor as jax_attach_health_monitor,
)
from k8s_dra_driver_tpu.tpulib import MockDeviceLib as JaxMockDeviceLib
from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
    ANN_DRAIN,
    ANN_DRAIN_FAILED,
    SLO_ALLOCATION_ADMISSION,
    ClaimReallocator,
    DefragPlanner,
    DrainController,
    SimulatedRepair,
    attach_defrag_planner,
    parse_gpu_index,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg import bootid, faultpoints
from k8s_dra_driver_tpu_torch.pkg.errors import PermanentError
from k8s_dra_driver_tpu_torch.pkg.events import (
    REASON_CLAIM_DRAINED,
    REASON_CLAIM_REALLOCATED,
    REASON_DEVICE_REJOINED,
    REASON_DEVICE_TAINTED,
    REASON_REALLOCATION_FAILED,
    list_events,
)
from k8s_dra_driver_tpu_torch.pkg.faultpoints import FaultCrash
from k8s_dra_driver_tpu_torch.pkg.metrics import RemediationMetrics
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_ABORTED,
    STATE_PREPARE_COMPLETED,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.cleanup import (
    CheckpointCleanupManager,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.health import (
    attach_health_monitor,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.healthcheck import (
    STATUS_NOT_SERVING,
    STATUS_SERVING,
    driver_probe,
)

DRIVER = "gpu.nvidia.com"


class Stack:
    """One node's remediation stack over the mock backend."""

    def __init__(self, tmp_path, with_loop=True):
        self.tmp = tmp_path
        self.boot_path = str(tmp_path / "bootid")
        with open(self.boot_path, "w") as f:
            f.write("boot-epoch-0\n")
        self.env = {bootid.ENV_ALT_BOOT_ID_PATH: self.boot_path}
        self.client = FakeClient()
        self.client.create(new_object(
            "DeviceClass", DRIVER,
            spec={"selectors": [{"cel": {
                "expression": "device.attributes['type'] == 'gpu'"}}]}))
        self.lib = MockDeviceLib("h100-8")
        self.driver = GpuDriver(self.client, DriverConfig(
            node_name="node-a", state_dir=str(tmp_path / "state"),
            cdi_root=str(tmp_path / "cdi"), env=self.env,
            retry_timeout=1.0), device_lib=self.lib).start()
        self.loop = None
        if with_loop:
            self.loop = NodePrepareLoop(
                self.client, self.driver, DRIVER, "node-a",
                namespace="default", retry_delay=0.1).start()
        self.monitor = attach_health_monitor(self.driver, start=False)
        self.repair = SimulatedRepair(
            heal=lambda dev: self.lib.set_healthy(parse_gpu_index(dev)),
            env=self.env)
        self.drainer = DrainController(
            self.client, self.driver, repair=self.repair,
            poll_interval=0.05, metrics=RemediationMetrics())
        self.alloc = Allocator(self.client)

    def stop(self):
        if self.loop is not None:
            self.loop.stop()

    def make_claim(self, name, selector=None, count=1):
        req = {"name": "gpu", "exactly": {
            "deviceClassName": DRIVER,
            "allocationMode": "ExactCount", "count": count}}
        if selector:
            req["exactly"]["selectors"] = [{"cel": {"expression": selector}}]
        return self.client.create(new_object(
            "ResourceClaim", name, "default",
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [req]}}))

    def allocate(self, claim, reserve=True):
        return self.alloc.allocate(
            claim,
            reserved_for=[{"resource": "pods", "name": "p"}] if reserve
            else None,
            node="node-a")

    def claim(self, name):
        return self.client.try_get("ResourceClaim", name, "default")

    def allocated_device(self, name):
        c = self.claim(name)
        res = ((c.get("status") or {}).get("allocation") or {}).get(
            "devices", {}).get("results") or []
        return res[0]["device"] if res else None

    def ready(self, name):
        c = self.claim(name)
        return c is not None and any(
            cond.get("type") == "Ready" and cond.get("status") == "True"
            for d in (c.get("status") or {}).get("devices") or []
            for cond in d.get("conditions") or [])

    def wait(self, cond, timeout=8.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return True
            time.sleep(0.02)
        return False

    def checkpoint_entry(self, name):
        uid = self.claim(name)["metadata"]["uid"]
        return self.driver.state.prepared_claims_nolock().get(uid)


@pytest.fixture()
def stack(tmp_path):
    s = Stack(tmp_path)
    yield s
    s.stop()


class TestDrainPipeline:
    def test_taint_drain_reallocate_rejoin(self, stack):
        """The full pipeline on one node: events, metrics, the tombstone,
        the boot-id flip, and the device rejoining the published slice."""
        realloc = ClaimReallocator(stack.client, retry_delay=0.05,
                                   metrics=stack.drainer.metrics).start()
        try:
            stack.allocate(stack.make_claim("c1"))
            assert stack.wait(lambda: stack.ready("c1"))
            dev = stack.allocated_device("c1")
            old_boot = stack.driver.state.node_boot_id

            stack.lib.set_unhealthy(parse_gpu_index(dev), "XID 79",
                                    xid_errors=1)
            stack.monitor.poll_once()
            assert dev in stack.driver.device_taints()
            # The repair waits until the claim is re-placed: an instant one
            # could rejoin the GPU before the reallocator runs, and the
            # claim would land on it again.
            stack.drainer.repair = lambda device: None
            assert stack.drainer.poll_once()["drained"] == 1

            assert stack.wait(lambda: stack.ready("c1")
                              and stack.allocated_device("c1") != dev)
            stack.drainer.repair = stack.repair
            entry = stack.checkpoint_entry("c1")
            assert entry is not None
            assert entry.state == STATE_PREPARE_COMPLETED
            assert entry.prepared_devices[0]["device"] != dev

            def settled():
                stack.drainer.poll_once()
                return not stack.drainer.draining
            assert stack.wait(settled)
            assert stack.driver.device_taints() == {}
            assert stack.drainer.recoveries

            assert stack.driver.state.node_boot_id != old_boot
            assert stack.driver.state.node_boot_id == \
                bootid.read_boot_id(stack.env)

            pub = {d["name"]: d for d in
                   stack.client.list("ResourceSlice")[0]["spec"]["devices"]}
            assert dev in pub and "taints" not in pub[dev]

            reasons = {e["reason"] for e in list_events(stack.client)}
            assert {REASON_DEVICE_TAINTED, REASON_CLAIM_DRAINED,
                    REASON_CLAIM_REALLOCATED,
                    REASON_DEVICE_REJOINED} <= reasons

            m = stack.drainer.metrics
            assert m.drains_total.value(driver=DRIVER) == 1
            assert m.active_drains.value(node="node-a") == 0
            assert m.recovery_seconds.count(node="node-a") == 1
            assert m.reallocations_total.value(outcome="success") == 1
        finally:
            realloc.stop()

    def test_drain_cancelled_when_gpu_recovers_first(self, stack):
        stack.allocate(stack.make_claim("c1"))
        assert stack.wait(lambda: stack.ready("c1"))
        idx = parse_gpu_index(stack.allocated_device("c1"))
        stack.lib.set_unhealthy(idx, "blip")
        stack.monitor.poll_once()
        stack.lib.set_healthy(idx)  # recovered before any drain poll
        counts = stack.drainer.poll_once()
        assert counts == {"drained": 0, "rejoined": 0, "cancelled": 1}
        entry = stack.checkpoint_entry("c1")
        assert entry is not None and entry.state == STATE_PREPARE_COMPLETED
        assert not list_events(stack.client, reason=REASON_CLAIM_DRAINED)
        stack.monitor.poll_once()
        assert stack.driver.device_taints() == {}
        assert not stack.drainer.draining

    def test_taint_lands_mid_prepare(self, stack):
        claim = stack.allocate(stack.make_claim(
            "c1", selector="device.attributes['index'] == 3"), reserve=False)
        uid = claim["metadata"]["uid"]
        errs = []

        def prep():
            try:
                with faultpoints.injected("devicestate.prepare=latency:0.4"):
                    stack.driver.state.prepare(claim)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        t = threading.Thread(target=prep, daemon=True)
        t.start()
        time.sleep(0.1)  # prepare is now inside its latency window
        stack.lib.set_unhealthy(3, "mid-prepare fault")
        stack.monitor.poll_once()
        assert "gpu-3" in stack.driver.device_taints()
        counts = stack.drainer.poll_once()  # blocks on the flight lock
        t.join(timeout=5.0)
        assert not errs, errs
        if counts["drained"] == 0:
            counts = stack.drainer.poll_once()
        assert counts["drained"] == 1
        entry = stack.driver.state.prepared_claims_nolock()[uid]
        assert entry.state == STATE_PREPARE_ABORTED
        assert uid not in stack.driver.cdi.list_claim_uids()

    def test_crash_mid_drain_replays_to_clean_state(self, stack, tmp_path):
        claim = stack.allocate(stack.make_claim("c1"), reserve=False)
        uid = claim["metadata"]["uid"]
        stack.driver.state.prepare(claim)
        dev = stack.allocated_device("c1")
        stack.lib.set_unhealthy(parse_gpu_index(dev), "dying GPU")
        stack.monitor.poll_once()

        with faultpoints.injected("checkpoint.replace=crash-nth:1"):
            with pytest.raises(FaultCrash):
                stack.drainer.poll_once()
        entry = stack.driver.state.prepared_claims_nolock()[uid]
        assert entry.state == STATE_PREPARE_COMPLETED

        restarted = GpuDriver(stack.client, DriverConfig(
            node_name="node-a", state_dir=str(tmp_path / "state"),
            cdi_root=str(tmp_path / "cdi"), env=stack.env,
            retry_timeout=1.0), device_lib=stack.lib)
        attach_health_monitor(restarted, start=False).poll_once()
        drainer2 = DrainController(stack.client, restarted,
                                   repair=stack.repair, poll_interval=0.05,
                                   metrics=RemediationMetrics())
        assert drainer2.poll_once()["drained"] == 1
        entry = restarted.state.prepared_claims_nolock()[uid]
        assert entry.state == STATE_PREPARE_ABORTED
        assert uid not in restarted.cdi.list_claim_uids()

    def test_stale_prepare_rejected_after_drain(self, stack):
        claim = stack.allocate(stack.make_claim(
            "c1", selector="device.attributes['index'] == 2"), reserve=False)
        uid = claim["metadata"]["uid"]
        stack.driver.state.prepare(claim)
        assert stack.driver.drain_claim(
            ClaimRef(uid=uid, name="c1", namespace="default"))
        with pytest.raises(PermanentError, match="aborted"):
            stack.driver.state.prepare(claim)
        fresh = stack.claim("c1")
        fresh["status"]["allocation"]["devices"]["results"][0]["device"] = \
            "gpu-5"
        stack.client.update_status(fresh)
        refs = stack.driver.state.prepare(stack.claim("c1"))
        assert refs and refs[0].device == "gpu-5"
        entry = stack.driver.state.prepared_claims_nolock()[uid]
        assert entry.state == STATE_PREPARE_COMPLETED

    def test_drain_finds_claims_of_vanished_gpu(self, stack):
        claim = stack.allocate(stack.make_claim(
            "c1", selector="device.attributes['index'] == 5"), reserve=False)
        uid = claim["metadata"]["uid"]
        stack.driver.state.prepare(claim)
        real = stack.lib.enumerate_gpus
        stack.lib.enumerate_gpus = lambda: [
            g for g in real() if g.index != 5]
        stack.driver.state.refresh_enumeration()
        assert [r.uid for r in stack.driver.affected_claims("gpu-5")] == [uid]
        assert stack.driver.affected_claims("gpu-1") == []

    def test_tombstone_gc_rides_cleanup_sweep(self, stack):
        claim = stack.allocate(stack.make_claim("c1"), reserve=False)
        uid = claim["metadata"]["uid"]
        stack.driver.state.prepare(claim)
        assert stack.driver.drain_claim(
            ClaimRef(uid=uid, name="c1", namespace="default"))
        CheckpointCleanupManager(stack.client,
                                 stack.driver.state).cleanup_once()
        assert uid in stack.driver.state.prepared_claims_nolock()
        expired = stack.driver.state.delete_expired_aborted(
            now=time.time() + stack.driver.state.aborted_ttl + 1.0)
        assert expired == [uid]
        assert stack.driver.state.prepared_claims_nolock() == {}

    def test_unprepare_drops_tombstone(self, stack):
        claim = stack.allocate(stack.make_claim("c1"), reserve=False)
        uid = claim["metadata"]["uid"]
        stack.driver.state.prepare(claim)
        ref = ClaimRef(uid=uid, name="c1", namespace="default")
        assert stack.driver.drain_claim(ref)
        assert not stack.driver.drain_claim(ref)  # already drained
        stack.driver.state.unprepare(ref)
        assert uid not in stack.driver.state.prepared_claims_nolock()

    def test_adopt_boot_id_moves_the_checkpoint(self, stack):
        stack.driver.adopt_boot_id("boot-epoch-1")
        assert stack.driver.state.node_boot_id == "boot-epoch-1"
        stack.driver.adopt_boot_id("")            # no reboot marker: no-op
        assert stack.driver.state.node_boot_id == "boot-epoch-1"


class TestDrainPriority:
    def test_drain_order_smallest_claim_first(self, stack):
        sizes = {"uid-small": 1, "uid-big": 4, "uid-mid": 2}
        drained_order = []

        class FakeDriver:
            config = None
            state = type("S", (), {"driver_name": DRIVER})()

            def device_taints(self):
                return {"gpu-0": [{"key": "k"}]}

            def device_healthy(self, dev):
                return False

            def affected_claims(self, dev):
                return [ClaimRef(uid=u, name=u, namespace="default")
                        for u in sorted(sizes)]

            def claim_device_count(self, ref):
                return sizes[ref.uid]

            def drain_claim(self, ref, reason=""):
                drained_order.append(ref.uid)
                return True

        drainer = DrainController(stack.client, FakeDriver(),
                                  poll_interval=999,
                                  metrics=RemediationMetrics())
        assert drainer.poll_once()["drained"] == 3
        assert drained_order == ["uid-small", "uid-mid", "uid-big"]

    def test_drain_order_degrades_to_uid_without_size(self, stack):
        refs = [ClaimRef(uid=u, name=u, namespace="default")
                for u in ("b", "a", "c")]

        class NoCountDriver:
            pass

        drainer = DrainController(stack.client, NoCountDriver(),
                                  poll_interval=999)
        assert [r.uid for r in drainer._drain_order(refs)] == ["a", "b", "c"]

    def test_claim_device_count_from_checkpoint(self, stack):
        one = stack.allocate(stack.make_claim(
            "one", selector="device.attributes['index'] == 5"),
            reserve=False)
        stack.driver.state.prepare(one)
        assert stack.driver.claim_device_count(ClaimRef(
            uid=one["metadata"]["uid"], name="one",
            namespace="default")) == 1
        assert stack.driver.claim_device_count(ClaimRef(
            uid="ghost", name="g", namespace="default")) == 0

    def test_claim_device_count_multi_gpu(self, stack):
        claim = stack.alloc.allocate(stack.make_claim("quad", count=4),
                                     node="node-a")
        stack.driver.state.prepare(claim)
        assert stack.driver.claim_device_count(ClaimRef(
            uid=claim["metadata"]["uid"], name="quad",
            namespace="default")) == 4


class TestReallocator:
    def test_reallocation_exhaustion_fails_cleanly(self, stack):
        stack.allocate(stack.make_claim("c1"))
        assert stack.wait(lambda: stack.ready("c1"))
        stack.drainer.repair = lambda device: None
        for i in range(8):
            stack.lib.set_unhealthy(i, "total loss")
        stack.monitor.poll_once()
        assert stack.drainer.poll_once()["drained"] == 1

        realloc = ClaimReallocator(stack.client, attempt_budget=2,
                                   metrics=RemediationMetrics())
        realloc._on_claim(stack.claim("c1"))
        assert realloc.reconcile_once() == 0  # attempt 1: no capacity
        assert realloc.reconcile_once() == 1  # attempt 2: budget → failed
        anns = stack.claim("c1")["metadata"]["annotations"]
        assert ANN_DRAIN_FAILED in anns and ANN_DRAIN not in anns
        assert list_events(stack.client, involved_name="c1",
                           reason=REASON_REALLOCATION_FAILED)
        assert realloc.failed == 1
        assert realloc.pending_count() == 0

    def test_restart_recovers_pending_drains_from_annotations(self, stack):
        stack.allocate(stack.make_claim("c1"))
        assert stack.wait(lambda: stack.ready("c1"))
        dev = stack.allocated_device("c1")
        stack.lib.set_unhealthy(parse_gpu_index(dev), "fault")
        stack.monitor.poll_once()
        assert stack.drainer.poll_once()["drained"] == 1
        assert ANN_DRAIN in stack.claim("c1")["metadata"]["annotations"]

        realloc = ClaimReallocator(stack.client, retry_delay=0.05,
                                   metrics=RemediationMetrics()).start()
        try:
            assert stack.wait(
                lambda: ANN_DRAIN not in (
                    stack.claim("c1")["metadata"].get("annotations") or {}))
            assert stack.wait(lambda: stack.ready("c1"))
            uid = stack.claim("c1")["metadata"]["uid"]

            def completed():
                pc = stack.driver.state.prepared_claims_nolock().get(uid)
                return pc is not None and pc.state == STATE_PREPARE_COMPLETED
            assert stack.wait(completed)
            assert list_events(stack.client, involved_name="c1",
                               reason=REASON_CLAIM_REALLOCATED)
        finally:
            realloc.stop()


class TestHealthcheckDrainGating:
    def test_not_serving_during_drain_serving_after_rejoin(self, stack):
        def probe():
            return driver_probe(stack.driver, drainer=stack.drainer)

        assert probe() == STATUS_SERVING
        stack.allocate(stack.make_claim("c1"))
        assert stack.wait(lambda: stack.ready("c1"))
        dev = stack.allocated_device("c1")
        stack.drainer.repair = lambda device: None   # held mid-pipeline
        stack.lib.set_unhealthy(parse_gpu_index(dev), "fault")
        stack.monitor.poll_once()
        stack.drainer.poll_once()
        assert stack.drainer.draining
        assert probe() == STATUS_NOT_SERVING
        stack.drainer.repair = stack.repair
        stack.drainer.poll_once()
        assert not stack.drainer.draining
        assert probe() == STATUS_SERVING


class TestRemediationFaultPoints:
    def test_drain_fault_retried_next_poll(self, stack):
        stack.allocate(stack.make_claim("c1"))
        assert stack.wait(lambda: stack.ready("c1"))
        dev = stack.allocated_device("c1")
        stack.lib.set_unhealthy(parse_gpu_index(dev), "fault")
        stack.monitor.poll_once()
        with faultpoints.injected("remediation.drain=nth:1"):
            assert stack.drainer.poll_once()["drained"] == 0
            assert stack.checkpoint_entry("c1").state == \
                STATE_PREPARE_COMPLETED
            assert stack.drainer.poll_once()["drained"] == 1

    def test_rejoin_fault_retried_next_poll(self, stack):
        stack.allocate(stack.make_claim("c1"))
        assert stack.wait(lambda: stack.ready("c1"))
        dev = stack.allocated_device("c1")
        stack.lib.set_unhealthy(parse_gpu_index(dev), "fault")
        stack.monitor.poll_once()
        with faultpoints.injected("remediation.rejoin=nth:1"):
            counts = stack.drainer.poll_once()
            assert counts["drained"] == 1 and counts["rejoined"] == 0
            assert stack.drainer.draining
            assert stack.drainer.poll_once()["rejoined"] == 1
        assert stack.driver.device_taints() == {}
        assert not stack.drainer.draining


class TestSameResultsReallocation:
    def test_loop_restart_resolves_same_device_reallocation(self, stack):
        """Drain → repair → the reallocator re-picks the SAME (repaired)
        GPU, and the restarted claim watcher's prepare meets the tombstone
        with identical results: it must resolve the tombstone and prepare,
        never retry the PermanentError forever."""
        stack.allocate(stack.make_claim(
            "c1", selector="device.attributes['index'] == 2"))
        assert stack.wait(lambda: stack.ready("c1"))
        uid = stack.claim("c1")["metadata"]["uid"]
        stack.loop.stop()
        stack.loop = None

        stack.lib.set_unhealthy(2, "fault")
        stack.monitor.poll_once()
        assert stack.drainer.poll_once()["drained"] == 1
        realloc = ClaimReallocator(stack.client, attempt_budget=50,
                                   metrics=RemediationMetrics())
        realloc._on_claim(stack.claim("c1"))
        for _ in range(50):
            if realloc.reconcile_once():
                break
            time.sleep(0.05)
        assert ANN_DRAIN not in (stack.claim("c1")["metadata"].get(
            "annotations") or {})
        assert stack.allocated_device("c1") == "gpu-2"
        assert stack.driver.state.prepared_claims_nolock()[uid].state == \
            STATE_PREPARE_ABORTED

        stack.loop = NodePrepareLoop(
            stack.client, stack.driver, DRIVER, "node-a",
            namespace="default", retry_delay=0.1).start()
        assert stack.wait(lambda: stack.ready("c1"))
        assert stack.driver.state.prepared_claims_nolock()[uid].state == \
            STATE_PREPARE_COMPLETED

    def test_live_pipeline_on_a_one_gpu_node(self, tmp_path):
        """A node of one GPU, every loop live: the drained claim waits for
        the repair, is re-bound to the same GPU and is Ready again."""
        from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl

        profile = dl._h100_8_profile(0)
        profile["gpus"] = profile["gpus"][:1]
        lib = MockDeviceLib(profile)
        client = FakeClient()
        client.create(new_object(
            "DeviceClass", DRIVER, spec={"selectors": [{"cel": {
                "expression": "device.attributes['type'] == 'gpu'"}}]}))
        driver = GpuDriver(client, DriverConfig(
            node_name="node-a", state_dir=str(tmp_path / "s"),
            cdi_root=str(tmp_path / "c"), env={}, retry_timeout=1.0),
            device_lib=lib).start()
        gate = threading.Event()
        monitor = attach_health_monitor(driver, poll_interval=0.02)
        loop = NodePrepareLoop(client, driver, DRIVER, "node-a",
                               namespace="default", retry_delay=0.02).start()
        drainer = DrainController(
            client, driver, poll_interval=0.02, metrics=RemediationMetrics(),
            repair=lambda dev: (lib.set_healthy(0) or "")
            if gate.is_set() else None).start()
        realloc = ClaimReallocator(client, retry_delay=0.02,
                                   attempt_budget=500,
                                   metrics=RemediationMetrics()).start()
        s = Stack.__new__(Stack)
        s.client = client
        try:
            Allocator(client).allocate(client.create(new_object(
                "ResourceClaim", "c1", "default",
                api_version="resource.k8s.io/v1",
                spec={"devices": {"requests": [{"name": "gpu", "exactly": {
                    "deviceClassName": DRIVER, "allocationMode": "ExactCount",
                    "count": 1}}]}})),
                reserved_for=[{"resource": "pods", "name": "p"}],
                node="node-a")
            assert s.wait(lambda: s.ready("c1"))
            lib.set_unhealthy(0, "XID 79", xid_errors=1)
            assert s.wait(lambda: ANN_DRAIN in (
                s.claim("c1")["metadata"].get("annotations") or {}))
            # Released by the reallocator, held off the GPU by its taint.
            assert s.wait(lambda: not s.ready("c1"))
            gate.set()
            assert s.wait(lambda: s.ready("c1") and ANN_DRAIN not in (
                s.claim("c1")["metadata"].get("annotations") or {}))
            assert s.allocated_device("c1") == "gpu-0"
            assert realloc.reallocated == 1 and realloc.failed == 0
        finally:
            for x in (realloc, drainer, loop, monitor):
                x.stop()

    def test_stale_bookkeeping_detected_against_checkpoint(self, stack):
        stack.allocate(stack.make_claim("c1"))
        assert stack.wait(lambda: stack.ready("c1"))
        uid = stack.claim("c1")["metadata"]["uid"]
        assert stack.driver.drain_claim(
            ClaimRef(uid=uid, name="c1", namespace="default"))
        c = stack.claim("c1")
        c["metadata"].setdefault("labels", {})["touch"] = "1"
        stack.client.update(c)
        assert stack.wait(
            lambda: stack.driver.state.prepared_claims_nolock().get(uid)
            is not None
            and stack.driver.state.prepared_claims_nolock()[uid].state
            == STATE_PREPARE_COMPLETED)


class TestClaimwatcherReallocation:
    def test_prepared_claim_follows_rewritten_allocation(self, stack):
        stack.allocate(stack.make_claim(
            "c1", selector="device.attributes['index'] == 1"))
        assert stack.wait(lambda: stack.ready("c1"))
        uid = stack.claim("c1")["metadata"]["uid"]
        assert stack.driver.state.prepared_claims_nolock()[uid] \
            .prepared_devices[0]["device"] == "gpu-1"
        fresh = stack.claim("c1")
        fresh["status"]["allocation"]["devices"]["results"][0]["device"] = \
            "gpu-6"
        stack.client.update_status(fresh)

        def moved():
            pc = stack.driver.state.prepared_claims_nolock().get(uid)
            return (pc is not None and pc.prepared_devices
                    and pc.prepared_devices[0].get("device") == "gpu-6")
        assert stack.wait(moved)
        devs = [d["device"] for d in stack.claim("c1")["status"]["devices"]
                if d.get("driver") == DRIVER]
        assert devs == ["gpu-6"]


class TestDefragPlannerWiring:
    def test_alert_arms_and_disarms(self, stack):
        class Transition:
            def __init__(self, kind, slo=SLO_ALLOCATION_ADMISSION):
                self.slo, self.transition = slo, kind

        class Engine:
            def __init__(self):
                self.subs = []

            def subscribe(self, fn):
                self.subs.append(fn)

        planner = DefragPlanner(stack.client, stack.alloc,
                                metrics=RemediationMetrics())
        engine = Engine()
        assert attach_defrag_planner(engine, planner) is planner
        assert engine.subs == [planner.on_alert]
        assert planner.maybe_plan() == {}          # disarmed: no pass
        planner.on_alert(Transition("fired", slo="other"))
        assert not planner.armed
        planner.on_alert(Transition("fired"))
        assert planner.armed
        assert planner.maybe_plan() == {"planned": 0, "preempted": 0,
                                        "skipped": 0, "resolved": 0}
        planner.on_alert(Transition("cleared"))
        assert not planner.armed


# --------------------------------------------------------------------------
# Against the JAX package
# --------------------------------------------------------------------------

class _JaxStack(Stack):
    """The same stack over the JAX package's TPU plugin (``v5e-8``)."""

    def __init__(self, tmp_path):
        self.boot_path = str(tmp_path / "jax-bootid")
        with open(self.boot_path, "w") as f:
            f.write("boot-epoch-0\n")
        self.env = {jax_bootid.ENV_ALT_BOOT_ID_PATH: self.boot_path}
        self.client = JaxFakeClient()
        self.client.create(jax_new_object(
            "DeviceClass", "tpu.google.com",
            spec={"selectors": [{"cel": {
                "expression": "device.attributes['type'] == 'tpu'"}}]}))
        self.lib = JaxMockDeviceLib("v5e-8")
        self.driver = TpuDriver(self.client, JaxDriverConfig(
            node_name="node-a", state_dir=str(tmp_path / "jax-state"),
            cdi_root=str(tmp_path / "jax-cdi"), env=self.env,
            retry_timeout=1.0), device_lib=self.lib).start()
        self.loop = JaxNodePrepareLoop(
            self.client, self.driver, "tpu.google.com", "node-a",
            namespace="default", retry_delay=0.1).start()
        self.monitor = jax_attach_health_monitor(self.driver, start=False)
        self.repair = jax_remediation.SimulatedRepair(
            heal=lambda dev: self.lib.set_healthy(
                jax_remediation.parse_chip_index(dev)), env=self.env)
        self.drainer = jax_remediation.DrainController(
            self.client, self.driver, repair=self.repair,
            poll_interval=0.05, metrics=JaxRemediationMetrics())
        self.alloc = JaxAllocator(self.client)

    def make_claim(self, name, selector=None, count=1):
        req = {"name": "tpu", "exactly": {
            "deviceClassName": "tpu.google.com",
            "allocationMode": "ExactCount", "count": count}}
        if selector:
            req["exactly"]["selectors"] = [{"cel": {"expression": selector}}]
        return self.client.create(jax_new_object(
            "ResourceClaim", name, "default",
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [req]}}))


_PIPELINE_REASONS = (REASON_DEVICE_TAINTED, REASON_CLAIM_DRAINED,
                     REASON_DEVICE_REJOINED, REASON_CLAIM_REALLOCATED,
                     REASON_REALLOCATION_FAILED)


def _norm(s: str) -> str:
    return (s.replace("tpu.google.com", "gpu.nvidia.com")
            .replace("/interrupt", "/xid").replace("tpu-", "gpu-"))


def _pipeline(s, reallocator, seed):
    """Claims pinned by index from a seed, one device faulted, then the
    drain → repair → rejoin → reallocate pipeline polled to rest."""
    rng = np.random.default_rng(seed)
    idx = [int(i) for i in rng.choice(8, size=3, replace=False)]
    for n, i in enumerate(idx):
        s.allocate(s.make_claim(f"c{n}",
                                selector=f"device.attributes['index'] == {i}"))
    assert s.wait(lambda: all(s.ready(f"c{n}") for n in range(3)))
    bad = idx[int(rng.integers(0, 3))]
    kwargs = {"ecc_errors": 2} if seed % 2 else {}
    s.lib.set_unhealthy(bad, "injected", **kwargs)
    s.monitor.poll_once()
    taints = sorted(_norm(t.key) for ts in s.driver.device_taints().values()
                    for t in ts)
    drained = s.drainer.poll_once()
    anns = {f"c{n}": sorted(_norm(k) for k in (
        s.claim(f"c{n}")["metadata"].get("annotations") or {}))
        for n in range(3)}
    realloc = reallocator(s.client, retry_delay=0.05)
    for n in range(3):
        realloc._on_claim(s.claim(f"c{n}"))
    for _ in range(40):
        if realloc.reconcile_once():
            break
        time.sleep(0.05)
    assert s.wait(lambda: all(s.ready(f"c{n}") for n in range(3)))
    s.monitor.poll_once()
    # The pipeline's own Events (a prepare the claim watcher retries may
    # add a PrepareFailed, depending on which watch event it saw first).
    reasons = [e["reason"] for e in sorted(
        (jax_list_events if isinstance(s, _JaxStack) else list_events)(
            s.client), key=lambda e: int(e["metadata"]["resourceVersion"]))
        if e["reason"] in _PIPELINE_REASONS]
    s.stop()
    return {"taints": taints, "drained": drained, "annotations": anns,
            "after": {f"c{n}": sorted(_norm(k) for k in (
                s.claim(f"c{n}")["metadata"].get("annotations") or {}))
                for n in range(3)},
            "devices": [_norm(s.allocated_device(f"c{n}")) for n in range(3)],
            "reasons": reasons, "reallocated": realloc.reallocated,
            "failed": realloc.failed, "recoveries": len(s.drainer.recoveries),
            "remaining_taints": s.driver.device_taints()}


class TestAgainstJax:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_fault_drain_repair_rejoin_reallocate(self, tmp_path, seed):
        port = _pipeline(Stack(tmp_path), lambda c, **kw: ClaimReallocator(
            c, metrics=RemediationMetrics(), **kw), seed)
        jax = _pipeline(_JaxStack(tmp_path), lambda c, **kw:
                        jax_remediation.ClaimReallocator(
                            c, metrics=JaxRemediationMetrics(), **kw), seed)
        assert port == jax
        assert port["drained"]["drained"] == 1
        assert port["reallocated"] == 1 and port["failed"] == 0
        assert port["taints"] == ["gpu.nvidia.com/ecc" if seed % 2
                                  else "gpu.nvidia.com/xid"]


def test_the_smokes_phase_on_a_mock_node(tmp_path, monkeypatch, capsys):
    """``chip_smoke.phase_selfheal`` as the card runs it, on a mock node of
    one GPU with a small CPU engine: the fault tainted, the claim drained
    and re-bound to the same GPU, the canary passing, failing in admission
    while the GPU is tainted and passing again, and nothing left."""
    import chip_smoke
    from k8s_dra_driver_tpu_torch.compute import _build
    from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    profile = dl._h100_8_profile(0)
    profile["gpus"] = profile["gpus"][:1]
    lib = MockDeviceLib(profile)
    gpu = lib.enumerate_gpus()[0]
    out = chip_smoke.phase_selfheal("mock", 0, lib, gpu, width={
        "max_batch": 4, "heads": 2, "head_dim": 8, "kv_cap": 64,
        "prompts": (8, 40), "new_tokens": 4, "device": "cpu",
        "uuids": {gpu.uuid: 0}})
    assert out["reallocated"] == 1 and out["failed"] == 0
    assert out["cordons"] == 0 and out["recoveries"] == 1
    assert out["launches_a"] == out["launches_b"] == 0   # plain on the CPU
    assert out["decode_steps_a"] > 0 and out["decode_steps_b"] > 0
    assert 0 < out["detect_ms"] <= out["drain_ms"] < out["outage_ms"] \
        < out["ttfb_after_ms"]
    text = capsys.readouterr().out
    assert "canary=tainted outcome=failed failed_phase=admission" in text
    assert text.count("outcome=ok") == 2
    assert "residue=[] threads_left=[]" in text
