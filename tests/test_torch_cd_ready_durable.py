"""A Ready status implies a committed prepare, on the ComputeDomain kubelet
plugin.

The GPU plugin's rule (``tests/test_torch_ready_durable.py``) on the CD
plugin's channel and daemon claims: a claim's ``status.devices`` entry of
``compute-domain.nvidia.com`` with ``Ready: True`` on device D says that the
node's CD checkpoint holds the claim as ``PrepareCompleted`` with D. For a
channel claim, Ready is what a multi-node job's ranks start from: the
rendezvous env in the CDI spec that a drain deletes.

The stack is the CD plugin's main on one mock node: a ``FakeClient``, the
controller, one daemon, a ``CdDriver`` and a ``NodePrepareLoop`` on the
driver's pool. ``ReadyProbe`` samples a channel claim and a daemon claim
while they are prepared, drained as the node cordon's companion drain
drains them, released and prepared again. The other tests force each
ordering the rule depends on with a hook, without load, and probe the
plugin's other paths that remove a record: the fence cleanup, the
checkpoint GC, reboot invalidation and a boot-id adoption. The JAX
package's CD drain, which stays as it is, leaves Ready standing over its
tombstone.
"""

import time

import pytest

from k8s_dra_driver_tpu_torch.api.computedomain import (
    NODE_LABEL_CD,
    new_compute_domain,
)
from k8s_dra_driver_tpu_torch.gpulib import MockDeviceLib
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import (
    REASON_DRAINED,
    NodePrepareLoop,
    drain_marked,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
    ANN_DRAIN,
    ClaimReallocator,
    DrainController,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg import bootid
from k8s_dra_driver_tpu_torch.pkg.metrics import RemediationMetrics
from k8s_dra_driver_tpu_torch.pkg.nodelease import fence_cleanup_for
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller import (
    ComputeDomainController,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin import (
    CD_DRIVER_NAME,
    PREPARE_ABORTED_TTL,
    CdCheckpointCleanupManager,
    CdDriver,
    CdDriverConfig,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_ABORTED,
    STATE_PREPARE_COMPLETED,
    CheckpointManager,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.driver import (
    DriverConfig,
    GpuDriver,
)
from tests.test_torch_cd_plugin import (
    _classes,
    make_channel_claim,
    make_daemon_claim,
    start_daemon,
)
from tests.test_torch_ready_durable import ReadyProbe, ready_devices
from tests.test_torch_remediation import DRIVER, Stack

PROFILE = "h100-8"
KINDS = ["channel", "daemon"]
DEVICE = {"channel": "channel-0", "daemon": "daemon"}


class CdStack:
    """The CD plugin's main on one mock node, as ``main.run_plugin`` wires
    it: the driver, the claim watcher on its pool with the informer rv in
    the state directory, the controller's live loop, and the node's daemon
    in a ComputeDomain of one node."""

    def __init__(self, tmp_path):
        self.tmp = tmp_path
        self.boot_path = str(tmp_path / "bootid")
        with open(self.boot_path, "w") as f:
            f.write("boot-epoch-0\n")
        self.env = {bootid.ENV_ALT_BOOT_ID_PATH: self.boot_path}
        self.state_dir = str(tmp_path / "state")
        self.client = FakeClient()
        self.client.create(new_object("Node", "node-0"))
        _classes(self.client)
        self.controller = ComputeDomainController(self.client).start()
        self.cd = self.client.create(new_compute_domain("cd", num_nodes=1))
        self.driver = self.new_driver()
        self.daemon = start_daemon(self.client, 0, self.cd, PROFILE)
        self.loop = None
        self.start_loop()
        self.alloc = Allocator(self.client)

    def new_driver(self):
        return CdDriver(self.client, CdDriverConfig(
            node_name="node-0", state_dir=self.state_dir,
            cdi_root=str(self.tmp / "cdi"), env=self.env, retry_timeout=1.0),
            device_lib=MockDeviceLib(PROFILE)).start()

    def start_loop(self):
        self.loop = NodePrepareLoop(
            self.client, self.driver, CD_DRIVER_NAME, self.driver.pool_name,
            state_dir=self.state_dir, retry_delay=0.1).start()

    def settle_loop(self, name="c1"):
        """Wait until the claim watcher has handled the newest event of
        claim ``name``: a watcher stopped before that resumes behind it and
        replays the events it missed, the older ones first."""
        rv = int(self.claim(name)["metadata"]["resourceVersion"])
        assert self.wait(lambda: self.loop._rv_store._latest >= rv)

    def stop(self):
        if self.loop is not None:
            self.loop.stop()
            self.loop = None
        self.controller.stop()

    def make(self, kind, name):
        if kind == "channel":
            return make_channel_claim(self.client, name, self.cd, node=0)
        return make_daemon_claim(self.client, name, self.cd, node=0)

    def allocate(self, name):
        return self.alloc.allocate(
            self.claim(name),
            reserved_for=[{"resource": "pods", "name": f"pod-{name}"}],
            node="node-0")

    def release(self, name):
        self.alloc.release(self.claim(name))

    def claim(self, name):
        return self.client.try_get("ResourceClaim", name, "default")

    def ref(self, name):
        return ClaimRef(uid=self.claim(name)["metadata"]["uid"], name=name,
                        namespace="default")

    def ready(self, name):
        return bool(ready_devices(self.claim(name), CD_DRIVER_NAME))

    def entries(self, name):
        c = self.claim(name)
        return [d for d in (c.get("status") or {}).get("devices") or []
                if d.get("driver") == CD_DRIVER_NAME]

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

    def node_labelled(self):
        labels = self.client.get("Node", "node-0")["metadata"].get("labels")
        return NODE_LABEL_CD in (labels or {})

    def expire_tombstones(self):
        return self.driver.state.delete_expired_aborted(
            now=time.time() + PREPARE_ABORTED_TTL + 1.0)

    def allocated_device(self, name):
        alloc = (self.claim(name).get("status") or {}).get("allocation")
        return [r.get("device") for r in
                ((alloc or {}).get("devices") or {}).get("results") or []
                if r.get("driver") == CD_DRIVER_NAME]

    def annotate_drained(self, name):
        """Write the reallocation annotation that the node cordon's drain
        writes for a claim it drained (the reallocator's work record)."""
        assert DrainController(
            self.client, self.driver, metrics=RemediationMetrics(),
        )._annotate_drained(self.ref(name), "node:node-0")
        assert ANN_DRAIN in self.claim(name)["metadata"]["annotations"]

    def new_reallocator(self, name, budget=100):
        realloc = ClaimReallocator(self.client, attempt_budget=budget,
                                   metrics=RemediationMetrics())
        realloc._on_claim(self.claim(name))
        return realloc

    def reallocate(self, name, realloc=None):
        """The cluster side's reallocator releases the drained claim and
        binds it again; returns the devices it bound."""
        realloc = realloc or self.new_reallocator(name)
        assert self.wait(lambda: realloc.reconcile_once() == 1)
        assert ANN_DRAIN not in (
            self.claim(name)["metadata"].get("annotations") or {})
        return self.allocated_device(name)


@pytest.fixture()
def stack(tmp_path):
    s = CdStack(tmp_path)
    yield s
    s.stop()


def prepared(stack, kind, name="c1"):
    stack.make(kind, name)
    stack.allocate(name)
    assert stack.wait(lambda: stack.ready(name))
    return stack.ref(name)


class TestReadyImpliesCommitted:
    def test_probe_across_drain_release_and_reprepare(self, stack):
        """Three rounds of a channel claim and a daemon claim: prepared
        through the watcher, drained as the node cordon's companion drain
        drains them, released, their tombstones expired by the GC, and
        prepared again. Then two rounds in which the drained claims are
        bound again to the same devices by the reallocator, without the
        GC, and prepared again at once. No sample may show Ready over a
        record that is not a completed prepare of the Ready devices."""
        names = {"channel": "ch", "daemon": "dm"}
        for kind, name in names.items():
            stack.make(kind, name)
        with ReadyProbe(stack, "ch", driver=CD_DRIVER_NAME) as pch, \
                ReadyProbe(stack, "dm", driver=CD_DRIVER_NAME) as pdm:
            for rnd in range(3):
                for name in names.values():
                    stack.allocate(name)
                for name in names.values():
                    assert stack.wait(lambda name=name: stack.ready(name))
                assert stack.wait(lambda rnd=rnd: min(
                    pch.samples, pdm.samples) >= 40 * (rnd + 1))
                for name in names.values():
                    assert stack.driver.drain_claim(
                        stack.ref(name), reason="node node-0 cordoned")
                    assert stack.checkpoint_entry(name).state == \
                        STATE_PREPARE_ABORTED
                time.sleep(0.05)
                for name in names.values():
                    stack.release(name)
                for name in names.values():
                    assert stack.wait(
                        lambda name=name: not stack.entries(name))
                assert sorted(stack.expire_tombstones()) == sorted(
                    stack.claim(n)["metadata"]["uid"]
                    for n in names.values())
                assert not stack.node_labelled()
            # Two rounds in which the drained claims are bound again to
            # the devices they were drained off, with no GC: the claim
            # watcher drops the drain tombstones and prepares them again.
            for rnd in range(2):
                for name in names.values():
                    stack.allocate(name)
                for name in names.values():
                    assert stack.wait(lambda name=name: stack.ready(name))
                for name in names.values():
                    assert stack.driver.drain_claim(
                        stack.ref(name), reason="node node-0 cordoned")
                    stack.annotate_drained(name)
                for kind, name in names.items():
                    assert stack.reallocate(name) == [DEVICE[kind]]
                for name in names.values():
                    assert stack.wait(lambda name=name: stack.ready(name))
                    assert stack.checkpoint_entry(name).state == \
                        STATE_PREPARE_COMPLETED
                assert stack.node_labelled()
                assert stack.wait(lambda rnd=rnd: min(
                    pch.samples, pdm.samples) >= 40 * (rnd + 4))
                for name in names.values():
                    stack.release(name)
                for name in names.values():
                    assert stack.wait(
                        lambda name=name: not stack.entries(name))
                    assert stack.checkpoint_entry(name) is None
                assert not stack.node_labelled()
        for probe in (pch, pdm):
            assert probe.violations == [], (
                probe.name, len(probe.violations), probe.samples)
            assert probe.samples >= 100, (probe.samples, probe.unconfirmed)


class TestOrderings:
    @pytest.mark.parametrize("kind", KINDS)
    def test_drain_retracts_ready_before_its_tombstone(self, stack, kind):
        ref = prepared(stack, kind)
        seen = []
        transact = stack.driver.state.checkpoints.transact

        def hooked(mutate):
            seen.append(ready_devices(stack.claim("c1"), CD_DRIVER_NAME))
            return transact(mutate)
        stack.driver.state.checkpoints.transact = hooked
        assert stack.driver.drain_claim(ref, reason="node node-0 cordoned")
        assert seen == [set()]
        claim = stack.claim("c1")
        assert drain_marked(claim, CD_DRIVER_NAME)
        (entry,) = stack.entries("c1")
        assert entry["conditions"] == [{"type": "Ready", "status": "False",
                                        "reason": REASON_DRAINED}]
        assert stack.checkpoint_entry("c1").state == STATE_PREPARE_ABORTED
        assert not stack.node_labelled()

    @pytest.mark.parametrize("kind", KINDS)
    def test_no_ready_for_a_claim_drained_before_its_publish(self, stack,
                                                             kind):
        """A drain that takes the record between the watcher's prepare and
        its publish: the publish is dropped, not made over the
        tombstone."""
        prepare = stack.driver.prepare_resource_claims
        drained = []

        def hooked(claims):
            out = prepare(claims)
            if not drained:
                c = claims[0]
                drained.append(stack.driver.drain_claim(ClaimRef(
                    uid=c["metadata"]["uid"], name=c["metadata"]["name"],
                    namespace=c["metadata"]["namespace"])))
            return out
        stack.driver.prepare_resource_claims = hooked
        stack.make(kind, "c1")
        stack.allocate("c1")
        uid = stack.claim("c1")["metadata"]["uid"]

        def handled():
            with stack.loop._mu:
                return uid in stack.loop._prepared
        assert stack.wait(handled)
        assert drained == [True]
        assert not stack.ready("c1")
        assert stack.checkpoint_entry("c1").state == STATE_PREPARE_ABORTED

    @pytest.mark.parametrize("kind", KINDS)
    def test_ready_restored_when_a_drain_stops_before_its_tombstone(
            self, stack, monkeypatch, kind):
        ref = prepared(stack, kind)
        undo = stack.driver.state._unprepare_devices
        seen = []

        def failing(pc):
            seen.append(ready_devices(stack.claim("c1"), CD_DRIVER_NAME))
            raise OSError("domain directory busy")
        monkeypatch.setattr(stack.driver.state, "_unprepare_devices",
                            failing)
        with pytest.raises(OSError):
            stack.driver.drain_claim(ref)
        # Retracted before the undo, then restored by the watcher: the
        # record still reads completed.
        assert seen == [set()]
        monkeypatch.setattr(stack.driver.state, "_unprepare_devices", undo)
        assert stack.wait(lambda: stack.ready("c1"))
        assert not drain_marked(stack.claim("c1"), CD_DRIVER_NAME)
        assert stack.checkpoint_entry("c1").state == STATE_PREPARE_COMPLETED

    @pytest.mark.parametrize("kind", KINDS)
    def test_unprepare_of_a_released_claim_clears_ready_first(
            self, stack, kind):
        """A claim released while its node is fenced: the claim watcher
        defers, and the fence cleanup unprepares the claim when the node
        heals. No Ready may stand while it does; the watcher removes the
        retracted entry once the fence is gone."""
        prepared(stack, kind)
        fenced = [True]
        stack.loop._fence = lambda: fenced[0]
        stack.release("c1")
        seen = []
        unprepare = stack.driver.state.unprepare

        def hooked(ref):
            seen.append(ready_devices(stack.claim("c1"), CD_DRIVER_NAME))
            return unprepare(ref)
        stack.driver.state.unprepare = hooked
        fence_cleanup_for(stack.driver, stack.client)()
        assert seen == [set()]
        assert stack.checkpoint_entry("c1") is None
        fenced[0] = False
        assert stack.wait(lambda: not stack.entries("c1"))
        assert not stack.node_labelled()


    @pytest.mark.parametrize("kind", KINDS)
    def test_an_event_older_than_the_drain_leaves_its_tombstone(
            self, stack, kind):
        """The watcher handles an event that predates the drain after it
        (its own publish's update, when it runs behind): it decides on the
        claim as it is now, so the drain's retraction and tombstone stand,
        and nothing prepares the drained claim once the tombstone
        expires."""
        ref = prepared(stack, kind)
        stale = stack.claim("c1")
        assert stack.driver.drain_claim(ref)
        stack.loop._on_change(stale)
        assert drain_marked(stack.claim("c1"), CD_DRIVER_NAME)
        assert stack.checkpoint_entry("c1").state == STATE_PREPARE_ABORTED
        assert stack.expire_tombstones() == [ref.uid]
        time.sleep(5 * stack.loop.retry_delay)
        assert stack.checkpoint_entry("c1") is None
        assert not stack.ready("c1")


class TestOtherPaths:
    """The plugin's other paths that remove or rewrite a record, each under
    the probe."""

    def test_fence_cleanup_of_the_gpu_plugin(self, tmp_path):
        """The fence cleanup is shared with the GPU plugin: a GPU claim
        released while the node is fenced has its Ready retracted before
        the cleanup unprepares it."""
        s = Stack(tmp_path)
        try:
            s.allocate(s.make_claim("c1"))
            assert s.wait(lambda: s.ready("c1"))
            fenced = [True]
            s.loop._fence = lambda: fenced[0]
            seen = []
            unprepare = s.driver.state.unprepare

            def hooked(ref):
                seen.append(ready_devices(s.claim("c1")))
                return unprepare(ref)
            s.driver.state.unprepare = hooked
            with ReadyProbe(s, "c1") as probe:
                assert s.wait(lambda: probe.samples >= 20)
                s.alloc.release(s.claim("c1"))
                fence_cleanup_for(s.driver, s.client)()
                time.sleep(0.05)
            assert seen == [set()]
            assert s.checkpoint_entry("c1") is None
            fenced[0] = False
            assert s.wait(lambda: not any(
                d.get("driver") == DRIVER
                for d in s.claim("c1")["status"].get("devices") or []))
        finally:
            s.stop()
        assert probe.violations == []

    @pytest.mark.parametrize("kind", KINDS)
    def test_checkpoint_gc_drops_only_records_without_ready(self, stack,
                                                            kind):
        """The GC's two sweeps drop expired tombstones (a drain retracted
        their Ready) and PrepareStarted records of claims that are gone
        (no Ready was published for them)."""
        clock = [time.time()]
        stack.driver.state.clock = lambda: clock[0]
        gc = CdCheckpointCleanupManager(stack.client, stack.driver.state)
        ref = prepared(stack, kind)
        with ReadyProbe(stack, "c1", driver=CD_DRIVER_NAME) as probe:
            assert stack.wait(lambda: probe.samples >= 20)
            assert stack.driver.drain_claim(ref)
            clock[0] += PREPARE_ABORTED_TTL + 1.0
            assert gc.cleanup_once() == [ref.uid]
            time.sleep(0.05)
        assert stack.checkpoint_entry("c1") is None
        assert probe.violations == []

    def test_boot_id_adoption_keeps_the_record(self, stack):
        """A simulated repair flips the node's boot id and every plugin on
        the node adopts it: only the checkpoint's boot id changes, and a
        plugin started after it keeps the claim."""
        ref = prepared(stack, "channel")
        with ReadyProbe(stack, "c1", driver=CD_DRIVER_NAME) as probe:
            assert stack.wait(lambda: probe.samples >= 20)
            with open(stack.boot_path, "w") as f:
                f.write("post-repair-boot\n")
            stack.driver.adopt_boot_id("post-repair-boot")
            assert stack.wait(lambda: probe.samples >= 40)
        assert probe.violations == []
        pc = stack.checkpoint_entry("c1")
        assert pc.state == STATE_PREPARE_COMPLETED and stack.ready("c1")
        assert stack.driver.state.checkpoints.read().node_boot_id == \
            "post-repair-boot"
        assert ref.uid in stack.new_driver().state.prepared_claims()

    @pytest.mark.parametrize("kind", KINDS)
    def test_reboot_invalidation_retracts_ready_before_the_reset(
            self, stack, monkeypatch, kind):
        """A plugin that starts after a reboot discards every record: the
        discarded claims' Ready goes before the reset checkpoint is
        written, and the claim watcher of the new plugin prepares the
        still-reserved claim again."""
        prepared(stack, kind)
        stack.loop.stop()
        stack.loop = None
        stack.driver.stop()
        with open(stack.boot_path, "w") as f:
            f.write("boot-epoch-1\n")
        seen = []
        write = CheckpointManager.write

        def hooked(manager, cp):
            if not cp.prepared_claims:
                seen.append(ready_devices(stack.claim("c1"), CD_DRIVER_NAME))
            return write(manager, cp)
        monkeypatch.setattr(CheckpointManager, "write", hooked)
        stack.driver = stack.new_driver()
        monkeypatch.setattr(CheckpointManager, "write", write)
        assert seen == [set()]
        assert stack.checkpoint_entry("c1") is None
        stack.start_loop()
        assert stack.wait(lambda: stack.ready("c1"))
        assert ready_devices(stack.claim("c1"), CD_DRIVER_NAME) == \
            {DEVICE[kind]}
        assert stack.checkpoint_entry("c1").state == STATE_PREPARE_COMPLETED


    def test_an_event_older_than_a_gpu_drain(self, tmp_path):
        """The same late event on the GPU plugin, whose unprepare drops a
        tombstone: the drained claim is not prepared again on its
        device."""
        s = Stack(tmp_path)
        try:
            s.allocate(s.make_claim("c1"))
            assert s.wait(lambda: s.ready("c1"))
            stale = s.claim("c1")
            uid = stale["metadata"]["uid"]
            assert s.driver.drain_claim(ClaimRef(uid=uid, name="c1",
                                                 namespace="default"))
            s.loop._on_change(stale)
            assert drain_marked(s.claim("c1"), DRIVER)
            assert s.checkpoint_entry("c1").state == STATE_PREPARE_ABORTED
            assert not s.ready("c1")
        finally:
            s.stop()

    def test_reboot_invalidation_of_the_gpu_plugin(self, tmp_path,
                                                   monkeypatch):
        """The GPU plugin's reboot invalidation, the same path on the shared
        checkpoint helper: Ready goes before the reset, and the new
        plugin's watcher prepares the claim again."""
        s = Stack(tmp_path)
        try:
            s.allocate(s.make_claim("c1"))
            assert s.wait(lambda: s.ready("c1"))
            s.loop.stop()
            s.loop = None
            s.driver.stop()
            with open(s.boot_path, "w") as f:
                f.write("boot-epoch-1\n")
            seen = []
            write = CheckpointManager.write

            def hooked(manager, cp):
                if not cp.prepared_claims:
                    seen.append(ready_devices(s.claim("c1")))
                return write(manager, cp)
            monkeypatch.setattr(CheckpointManager, "write", hooked)
            s.driver = GpuDriver(s.client, DriverConfig(
                node_name="node-a", state_dir=str(tmp_path / "state"),
                cdi_root=str(tmp_path / "cdi"), env=s.env,
                retry_timeout=1.0), device_lib=s.lib).start()
            monkeypatch.setattr(CheckpointManager, "write", write)
            assert seen == [set()]
            assert s.checkpoint_entry("c1") is None
            s.loop = NodePrepareLoop(s.client, s.driver, DRIVER, "node-a",
                                     namespace="default",
                                     retry_delay=0.1).start()
            assert s.wait(lambda: s.ready("c1"))
            assert s.checkpoint_entry("c1").state == STATE_PREPARE_COMPLETED
        finally:
            s.stop()


class TestAgainstJax:
    def test_jax_drain_leaves_ready_over_its_tombstone(self, tmp_path):
        """The JAX package's CD drain, which stays as it is, undoes the
        channel and leaves its tombstone with the claim still Ready; the
        port's retracts Ready first. The claim watchers are stopped first:
        a late event would have the JAX watcher act on the claim again."""
        from k8s_dra_driver_tpu.api.computedomain import (
            new_compute_domain as jax_new_compute_domain,
        )
        from k8s_dra_driver_tpu.api.configs import API_VERSION as JAX_API
        from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxClient
        from k8s_dra_driver_tpu.kubeletplugin import Allocator as JaxAlloc
        from k8s_dra_driver_tpu.kubeletplugin.claimwatcher import (
            NodePrepareLoop as JaxLoop,
        )
        from k8s_dra_driver_tpu.plugins.compute_domain_daemon import (
            ComputeDomainDaemon as JaxDaemon,
        )
        from k8s_dra_driver_tpu.plugins.compute_domain_kubelet_plugin import (
            CD_DRIVER_NAME as JAX_CD_DRIVER,
            CdDriver as JaxCdDriver,
            CdDriverConfig as JaxCdDriverConfig,
        )
        from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin.checkpoint import (
            STATE_PREPARE_ABORTED as JAX_ABORTED,
        )
        from k8s_dra_driver_tpu.tpulib import MockDeviceLib as TpuMock

        client = JaxClient()
        client.create(new_object("Node", "node-0"))
        channel_class = "compute-domain-default-channel.tpu.google.com"
        client.create(new_object("DeviceClass", channel_class, spec={
            "selectors": [{"cel": {"expression":
                                   "device.attributes['type'] == "
                                   "'channel'"}}]}))
        cd = client.create(jax_new_compute_domain("cd", num_nodes=1))
        driver = JaxCdDriver(client, JaxCdDriverConfig(
            node_name="node-0", state_dir=str(tmp_path / "jax-state"),
            cdi_root=str(tmp_path / "jax-cdi"), env={}, retry_timeout=1.0),
            device_lib=TpuMock("v5e-16", host_index=0)).start()
        JaxDaemon(client=client, device_lib=TpuMock("v5e-16", host_index=0),
                  cd_uid=cd["metadata"]["uid"], cd_name="cd",
                  node_name="node-0", hostname="host-0").sync_once()
        loop = JaxLoop(client, driver, JAX_CD_DRIVER, driver.pool_name,
                       namespace="default", retry_delay=0.1).start()
        port = CdStack(tmp_path)
        try:
            claim = client.create(new_object(
                "ResourceClaim", "c1", "default",
                api_version="resource.k8s.io/v1", spec={"devices": {
                    "requests": [{"name": "channel", "exactly": {
                        "deviceClassName": channel_class,
                        "allocationMode": "ExactCount", "count": 1}}],
                    "config": [{"requests": ["channel"], "opaque": {
                        "driver": JAX_CD_DRIVER, "parameters": {
                            "apiVersion": JAX_API,
                            "kind": "ComputeDomainChannelConfig",
                            "domainID": cd["metadata"]["uid"],
                            "allocationMode": "Single"}}}]}}))
            JaxAlloc(client).allocate(
                claim, reserved_for=[{"resource": "pods", "name": "p"}],
                node="node-0")

            def jax_claim():
                return client.get("ResourceClaim", "c1", "default")
            assert port.wait(lambda: ready_devices(
                jax_claim(), JAX_CD_DRIVER) == {"channel-0"})
            prepared(port, "channel")
            loop.stop()
            port.loop.stop()
            port.loop = None
            uid = jax_claim()["metadata"]["uid"]
            assert driver.drain_claim(ClaimRef(uid=uid, name="c1",
                                               namespace="default"))
            assert port.driver.drain_claim(port.ref("c1"))
            assert driver.state.prepared_claims()[uid].state == JAX_ABORTED
            assert ready_devices(jax_claim(), JAX_CD_DRIVER) == {"channel-0"}
            assert port.checkpoint_entry("c1").state == STATE_PREPARE_ABORTED
            assert not port.ready("c1")
        finally:
            loop.stop()
            port.stop()


def test_the_smokes_drain_leg_on_a_mock_node(tmp_path, monkeypatch, capsys):
    """``chip_smoke.phase_computedomain``'s teardown on a mock node: its
    drain leg's line reads Ready retracted (``Drained``) when the tombstone
    committed, its rejoin leg's line reads the claim Ready again on a
    completed prepare with the node labelled, and the residue is empty."""
    import chip_smoke
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    _env, teardown = chip_smoke.phase_computedomain(
        "mock", MockDeviceLib(PROFILE), str(tmp_path))
    teardown()
    out = capsys.readouterr().out.splitlines()
    lines = [ln for ln in out if "leg=drain" in ln]
    assert len(lines) == 1, lines
    fields = dict(f.split("=", 1) for f in lines[0].split()[1:])
    assert (fields["ready_at_tombstone"], fields["reason_at_tombstone"],
            fields["node_label"]) == ("False", REASON_DRAINED, "None")
    assert float(fields["ready_ms"]) > 0 and float(fields["drain_ms"]) > 0
    # The rejoin leg: the drained claim, bound again to the same channel,
    # is Ready again within the smoke's deadline, not after the TTL.
    lines = [ln for ln in out if "leg=rejoin" in ln]
    assert len(lines) == 1, lines
    fields = dict(f.split("=", 1) for f in lines[0].split()[1:])
    assert fields["device"] == "channel-0"
    assert 0 < float(fields["reready_ms"]) < chip_smoke.CD_REREADY_S * 1e3
    assert fields["state"] == STATE_PREPARE_COMPLETED
    assert fields["node_label"] not in ("", "None")
    assert fields["residue"] == "[]"
