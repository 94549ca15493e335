"""A ComputeDomain claim drained off its node and bound again to the same
device is prepared again at once, not after its tombstone's TTL.

A node cordon drains every CD claim of the node, and the drain leaves a
``PrepareAborted`` tombstone that keeps the claim's results. After the
uncordon the reallocator may bind the claim again to the same node's
``channel-0`` (or daemon device): the results are then identical, and the
prepare meets the tombstone as a stale retry. The claim watcher resolves
that case. The GPU plugin resolves it by an unprepare, which drops the
tombstone; the CD plugin's unprepare leaves every tombstone standing, as the
reference's does, so its resolution drops only a drain's tombstone of the
same results, under the claim's flight lock. The tombstone of a rolled-back
mid-flight prepare still refuses its stale retry until the GC expires it.

Every case leaves ``PREPARE_ABORTED_TTL`` at its 600 s default, so that a
claim which waits for the GC shows as one that is not Ready within
``REREADY_S``. ``TestAgainstJax`` pins the difference: the JAX package's CD
plugin, which stays as it is, keeps refusing the same-results prepare until
the GC has expired the tombstone.
"""

import json
import time
import zlib

import pytest

from k8s_dra_driver_tpu_torch.api.computedomain import NODE_LABEL_CD
from k8s_dra_driver_tpu_torch.gpulib import MockDeviceLib
from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
    ANN_DRAIN,
    ClaimReallocator,
    DrainController,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg.errors import StaleAbortedClaimError
from k8s_dra_driver_tpu_torch.pkg.faultpoints import FaultCrash
from k8s_dra_driver_tpu_torch.pkg.metrics import RemediationMetrics
from k8s_dra_driver_tpu_torch.pkg.nodelease import (
    clear_cordon_request,
    request_cordon,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin import (
    CD_DRIVER_NAME,
    PREPARE_ABORTED_TTL,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_ABORTED,
    STATE_PREPARE_COMPLETED,
    STATE_PREPARE_STARTED,
    Checkpoint,
    PreparedClaimCP,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.driver import (
    DriverConfig,
    GpuDriver,
)
from tests.test_torch_cd_plugin import (
    make_channel_claim,
    make_cluster,
    prepare,
)
from tests.test_torch_cd_ready_durable import (
    DEVICE,
    KINDS,
    PROFILE,
    CdStack,
    prepared,
)
from tests.test_torch_ready_durable import ready_devices
from tests.test_torch_remediation import Stack

#: how soon a claim bound again to its drained devices must be Ready.
REREADY_S = 5.0

#: the keys of a checkpoint record as the plugin wrote them before a
#: record could mark a drain's tombstone.
PARENT_RECORD_KEYS = {"checkpointState", "name", "namespace", "results",
                      "preparedDevices", "abortedExpiry", "domainID",
                      "vfioRestore"}


@pytest.fixture()
def stack(tmp_path):
    s = CdStack(tmp_path)
    yield s
    s.stop()


def drained_and_annotated(stack, name="c1"):
    """Drain the prepared claim as the node cordon's drain does and write
    its reallocation annotation; the tombstone and the retraction stand."""
    assert stack.driver.drain_claim(stack.ref(name),
                                    reason="node node-0 cordoned")
    stack.annotate_drained(name)
    assert stack.checkpoint_entry(name).state == STATE_PREPARE_ABORTED
    assert not stack.ready(name)


def assert_rejoined(stack, kind, name="c1"):
    """Ready within ``REREADY_S`` of the re-binding, on a completed prepare
    of the same device, with the node's CD label back for a channel, one
    CDI spec (the claim's) and no other record."""
    t0 = time.monotonic()
    assert stack.wait(lambda: stack.ready(name), timeout=REREADY_S), (
        stack.checkpoint_entry(name), stack.entries(name))
    assert time.monotonic() - t0 < REREADY_S
    stack.settle_loop(name)
    uid = stack.claim(name)["metadata"]["uid"]
    pc = stack.checkpoint_entry(name)
    assert pc.state == STATE_PREPARE_COMPLETED
    assert [d["device"] for d in pc.prepared_devices] == [DEVICE[kind]]
    assert ready_devices(stack.claim(name), CD_DRIVER_NAME) == {DEVICE[kind]}
    labels = stack.client.get("Node", "node-0")["metadata"].get("labels")
    cd_labels = {k: v for k, v in (labels or {}).items()
                 if k == NODE_LABEL_CD}
    want = {NODE_LABEL_CD: stack.cd["metadata"]["uid"]}
    assert cd_labels == (want if kind == "channel" else {})
    assert stack.driver.cdi.list_claim_uids() == [uid]
    assert list(stack.driver.state.prepared_claims_nolock()) == [uid]


class TestRejoin:
    @pytest.mark.parametrize("kind", KINDS)
    def test_direct(self, stack, kind):
        """(a) Drained with the watcher live, annotated, and bound again to
        the same device on node-0 by the reallocator: Ready again at once."""
        prepared(stack, kind)
        drained_and_annotated(stack)
        assert stack.reallocate("c1") == [DEVICE[kind]]
        assert_rejoined(stack, kind)

    @pytest.mark.parametrize("kind", KINDS)
    def test_through_the_node_cordon(self, stack, tmp_path, kind):
        """(b) The cordon annotation goes to the node's drain controller,
        whose node-cordon step drains the CD claim as its companion's. The
        reallocator cannot place the claim while the node is cordoned;
        after the uncordon it binds it again to the same device, and the
        claim is Ready again at once."""
        gpu = GpuDriver(stack.client, DriverConfig(
            node_name="node-0", state_dir=str(tmp_path / "gpu-state"),
            cdi_root=str(tmp_path / "gpu-cdi"), env=stack.env,
            retry_timeout=1.0), device_lib=MockDeviceLib(PROFILE)).start()
        drainer = DrainController(stack.client, gpu,
                                  companions=[stack.driver],
                                  metrics=RemediationMetrics())
        try:
            prepared(stack, kind)
            assert request_cordon(stack.client, "node-0")
            assert drainer.poll_once()["drained"] == 1
            assert stack.driver.cordoned
            assert stack.checkpoint_entry("c1").state == \
                STATE_PREPARE_ABORTED
            assert ANN_DRAIN in stack.claim("c1")["metadata"]["annotations"]
            assert not stack.ready("c1")
            realloc = stack.new_reallocator("c1")
            assert realloc.reconcile_once() == 0    # no device while cordoned
            assert not stack.allocated_device("c1")
            assert clear_cordon_request(stack.client, "node-0")
            drainer.poll_once()
            assert not stack.driver.cordoned
            assert stack.reallocate("c1", realloc) == [DEVICE[kind]]
            assert_rejoined(stack, kind)
        finally:
            gpu.stop()

    @pytest.mark.parametrize("kind", KINDS)
    def test_restarted_watcher(self, stack, kind):
        """(c) The watcher is stopped before the drain and the
        reallocation; a new one resumes the claim watch and makes the
        claim Ready."""
        prepared(stack, kind)
        stack.settle_loop()
        stack.loop.stop()
        stack.loop = None
        drained_and_annotated(stack)
        assert stack.reallocate("c1") == [DEVICE[kind]]
        assert stack.checkpoint_entry("c1").state == STATE_PREPARE_ABORTED
        stack.start_loop()
        assert_rejoined(stack, kind)

    @pytest.mark.parametrize("kind", KINDS)
    def test_events_behind_the_reallocation(self, stack, kind):
        """The watcher runs behind: the reallocation lands while it still
        holds the drain's events. Deciding on a fresh read of the claim, it
        prepares the claim bound again; the release event it handles after
        that is older than the state it prepared from and must not
        unprepare the claim: once Ready, the claim stays Ready with its
        label, and nothing undoes its devices after the drain."""
        prepared(stack, kind)
        undone = []
        undo = stack.driver.state._unprepare_devices

        def counted(pc):
            undone.append(pc.state)
            return undo(pc)
        stack.driver.state._unprepare_devices = counted
        with stack.loop._mu:
            drained_and_annotated(stack)
            assert stack.reallocate("c1") == [DEVICE[kind]]
        assert stack.wait(lambda: stack.ready("c1"), timeout=REREADY_S)
        rv = int(stack.claim("c1")["metadata"]["resourceVersion"])
        deadline = time.monotonic() + REREADY_S
        while stack.loop._rv_store._latest < rv:
            assert time.monotonic() < deadline
            assert stack.ready("c1")
            assert stack.node_labelled() == (kind == "channel")
            time.sleep(0.005)
        assert_rejoined(stack, kind)
        assert len(undone) == 1, undone        # the drain's own undo

    def test_events_behind_the_reallocation_on_the_gpu_plugin(
            self, tmp_path):
        """The same late release event on the GPU plugin, whose resolution
        is an unprepare: the claim prepared on a fresh read is not undone
        by it."""
        s = Stack(tmp_path)
        try:
            s.allocate(s.make_claim(
                "c1", selector="device.attributes['index'] == 2"))
            assert s.wait(lambda: s.ready("c1"))
            undone = []
            undo = s.driver.state._undo_devices

            def counted(pc):
                undone.append(pc.state)
                return undo(pc)
            s.driver.state._undo_devices = counted
            ref = ClaimRef.from_claim(s.claim("c1"))
            realloc = ClaimReallocator(s.client, attempt_budget=100,
                                       metrics=RemediationMetrics())
            with s.loop._mu:
                assert s.driver.drain_claim(ref)
                assert DrainController(
                    s.client, s.driver, metrics=RemediationMetrics(),
                )._annotate_drained(ref, "gpu-2")
                realloc._on_claim(s.claim("c1"))
                assert s.wait(lambda: realloc.reconcile_once() == 1)
            assert s.allocated_device("c1") == "gpu-2"
            assert s.wait(lambda: s.ready("c1"), timeout=REREADY_S)
            # The loop keeps no informer rv here: give it the time to
            # handle the events it held (a few milliseconds).
            time.sleep(10 * s.loop.retry_delay)
            assert s.ready("c1")
            assert s.checkpoint_entry("c1").state == STATE_PREPARE_COMPLETED
            assert len(undone) == 1, undone        # the drain's own undo
        finally:
            s.stop()

    @pytest.mark.parametrize("point", ["before_drop", "after_drop"])
    @pytest.mark.parametrize("kind", KINDS)
    def test_restart_inside_the_resolution(self, stack, kind, point):
        """(d) The plugin dies inside the watcher's resolution, before the
        drop of the tombstone or after it (with the new prepare's label
        and CDI spec made and its completion not committed), and the
        driver and watcher are started again on the same state directory.
        The watcher that died is driven by hand from the test's thread, so
        that the simulated crash lands there."""
        prepared(stack, kind)
        drained_and_annotated(stack)
        stack.settle_loop()
        old = stack.loop
        old.stop()
        stack.loop = None
        assert stack.reallocate("c1") == [DEVICE[kind]]
        driver = stack.driver
        resolve = driver.resolve_drained_claims
        create_spec = driver.cdi.create_claim_spec_file
        reached = []

        def crash_in_resolve(claims):
            reached.append("resolve")
            if point == "before_drop":
                raise FaultCrash("plugin killed before the tombstone's drop")
            errs = resolve(claims)
            assert set(errs.values()) == {None}
            return errs

        def crash_after_spec(uid, devices):
            create_spec(uid, devices)
            reached.append("spec")
            raise FaultCrash("plugin killed before the prepare's commit")

        driver.resolve_drained_claims = crash_in_resolve
        driver.cdi.create_claim_spec_file = crash_after_spec
        with pytest.raises(FaultCrash):
            old._on_change(stack.claim("c1"))
        pc = stack.checkpoint_entry("c1")
        if point == "before_drop":
            assert reached == ["resolve"]
            assert pc.state == STATE_PREPARE_ABORTED
        else:
            assert reached == ["resolve", "spec"]
            assert pc.state == STATE_PREPARE_STARTED
        assert not stack.ready("c1")
        driver.stop()
        stack.driver = stack.new_driver()
        stack.start_loop()
        assert_rejoined(stack, kind)


class TestRollbackTombstone:
    def test_resolution_keeps_a_rolled_back_prepares_tombstone(
            self, tmp_path):
        """An unprepare of a mid-flight prepare leaves a tombstone that is
        not a drain's: the resolution refuses to drop it, the stale retry
        stays refused, and only the GC's expiry lets the claim prepare."""
        client, drivers, cd = make_cluster(tmp_path)
        driver = drivers[0]
        make_channel_claim(client, "stuck", cd, node=0)
        claim, result = prepare(client, driver, "stuck")
        assert result.error is not None
        uid = claim["metadata"]["uid"]
        assert driver.state.prepared_claims()[uid].state == \
            STATE_PREPARE_STARTED
        driver.unprepare_resource_claims([ClaimRef.from_claim(claim)])
        pc = driver.state.prepared_claims()[uid]
        assert pc.state == STATE_PREPARE_ABORTED and not pc.drained
        err = driver.resolve_drained_claims([claim])[uid]
        assert isinstance(err, StaleAbortedClaimError)
        assert driver.state.prepared_claims()[uid].state == \
            STATE_PREPARE_ABORTED
        assert isinstance(
            driver.prepare_resource_claims([claim])[uid].error,
            StaleAbortedClaimError)
        assert driver.state.delete_expired_aborted(
            now=time.time() + PREPARE_ABORTED_TTL + 1.0) == [uid]
        assert driver.resolve_drained_claims([claim])[uid] is None

    @pytest.mark.parametrize("kind", KINDS)
    def test_resolution_keeps_a_tombstone_of_other_results(self, stack,
                                                           kind):
        """A drain's tombstone of other results than the claim's current
        allocation is left to the prepare, which overwrites it."""
        prepared(stack, kind)
        drained_and_annotated(stack)
        claim = stack.claim("c1")
        claim["status"]["allocation"]["devices"]["results"][0]["device"] = \
            "channel-1" if kind == "channel" else "daemon-x"
        assert stack.driver.resolve_drained_claims([claim]) == {
            claim["metadata"]["uid"]: None}
        pc = stack.checkpoint_entry("c1")
        assert pc.state == STATE_PREPARE_ABORTED and pc.drained


def _crc(payload):
    return zlib.crc32(json.dumps(payload, sort_keys=True,
                                 separators=(",", ":")).encode())


class TestParentCheckpoint:
    @pytest.mark.parametrize("kind", KINDS)
    def test_a_drain_marks_its_tombstone(self, stack, kind):
        """The drain's tombstone carries the marker and the claim's
        results; the prepare that replaces it starts a record without
        it."""
        prepared(stack, kind)
        results = stack.checkpoint_entry("c1").results
        drained_and_annotated(stack)
        pc = stack.checkpoint_entry("c1")
        assert pc.drained and pc.results == results
        stack.reallocate("c1")
        assert_rejoined(stack, kind)
        assert not stack.checkpoint_entry("c1").drained

    def test_marker_is_written_only_for_a_drain(self):
        """A record that is not a drain's tombstone serializes with the
        keys it had before the marker existed; a drain's adds the marker
        and reads back with it."""
        plain = PreparedClaimCP(state=STATE_PREPARE_ABORTED, name="c1",
                                results=[{"device": "channel-0"}])
        assert set(plain.to_dict()) == PARENT_RECORD_KEYS
        drained = PreparedClaimCP.from_dict(
            dict(plain.to_dict(), drained=True))
        assert drained.drained and drained.to_dict()["drained"] is True
        cp = Checkpoint.unmarshal(Checkpoint(
            prepared_claims={"u": drained}).marshal())
        assert cp.prepared_claims["u"].drained

    @pytest.mark.parametrize("kind", KINDS)
    def test_a_parent_written_tombstone_is_an_unprepares(self, stack, kind):
        """A checkpoint file with a drained claim's tombstone as the plugin
        wrote it before the marker existed loads, and its tombstone is
        treated as an unprepare's: the resolution does not drop it, the
        same-results prepare stays refused, and the GC's expiry frees the
        claim."""
        prepared(stack, kind)
        drained_and_annotated(stack)
        stack.settle_loop()
        stack.loop.stop()
        stack.loop = None
        stack.driver.stop()
        path = stack.driver.state.checkpoints.path
        with open(path) as f:
            doc = json.load(f)
        uid = stack.claim("c1")["metadata"]["uid"]
        record = doc["v2"]["preparedClaims"][uid]
        del record["drained"]
        assert set(record) == PARENT_RECORD_KEYS
        doc["v2"]["checksum"] = 0
        doc["v2"]["checksum"] = _crc(doc["v2"])
        doc["checksum"] = 0
        doc["checksum"] = _crc(doc)
        with open(path, "w") as f:
            f.write(json.dumps(doc, sort_keys=True, indent=1))

        stack.driver = stack.new_driver()
        pc = stack.checkpoint_entry("c1")
        assert pc.state == STATE_PREPARE_ABORTED and not pc.drained
        assert stack.reallocate("c1") == [DEVICE[kind]]
        claim = stack.claim("c1")
        assert isinstance(stack.driver.resolve_drained_claims([claim])[uid],
                          StaleAbortedClaimError)
        assert isinstance(
            stack.driver.prepare_resource_claims([claim])[uid].error,
            StaleAbortedClaimError)
        assert stack.expire_tombstones() == [uid]
        stack.start_loop()
        assert_rejoined(stack, kind)


class TestAgainstJax:
    def test_jax_plugin_waits_out_the_ttl(self, tmp_path):
        """Sequence (a) on the JAX package's CD plugin, claim watcher and
        reallocator: the same-results prepare stays refused, with no Ready,
        for ``REREADY_S``, and the claim is prepared only after the GC has
        expired the tombstone."""
        from k8s_dra_driver_tpu.api.computedomain import (
            new_compute_domain as jax_new_compute_domain,
        )
        from k8s_dra_driver_tpu.api.configs import API_VERSION as JAX_API
        from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxClient
        from k8s_dra_driver_tpu.k8sclient.client import (
            new_object as jax_new_object,
        )
        from k8s_dra_driver_tpu.kubeletplugin import Allocator as JaxAlloc
        from k8s_dra_driver_tpu.kubeletplugin.claimwatcher import (
            NodePrepareLoop as JaxLoop,
        )
        from k8s_dra_driver_tpu.kubeletplugin.remediation import (
            ANN_DRAIN as JAX_ANN_DRAIN,
            ClaimReallocator as JaxReallocator,
            DrainController as JaxDrainController,
        )
        from k8s_dra_driver_tpu.kubeletplugin.types import (
            ClaimRef as JaxClaimRef,
        )
        from k8s_dra_driver_tpu.pkg.metrics import (
            RemediationMetrics as JaxRemediationMetrics,
        )
        from k8s_dra_driver_tpu.plugins.compute_domain_daemon import (
            ComputeDomainDaemon as JaxDaemon,
        )
        from k8s_dra_driver_tpu.plugins.compute_domain_kubelet_plugin import (
            CD_DRIVER_NAME as JAX_CD_DRIVER,
            PREPARE_ABORTED_TTL as JAX_TTL,
            CdDriver as JaxCdDriver,
            CdDriverConfig as JaxCdDriverConfig,
        )
        from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin.checkpoint import (
            STATE_PREPARE_ABORTED as JAX_ABORTED,
            STATE_PREPARE_COMPLETED as JAX_COMPLETED,
        )
        from k8s_dra_driver_tpu.tpulib import MockDeviceLib as TpuMock

        assert JAX_TTL == PREPARE_ABORTED_TTL
        client = JaxClient()
        client.create(jax_new_object("Node", "node-0"))
        channel_class = "compute-domain-default-channel.tpu.google.com"
        client.create(jax_new_object("DeviceClass", channel_class, spec={
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
        try:
            claim = client.create(jax_new_object(
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

            def jax_ready():
                return ready_devices(jax_claim(), JAX_CD_DRIVER)

            def wait(cond, timeout):
                deadline = time.monotonic() + timeout
                while time.monotonic() < deadline:
                    if cond():
                        return True
                    time.sleep(0.02)
                return False

            assert wait(lambda: jax_ready() == {"channel-0"}, 8.0)
            uid = jax_claim()["metadata"]["uid"]
            ref = JaxClaimRef(uid=uid, name="c1", namespace="default")
            assert driver.drain_claim(ref, reason="node node-0 cordoned")
            assert JaxDrainController(
                client, driver, metrics=JaxRemediationMetrics(),
            )._annotate_drained(ref, "node:node-0")
            realloc = JaxReallocator(client, attempt_budget=100,
                                     metrics=JaxRemediationMetrics())
            realloc._on_claim(jax_claim())
            assert wait(lambda: realloc.reconcile_once() == 1, 8.0)
            assert JAX_ANN_DRAIN not in (
                jax_claim()["metadata"].get("annotations") or {})
            results = jax_claim()["status"]["allocation"]["devices"][
                "results"]
            assert [r["device"] for r in results] == ["channel-0"]
            assert not wait(jax_ready, REREADY_S)
            assert driver.state.prepared_claims()[uid].state == JAX_ABORTED
            assert driver.state.delete_expired_aborted(
                now=time.time() + JAX_TTL + 1.0) == [uid]
            assert wait(lambda: jax_ready() == {"channel-0"}, 8.0)
            assert driver.state.prepared_claims()[uid].state == JAX_COMPLETED
        finally:
            loop.stop()
