"""The GPU port's synthetic canary prober.

The scenarios of the JAX package's ``tests/test_canary.py``
``TestCanaryProber``, ``TestCanaryScoring``, ``TestDefragCanary`` and
``TestCanaryCorroboration`` on the port's ``h100-8`` mock: the green
lifecycle and per-phase failure classification, the residue leak
detector, the ``canary.probe`` fault point, last-resort canary placement,
the utilization gauge and the defrag planner's placement menu (held
against the JAX allocator on the JAX package's own mesh slices), canary
victims free to evict, and the canary verdict as a corroborating — never
deciding — node-lost signal. ``TestAgainstJax`` drives one canary round
with a leak through both packages.
"""

import time

import pytest

from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxFakeClient
from k8s_dra_driver_tpu.k8sclient.client import new_object as jax_new_object
from k8s_dra_driver_tpu.kubeletplugin import Allocator as JaxAllocator
from k8s_dra_driver_tpu.kubeletplugin import Helper as JaxHelper
from k8s_dra_driver_tpu.kubeletplugin.claimwatcher import (
    NodePrepareLoop as JaxNodePrepareLoop,
)
from k8s_dra_driver_tpu.kubeletplugin.types import (
    DriverResources as JaxDriverResources,
)
from k8s_dra_driver_tpu.kubeletplugin.types import Pool as JaxPool
from k8s_dra_driver_tpu.kubeletplugin.types import Slice as JaxSlice
from k8s_dra_driver_tpu.pkg import canary as jax_canary
from k8s_dra_driver_tpu.pkg.metrics import (
    AllocatorMetrics as JaxAllocatorMetrics,
)
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import (
    DriverConfig as JaxDriverConfig,
)
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import TpuDriver
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import (
    partitions as jax_partitions,
)
from k8s_dra_driver_tpu.tpulib.device_lib import (
    MockDeviceLib as JaxMockDeviceLib,
)
from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import DefragPlanner
from k8s_dra_driver_tpu_torch.pkg import faultpoints, tracing
from k8s_dra_driver_tpu_torch.pkg.canary import (
    ANN_CANARY,
    CanaryMetrics,
    CanaryProber,
    canary_probe_signal,
    driver_probe_hooks,
)
from k8s_dra_driver_tpu_torch.pkg.metrics import AllocatorMetrics
from k8s_dra_driver_tpu_torch.pkg.nodelease import (
    NodeLeaseHeartbeat,
    NodeLifecycleController,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)

DRIVER = "gpu.nvidia.com"


def _gpu_class(client):
    client.create(new_object(
        "DeviceClass", DRIVER,
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))


def _driver(client, tmp_path):
    return GpuDriver(client, DriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "s"),
        cdi_root=str(tmp_path / "c"), env={}, retry_timeout=0.3,
    ), device_lib=MockDeviceLib("h100-8")).start()


@pytest.fixture()
def stack(tmp_path):
    """One real node stack: GpuDriver + NodePrepareLoop + DeviceClass —
    the full path a canary probe exercises."""
    client = FakeClient()
    _gpu_class(client)
    client.create(new_object("Node", "node-a"))
    driver = _driver(client, tmp_path)
    loop = NodePrepareLoop(client, driver, DRIVER, "node-a",
                           retry_delay=0.2).start()
    yield client, driver, loop
    loop.stop()
    driver.stop()


def _prober(client, driver=None, **kw):
    kw.setdefault("nodes", ["node-a"])
    kw.setdefault("probe_deadline_s", 3.0)
    kw.setdefault("metrics", CanaryMetrics())
    if driver is not None and "verify" not in kw:
        verify, residue = driver_probe_hooks(lambda _n: driver)
        kw["verify"], kw["residue"] = verify, residue
    return CanaryProber(client, Allocator(client), **kw)


def _canary_claim(client, name, node="node-a"):
    return client.create({
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": name, "namespace": "default",
                     "annotations": {ANN_CANARY: node}},
        "spec": {"devices": {"requests": []}}})


def _gpu_claim(client, name, count=1, canary=False):
    obj = new_object(
        "ResourceClaim", name, "default", api_version="resource.k8s.io/v1",
        spec={"devices": {"requests": [{"name": "r", "exactly": {
            "deviceClassName": DRIVER, "allocationMode": "ExactCount",
            "count": count}}]}})
    if canary:
        obj["metadata"]["annotations"] = {ANN_CANARY: "node-a"}
    return client.create(obj)


def _device(claim):
    return claim["status"]["allocation"]["devices"]["results"][0]["device"]


class TestCanaryProber:
    def test_green_probe_full_lifecycle(self, stack):
        client, driver, _loop = stack
        p = _prober(client, driver)
        res = p.probe_node("node-a")
        assert res["outcome"] == "ok", res
        assert set(res["phases"]) == {"admission", "prepare", "verify",
                                      "teardown", "residue"}
        for ph in ("admission", "prepare", "verify", "teardown", "residue"):
            assert p.metrics.probe_total.value(phase=ph, outcome="ok") == 1
        assert p.metrics.probes_total.value(node="node-a", outcome="ok") == 1
        assert p.metrics.probe_seconds.count(node="node-a") == 1
        assert not [c for c in client.list("ResourceClaim", "default")
                    if ANN_CANARY in (c["metadata"].get("annotations")
                                      or {})]
        assert not driver.state.prepared_claims()
        assert p.success_p99_s() is not None

    def test_probe_histograms_carry_no_exemplar_while_untraced(self, stack):
        """With the tracer off (the default) the probe histograms expose
        no exemplar."""
        client, driver, _loop = stack
        p = _prober(client, driver)
        assert p.probe_node("node-a")["outcome"] == "ok"
        text = p.metrics.registry.expose_text()
        assert "gpu_dra_canary_phase_seconds_bucket" in text
        assert "gpu_dra_canary_probe_seconds_bucket" in text
        assert "# EXEMPLAR" not in text

    def test_probe_phases_carry_trace_exemplars(self, stack):
        """With the tracer on, each probe's trace is the exemplar of its
        phase and probe histograms, as in the JAX test."""
        client, driver, _loop = stack
        tracing.enable()
        try:
            p = _prober(client, driver)
            assert p.probe_node("node-a")["outcome"] == "ok"
            text = p.metrics.registry.expose_text()
            assert "# EXEMPLAR gpu_dra_canary_phase_seconds" in text
            assert "# EXEMPLAR gpu_dra_canary_probe_seconds" in text
        finally:
            tracing._reset_for_tests()

    def test_admission_failure_classified(self, stack):
        client, _driver, _loop = stack
        p = _prober(client, nodes=["node-nope"])
        res = p.probe_node("node-nope")
        assert res["outcome"] == "failed" and res["phase"] == "admission"
        assert p.metrics.probe_total.value(
            phase="admission", outcome="failed") == 1
        assert p.metrics.probes_total.value(node="node-nope",
                                            outcome="failed") == 1

    def test_admission_fails_on_a_tainted_only_gpu(self, stack):
        """Every GPU tainted NoSchedule: the probe fails in admission and
        leaves nothing behind."""
        client, driver, _loop = stack
        driver.set_cordon("requested")
        p = _prober(client, driver)
        res = p.probe_node("node-a")
        assert res["outcome"] == "failed" and res["phase"] == "admission"
        assert res["leaks"] == []
        assert not client.list("ResourceClaim", "default")

    def test_prepare_timeout_classified(self, tmp_path):
        client = FakeClient()
        _gpu_class(client)
        driver = _driver(client, tmp_path)
        try:
            p = _prober(client, probe_deadline_s=0.3)
            res = p.probe_node("node-a")
            assert res["outcome"] == "failed" and res["phase"] == "prepare"
            assert not client.list("ResourceClaim", "default")
        finally:
            driver.stop()

    def test_verify_failure_classified(self, stack):
        client, _driver, _loop = stack
        p = _prober(client, verify=lambda _n, _c: "synthetic verify error")
        res = p.probe_node("node-a")
        assert res["outcome"] == "failed" and res["phase"] == "verify"
        assert "synthetic verify error" in res["error"]

    def test_verify_hook_reads_cuda_visible_devices(self, stack):
        client, driver, _loop = stack
        verify, _residue = driver_probe_hooks(lambda _n: driver)
        claim = Allocator(client).allocate(_gpu_claim(client, "v"),
                                           node="node-a")
        uid = claim["metadata"]["uid"]
        assert verify("node-a", claim) == f"no CDI spec on node-a for " \
                                          f"claim {uid}"
        assert driver.prepare_resource_claims([claim])[uid].error is None
        assert verify("node-a", claim) is None
        assert verify("node-a", {"metadata": {}}) is not None

    def test_teardown_failure_classified(self, stack, monkeypatch):
        client, _driver, _loop = stack
        p = _prober(client)
        real_delete = client.delete

        def bad_delete(kind, name, ns=""):
            if kind == "ResourceClaim" and name.startswith("canary-"):
                raise RuntimeError("delete broken")
            return real_delete(kind, name, ns)

        monkeypatch.setattr(client, "delete", bad_delete)
        res = p.probe_node("node-a")
        assert res["outcome"] == "failed" and res["phase"] == "teardown"
        monkeypatch.undo()
        res2 = p.probe_node("node-a")
        assert res2["outcome"] == "leaked"
        assert any("claim:" in s for s in res2["leaks"])

    def test_residue_reports_leaked(self, stack):
        client, driver, _loop = stack
        _canary_claim(client, "canary-node-a-stale-1")
        p = _prober(client, driver)
        res = p.probe_node("node-a")
        assert res["outcome"] == "leaked"
        assert res["leaks"] == ["claim:canary-node-a-stale-1"]
        assert p.metrics.probe_total.value(
            phase="residue", outcome="leaked") == 1
        assert p.metrics.probes_total.value(node="node-a",
                                            outcome="leaked") == 1
        assert p.leaked == 1

    def test_residue_hook_flags_leaked_checkpoint(self, tmp_path):
        client = FakeClient()
        _gpu_class(client)
        driver = _driver(client, tmp_path)
        try:
            claim = Allocator(client).allocate(
                _gpu_claim(client, "canary-node-a-dead-7"), node="node-a")
            uid = claim["metadata"]["uid"]
            assert driver.prepare_resource_claims([claim])[uid].error is None
            client.delete("ResourceClaim", "canary-node-a-dead-7", "default")
            _verify, residue = driver_probe_hooks(lambda _n: driver)
            assert residue("node-a", set()) == [
                "checkpoint:node-a:canary-node-a-dead-7"]
            assert residue("node-a", {uid}) == []
            # An unreachable node's hooks skip.
            verify, residue = driver_probe_hooks(lambda _n: None)
            assert residue("node-a", set()) == []
            assert verify("node-a", claim) is None
        finally:
            driver.stop()

    def test_failed_probe_with_residue_stays_failed(self, tmp_path):
        client = FakeClient()
        _gpu_class(client)
        driver = _driver(client, tmp_path)
        try:
            _canary_claim(client, "canary-node-a-old-9")
            p = _prober(client, probe_deadline_s=0.2, fail_threshold=2)
            for _ in range(2):
                res = p.probe_node("node-a")
                assert res["outcome"] == "failed", res
                assert res["phase"] == "prepare"
                assert res["leaks"] == ["claim:canary-node-a-old-9"]
            assert p.node_failing("node-a")
            assert p.failures == 2 and p.leaked == 2
            snap = p.debug_snapshot()
            assert snap["nodes"]["node-a"]["consecutive_failures"] == 2
            assert snap["nodes"]["node-a"]["leaked"] == 2
        finally:
            driver.stop()

    def test_probe_fault_point_degrades_never_raises(self, stack):
        client, driver, _loop = stack
        p = _prober(client, driver)
        with faultpoints.injected("canary.probe=nth:1"):
            results = p.run_once()
        assert [r["outcome"] for r in results] == ["failed"]
        assert results[0]["phase"] == "admission"
        assert p.node_failing("node-a") is False  # threshold is 2
        assert p.probe_node("node-a")["outcome"] == "ok"

    def test_node_failing_threshold_and_reset(self, stack):
        client, _driver, _loop = stack
        p = _prober(client, nodes=["node-gone"], probe_deadline_s=0.2)
        assert p.probe_node("node-gone")["outcome"] == "failed"
        assert not p.node_failing("node-gone")
        assert p.probe_node("node-gone")["outcome"] == "failed"
        assert p.node_failing("node-gone")
        assert canary_probe_signal(p)("node-gone") is True
        p2 = _prober(client, driver=None)
        assert not p2.node_failing("node-a")

    def test_node_set_from_published_slices(self, stack):
        client, _driver, _loop = stack
        assert CanaryProber(client, Allocator(client)).node_names() == [
            "node-a"]
        assert CanaryProber(client, Allocator(client),
                            nodes=lambda: ["x"]).node_names() == ["x"]

    def test_debug_snapshot_shape(self, stack):
        client, driver, _loop = stack
        p = _prober(client, driver)
        p.probe_node("node-a")
        snap = p.debug_snapshot()
        assert snap["probes"] == 1
        st = snap["nodes"]["node-a"]
        assert st["last_outcome"] == "ok" and len(st["history"]) == 1
        assert st["history"][0]["phases"]["prepare"] >= 0

    def test_background_loop_pauses_and_stops(self, stack):
        client, driver, _loop = stack
        p = _prober(client, driver, interval_s=0.05).start()
        try:
            deadline = time.monotonic() + 5
            while p.probes < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert p.probes >= 1
            p.pause()
        finally:
            p.stop()


# --------------------------------------------------------------------------
# Allocator: last-resort canary placement, utilization, placement menu
# --------------------------------------------------------------------------

def _gpu_node(tmp_path):
    client = FakeClient()
    _gpu_class(client)
    return client, _driver(client, tmp_path)


def _jax_mesh_slices(shapes=((1, 2), (2, 2), (2, 4))):
    """The JAX test's placement cluster (one single-host 4x4 pool of chip
    and subslice devices with KEP-4815 counters), published by the JAX
    package; returns its DeviceClasses and ResourceSlices as plain
    objects."""
    client = JaxFakeClient()
    client.create(jax_new_object(
        "DeviceClass", "tpu-chip",
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'tpu'"}}]}))
    for s in sorted({"x".join(str(x) for x in sh) for sh in shapes}):
        client.create(jax_new_object(
            "DeviceClass", f"tpu-sub-{s}",
            spec={"selectors": [{"cel": {"expression":
                "device.attributes['type'] == 'subslice' && "
                f"device.attributes['shape'] == '{s}'"}}]}))
    lib = JaxMockDeviceLib({"name": "canary-test", "chip_type": "v5e",
                            "topology": "4x4", "wrap": [False, False],
                            "num_hosts": 1, "slice_uuid": "cn-0"},
                           host_index=0)
    chips, info = lib.enumerate_chips(), lib.slice_info()
    devices = [jax_partitions.full_chip_device(c, info) for c in chips]
    devices += jax_partitions.subslice_devices(chips, info, shapes=shapes)

    class _Stub:
        def prepare_resource_claims(self, claims):
            return {}

        def unprepare_resource_claims(self, refs):
            return {}

    JaxHelper(client, "tpu.google.com", "node-0", _Stub()).publish_resources(
        JaxDriverResources(pools={"node-0": JaxPool(slices=[JaxSlice(
            devices=devices,
            shared_counters=[jax_partitions.chip_counter_set(chips)])])}))
    return client


def _copy_into(src, dst):
    """The JAX cluster's classes and slices, re-created in ``dst``."""
    for kind in ("DeviceClass", "ResourceSlice"):
        for o in src.list(kind):
            md = o["metadata"]
            dst.create({**o, "metadata": {"name": md["name"],
                                          "labels": md.get("labels", {})}})


def _mesh_claim(client, new, name, device_class="tpu-chip", count=1):
    return client.create(new(
        "ResourceClaim", name, "default", api_version="resource.k8s.io/v1",
        spec={"devices": {"requests": [{"name": "r", "exactly": {
            "deviceClassName": device_class,
            "allocationMode": "ExactCount", "count": count}}]}}))


class TestCanaryScoring:
    def test_canary_places_last_real_places_first(self, tmp_path):
        client, driver = _gpu_node(tmp_path)
        alloc = Allocator(client, metrics=AllocatorMetrics())
        cn = alloc.allocate(_gpu_claim(client, "cn", canary=True),
                            node="node-a")
        real = alloc.allocate(_gpu_claim(client, "real"), node="node-a")
        assert _device(cn) == "gpu-7"
        assert _device(real) == "gpu-0"
        driver.stop()

    def test_canary_last_resort_under_first_fit_too(self, tmp_path):
        client, driver = _gpu_node(tmp_path)
        alloc = Allocator(client, metrics=AllocatorMetrics(),
                          strategy="first-fit")
        cn = alloc.allocate(_gpu_claim(client, "cn", canary=True),
                            node="node-a")
        assert _device(cn) == "gpu-7"
        driver.stop()

    def test_whole_gpu_pools_have_no_placement_geometry(self, tmp_path):
        """A GPU slice publishes no mesh geometry, so the fragmentation
        report and the defrag planner's placement menu are empty there."""
        client, driver = _gpu_node(tmp_path)
        alloc = Allocator(client, metrics=AllocatorMetrics())
        claim = alloc.allocate(_gpu_claim(client, "u"), node="node-a")
        assert alloc.fragmentation_report() == []
        assert alloc.placement_options(claim) == []
        driver.stop()

    def test_utilization_and_placement_match_jax_on_a_mesh(self):
        """The ported utilization gauge, fragmentation report and
        placement menu on the JAX package's own mesh slices: allocate,
        allocate a 2x2 subslice, release — every read equal to JAX's."""
        jc = _jax_mesh_slices()
        pc = FakeClient()
        _copy_into(jc, pc)
        jm, pm = JaxAllocatorMetrics(), AllocatorMetrics()
        ja = JaxAllocator(jc, metrics=jm)
        pa = Allocator(pc, metrics=pm)
        reads = []
        for client, alloc, m, new in ((jc, ja, jm, jax_new_object),
                                      (pc, pa, pm, new_object)):
            got = []
            u1 = alloc.allocate(_mesh_claim(client, new, "u1"),
                                node="node-0")
            got.append(m.utilization.value(node="node-0", pool="node-0"))
            alloc.allocate(_mesh_claim(client, new, "u2", "tpu-sub-2x2"),
                           node="node-0")
            got.append(m.utilization.value(node="node-0", pool="node-0"))
            blocked = _mesh_claim(client, new, "big", "tpu-sub-2x4")
            got.append(sorted(
                (o["device"], o["volume"], o["victim_chips"],
                 sorted(v["name"] for v in o["victims"]))
                for o in alloc.placement_options(blocked, node="node-0")))
            alloc.release(u1)
            got.append(m.utilization.value(node="node-0", pool="node-0"))
            got.append(alloc.fragmentation_report())
            reads.append(got)
        assert reads[1] == reads[0]
        assert reads[1][0] == pytest.approx(1 / 16)
        assert reads[1][1] == pytest.approx(5 / 16)
        assert reads[1][3] == pytest.approx(4 / 16)
        assert reads[1][2]          # the 2x4 boxes, some with victims

    def test_utilization_excludes_tainted_chips_like_jax(self):
        jc = _jax_mesh_slices()
        pc = FakeClient()
        _copy_into(jc, pc)
        values = []
        for client, alloc_cls, metrics, new in (
                (jc, JaxAllocator, JaxAllocatorMetrics(), jax_new_object),
                (pc, Allocator, AllocatorMetrics(), new_object)):
            for s in client.list("ResourceSlice"):
                for dev in s["spec"]["devices"]:
                    if dev["name"] == "tpu-3":
                        dev["taints"] = [{"key": "k", "value": "v",
                                          "effect": "NoSchedule"}]
                client.update(s)
            alloc_cls(client, metrics=metrics).allocate(
                _mesh_claim(client, new, "u1"), node="node-0")
            values.append(metrics.utilization.value(node="node-0",
                                                    pool="node-0"))
        assert values[1] == values[0] == pytest.approx(1 / 15, abs=1e-4)


# --------------------------------------------------------------------------
# DefragPlanner: canary claims are free to evict
# --------------------------------------------------------------------------

class TestDefragCanary:
    def _planner(self, client):
        return DefragPlanner(client, Allocator(client),
                             max_evictions_per_claim=1)

    def test_canary_victim_always_movable_and_sorted_first(self, tmp_path):
        client, driver = _gpu_node(tmp_path)
        alloc = Allocator(client)
        big = alloc.allocate(_gpu_claim(client, "big-canary", count=2,
                                        canary=True), node="node-a")
        small = alloc.allocate(_gpu_claim(client, "small-real"),
                               node="node-a")
        victims = [
            {"uid": big["metadata"]["uid"], "name": "big-canary",
             "namespace": "default", "chips": 2},
            {"uid": small["metadata"]["uid"], "name": "small-real",
             "namespace": "default", "chips": 1},
        ]
        movable = self._planner(client)._movable(victims, blocked_chips=1)
        assert movable is not None
        assert [v["name"] for v in movable] == ["big-canary", "small-real"]
        assert movable[0]["canary"] and not movable[1]["canary"]
        driver.stop()

    def test_real_oversize_victim_still_unmovable(self, tmp_path):
        client, driver = _gpu_node(tmp_path)
        big = Allocator(client).allocate(_gpu_claim(client, "big-real",
                                                    count=2), node="node-a")
        victims = [{"uid": big["metadata"]["uid"], "name": "big-real",
                    "namespace": "default", "chips": 2}]
        assert self._planner(client)._movable(victims,
                                              blocked_chips=1) is None
        driver.stop()


# --------------------------------------------------------------------------
# NodeLifecycleController: the canary verdict corroborates, never decides
# --------------------------------------------------------------------------

def _lease_cluster():
    client = FakeClient()
    client.create(new_object("Node", "n0"))
    client.create({
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
        "metadata": {"name": "s0"},
        "spec": {"driver": DRIVER, "nodeName": "n0",
                 "pool": {"name": "n0", "generation": 1,
                          "resourceSliceCount": 1},
                 "devices": [{"name": "gpu-0"}]}})
    clock = [100.0]
    hb = NodeLeaseHeartbeat(client, "n0", lease_duration=10.0,
                            clock=lambda: clock[0])
    assert hb.renew_once()
    return client, clock, hb


class TestCanaryCorroboration:
    def test_canary_tightens_detection_with_expired_lease(self):
        client, clock, _hb = _lease_cluster()
        ctl = NodeLifecycleController(client, clock=lambda: clock[0],
                                      canary_failing=lambda n: True)
        clock[0] += 12.0
        assert ctl.poll_once()["cordoned"] == 1
        assert ctl.cordoned_nodes() == ["n0"]

    def test_without_canary_same_age_does_not_cordon(self):
        client, clock, _hb = _lease_cluster()
        ctl = NodeLifecycleController(client, clock=lambda: clock[0],
                                      canary_failing=lambda n: False)
        clock[0] += 12.0
        assert ctl.poll_once()["cordoned"] == 0

    def test_canary_alone_never_cordons_fresh_lease(self):
        client, clock, _hb = _lease_cluster()
        ctl = NodeLifecycleController(client, clock=lambda: clock[0],
                                      canary_failing=lambda n: True)
        clock[0] += 5.0
        assert ctl.poll_once()["cordoned"] == 0

    def test_broken_canary_signal_keeps_default_factor(self):
        client, clock, _hb = _lease_cluster()

        def boom(_n):
            raise RuntimeError("signal broken")

        ctl = NodeLifecycleController(client, clock=lambda: clock[0],
                                      canary_failing=boom)
        clock[0] += 12.0
        assert ctl.poll_once()["cordoned"] == 0
        clock[0] += 5.0
        assert ctl.poll_once()["cordoned"] == 1


# --------------------------------------------------------------------------
# Against the JAX package
# --------------------------------------------------------------------------

def _canary_round(side, tmp_path):
    """One probe round against a node with a prior probe's claim left
    behind: the round's outcome, phases, leaks and counters."""
    (client, driver, loop, prober, plant) = side(tmp_path)
    try:
        plant(client, "canary-node-a-stale-1")
        res = prober.run_once()
        again = prober.probe_node("node-a")
        return {"outcomes": [r["outcome"] for r in res] + [again["outcome"]],
                "phases": [sorted(r["phases"]) for r in res],
                "leaks": [r["leaks"] for r in res] + [again["leaks"]],
                "probes": prober.probes, "failures": prober.failures,
                "leaked": prober.leaked,
                "node_failing": prober.node_failing("node-a"),
                "residue_leaked": prober.metrics.probe_total.value(
                    phase="residue", outcome="leaked"),
                "left": sorted(c["metadata"]["name"] for c in
                               client.list("ResourceClaim", "default"))}
    finally:
        loop.stop()
        driver.stop()


def _port_canary(tmp_path):
    client = FakeClient()
    _gpu_class(client)
    driver = _driver(client, tmp_path)
    loop = NodePrepareLoop(client, driver, DRIVER, "node-a",
                           retry_delay=0.2).start()
    verify, residue = driver_probe_hooks(lambda _n: driver)
    prober = CanaryProber(client, Allocator(client), nodes=["node-a"],
                          probe_deadline_s=3.0, metrics=CanaryMetrics(),
                          verify=verify, residue=residue)
    return client, driver, loop, prober, _canary_claim


def _jax_canary(tmp_path):
    client = JaxFakeClient()
    client.create(jax_new_object(
        "DeviceClass", "tpu.google.com",
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'tpu'"}}]}))
    driver = TpuDriver(client, JaxDriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "js"),
        cdi_root=str(tmp_path / "jc"), env={}, retry_timeout=0.3,
    ), device_lib=JaxMockDeviceLib("v5e-8")).start()
    loop = JaxNodePrepareLoop(client, driver, "tpu.google.com", "node-a",
                              retry_delay=0.2).start()
    verify, residue = jax_canary.driver_probe_hooks(lambda _n: driver)
    prober = jax_canary.CanaryProber(
        client, JaxAllocator(client), nodes=["node-a"],
        probe_deadline_s=3.0, metrics=jax_canary.CanaryMetrics(),
        verify=verify, residue=residue)

    def plant(client, name):
        client.create({
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": name, "namespace": "default",
                         "annotations": {jax_canary.ANN_CANARY: "node-a"}},
            "spec": {"devices": {"requests": []}}})

    return client, driver, loop, prober, plant


class TestAgainstJax:
    def test_canary_round_with_a_leak(self, tmp_path):
        port = _canary_round(_port_canary, tmp_path)
        jax = _canary_round(_jax_canary, tmp_path)
        assert port == jax
        assert port["outcomes"] == ["leaked", "leaked"]
        assert port["leaks"][0] == ["claim:canary-node-a-stale-1"]
        assert port["left"] == ["canary-node-a-stale-1"]
