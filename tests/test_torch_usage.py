"""The GPU port's usage meter, the canary availability SLO and the canary
leg of the soak.

The scenarios of the JAX package's ``tests/test_canary.py``
``TestUsageMeterConservation``, ``TestCanaryAvailabilitySlo``,
``TestDebugEndpoints`` and ``TestCanaryHarness`` (its node-kill leg; the
overhead harness waits with ``run_canary_overhead``) on the port's
``pkg/usage.py``. The meter bills GPU-seconds: on the JAX package's mesh
slices (chip and subslice devices drawing KEP-4815 counters) and on the
``h100-8`` mock's whole GPUs. ``TestAgainstJax`` drives one seeded claim
timeline through both packages' meters: the port's per-tenant GPU-seconds
equal the JAX package's chip-seconds, interval for interval."""

import json
import random
import time
import urllib.request

import pytest

from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxFakeClient
from k8s_dra_driver_tpu.k8sclient.client import new_object as jax_new_object
from k8s_dra_driver_tpu.kubeletplugin import Allocator as JaxAllocator
from k8s_dra_driver_tpu.kubeletplugin import Helper as JaxHelper
from k8s_dra_driver_tpu.kubeletplugin.allocator import (
    AllocationError as JaxAllocationError,
)
from k8s_dra_driver_tpu.kubeletplugin.types import (
    DriverResources as JaxDriverResources,
)
from k8s_dra_driver_tpu.kubeletplugin.types import Pool as JaxPool
from k8s_dra_driver_tpu.kubeletplugin.types import Slice as JaxSlice
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import (
    partitions as jax_partitions,
)
from k8s_dra_driver_tpu.tpulib.device_lib import (
    MockDeviceLib as JaxMockDeviceLib,
)
from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
from k8s_dra_driver_tpu_torch.internal.common import standard_debug_handlers
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.allocator import AllocationError
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.pkg import faultpoints, slo as slolib
from k8s_dra_driver_tpu_torch.pkg.blackbox import FlightRecorder
from k8s_dra_driver_tpu_torch.pkg.canary import (
    CanaryMetrics,
    CanaryProber,
    driver_probe_hooks,
)
from k8s_dra_driver_tpu_torch.pkg.metrics import MetricsServer, Registry
from k8s_dra_driver_tpu_torch.pkg.telemetry import (
    RecordingRules,
    parse_exposition,
)
from k8s_dra_driver_tpu_torch.pkg.usage import (
    ANN_USAGE_SINCE,
    UsageMeter,
    UsageMetrics,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)

DRIVER = "gpu.nvidia.com"


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _jax_mesh_slices(shapes=((1, 2), (2, 2), (2, 4))):
    """The JAX test's cluster (one single-host 4x4 pool of chip and
    subslice devices with KEP-4815 counters), published by the JAX
    package."""
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


#: the mesh cluster's classes and the devices' draws: chip, 1x2, 2x2
MESH_CLASSES = {"tpu-chip": (1, 1), "tpu-sub-1x2": (1, 2),
                "tpu-sub-2x2": (1, 4)}
#: the h100-8 node's requests: 1, 2 or 4 whole GPUs
GPU_CLASSES = {"gpu-x1": (1, 1), "gpu-x2": (2, 2), "gpu-x4": (4, 4)}


class _Cluster:
    """A cluster the meter runs against: the JAX mesh slices copied into
    the port's client, or one ``h100-8`` node published by a GpuDriver."""

    def __init__(self, kind: str, tmp_path=None):
        self.kind = kind
        self.client = FakeClient()
        self.driver = None
        if kind == "mesh":
            _copy_into(_jax_mesh_slices(), self.client)
            self.classes = MESH_CLASSES
        else:
            self.client.create(new_object(
                "DeviceClass", DRIVER,
                spec={"selectors": [{"cel": {
                    "expression": "device.attributes['type'] == 'gpu'"}}]}))
            self.driver = GpuDriver(self.client, DriverConfig(
                node_name="node-0", state_dir=str(tmp_path / "s"),
                cdi_root=str(tmp_path / "c"), env={}, retry_timeout=0.3,
            ), device_lib=MockDeviceLib("h100-8")).start()
            self.classes = GPU_CLASSES
        self.alloc = Allocator(self.client)

    def claim(self, name, cls, ns="default"):
        count, _gpus = self.classes[cls]
        device_class = DRIVER if self.kind == "h100" else cls
        return self.client.create(new_object(
            "ResourceClaim", name, ns, api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{"name": "r", "exactly": {
                "deviceClassName": device_class,
                "allocationMode": "ExactCount", "count": count}}]}}))

    def gpus(self, cls):
        return self.classes[cls][1]

    def stop(self):
        if self.driver is not None:
            self.driver.stop()


class _Reference:
    """The test-side draw ledger: intervals recorded at the SAME fake
    clock readings the meter observes."""

    def __init__(self):
        self.live = {}
        self.done = []

    def open(self, uid, ns, gpus, t):
        self.live[uid] = (ns, gpus, t)

    def close(self, uid, t):
        ns, gpus, t0 = self.live.pop(uid)
        self.done.append((uid, ns, gpus, t0, t))

    def totals(self):
        out = {}
        for _uid, ns, gpus, t0, t1 in self.done:
            out[ns] = out.get(ns, 0.0) + gpus * (t1 - t0)
        return out


NAMESPACES = ("tenant-a", "tenant-b", "tenant-c")


@pytest.fixture(params=["mesh", "h100"])
def cluster(request, tmp_path):
    c = _Cluster(request.param, tmp_path)
    yield c
    c.stop()


class TestUsageMeterConservation:
    def _drive(self, cluster, seed, faults=False, restart_at=None):
        """Randomized multi-tenant claim lifecycles, the meter driven
        purely by LIST reconcile at deterministic integer fake-clock
        instants; returns (meters, reference)."""
        rng = random.Random(seed)
        client, alloc = cluster.client, cluster.alloc
        clock = [100.0]
        meters = [UsageMeter(client, metrics=UsageMetrics(),
                             clock=lambda: clock[0])]
        ref = _Reference()
        live: dict[str, dict] = {}
        seq = 0

        def observe():
            # Under injected faults a tick may fail (counted, stale) —
            # retry fault-free so no transition is observed late.
            if not meters[-1].observe():
                with faultpoints.injected(""):
                    assert meters[-1].observe()

        for step in range(60):
            if restart_at is not None and step == restart_at:
                # Mid-run restart: stamps durable first, then a FRESH
                # meter rebuilds from LIST + annotations, exactly.
                for _ in range(20):
                    observe()
                    if all(r["stamped"]
                           for r in meters[-1].ledger()["live"]):
                        break
                meters[-1].stop()
                meters.append(UsageMeter(client, metrics=UsageMetrics(),
                                         clock=lambda: clock[0]))
                observe()
            if rng.random() < 0.55 or not live:
                cls = rng.choice(sorted(cluster.classes))
                ns = rng.choice(NAMESPACES)
                seq += 1
                name = f"u-{seq}"
                claim = cluster.claim(name, cls, ns)
                try:
                    claim = alloc.allocate(claim)
                except AllocationError:
                    client.delete("ResourceClaim", name, ns)
                else:
                    uid = claim["metadata"]["uid"]
                    live[uid] = claim
                    ref.open(uid, ns, cluster.gpus(cls), clock[0])
            else:
                uid = rng.choice(sorted(live))
                claim = live.pop(uid)
                if rng.random() < 0.5:
                    alloc.release(claim)
                else:
                    client.delete("ResourceClaim",
                                  claim["metadata"]["name"],
                                  claim["metadata"]["namespace"])
                ref.close(uid, clock[0])
            if faults and rng.random() < 0.3:
                with faultpoints.injected("k8sclient.fake.read=rate:0.6",
                                          seed=seed + step):
                    meters[-1].observe()
            observe()
            clock[0] += rng.randrange(1, 5)  # integer seconds: exact FP
        for uid, claim in list(live.items()):
            alloc.release(claim)
            ref.close(uid, clock[0])
        observe()
        meters[-1].stop()
        return meters, ref

    def _assert_conserved(self, meters, ref):
        totals: dict[str, float] = {}
        intervals = 0
        for m in meters:
            for ns, v in m.completed().items():
                totals[ns] = totals.get(ns, 0.0) + v
            led = m.ledger()
            assert led["intervals_evicted"] == 0
            intervals += sum(e["intervals"]
                             for e in led["claims"].values())
        assert not meters[-1].ledger()["live"]
        expect = ref.totals()
        assert set(totals) <= set(NAMESPACES)
        for ns in NAMESPACES:
            assert totals.get(ns, 0.0) == expect.get(ns, 0.0), (
                ns, totals, expect)
        assert intervals == len(ref.done)

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_randomized_lifecycles_conserve_exactly(self, cluster, seed):
        meters, ref = self._drive(cluster, seed)
        self._assert_conserved(meters, ref)

    @pytest.mark.parametrize("seed", [11, 12])
    def test_injected_faults_double_count_nothing(self, cluster, seed):
        meters, ref = self._drive(cluster, seed, faults=True)
        self._assert_conserved(meters, ref)
        assert meters[-1].observe_failures >= 0  # counted, never raised

    @pytest.mark.parametrize("seed", [21, 22])
    def test_restart_rebuilds_from_list_losing_nothing(self, cluster, seed):
        meters, ref = self._drive(cluster, seed, restart_at=30)
        assert len(meters) == 2
        self._assert_conserved(meters, ref)

    def test_since_annotation_stamped_and_reused(self, cluster):
        client, alloc = cluster.client, cluster.alloc
        clock = [50.0]
        meter = UsageMeter(client, metrics=UsageMetrics(),
                           clock=lambda: clock[0])
        cls = sorted(cluster.classes)[0]
        claim = alloc.allocate(cluster.claim("st", cls, "tenant-a"))
        assert meter.observe()
        fresh = client.get("ResourceClaim", "st", "tenant-a")
        assert fresh["metadata"]["annotations"][ANN_USAGE_SINCE] == \
            repr(50.0)
        clock[0] = 60.0
        # A restarted meter reads the TRUE start from the annotation.
        meter2 = UsageMeter(client, metrics=UsageMetrics(),
                            clock=lambda: clock[0])
        assert meter2.observe()
        clock[0] = 70.0
        alloc.release(claim)
        assert meter2.observe()
        assert meter2.completed() == {
            "tenant-a": 20.0 * cluster.gpus(cls)}

    def test_reallocated_claim_does_not_bill_the_released_gap(self,
                                                               cluster):
        """Drain → reallocate keeps the uid (and any surviving usage-since
        stamp): the second interval opens at the REOPEN time, so 10 s +
        10 s of holding bill 20 s per GPU, never 70."""
        client, alloc = cluster.client, cluster.alloc
        clock = [100.0]
        meter = UsageMeter(client, metrics=UsageMetrics(),
                           clock=lambda: clock[0])
        cls = sorted(cluster.classes)[0]
        claim = alloc.allocate(cluster.claim("re", cls, "tenant-a"))
        assert meter.observe()  # opens + stamps since=100
        clock[0] = 110.0
        alloc.release(claim)
        assert meter.observe()  # closes (10s) + clears the stamp
        clock[0] = 150.0
        claim = alloc.allocate(client.get("ResourceClaim", "re",
                                          "tenant-a"))
        assert meter.observe()  # REOPENS at 150, not the stale 100
        clock[0] = 160.0
        alloc.release(claim)
        assert meter.observe()
        assert meter.completed() == {"tenant-a": 20.0 * cluster.gpus(cls)}
        led = meter.ledger()
        assert led["claims"][claim["metadata"]["uid"]]["intervals"] == 2
        for _ in range(3):
            meter.observe()
        anns = client.get("ResourceClaim", "re",
                          "tenant-a")["metadata"].get("annotations") or {}
        assert ANN_USAGE_SINCE not in anns
        assert led["clears_dropped"] == 0

    def test_observe_fault_point_degrades_visibly(self, cluster):
        meter = UsageMeter(cluster.client, metrics=UsageMetrics())
        with faultpoints.injected("usage.observe=nth:1"):
            assert meter.observe() is False
        assert meter.stale and meter.observe_failures == 1
        assert meter.metrics.observe_failures_total.value() == 1
        assert meter.observe() is True
        assert not meter.stale

    def test_gauges_and_utilization(self, cluster):
        client, alloc = cluster.client, cluster.alloc
        meter = UsageMeter(client, metrics=UsageMetrics())
        small, big = sorted(cluster.classes, key=cluster.gpus)[0::2]
        alloc.allocate(cluster.claim("g1", small, "tenant-a"))
        alloc.allocate(cluster.claim("g2", big, "tenant-b"))
        assert meter.observe()
        assert meter.metrics.gpus_allocated.value(namespace="tenant-a") == 1
        assert meter.metrics.gpus_allocated.value(namespace="tenant-b") == 4
        capacity = 16 if cluster.kind == "mesh" else 8
        assert meter.metrics.cluster_utilization.value() == \
            pytest.approx(round(5 / capacity, 4))
        snap = meter.debug_snapshot()
        assert snap["gpus_allocated"] == 5
        assert snap["healthy_capacity"] == capacity

    def test_event_driven_meter_over_real_informer(self, cluster):
        """start() wires the claim informer: allocations/releases are
        metered without explicit observe calls."""
        client, alloc = cluster.client, cluster.alloc
        meter = UsageMeter(client, metrics=UsageMetrics()).start(
            observe_interval_s=0.05)
        try:
            claim = alloc.allocate(cluster.claim(
                "ev", sorted(cluster.classes)[0], "tenant-a"))
            assert _wait(lambda: meter.ledger()["live"])
            alloc.release(claim)
            assert _wait(lambda: not meter.ledger()["live"])
            led = meter.ledger()
            assert list(led["claims"].values())[0]["namespace"] == \
                "tenant-a"
        finally:
            meter.stop()


class TestCanaryAvailabilitySlo:
    def _rules_with(self, clock, rows_t0, rows_t1, dt=60.0):
        rules = RecordingRules(clock=lambda: clock[0])

        def fam(rows):
            text = ("# TYPE gpu_dra_fleet_canary_probes_total counter\n"
                    + "".join(
                        f'gpu_dra_fleet_canary_probes_total'
                        f'{{node="{n}",outcome="{o}"}} {v}\n'
                        for n, o, v in rows))
            return parse_exposition(text)

        rules.observe(fam(rows_t0), now=clock[0])
        clock[0] += dt
        rules.observe(fam(rows_t1), now=clock[0])
        return rules

    def test_burns_on_failed_and_leaked(self):
        clock = [1000.0]
        rules = self._rules_with(
            clock,
            [("n0", "ok", 100.0), ("n0", "failed", 0.0),
             ("n0", "leaked", 0.0)],
            [("n0", "ok", 130.0), ("n0", "failed", 15.0),
             ("n0", "leaked", 5.0)])
        s = slolib.canary_availability_slo(0.99)
        # 30 ok of 50 probes in the window → error ratio 0.4.
        assert s.error_ratio(rules, 120.0) == pytest.approx(0.4)
        assert s.burn_rate(rules, 120.0) == pytest.approx(40.0)

    def test_no_probes_no_verdict(self):
        clock = [1000.0]
        rules = RecordingRules(clock=lambda: clock[0])
        s = slolib.canary_availability_slo()
        assert s.error_ratio(rules, 300.0) is None

    def test_all_green_burns_nothing(self):
        clock = [1000.0]
        rules = self._rules_with(
            clock,
            [("n0", "ok", 10.0)], [("n0", "ok", 60.0)])
        s = slolib.canary_availability_slo()
        assert s.error_ratio(rules, 120.0) == pytest.approx(0.0)


@pytest.fixture()
def stack(tmp_path):
    """One real node stack: GpuDriver + NodePrepareLoop + DeviceClass —
    the full path a canary probe exercises."""
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", DRIVER,
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    client.create(new_object("Node", "node-a"))
    driver = GpuDriver(client, DriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "s"),
        cdi_root=str(tmp_path / "c"), env={}, retry_timeout=0.3,
    ), device_lib=MockDeviceLib("h100-8")).start()
    loop = NodePrepareLoop(client, driver, DRIVER, "node-a",
                           retry_delay=0.2).start()
    yield client, driver, loop
    loop.stop()
    driver.stop()


def _prober(client, driver):
    verify, residue = driver_probe_hooks(lambda _n: driver)
    return CanaryProber(client, Allocator(client), nodes=["node-a"],
                        probe_deadline_s=3.0, metrics=CanaryMetrics(),
                        verify=verify, residue=residue)


class TestDebugEndpoints:
    def test_canary_and_usage_served_over_http(self, stack):
        client, driver, _loop = stack
        p = _prober(client, driver)
        p.probe_node("node-a")
        meter = UsageMeter(client, metrics=UsageMetrics())
        meter.observe()
        srv = MetricsServer(Registry(), port=0,
                            debug=standard_debug_handlers()).start()
        try:
            docs = {}
            for name in ("canary", "usage"):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}/debug/{name}",
                        timeout=5.0) as resp:
                    docs[name] = json.loads(resp.read().decode())
                assert isinstance(docs[name], list)
            assert any(row.get("probes", 0) >= 1 for row in docs["canary"]
                       if isinstance(row, dict))
            assert any("tenants" in row for row in docs["usage"]
                       if isinstance(row, dict))
        finally:
            srv.stop()

    def test_bundle_carries_canary_and_usage_sections(self, stack,
                                                      tmp_path):
        client, driver, _loop = stack
        p = _prober(client, driver)
        p.probe_node("node-a")
        meter = UsageMeter(client, metrics=UsageMetrics())
        meter.observe()
        rec = FlightRecorder(str(tmp_path / "bb"), client=client,
                             canary=p, usage=meter)
        bundle = rec.capture({"id": "incident-000001-test-page",
                              "trigger": {}, "opened_at": 0.0})
        assert bundle is not None and not bundle["partial"]
        assert bundle["sections"]["canary"]["probes"] == 1
        assert "tenants" in bundle["sections"]["usage"]


class TestCanaryHarness:
    def test_node_kill_detected_cleared_and_conserved(self):
        """The canary leg: probes green → node kill → the availability
        SLO pages within the fence bound → rejoin → clears and goes green
        → zero residue → GPU-seconds conserved exactly."""
        from k8s_dra_driver_tpu_torch.internal.stresslab import run_canary
        r = run_canary(duration_s=6.0, lease_duration_s=1.0,
                       node_kill_at_s=1.5)
        cn = r["canary"]
        assert r["error_count"] == 0 and not r["leaks"], (
            r["errors"], r["leaks"])
        assert r["outcomes"]["stuck"] == 0
        assert cn["fired_page"] and cn["detection_delay_s"] is not None
        assert cn["detection_delay_s"] <= cn["detect_bound_s"], cn
        assert cn["cleared"] and cn["green_after_rejoin"], cn
        assert cn["fault_free_failures"] == 0, cn
        assert cn["pre_kill_pages"] == 0, cn
        assert cn["leaked"] == 0, cn
        assert cn["conservation_ok"], cn["conservation"]
        assert cn["conservation"]["intervals"] > 0


# -- held against the JAX package --------------------------------------------

def _timeline(side: str, seed: int) -> dict:
    """One seeded claim timeline on the JAX mesh cluster through one
    package's meter: allocations and releases at integer fake-clock
    instants, with a meter restart halfway. Returns per-tenant seconds
    and per-claim (by name) interval records."""
    from k8s_dra_driver_tpu.pkg import usage as jusage
    rng = random.Random(seed)
    jc = _jax_mesh_slices()
    if side == "jax":
        client, new, alloc_cls, err = (jc, jax_new_object, JaxAllocator,
                                       JaxAllocationError)
        meter_cls, metrics_cls = jusage.UsageMeter, jusage.UsageMetrics
    else:
        client = FakeClient()
        _copy_into(jc, client)
        new, alloc_cls, err = new_object, Allocator, AllocationError
        meter_cls, metrics_cls = UsageMeter, UsageMetrics
    alloc = alloc_cls(client)
    clock = [1000.0]
    meters = [meter_cls(client, metrics=metrics_cls(),
                        clock=lambda: clock[0])]
    names, live, seq = {}, {}, 0
    for step in range(50):
        if step == 25:
            for _ in range(5):
                meters[-1].observe()
            meters.append(meter_cls(client, metrics=metrics_cls(),
                                    clock=lambda: clock[0]))
        if rng.random() < 0.55 or not live:
            cls = rng.choice(sorted(MESH_CLASSES))
            ns = rng.choice(NAMESPACES)
            seq += 1
            name = f"u-{seq}"
            claim = client.create(new(
                "ResourceClaim", name, ns, api_version="resource.k8s.io/v1",
                spec={"devices": {"requests": [{"name": "r", "exactly": {
                    "deviceClassName": cls, "allocationMode": "ExactCount",
                    "count": 1}}]}}))
            try:
                claim = alloc.allocate(claim)
            except err:
                client.delete("ResourceClaim", name, ns)
            else:
                live[name] = claim
                names[claim["metadata"]["uid"]] = name
        else:
            name = rng.choice(sorted(live))
            claim = live.pop(name)
            if rng.random() < 0.5:
                alloc.release(claim)
            else:
                client.delete("ResourceClaim", name,
                              claim["metadata"]["namespace"])
        meters[-1].observe()
        clock[0] += rng.randrange(1, 5)
    for claim in live.values():
        alloc.release(claim)
    meters[-1].observe()
    tenants, claims = {}, {}
    for m in meters:
        for ns, v in m.completed().items():
            tenants[ns] = tenants.get(ns, 0.0) + v
        for uid, e in m.ledger()["claims"].items():
            row = claims.setdefault(names[uid], [e["namespace"], 0, 0.0])
            row[1] += e["intervals"]
            row[2] += e["seconds"]
            row.append(e.get("gpus", e.get("chips")))
    return {"tenants": tenants, "claims": claims,
            "live": meters[-1].ledger()["live"]}


class TestAgainstJax:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_gpu_seconds_equal_jax_chip_seconds(self, seed):
        jax_run = _timeline("jax", seed)
        port_run = _timeline("port", seed)
        assert port_run["tenants"] == jax_run["tenants"]
        assert port_run["claims"] == jax_run["claims"]
        assert not port_run["live"] and not jax_run["live"]
        assert sum(port_run["tenants"].values()) > 0
