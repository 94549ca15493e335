"""MIG partitions in the port's GPU kubelet plugin, held to the JAX
package's subslice tests.

On the ``h100-8`` mock in MIG mode with ``DynamicMIG`` on, each test
mirrors what its JAX counterpart asserts of subslices:

- ``tests/test_tpu_plugin.py::TestSubsliceTenancy``: two tenants, then
  exhaustion; a whole-GPU claim blocks its partitions; a profile config
  mismatch is permanent;
- ``tests/test_topology.py::TestSubslicePlacementProperties``: every
  published placement valid, none duplicated, same-profile placements
  disjoint; and the compute slices of any disjoint set within 7;
- ``tests/test_allocator_placement.py``'s ``TestBestFitPlacement``,
  ``TestGeometryIndex``, ``TestFragmentationAccounting``,
  ``TestBlockedClassification`` and ``TestDefragPlanner`` on the node's
  GPU × memory-slice mesh;
- the JAX package's ``Allocator`` and the port's, each on its own
  package's ``FakeClient``, given the port's published MIG slice and the
  same seeded claim sequence: the same devices, or the same refusals;
- crash recovery, the startup sweep, and a GPU taint reaching its MIG
  devices; the NVML MIG calls against a fake of the library's C functions.
"""

import copy
import ctypes
import itertools
import json
import os
import threading

import numpy as np
import pytest

from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxClient
from k8s_dra_driver_tpu.kubeletplugin import allocator as jax_alloc
from k8s_dra_driver_tpu_torch.api.configs import API_VERSION
from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl
from k8s_dra_driver_tpu_torch.gpulib.chip import (
    MIG_COMPUTE_SLICES,
    MIG_MEMORY_SLICES,
    MIG_PROFILES,
    GpuType,
    mig_profile,
    mig_profile_label,
)
from k8s_dra_driver_tpu_torch.gpulib.topology import Box, Topology
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Helper
from k8s_dra_driver_tpu_torch.kubeletplugin import allocator as port_alloc
from k8s_dra_driver_tpu_torch.kubeletplugin.allocator import (
    AllocationError,
    Allocator,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
    ANN_DRAIN,
    ANN_DRAIN_FAILED,
    ClaimReallocator,
    DefragPlanner,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.types import (
    ClaimRef,
    DeviceTaint,
    DriverResources,
    Pool,
    Slice,
)
from k8s_dra_driver_tpu_torch.pkg import faultpoints
from k8s_dra_driver_tpu_torch.pkg.errors import PermanentError
from k8s_dra_driver_tpu_torch.pkg.events import (
    REASON_CLAIM_PREEMPTED,
    REASON_DEFRAG_PLANNED,
    list_events,
)
from k8s_dra_driver_tpu_torch.pkg.featuregates import new_feature_gates
from k8s_dra_driver_tpu_torch.pkg.metrics import AllocatorMetrics
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    partitions as P,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_COMPLETED,
    STATE_PREPARE_STARTED,
    PreparedClaimCP,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    DRIVER_NAME,
    parse_mig_name,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.vfio import (
    VfioPciManager,
)

H100 = GpuType.H100_SXM_80GB
PROFILES = MIG_PROFILES[H100]
MIG_GATES = "DynamicMIG=true"


def _classes(client):
    for name, expr in P.DEVICE_CLASS_SELECTORS.items():
        client.create(new_object("DeviceClass", name, spec={"selectors": [
            {"cel": {"expression": expr}}]}))
    for p in PROFILES:
        client.create(new_object("DeviceClass",
                                 f"mig-{mig_profile_label(p.name)}", spec={
            "selectors": [{"cel": {"expression":
                f"device.attributes['type'] == 'mig' && "
                f"device.attributes['profile'] == '{p.name}'"}}]}))


def _driver(client, tmp_path, lib, gates=MIG_GATES, node="node-a"):
    return GpuDriver(client, DriverConfig(
        node_name=node, state_dir=str(tmp_path / "state"),
        cdi_root=str(tmp_path / "cdi"), env={}, retry_timeout=0.5,
        feature_gates=new_feature_gates(gates)), device_lib=lib)


@pytest.fixture()
def cluster(tmp_path):
    """One node: the fake API and the h100-8 GPU driver in MIG mode."""
    client = FakeClient()
    _classes(client)
    lib = dl.MockDeviceLib("h100-8", mig=True)
    lib.materialize(tmp_path / "tree")
    return client, _driver(client, tmp_path, lib).start(), lib


def make_claim(client, name, device_class=P.DEVICE_CLASS_MIG, selectors=(),
               config=None, ns="default"):
    exactly = {"deviceClassName": device_class,
               "allocationMode": "ExactCount", "count": 1}
    if selectors:
        exactly["selectors"] = [{"cel": {"expression": s}} for s in selectors]
    spec = {"devices": {"requests": [{"name": "gpu", "exactly": exactly}]}}
    if config is not None:
        spec["devices"]["config"] = [{
            "requests": ["gpu"],
            "opaque": {"driver": DRIVER_NAME, "parameters": config}}]
    return client.create(new_object(
        "ResourceClaim", name, ns, api_version="resource.k8s.io/v1",
        spec=spec))


def on_gpu0(profile):
    return [f"device.attributes['profile'] == '{profile}'",
            "device.attributes['parentIndex'] == 0"]


def device_of(claim):
    return claim["status"]["allocation"]["devices"]["results"][0]["device"]


def claim_env(spec):
    return dict(e.split("=", 1) for e in spec["containerEdits"]["env"])


def slices_of(name):
    _, _, start, size = parse_mig_name(name)
    return set(range(start, start + size))


class TestMigTenancy:
    """``TestSubsliceTenancy``: two isolated 3g.40gb tenants carved from
    one GPU, a third overlapping attempt refused — by counter
    construction."""

    def test_two_tenants_then_exhaustion(self, cluster):
        client, driver, lib = cluster
        alloc = Allocator(client)
        a1 = alloc.allocate(make_claim(client, "tenant1",
                                       selectors=on_gpu0("3g.40gb")))
        a2 = alloc.allocate(make_claim(client, "tenant2",
                                       selectors=on_gpu0("3g.40gb")))
        assert {device_of(a1), device_of(a2)} == {
            "gpu-0-mig-3g40gb-0-4", "gpu-0-mig-3g40gb-4-4"}
        with pytest.raises(AllocationError):
            alloc.allocate(make_claim(client, "tenant3",
                                      selectors=on_gpu0("3g.40gb")))
        # Prepare both: distinct instances on disjoint slices, each spec
        # naming its own MIG-<uuid> and caps nodes.
        specs = []
        for a in (a1, a2):
            r = driver.prepare_resource_claims([a])[a["metadata"]["uid"]]
            assert r.error is None, r.error
            specs.append(driver.cdi.read_claim_spec(a["metadata"]["uid"]))
        migs = {m.uuid: m for m in lib.mig_devices()}
        assert len(migs) == 2
        seen = set()
        for a, spec in zip((a1, a2), specs):
            env = claim_env(spec)
            uuid = env["CUDA_VISIBLE_DEVICES"]
            assert uuid.startswith("MIG-") and uuid in migs
            assert env["NVIDIA_VISIBLE_DEVICES"] == uuid
            m = migs[uuid]
            assert (m.start, m.size) == (parse_mig_name(device_of(a))[2], 4)
            nodes = [n["path"] for n in
                     spec["devices"][0]["containerEdits"]["deviceNodes"]]
            assert nodes[0] == "/dev/nvidia0"
            assert nodes[-2:] == m.caps_paths
            assert all(os.path.exists(
                os.path.join(lib._tree[1], p[len("/dev/"):]))
                for p in m.caps_paths)
            assert not (seen & slices_of(device_of(a)))
            seen |= slices_of(device_of(a))
        assert seen == set(range(MIG_MEMORY_SLICES))

    def test_whole_gpu_claim_blocks_its_partitions(self, cluster):
        client, driver, _ = cluster
        alloc = Allocator(client)
        whole = alloc.allocate(make_claim(
            client, "gpu0", P.DEVICE_CLASS_GPU,
            ["device.attributes['index'] == 0"]))
        assert device_of(whole) == "gpu-0"
        with pytest.raises(AllocationError):
            alloc.allocate(make_claim(client, "sub",
                                      selectors=on_gpu0("1g.10gb")))
        # And the other way round, at prepare: a MIG claim's record holds
        # its slices, so a whole-GPU prepare on that GPU is refused.
        alloc.release(client.get("ResourceClaim", "gpu0", "default"))
        sub = alloc.allocate(client.get("ResourceClaim", "sub", "default"))
        assert driver.prepare_resource_claims([sub])[
            sub["metadata"]["uid"]].error is None
        whole = client.get("ResourceClaim", "gpu0", "default")
        whole["status"] = {"allocation": {"devices": {"results": [{
            "request": "gpu", "driver": DRIVER_NAME, "pool": "node-a",
            "device": "gpu-0"}]}}}
        err = driver.prepare_resource_claims([whole])[
            whole["metadata"]["uid"]].error
        assert err is not None and "already prepared" in str(err)

    def test_profile_config_mismatch_permanent(self, cluster):
        client, driver, lib = cluster
        a = Allocator(client).allocate(make_claim(
            client, "mismatch", selectors=on_gpu0("3g.40gb"),
            config={"apiVersion": API_VERSION, "kind": "MigDeviceConfig",
                    "profile": "4g.40gb"}))
        r = driver.prepare_resource_claims([a])[a["metadata"]["uid"]]
        assert isinstance(r.error, PermanentError)
        assert "profile" in str(r.error)
        assert lib.mig_devices() == []

    def test_matching_config_env_reaches_the_device(self, cluster):
        client, driver, _ = cluster
        a = Allocator(client).allocate(make_claim(
            client, "ok", selectors=on_gpu0("1g.20gb"),
            config={"apiVersion": API_VERSION, "kind": "MigDeviceConfig",
                    "profile": "1g.20gb", "env": {"TENANT": "a"}}))
        r = driver.prepare_resource_claims([a])[a["metadata"]["uid"]]
        assert r.error is None, r.error
        spec = driver.cdi.read_claim_spec(a["metadata"]["uid"])
        assert "TENANT=a" in spec["devices"][0]["containerEdits"]["env"]


def _placements():
    """(profile, start, size, compute) of every placement of the table."""
    return [(p.name, s, p.size, p.compute_slices) for p in PROFILES
            for s in p.starts]


class TestMigPlacementProperties:
    """``TestSubslicePlacementProperties`` on the MIG table and the
    devices the plugin publishes from it."""

    def test_published_placements_valid_unique_disjoint(self, cluster):
        client, _, _ = cluster
        (spec,) = [s["spec"] for s in client.list("ResourceSlice")]
        names = [d["name"] for d in spec["devices"]]
        assert len(names) == len(set(names)) == 8 * 26
        topo = Topology(dims=(8, MIG_MEMORY_SLICES))
        by_profile: dict = {}
        for d in spec["devices"]:
            attrs = {k: next(iter(v.values()))
                     for k, v in d["attributes"].items()}
            box = Box(origin=tuple(int(x) for x in attrs["origin"]
                                   .split("-")),
                      shape=Box.parse_shape(attrs["shape"]))
            assert topo.is_valid_subslice(box), d["name"]
            drawn = {c for cc in d["consumesCounters"]
                     for c in cc["counters"]}
            media = ({P.media_counter_name(box.origin[0])}
                     if attrs.get("mediaExtensions") else set())
            assert drawn == {P.slice_counter_name(*xy)
                             for xy in box.coords()} | media
            if attrs["type"] != "mig":
                continue
            p = mig_profile(H100, attrs["profile"])
            assert attrs["placementStart"] in p.starts
            assert attrs["placementSize"] == p.size
            assert d["capacity"]["memory"]["value"] == \
                (81559 << 20) * p.size // 8
            by_profile.setdefault((attrs["parentIndex"], p.name),
                                  []).append(box)
        for (gpu, name), boxes in by_profile.items():
            assert len(boxes) == len(mig_profile(H100, name).starts)
            for a, b in itertools.combinations(boxes, 2):
                assert not a.overlaps(b), (gpu, name, a, b)

    def test_only_gpus_in_mig_mode_publish_placements(self, tmp_path):
        """MIG mode is per GPU: a GPU taken out of it is published whole
        (still drawing its counters) with no placement."""
        client = FakeClient()
        lib = dl.MockDeviceLib("h100-8", mig=True)
        lib.set_mig_mode(3, False)
        _driver(client, tmp_path, lib).start()
        names = [d["name"] for d in
                 client.list("ResourceSlice")[0]["spec"]["devices"]]
        assert len(names) == 8 + 7 * 25 and "gpu-3" in names
        assert not any(n.startswith("gpu-3-mig-") for n in names)

    def test_table_not_the_enumerated_mesh(self):
        """The mesh's aligned 1-slice boxes include slice 7, which no H100
        profile has: the device list is the table's, not
        ``Topology.enumerate_subslices``'."""
        gpus = dl.MockDeviceLib("h100-8", mig=True).enumerate_gpus()[:1]
        names = {d.name for d in P.mig_devices(gpus)}
        mesh = Topology(dims=(1, MIG_MEMORY_SLICES)).enumerate_subslices(
            [(1, 1)])
        assert len(mesh) == 8 and len([n for n in names
                                       if "-1g10gb-" in n]) == 7
        assert "gpu-0-mig-1g10gb-7-1" not in names
        assert len(names) == sum(len(p.starts) for p in PROFILES) == 25

    def test_disjoint_placements_stay_within_compute_slices(self):
        """The compute slices are not a counter: every set of pairwise
        disjoint placements of the table fits the GPU's seven, so the
        memory counters alone keep allocations valid. The bound is met."""
        placements = _placements()
        best = 0

        def grow(chosen, used, compute, start):
            nonlocal best
            best = max(best, compute)
            assert compute <= MIG_COMPUTE_SLICES, chosen
            for i in range(start, len(placements)):
                name, s, size, c = placements[i]
                cells = set(range(s, s + size))
                if not cells & used:
                    grow(chosen + [(name, s)], used | cells, compute + c,
                         i + 1)

        grow([], set(), 0, 0)
        assert best == MIG_COMPUTE_SLICES

    def test_names_round_trip(self):
        for name, s, size, _ in _placements():
            dev = f"gpu-3-mig-{name}-{s}-{size}"
            assert parse_mig_name(dev) == (3, name, s, size)
        for bad in ("gpu-3", "gpu-x-mig-1g10gb-0-1", "vfio-gpu-0",
                    "gpu-1-mig-1g10gb-0"):
            assert parse_mig_name(bad) is None


class _StubPlugin:
    def prepare_resource_claims(self, claims):
        return {}

    def unprepare_resource_claims(self, refs):
        return {}


def make_mesh(n_nodes=1, n_gpus=8):
    """N MIG-mode pools of ``n_gpus`` H100s, published through the real
    Helper and partitions path, with a DeviceClass per profile."""
    client = FakeClient()
    _classes(client)
    for i in range(n_nodes):
        profile = dl._h100_8_profile(i)
        profile["gpus"] = profile["gpus"][:n_gpus]
        gpus = dl.MockDeviceLib(profile, mig=True).enumerate_gpus()
        devices = [P.full_gpu_device(g, with_counters=True) for g in gpus]
        devices += P.mig_devices(gpus)
        Helper(client, DRIVER_NAME, f"node-{i}", _StubPlugin()) \
            .publish_resources(DriverResources(pools={f"node-{i}": Pool(
                slices=[Slice(devices=devices, shared_counters=[
                    P.memory_slice_counter_set(gpus)])])}))
    return client


def held_devices(client):
    out = {}
    for c in client.list("ResourceClaim"):
        rs = ((c.get("status") or {}).get("allocation") or {}).get(
            "devices", {}).get("results", [])
        if rs:
            out[c["metadata"]["name"]] = [r["device"] for r in rs]
    return out


class TestBestFitPlacement:
    def test_small_claims_pack_into_one_gpu(self):
        """Four 1g.10gb claims on an empty node land on ONE GPU, slices
        0-3: the smallest viable free box, not a spread."""
        client = make_mesh()
        alloc = Allocator(client, metrics=AllocatorMetrics())
        for j in range(4):
            alloc.allocate(make_claim(client, f"c{j}", "mig-1g10gb"))
        got = sorted(d for ds in held_devices(client).values() for d in ds)
        assert got == [f"gpu-0-mig-1g10gb-{s}-1" for s in range(4)]

    def test_partition_prefers_broken_pool_over_pristine(self):
        client = make_mesh(n_nodes=2)
        alloc = Allocator(client, metrics=AllocatorMetrics())
        alloc.allocate(make_claim(client, "pin", "mig-1g10gb"))
        sub = alloc.allocate(make_claim(client, "sub", "mig-3g40gb"))
        res = sub["status"]["allocation"]["devices"]["results"][0]
        assert res["pool"] == "node-0"
        assert res["device"] == "gpu-0-mig-3g40gb-4-4"

    @pytest.mark.parametrize("strategy", ["best-fit", "first-fit"])
    def test_no_overlap_under_mixed_sizes(self, strategy):
        """KEP-4815's floor: whatever the strategy picks, no memory slice
        is drawn twice, and whole GPUs never share a GPU with a MIG
        device."""
        client = make_mesh(n_gpus=3)
        alloc = Allocator(client, metrics=AllocatorMetrics(),
                          strategy=strategy)
        sizes = ["mig-1g10gb", "mig-3g40gb", "mig-2g20gb", "gpu.nvidia.com",
                 "mig-1g20gb", "mig-4g40gb", "mig-1g10gb", "mig-7g80gb",
                 "mig-1g10gb", "mig-2g20gb"]
        placed = 0
        for j, cls in enumerate(sizes):
            try:
                alloc.allocate(make_claim(client, f"m{j}", cls))
                placed += 1
            except AllocationError:
                pass
        assert placed >= 6
        idx = alloc._slice_index()
        seen = {}
        for ds in held_devices(client).values():
            for d in ds:
                dev = idx.by_pool_device[("node-0", d)]
                for cc in dev.get("consumesCounters", []):
                    for cn in cc.get("counters", {}):
                        assert cn not in seen, (d, cn, seen[cn])
                        seen[cn] = d


class TestGeometryIndex:
    def test_containers_match_enclosing_placements(self):
        """The counter-subset containment chains equal the geometric
        ``Topology.enclosing_subslices`` answer over the published menu
        (+ the whole-pool box) on the GPU × slice mesh."""
        client = make_mesh()
        alloc = Allocator(client, metrics=AllocatorMetrics())
        geo = alloc._slice_index().geometry["node-0"]
        topo = geo.topology
        assert topo is not None and topo.dims == (8, MIG_MEMORY_SLICES)
        menu = [tuple(int(p) for p in s.split("x")) for s in
                {g.shape for g in geo.boxes.values() if g.box is not None}]
        assert sorted(menu) == [(1, 1), (1, 2), (1, 4), (1, 8)]
        for g in geo.boxes.values():
            want = {(b.origin, b.shape)
                    for b in topo.enclosing_subslices(g.box, menu)}
            got = {(c.box.origin, c.box.shape)
                   for c in g.containers if c.box is not None}
            whole = {(c.box.origin, c.box.shape) for c in g.containers
                     if c is geo.whole and c.box is not None}
            assert got - whole == want, g.name

    def test_every_mig_device_is_in_the_index(self):
        """Every draw is a unit draw, so every MIG device and whole GPU
        whose draws are the cells of its box keeps that box in the
        geometry index: all but the 1g.10gb+me placements, which also draw
        their GPU's media counter and stay on the counter-fit path. The
        mesh is the 64 memory slices; the media counters are no cell."""
        client = make_mesh()
        geo = Allocator(client, metrics=AllocatorMetrics()) \
            ._slice_index().geometry["node-0"]
        assert len(geo.boxes) == 8 * 19
        assert all(g.box is not None for g in geo.boxes.values())
        assert not any("-1g10gbme-" in n for n in geo.boxes)
        assert len(geo.unit_counters) == 8 * MIG_MEMORY_SLICES


class TestFragmentationAccounting:
    def test_gauge_and_report(self):
        client = make_mesh()
        m = AllocatorMetrics()
        alloc = Allocator(client, metrics=m)
        (row,) = alloc.fragmentation_report()
        assert (row["fragmentation"], row["free_chips"],
                row["largest_free"]) == (0.0, 64, 64)
        alloc.allocate(make_claim(client, "a", "mig-1g10gb"))
        (row,) = alloc.fragmentation_report()
        assert row["free_chips"] == 63
        # Largest allocatable after one slice of GPU 0: a whole GPU row.
        assert (row["largest_free"], row["largest_free_shape"]) == (8, "1x8")
        assert row["fragmentation"] == pytest.approx(1 - 8 / 63, abs=1e-3)
        text = m.registry.expose_text()
        assert 'allocator_fragmentation{node="node-0"' in text

    def test_full_pool_reads_zero(self):
        client = make_mesh()
        alloc = Allocator(client, metrics=AllocatorMetrics())
        for j in range(8):
            alloc.allocate(make_claim(client, f"c{j}", "mig-7g80gb"))
        (row,) = alloc.fragmentation_report()
        assert row["free_chips"] == 0 and row["fragmentation"] == 0.0


def _fragment(client, alloc):
    """On one GPU: a 1g.10gb in each half → no free 3g.40gb while six
    slices idle."""
    alloc.allocate(make_claim(client, "pin-top", "mig-1g10gb"))
    alloc.allocate(make_claim(client, "pin-bot", "mig-1g10gb"),
                   avoid=[("node-0", "gpu-0-mig-3g40gb-0-4")])


class TestBlockedClassification:
    def test_fragmented_vs_unsatisfiable(self):
        client = make_mesh(n_gpus=1)
        m = AllocatorMetrics()
        alloc = Allocator(client, metrics=m)
        _fragment(client, alloc)
        with pytest.raises(AllocationError, match="fragmented"):
            alloc.allocate(make_claim(client, "big", "mig-3g40gb"))
        assert m.allocations_total.value(outcome="fragmented") == 1
        blocked = alloc.blocked_claims()
        assert [b["name"] for b in blocked] == ["big"]
        assert blocked[0]["chips"] == 4 and blocked[0]["shapes"] == ["1x4"]
        client.create(new_object("DeviceClass", "mig-9g", spec={
            "selectors": [{"cel": {"expression":
                "device.attributes['profile'] == '9g.90gb'"}}]}))
        with pytest.raises(AllocationError):
            alloc.allocate(make_claim(client, "huge", "mig-9g"))
        assert m.allocations_total.value(outcome="unsatisfiable") == 1

    def test_blocked_clears_on_success(self):
        client = make_mesh(n_gpus=1)
        alloc = Allocator(client, metrics=AllocatorMetrics())
        _fragment(client, alloc)
        with pytest.raises(AllocationError):
            alloc.allocate(make_claim(client, "big", "mig-3g40gb"))
        alloc.release(client.get("ResourceClaim", "pin-top", "default"))
        alloc.allocate(client.get("ResourceClaim", "big", "default"))
        assert alloc.blocked_claims() == []

    def test_avoid_excludes_overlapping_placements(self):
        client = make_mesh(n_gpus=1)
        alloc = Allocator(client, metrics=AllocatorMetrics())
        alloc.allocate(make_claim(client, "c", "mig-1g10gb"),
                       avoid=[("node-0", "gpu-0-mig-3g40gb-0-4")])
        (dev,) = held_devices(client)["c"]
        assert min(slices_of(dev)) >= 4

    def test_placement_options_victims(self):
        client = make_mesh(n_gpus=1)
        alloc = Allocator(client, metrics=AllocatorMetrics())
        alloc.allocate(make_claim(client, "small", "mig-1g20gb"),
                       avoid=[("node-0", "gpu-0-mig-3g40gb-4-4")])
        opts = alloc.placement_options(make_claim(client, "big",
                                                  "mig-3g40gb"))
        top = next(o for o in opts if o["device"] == "gpu-0-mig-3g40gb-0-4")
        assert [v["name"] for v in top["victims"]] == ["small"]
        assert top["victim_chips"] == 2
        bottom = next(o for o in opts
                      if o["device"] == "gpu-0-mig-3g40gb-4-4")
        assert bottom["victims"] == []


class TestDefragPlanner:
    def _blocked_world(self):
        client = make_mesh(n_gpus=1)
        m = AllocatorMetrics()
        mu = threading.Lock()
        alloc = Allocator(client, metrics=m)
        _fragment(client, alloc)
        with pytest.raises(AllocationError):
            alloc.allocate(make_claim(client, "big", "mig-3g40gb"))
        return client, alloc, mu, m

    def test_scored_preemption_unblocks(self):
        client, alloc, mu, _m = self._blocked_world()
        realloc = ClaimReallocator(client, alloc_mutex=mu, allocator=alloc)
        planner = DefragPlanner(client, alloc, alloc_mutex=mu)
        counts = planner.plan_once()
        assert counts["planned"] == 1 and counts["preempted"] == 1
        hint = planner.hints()[0]
        assert hint["victim_chips"] == 1   # the cheapest box: one slice
        victims = [c for c in client.list("ResourceClaim")
                   if ANN_DRAIN in (c["metadata"].get("annotations") or {})]
        assert len(victims) == 1
        ann = json.loads(victims[0]["metadata"]["annotations"][ANN_DRAIN])
        assert ann["avoid"]["device"] == hint["target_device"]
        for c in victims:
            realloc._on_claim(c)
        assert realloc.reconcile_once() == 1
        with mu:
            alloc.allocate(client.get("ResourceClaim", "big", "default"))
        held = held_devices(client)
        assert held["big"] == [hint["target_device"]]
        moved = held[victims[0]["metadata"]["name"]][0]
        assert not slices_of(moved) & slices_of(hint["target_device"])
        assert list_events(client, reason=REASON_DEFRAG_PLANNED)
        assert list_events(client, reason=REASON_CLAIM_PREEMPTED)

    def test_eviction_budget_bounds_storm(self):
        client, alloc, mu, _m = self._blocked_world()
        planner = DefragPlanner(client, alloc, alloc_mutex=mu,
                                max_evictions_per_claim=1)
        for _ in range(3):
            planner.plan_once()
        assert planner.preempted == 1
        assert len([c for c in client.list("ResourceClaim") if ANN_DRAIN in
                    (c["metadata"].get("annotations") or {})]) == 1

    def test_unmovable_occupant_poisons_placement(self):
        client, alloc, mu, _m = self._blocked_world()
        for name in ("pin-top", "pin-bot"):
            c = client.get("ResourceClaim", name, "default")
            c["metadata"].setdefault("annotations", {})[
                ANN_DRAIN_FAILED] = "x"
            client.update(c)
        planner = DefragPlanner(client, alloc, alloc_mutex=mu)
        counts = planner.plan_once()
        assert counts["planned"] == 0 and counts["skipped"] == 1
        assert planner.preempted == 0

    def test_oversized_victim_not_evicted(self):
        """A victim holding more slices than the blocked claim needs is
        never preempted (a net-loss migration)."""
        client = make_mesh(n_gpus=1)
        alloc = Allocator(client, metrics=AllocatorMetrics())
        alloc.allocate(make_claim(client, "big-old", "mig-4g40gb"))
        planner = DefragPlanner(client, alloc, alloc_mutex=threading.Lock())
        uid = client.get("ResourceClaim", "big-old",
                         "default")["metadata"]["uid"]
        assert planner._movable([{"uid": uid, "name": "big-old",
                                  "namespace": "default", "chips": 4}],
                                blocked_chips=2) is None

    def test_resolved_blocked_claims_pruned(self):
        client, alloc, mu, _m = self._blocked_world()
        client.delete("ResourceClaim", "big", "default")
        planner = DefragPlanner(client, alloc, alloc_mutex=mu)
        assert planner.plan_once()["resolved"] == 1
        assert alloc.blocked_claims() == []


def _plain(obj):
    o = copy.deepcopy(obj)
    for k in ("uid", "resourceVersion", "creationTimestamp"):
        o["metadata"].pop(k, None)
    o.pop("status", None)
    return o


def _without_media(obj):
    """A ResourceSlice less its media-extensions placements and media
    counters: the GPU × memory-slice mesh alone."""
    if obj["kind"] != "ResourceSlice":
        return obj
    spec = obj["spec"]
    spec["devices"] = [d for d in spec["devices"]
                       if "mediaExtensions" not in d.get("attributes", {})]
    for cs in spec.get("sharedCounters", []):
        cs["counters"] = {k: v for k, v in cs["counters"].items()
                          if not k.endswith("-media")}
    return obj


#: The profiles whose placements draw memory slices alone.
MESH_PROFILES = tuple(p for p in PROFILES if not p.media_extensions)


def _mig_request(rng):
    kind = rng.integers(4)
    if kind == 0:
        return P.DEVICE_CLASS_GPU, [
            f"device.attributes['index'] >= {rng.integers(0, 8)}"]
    profile = MESH_PROFILES[rng.integers(len(MESH_PROFILES))].name
    sels = [f"device.attributes['profile'] == '{profile}'"]
    if kind == 2:
        sels.append(f"device.attributes['parentIndex'] == "
                    f"{rng.integers(0, 3)}")
    elif kind == 3:
        sels.append(f"device.attributes['placementStart'] >= "
                    f"{rng.integers(0, 5)}")
    return P.DEVICE_CLASS_MIG, sels


@pytest.mark.parametrize("strategy", ["best-fit", "first-fit"])
@pytest.mark.parametrize("seed", [0, 1])
def test_jax_and_port_allocators_agree_on_the_mig_slice(tmp_path, strategy,
                                                        seed):
    """The port's published MIG slice (208 placements, 8 whole GPUs, 64
    memory-slice and 8 media counters) in a port ``FakeClient``, and its
    GPU × memory-slice mesh (the slice less the 56 media-extensions
    placements and their counters: 152 placements, the geometry the JAX
    allocator models) in a JAX ``FakeClient``, with the DeviceClasses; a
    seeded sequence of claims for whole GPUs and the mesh's profiles and
    releases through each package's ``Allocator``: the same placements,
    or the same refusal, step for step. The media-extensions placements
    the port publishes change nothing for other traffic."""
    source = FakeClient()
    _classes(source)
    _driver(source, tmp_path, dl.MockDeviceLib("h100-8", mig=True)).start()
    objects = [_plain(o) for kind in ("DeviceClass", "ResourceSlice")
               for o in source.list(kind)]
    assert len(objects[-1]["spec"]["devices"]) == 208
    clients = (JaxClient(), FakeClient())
    for o in objects:
        clients[0].create(_without_media(copy.deepcopy(o)))
        clients[1].create(copy.deepcopy(o))
    assert len(clients[0].list("ResourceSlice")[0]["spec"]["devices"]) == 152
    allocs = (jax_alloc.Allocator(clients[0], strategy=strategy),
              port_alloc.Allocator(clients[1], strategy=strategy))
    errors = (jax_alloc.AllocationError, port_alloc.AllocationError)
    rng = np.random.default_rng(seed)
    live, log, kinds = [], ([], []), set()
    for step in range(70):
        if live and rng.random() < 0.2:
            name = live.pop(int(rng.integers(len(live))))
            for a, c in zip(allocs, clients):
                a.release(c.get("ResourceClaim", name, "default"))
            continue
        name = f"c{step}"
        cls, sels = _mig_request(rng)
        obj = new_object("ResourceClaim", name, "default",
                         api_version="resource.k8s.io/v1",
                         spec={"devices": {"requests": [{
                             "name": "req", "exactly": {
                                 "deviceClassName": cls,
                                 "allocationMode": "ExactCount", "count": 1,
                                 "selectors": [{"cel": {"expression": s}}
                                               for s in sels]}}]}})
        for side, (a, c, err) in enumerate(zip(allocs, clients, errors)):
            c.create(copy.deepcopy(obj))
            try:
                got = a.allocate(c.get("ResourceClaim", name, "default"))
                out = ("ok", [r["device"] for r in
                              got["status"]["allocation"]["devices"][
                                  "results"]])
            except err as e:
                out = ("error", str(e))
            log[side].append((name, out))
        kinds.add(log[1][-1][1][0])
        if log[1][-1][1][0] == "ok":
            live.append(name)
    assert log[0] == log[1]
    assert kinds == {"ok", "error"}


class TestCrashAndSweep:
    def test_crash_mid_prepare_leaves_no_instance_after_restart(
            self, cluster, tmp_path):
        """A crash after the instance was created, before its record
        completed: the restarted plugin's startup sweep destroys it, and
        the retried prepare creates exactly one."""
        client, driver, lib = cluster
        a = Allocator(client).allocate(make_claim(
            client, "crashy", selectors=on_gpu0("2g.20gb")))
        uid = a["metadata"]["uid"]
        with pytest.raises(faultpoints.FaultCrash):
            with faultpoints.injected("cdi.write=crash-nth:1"):
                driver.state.prepare(a)
        assert driver.state.prepared_claims()[uid].state == \
            STATE_PREPARE_STARTED
        assert len(lib.mig_devices()) == 1          # leaked by the crash
        driver2 = _driver(client, tmp_path, lib).start()
        assert lib.mig_devices() == []
        assert not os.listdir(os.path.join(lib._tree[1], "nvidia-caps"))
        r = driver2.prepare_resource_claims([a])[uid]
        assert r.error is None, r.error
        assert driver2.state.prepared_claims()[uid].state == \
            STATE_PREPARE_COMPLETED
        (m,) = lib.mig_devices()
        assert (m.profile, m.parent_index) == ("2g.20gb", 0)

    def test_retry_rolls_back_the_partial_instance(self, cluster,
                                                   monkeypatch):
        """Without a restart: a failed CDI write leaves PrepareStarted and
        an instance; the retry's rollback destroys it before preparing
        again."""
        client, driver, lib = cluster
        a = Allocator(client).allocate(make_claim(
            client, "retry", selectors=on_gpu0("1g.10gb")))
        uid = a["metadata"]["uid"]
        real = driver.cdi.create_claim_spec_file
        monkeypatch.setattr(driver.cdi, "create_claim_spec_file",
                            lambda *a, **kw: (_ for _ in ()).throw(
                                RuntimeError("boom")))
        assert driver.prepare_resource_claims([a])[uid].error is not None
        first = {m.uuid for m in lib.mig_devices()}
        assert len(first) == 1
        monkeypatch.setattr(driver.cdi, "create_claim_spec_file", real)
        assert driver.prepare_resource_claims([a])[uid].error is None
        (m,) = lib.mig_devices()
        assert m.uuid not in first
        rec = driver.state.prepared_claims()[uid].prepared_devices[0]
        assert rec["mig"]["uuid"] == m.uuid and rec["chipIndices"] == [0]

    def test_unprepare_and_drain_destroy_the_instance(self, cluster):
        client, driver, lib = cluster
        alloc = Allocator(client)
        refs = []
        for name in ("u", "d"):
            a = alloc.allocate(make_claim(client, name,
                                          selectors=on_gpu0("3g.40gb")))
            assert driver.prepare_resource_claims([a])[
                a["metadata"]["uid"]].error is None
            refs.append(ClaimRef.from_claim(a))
        assert len(lib.mig_devices()) == 2
        assert driver.unprepare_resource_claims([refs[0]])[refs[0].uid] \
            is None
        assert len(lib.mig_devices()) == 1
        assert driver.drain_claim(refs[1])
        assert lib.mig_devices() == []
        assert driver.cdi.list_claim_uids() == []

    def test_sweep_destroys_unknown_instances_only_under_the_gate(
            self, tmp_path):
        client = FakeClient()
        lib = dl.MockDeviceLib("h100-8", mig=True)
        gpu = lib.enumerate_gpus()[5]
        lib.create_mig_device(gpu, "1g.10gb", 3)      # an admin's instance
        _driver(client, tmp_path / "off", lib, gates="").start()
        assert len(lib.mig_devices()) == 1
        _driver(client, tmp_path / "on", lib)         # its startup sweep
        assert lib.mig_devices() == []

    def test_old_whole_gpu_records_still_read(self, cluster):
        """A record without the ``mig`` key (an older checkpoint) holds
        its whole GPU: a MIG prepare on it is refused."""
        client, driver, _ = cluster

        def add(c):
            c.prepared_claims["old"] = PreparedClaimCP(
                state=STATE_PREPARE_COMPLETED, name="old",
                namespace="default",
                results=[{"device": "gpu-2", "driver": DRIVER_NAME}],
                prepared_devices=[{"device": "gpu-2", "chipIndices": [2]}])
        driver.state.checkpoints.transact(add)
        a = Allocator(client).allocate(make_claim(
            client, "m", selectors=["device.attributes['parentIndex'] == 2",
                                    "device.attributes['profile'] == "
                                    "'1g.10gb'"]))
        err = driver.prepare_resource_claims([a])[a["metadata"]["uid"]].error
        assert err is not None and "claim old" in str(err)


def test_mig_record_read_by_the_jax_package(cluster):
    """A live MIG prepare's checkpoint (its record with the instance's
    profile, placement, ids and UUID beside ``chipIndices: [parent]``),
    read by the JAX package's manager: the same claim states and records."""
    from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import (
        checkpoint as jax_cp,
    )
    client, driver, lib = cluster
    a = Allocator(client).allocate(make_claim(client, "rec",
                                              selectors=on_gpu0("2g.20gb")))
    uid = a["metadata"]["uid"]
    assert driver.prepare_resource_claims([a])[uid].error is None
    ours = driver.state.prepared_claims()[uid]
    theirs = jax_cp.CheckpointManager(os.path.join(
        driver.config.state_dir, "checkpoint.json")).read()
    assert theirs.prepared_claims[uid].__dict__ == ours.__dict__
    (rec,) = ours.prepared_devices
    (m,) = lib.mig_devices()
    assert rec["chipIndices"] == [0]
    assert rec["mig"] == {
        "profile": "2g.20gb", "parentUUID": m.parent_uuid,
        "placementStart": m.start, "placementSize": 2, "giID": m.gi_id,
        "ciID": 0, "uuid": m.uuid, "capsMinors": list(m.caps_minors)}


class TestTaints:
    def test_gpu_taint_reaches_its_mig_devices(self, cluster):
        client, driver, _ = cluster
        alloc = Allocator(client)
        a = alloc.allocate(make_claim(
            client, "t", selectors=["device.attributes['parentIndex'] == 3",
                                    "device.attributes['profile'] == "
                                    "'2g.20gb'"]))
        assert driver.prepare_resource_claims([a])[
            a["metadata"]["uid"]].error is None
        driver.set_device_taint("gpu-3", DeviceTaint(
            key="gpu.nvidia.com/xid", value="79", effect="NoSchedule"))
        devs = {d["name"]: d for d in
                client.list("ResourceSlice")[0]["spec"]["devices"]}
        for name, d in devs.items():
            on3 = name == "gpu-3" or name.startswith("gpu-3-mig-")
            keys = [t["key"] for t in d.get("taints", [])]
            assert keys == (["gpu.nvidia.com/xid"] if on3 else []), name
        # The drain controller's work list reaches the MIG claim.
        assert [r.name for r in driver.affected_claims("gpu-3")] == ["t"]
        assert driver.affected_claims("gpu-4") == []
        assert driver.claim_device_count(ClaimRef.from_claim(a)) == 1
        with pytest.raises(AllocationError):
            alloc.allocate(make_claim(
                client, "t2", selectors=["device.attributes['parentIndex'] "
                                         "== 3"]))


# -- the NVML backend's MIG calls, against a fake of the C library ----------

class _FakeNvmlLib:
    """The NVML C functions the binding calls, over an in-memory node of
    GPUs with MIG state; out-parameters are written through their
    ``byref`` objects, strings into their buffers, as the library does."""

    NOT_FOUND, NOT_SUPPORTED, INSUFFICIENT = 6, 3, 23

    def __init__(self, gpus):
        self.gpus = gpus          # [{uuid, minor, mig: 0|1|None}]
        self.gis = {}             # (gpu, gi) -> {profile_id, start, size, ci}
        self.uuid_serial = 0
        self.inits = 0

    # handles: GPU 0x1000+g, MIG device 0x2000+g*16+k, GI 0x3000+g*16+gi,
    # CI 0x4000+g*16+gi
    @staticmethod
    def _set(ref, value):
        ref._obj.value = value

    def nvmlInit_v2(self):
        self.inits += 1
        return 0

    def nvmlShutdown(self):
        self.inits -= 1
        return 0

    def nvmlErrorString(self, rc):
        return {6: b"Not Found", 3: b"Not Supported",
                23: b"Insufficient Resources"}.get(rc, b"Unknown Error")

    def nvmlSystemGetDriverVersion(self, buf, size):
        buf.value = b"580.159.03"
        return 0

    def nvmlDeviceGetCount_v2(self, ref):
        self._set(ref, len(self.gpus))
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, i, ref):
        self._set(ref, 0x1000 + i)
        return 0

    def nvmlDeviceGetHandleByUUID(self, uuid, ref):
        for g, gpu in enumerate(self.gpus):
            if gpu["uuid"].encode() == uuid:
                self._set(ref, 0x1000 + g)
                return 0
        return self.NOT_FOUND

    def _g(self, h):
        return h.value - 0x1000

    def nvmlDeviceGetMinorNumber(self, h, ref):
        self._set(ref, self.gpus[self._g(h)]["minor"])
        return 0

    def nvmlDeviceGetPciInfo_v3(self, h, ref):
        return self.NOT_SUPPORTED

    def nvmlDeviceGetMemoryInfo(self, h, ref):
        ref._obj.total = 81559 << 20
        return 0

    def nvmlDeviceGetName(self, h, buf, size):
        buf.value = b"NVIDIA H100 80GB HBM3"
        return 0

    def nvmlDeviceGetUUID(self, h, buf, size):
        v = h.value
        if v >= 0x2000:
            g, k = divmod(v - 0x2000, 16)
            buf.value = self.gis[(g, k)]["uuid"].encode()
        else:
            buf.value = self.gpus[self._g(h)]["uuid"].encode()
        return 0

    def nvmlDeviceGetMigMode(self, h, cur, pend):
        mode = self.gpus[self._g(h)]["mig"]
        if mode is None:
            return self.NOT_SUPPORTED
        self._set(cur, mode)
        self._set(pend, mode)
        return 0

    def nvmlDeviceGetMaxMigDeviceCount(self, h, ref):
        self._set(ref, 7)
        return 0

    def nvmlDeviceGetMigDeviceHandleByIndex(self, h, i, ref):
        g = self._g(h)
        mine = sorted(gi for (gg, gi) in self.gis if gg == g)
        if i >= len(mine):
            return self.NOT_FOUND
        self._set(ref, 0x2000 + g * 16 + mine[i])
        return 0

    def nvmlDeviceGetGpuInstanceId(self, mh, ref):
        self._set(ref, (mh.value - 0x2000) % 16)
        return 0

    def nvmlDeviceGetComputeInstanceId(self, mh, ref):
        self._set(ref, 0)
        return 0

    def nvmlDeviceGetGpuInstanceById(self, h, gi, ref):
        g = self._g(h)
        if (g, gi) not in self.gis:
            return self.NOT_FOUND
        self._set(ref, 0x3000 + g * 16 + gi)
        return 0

    def nvmlGpuInstanceGetInfo(self, gih, ref):
        g, gi = divmod(gih.value - 0x3000, 16)
        rec = self.gis[(g, gi)]
        ref._obj.id = gi
        ref._obj.profileId = rec["profile_id"]
        ref._obj.placement.start = rec["start"]
        ref._obj.placement.size = rec["size"]
        return 0

    def nvmlDeviceGetGpuInstanceProfileInfo(self, h, index, ref):
        ref._obj.id = 100 + index          # NVML's ids are its own
        return 0

    def nvmlDeviceCreateGpuInstanceWithPlacement(self, h, pid, placement,
                                                 ref):
        g = self._g(h)
        start, size = placement._obj.start, placement._obj.size
        for (gg, _), rec in self.gis.items():
            if gg == g and rec["start"] < start + size \
                    and start < rec["start"] + rec["size"]:
                return self.INSUFFICIENT
        gi = min(set(range(1, 15)) - {k for (gg, k) in self.gis if gg == g})
        self.uuid_serial += 1
        self.gis[(g, gi)] = {"profile_id": pid, "start": start,
                             "size": size, "ci": None,
                             "uuid": f"MIG-fake-{self.uuid_serial}"}
        self._set(ref, 0x3000 + g * 16 + gi)
        return 0

    def nvmlGpuInstanceGetComputeInstanceProfileInfo(self, gih, prof, eng,
                                                     ref):
        ref._obj.id = 200 + prof
        return 0

    def nvmlGpuInstanceCreateComputeInstance(self, gih, cid, ref):
        g, gi = divmod(gih.value - 0x3000, 16)
        self.gis[(g, gi)]["ci"] = cid
        self._set(ref, 0x4000 + g * 16 + gi)
        return 0

    def nvmlComputeInstanceGetInfo_v2(self, cih, ref):
        ref._obj.id = 0
        return 0

    def nvmlGpuInstanceGetComputeInstanceById(self, gih, ci, ref):
        g, gi = divmod(gih.value - 0x3000, 16)
        if ci != 0 or self.gis[(g, gi)]["ci"] is None:
            return self.NOT_FOUND
        self._set(ref, 0x4000 + g * 16 + gi)
        return 0

    def nvmlComputeInstanceDestroy(self, cih):
        g, gi = divmod(cih.value - 0x4000, 16)
        self.gis[(g, gi)]["ci"] = None
        return 0

    def nvmlGpuInstanceDestroy(self, gih):
        g, gi = divmod(gih.value - 0x3000, 16)
        if self.gis[(g, gi)]["ci"] is not None:
            return 19                        # NVML_ERROR_IN_USE
        del self.gis[(g, gi)]
        return 0


UUIDS = ["GPU-73c4229c-ad5b-35c2-99a6-411722b9ffa0",
         "GPU-73c4229c-ad5b-35c2-99a6-411722b9ffa1"]


def _nvml_node(tmp_path, modes):
    """Two GPUs behind the fake library (MIG ``modes``: 1 on, 0 off, None
    Not Supported), their device nodes, and the NVML-backend library."""
    fake = _FakeNvmlLib([{"uuid": u, "minor": i, "mig": m}
                         for i, (u, m) in enumerate(zip(UUIDS, modes))])
    for i in range(len(modes)):
        (tmp_path / f"nvidia{i}").write_text("")
    lib = dl.SysfsDeviceLib(dev_root=str(tmp_path),
                            sysfs_root=str(tmp_path / "nosys"),
                            proc_root=str(tmp_path / "proc"),
                            backend=dl.BACKEND_NVML, env={},
                            nvml=dl.NvmlBinding(lib=fake))
    return fake, lib


def _caps(tmp_path, minor, gi, ci=0):
    """The capability files the driver publishes for a new instance."""
    d = dl.mig_caps_dir(str(tmp_path / "proc"), minor, gi)
    (d / f"ci{ci}").mkdir(parents=True, exist_ok=True)
    a, b = dl.mig_caps_minors(minor, gi, ci)
    (d / "access").write_text(f"DeviceFileMinor: {a}\nDeviceFileMode: 292\n")
    (d / f"ci{ci}" / "access").write_text(f"DeviceFileMinor: {b}\n")


class TestNvmlMig:
    def test_mig_mode_answers(self, tmp_path):
        fake, lib = _nvml_node(tmp_path, [1, None])
        g0, g1 = lib.enumerate_gpus()
        assert (g0.mig_enabled, g1.mig_enabled) == (True, False)
        assert lib.mig_modes == {
            UUIDS[0]: "current=enabled pending=enabled",
            UUIDS[1]: "Not Supported (code 3)"}
        assert fake.inits == 0                   # every init shut down

    def test_create_list_destroy(self, tmp_path):
        fake, lib = _nvml_node(tmp_path, [1, 0])
        g0, g1 = lib.enumerate_gpus()
        assert lib.mig_devices() == []
        _caps(tmp_path, 0, 1)
        m = lib.create_mig_device(g0, "3g.40gb", 4)
        assert (m.profile, m.start, m.size, m.gi_id, m.ci_id) == \
            ("3g.40gb", 4, 4, 1, 0)
        assert m.uuid == "MIG-fake-1"
        assert m.caps_minors == dl.mig_caps_minors(0, 1, 0)
        assert fake.gis[(0, 1)]["profile_id"] == 100 + 2   # 3_SLICE
        assert fake.gis[(0, 1)]["ci"] == 200 + 2           # CI 3_SLICE
        assert lib.mig_devices() == [m]
        _caps(tmp_path, 0, 2)
        with pytest.raises(dl.EnumerationError, match="Insufficient"):
            lib.create_mig_device(g0, "1g.10gb", 5)
        with pytest.raises(dl.EnumerationError, match="MIG mode is off"):
            lib.create_mig_device(g1, "1g.10gb", 0)
        with pytest.raises(ValueError, match="no placement"):
            lib.create_mig_device(g0, "3g.40gb", 2)
        lib.destroy_mig_device(m)
        lib.destroy_mig_device(m)                # already gone: no error
        assert lib.mig_devices() == [] and fake.gis == {}
        assert fake.inits == 0

    def test_failed_compute_instance_destroys_the_gpu_instance(
            self, tmp_path):
        fake, lib = _nvml_node(tmp_path, [1])
        fake.nvmlGpuInstanceCreateComputeInstance = \
            lambda gih, cid, ref: fake.INSUFFICIENT
        with pytest.raises(dl.EnumerationError):
            lib.create_mig_device(lib.enumerate_gpus()[0], "1g.10gb", 0)
        assert fake.gis == {} and fake.inits == 0

    def test_plugin_publishes_placements_only_for_gpus_in_mig_mode(
            self, tmp_path):
        """What the smoke checks on the card: with DynamicMIG on, a GPU
        whose NVML mode is off (or not supported) is a whole GPU and
        nothing else; one in MIG mode adds its 25 placements."""
        _, lib = _nvml_node(tmp_path, [1, None])
        client = FakeClient()
        _driver(client, tmp_path, lib).start()
        names = [d["name"] for d in
                 client.list("ResourceSlice")[0]["spec"]["devices"]]
        assert names[:2] == ["gpu-0", "gpu-1"]
        assert len(names) == 2 + 25
        assert all(n.startswith("gpu-0-mig-") for n in names[2:])

    def test_procfs_backend_has_no_mig(self, tmp_path):
        mock = dl.MockDeviceLib("h100-8", mig=True)
        dev, sysfs, proc = mock.materialize(tmp_path)
        lib = dl.SysfsDeviceLib(dev_root=dev, sysfs_root=sysfs,
                                proc_root=proc, env={})
        assert not any(g.mig_enabled for g in lib.enumerate_gpus())
        assert lib.mig_devices() == []
        with pytest.raises(dl.EnumerationError, match="nvml backend"):
            lib.destroy_mig_device(mock.create_mig_device(
                mock.enumerate_gpus()[0], "1g.10gb", 0))


def test_mock_instances_and_their_capability_files(tmp_path):
    """The mock's MIG state as the driver keeps it: the lowest free GPU
    instance id, the driver's ``mig-minors`` layout, capability files and
    ``nvidia-caps`` nodes written and removed, overlap refused, a new UUID
    for a re-created placement."""
    lib = dl.MockDeviceLib("h100-8", mig=True)
    dev, _, proc = lib.materialize(tmp_path)
    g = lib.enumerate_gpus()[1]
    a = lib.create_mig_device(g, "3g.40gb", 0)
    assert (a.gi_id, a.ci_id) == (1, 0)
    assert a.caps_minors == (3 + 1 * 135 + 9, 3 + 1 * 135 + 10)
    access = dl.mig_caps_dir(proc, g.minor, 1) / "access"
    assert access.read_text().startswith(f"DeviceFileMinor: {a.caps_minors[0]}")
    assert sorted(os.listdir(os.path.join(dev, "nvidia-caps"))) == sorted(
        p.rsplit("/", 1)[1] for p in a.caps_paths)
    with pytest.raises(dl.EnumerationError, match="overlaps"):
        lib.create_mig_device(g, "1g.20gb", 2)
    lib.destroy_mig_device(a)
    assert not access.exists() and os.listdir(os.path.join(dev,
                                                           "nvidia-caps")) \
        == []
    b = lib.create_mig_device(g, "3g.40gb", 0)
    assert b.uuid != a.uuid and b.gi_id == 1


def test_nvml_struct_layouts():
    """The ctypes structures have nvml.h's sizes on a 64-bit host:
    nvmlGpuInstanceProfileInfo_t ten unsigned ints and an unsigned long
    long, nvmlGpuInstanceInfo_t a handle, two ids and a placement,
    nvmlComputeInstanceInfo_t two handles, two ids and a placement."""
    assert ctypes.sizeof(dl._NvmlGpuInstanceProfileInfo) == 48
    assert ctypes.sizeof(dl._NvmlGpuInstanceInfo) == 24
    assert ctypes.sizeof(dl._NvmlComputeInstanceProfileInfo) == 36
    assert ctypes.sizeof(dl._NvmlComputeInstanceInfo) == 32


def test_the_smokes_mig_phase_on_a_mock_node(tmp_path, monkeypatch, capsys):
    """``chip_smoke.phase_mig`` as the card runs it, its card an NVML
    library (the fake above) whose GPU answers Not Supported to the MIG
    mode, with small CPU engines: two 3g.40gb tenants on a mock node,
    the refusals, the engines within their profile's memory, a
    1g.10gb+me claim and its refused twin, the VFIO leg on a materialized
    tree, one ``mig`` line and nothing left."""
    import chip_smoke
    from k8s_dra_driver_tpu_torch.compute import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _, lib = _nvml_node(tmp_path, [None])
    (gpu,) = lib.enumerate_gpus()
    out = chip_smoke.phase_mig("mock", 0, lib, gpu, width={
        "max_batch": 4, "heads": 2, "head_dim": 8, "kv_cap": 64,
        "prompts": (8, 40), "new_tokens": 4, "requests": 4,
        "device": "cpu"})
    assert out["nvml_mig"] == "Not Supported (code 3)"
    assert out["real_published"] == ["gpu-0"]
    assert out["tenants"] == ["gpu-0-mig-3g40gb-0-4",
                              "gpu-0-mig-3g40gb-4-4"]
    assert out["refused"] == ["over-4g", "over-whole"]
    assert out["kernel_launches"] == 0 and out["decode_steps"] > 0
    assert out["kv_isolation_max_err"] < 1e-4
    assert all(b <= out["profile_memory_bytes"] for b in out["engine_bytes"])
    assert out["after_4g"] == "4g.40gb" and out["residue"] == []
    assert out["devices_published"] == 208
    assert out["media"]["twin_refused"]
    assert out["media"]["device"].startswith("gpu-1-mig-1g10gbme-")
    assert out["vfio"]["names"] == 8
    assert out["vfio"]["ledger"] == {out["vfio"]["bdf"]: "nvidia"}
    assert out["vfio"]["restored"] == "nvidia"
    assert out["vfio_managers"] == 1
    text = capsys.readouterr().out
    assert text.count("[mig]") == 1 and "residue=[]" in text


def test_the_smokes_mig_phase_refuses_a_card_in_mig_mode(tmp_path,
                                                         monkeypatch):
    """A card in MIG mode fails the phase before anything runs on it."""
    import chip_smoke
    from k8s_dra_driver_tpu_torch.compute import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _, lib = _nvml_node(tmp_path, [1])
    (gpu,) = lib.enumerate_gpus()
    with pytest.raises(SystemExit, match="MIG mode"):
        chip_smoke.phase_mig("mock", 0, lib, gpu, width={"device": "cpu"})


def test_the_smokes_guard_refuses_vfio_on_the_host():
    import chip_smoke

    with chip_smoke._NoVfioOnTheHost() as guard:
        with pytest.raises(SystemExit, match="real /sys"):
            VfioPciManager()
    assert guard.roots == []
    assert VfioPciManager.__init__ is guard.orig
