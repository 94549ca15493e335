"""End-to-end tests of the port's GPU kubelet plugin on the ``h100-8`` mock.

Each whole-device scenario of ``tests/test_tpu_plugin.py`` has its
counterpart here: publication, an exclusive claim, a multi-GPU claim's
union env, idempotent shared prepare, unprepare cleanup, the overlap
refusal, opaque-config env and its strict failures, metrics, a kill
mid-prepare and recovery, boot-id invalidation, the startup sweep of stray
CDI specs, the checkpoint format (round trip, corruption, v1 migration and
shadow), and taints. The checkpoint is the JAX package's format: files
written by either package's ``CheckpointManager`` read back equal in the
other, byte for byte.
"""

import json
import os

import pytest

from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import checkpoint as jax_cp
from k8s_dra_driver_tpu_torch.api.configs import API_VERSION
from k8s_dra_driver_tpu_torch.cdi.spec import CDIDevice
from k8s_dra_driver_tpu_torch.gpulib import MockDeviceLib
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import AllocationError, Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef, DeviceTaint
from k8s_dra_driver_tpu_torch.pkg import faultpoints
from k8s_dra_driver_tpu_torch.pkg.errors import PermanentError, is_permanent
from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    DYNAMIC_MIG,
    PASSTHROUGH_SUPPORT,
    new_feature_gates,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    checkpoint as port_cp,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_COMPLETED,
    STATE_PREPARE_STARTED,
    Checkpoint,
    CheckpointManager,
    CorruptCheckpointError,
    PreparedClaimCP,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    DRIVER_NAME,
    OverlapError,
)

GPUS = MockDeviceLib("h100-8").enumerate_gpus()


@pytest.fixture()
def cluster(tmp_path):
    """A one-node mock cluster: fake API + the h100-8 GPU driver."""
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", "gpu.nvidia.com",
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    cfg = DriverConfig(
        node_name="node-a",
        state_dir=str(tmp_path / "state"),
        cdi_root=str(tmp_path / "cdi"),
        env={},
        retry_timeout=0.5,  # fast tests: retryable failures give up quickly
    )
    driver = GpuDriver(client, cfg, device_lib=MockDeviceLib("h100-8")).start()
    return client, driver


def make_claim(client, name, count=1, config=None, selectors=None):
    req = {"name": "gpu",
           "exactly": {"deviceClassName": "gpu.nvidia.com",
                       "allocationMode": "ExactCount", "count": count}}
    if selectors:
        req["exactly"]["selectors"] = [{"cel": {"expression": s}}
                                       for s in selectors]
    spec = {"devices": {"requests": [req]}}
    if config is not None:
        spec["devices"]["config"] = [{
            "requests": ["gpu"],
            "opaque": {"driver": DRIVER_NAME, "parameters": config}}]
    return client.create(new_object(
        "ResourceClaim", name, "default",
        api_version="resource.k8s.io/v1", spec=spec))


def prepare(client, driver, name):
    claim = Allocator(client).allocate(
        client.get("ResourceClaim", name, "default"))
    results = driver.prepare_resource_claims([claim])
    return claim, results[claim["metadata"]["uid"]]


def claim_env(spec):
    return dict(e.split("=", 1) for e in spec["containerEdits"]["env"])


def devices(client):
    return {d["name"]: d
            for d in client.list("ResourceSlice")[0]["spec"]["devices"]}


class TestPublication:
    def test_slice_contents(self, cluster):
        client, _ = cluster
        slices = client.list("ResourceSlice")
        assert len(slices) == 1
        spec = slices[0]["spec"]
        assert [d["name"] for d in spec["devices"]] == [f"gpu-{i}"
                                                        for i in range(8)]
        assert spec["pool"]["name"] == "node-a"
        assert spec["driver"] == "gpu.nvidia.com"
        assert "sharedCounters" not in spec   # no MIG partitions yet

    def test_gpu_attributes_and_capacity(self, cluster):
        client, _ = cluster
        dev = devices(client)["gpu-2"]
        g = GPUS[2]
        assert dev["attributes"] == {
            "type": {"string": "gpu"},
            "uuid": {"string": g.uuid},
            "productName": {"string": "NVIDIA H100 80GB HBM3"},
            "index": {"int": 2},
            "minor": {"int": g.minor},
            "cudaComputeCapability": {"version": "9.0.0"},
            "driverVersion": {"version": "550.54.15"},
            "pciAddress": {"string": g.pci_address},
            "numaNode": {"int": 0},
        }
        assert dev["capacity"]["memory"]["value"] == 81559 << 20

    def test_list_type_attributes_gate(self, tmp_path):
        client = FakeClient()
        GpuDriver(client, DriverConfig(
            node_name="n", state_dir=str(tmp_path / "s"),
            cdi_root=str(tmp_path / "c"), env={},
            feature_gates=new_feature_gates("DRAListTypeAttributes=true")),
            device_lib=MockDeviceLib("h100-8")).start()
        dev = devices(client)["gpu-5"]
        assert dev["attributes"]["numaNode"] == {"list": [1]}

    @pytest.mark.parametrize("gate", [DYNAMIC_MIG, PASSTHROUGH_SUPPORT])
    def test_waiting_features_refuse_to_start(self, tmp_path, gate):
        """Once refused at assembly, each gate now starts the plugin:
        DynamicMIG publishes the 26 devices of each GPU in MIG mode over
        the memory-slice and media counters, PassthroughSupport the GPUs
        (the mock
        binds none to vfio-pci)."""
        client = FakeClient()
        GpuDriver(client, DriverConfig(
            node_name="n", state_dir=str(tmp_path / "s"),
            cdi_root=str(tmp_path / "c"), env={},
            feature_gates=new_feature_gates(f"{gate}=true")),
            device_lib=MockDeviceLib("h100-8", mig=True)).start()
        (spec,) = [s["spec"] for s in client.list("ResourceSlice")]
        if gate == DYNAMIC_MIG:
            assert len(spec["devices"]) == 8 * 26
            (cs,) = spec["sharedCounters"]
            assert len(cs["counters"]) == 8 * 8 + 8
        else:
            assert [d["name"] for d in spec["devices"]] == [
                f"gpu-{i}" for i in range(8)]
            assert "sharedCounters" not in spec


class TestPrepareEndToEnd:
    def test_exclusive_gpu_claim(self, cluster):
        client, driver = cluster
        make_claim(client, "wl", count=1)
        claim, result = prepare(client, driver, "wl")
        assert result.error is None
        assert len(result.devices) == 1
        ref = result.devices[0]
        assert ref.cdi_device_ids[0].startswith("k8s.gpu.nvidia.com/claim=")
        g = next(g for g in GPUS if g.canonical_name == ref.device)
        spec = driver.cdi.read_claim_spec(claim["metadata"]["uid"])
        env = claim_env(spec)
        assert env["CUDA_VISIBLE_DEVICES"] == g.uuid
        assert env["NVIDIA_VISIBLE_DEVICES"] == g.uuid
        nodes = [n["path"] for n in
                 spec["devices"][0]["containerEdits"]["deviceNodes"]]
        assert nodes == [f"/dev/nvidia{g.minor}", "/dev/nvidiactl",
                         "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools"]

    def test_multi_gpu_claim_union_env(self, cluster):
        client, driver = cluster
        make_claim(client, "wl4", count=4,
                   selectors=["device.attributes['numaNode'] == 1"])
        claim, result = prepare(client, driver, "wl4")
        assert result.error is None
        spec = driver.cdi.read_claim_spec(claim["metadata"]["uid"])
        # The union env names the claim's four GPUs by UUID, in node
        # index order: the NUMA-1 half of the node.
        assert claim_env(spec)["CUDA_VISIBLE_DEVICES"] == ",".join(
            g.uuid for g in GPUS[4:])
        assert len(spec["devices"]) == 4

    def test_shared_claim_idempotent_prepare(self, cluster):
        client, driver = cluster
        make_claim(client, "shared", count=1)
        claim, r1 = prepare(client, driver, "shared")
        r2 = driver.prepare_resource_claims([claim])[claim["metadata"]["uid"]]
        assert r1.error is None and r2.error is None
        assert [d.cdi_device_ids for d in r1.devices] == \
               [d.cdi_device_ids for d in r2.devices]
        assert len(driver.cdi.list_claim_uids()) == 1

    def test_unprepare_cleans_up(self, cluster):
        client, driver = cluster
        make_claim(client, "wl", count=2)
        claim, _ = prepare(client, driver, "wl")
        uid = claim["metadata"]["uid"]
        out = driver.unprepare_resource_claims(
            [ClaimRef(uid=uid, name="wl", namespace="default")])
        assert out[uid] is None
        assert driver.cdi.read_claim_spec(uid) is None
        assert driver.state.prepared_claims() == {}
        out2 = driver.unprepare_resource_claims(
            [ClaimRef(uid="ghost", name="g", namespace="default")])
        assert out2["ghost"] is None

    def test_overlapping_prepare_rejected(self, cluster):
        client, driver = cluster
        make_claim(client, "a", count=1)
        _, ra = prepare(client, driver, "a")
        assert ra.error is None
        forged = make_claim(client, "b", count=1)
        forged["status"] = {"allocation": {"devices": {"results": [
            {"request": "gpu", "driver": DRIVER_NAME,
             "pool": "node-a", "device": ra.devices[0].device}]}}}
        forged = client.update_status(forged)
        err = driver.prepare_resource_claims([forged])[
            forged["metadata"]["uid"]].error
        assert isinstance(err, OverlapError)
        assert "overlapping" in str(err)
        assert f"gpu:{ra.devices[0].device.split('-')[1]}" in str(err)

    def test_opaque_config_env_injection(self, cluster):
        client, driver = cluster
        make_claim(client, "cfg", count=1, config={
            "apiVersion": API_VERSION, "kind": "GpuConfig",
            "env": {"NCCL_DEBUG": "INFO"}})
        claim, result = prepare(client, driver, "cfg")
        assert result.error is None
        spec = driver.cdi.read_claim_spec(claim["metadata"]["uid"])
        assert "NCCL_DEBUG=INFO" in spec["devices"][0]["containerEdits"]["env"]

    @pytest.mark.parametrize("config,match", [
        ({"kind": "GpuConfig", "env": {"CUDA_VISIBLE_DEVICES": "7"}},
         "driver-managed"),
        ({"kind": "GpuConfig", "envv": {"X": "1"}}, "unknown fields"),
        ({"kind": "MigDeviceConfig", "profile": "1g.10gb"},
         "MigDeviceConfig cannot target device gpu-"),
        ({"kind": "VfioDeviceConfig", "iommu": "legacy"},
         "feature gate PassthroughSupport is disabled"),
        ({"kind": "TimeSlicingConfig"}, "unknown config kind"),
    ])
    def test_invalid_opaque_config_is_permanent(self, cluster, config, match):
        client, driver = cluster
        make_claim(client, "bad", count=1,
                   config={"apiVersion": API_VERSION, **config})
        _, result = prepare(client, driver, "bad")
        assert isinstance(result.error, PermanentError)
        assert match in str(result.error)

    def test_class_config_strictly_decoded(self, cluster):
        client, driver = cluster
        dc = client.get("DeviceClass", "gpu.nvidia.com")
        dc["spec"]["config"] = [{"opaque": {
            "driver": DRIVER_NAME,
            "parameters": {"apiVersion": API_VERSION, "kind": "GpuConfig",
                           "envv": {"X": "1"}}}}]
        client.update(dc)
        make_claim(client, "typo", count=1)
        _, result = prepare(client, driver, "typo")
        assert isinstance(result.error, PermanentError)
        assert "unknown fields" in str(result.error)

    def test_metrics_populated(self, cluster):
        client, driver = cluster
        make_claim(client, "m", count=2)
        prepare(client, driver, "m")
        m = driver.metrics
        assert m.requests_total.value(
            driver=DRIVER_NAME, operation="prepare") == 1
        assert m.request_duration_seconds.count(
            driver=DRIVER_NAME, operation="prepare") == 1
        assert m.prepared_devices.value(
            node="node-a", driver=DRIVER_NAME, device_type="gpu") == 2
        assert "gpu_dra_requests_total" in m.registry.expose_text()


class TestCrashConsistency:
    def test_kill_mid_prepare_then_recover(self, cluster, monkeypatch):
        client, driver = cluster
        make_claim(client, "crashy", count=1)
        claim = Allocator(client).allocate(
            client.get("ResourceClaim", "crashy", "default"))
        uid = claim["metadata"]["uid"]
        real_create = driver.cdi.create_claim_spec_file
        calls = {"n": 0}

        def exploding(*a, **kw):
            calls["n"] += 1
            raise RuntimeError("simulated crash during CDI write")

        monkeypatch.setattr(driver.cdi, "create_claim_spec_file", exploding)
        result = driver.prepare_resource_claims([claim])[uid]
        assert result.error is not None
        assert calls["n"] >= 1
        assert driver.state.prepared_claims()[uid].state == \
            STATE_PREPARE_STARTED
        monkeypatch.setattr(driver.cdi, "create_claim_spec_file", real_create)
        driver2 = GpuDriver(client, driver.config,
                            device_lib=MockDeviceLib("h100-8")).start()
        r2 = driver2.prepare_resource_claims([claim])[uid]
        assert r2.error is None
        assert driver2.state.prepared_claims()[uid].state == \
            STATE_PREPARE_COMPLETED
        assert driver2.cdi.read_claim_spec(uid) is not None

    def test_cdi_write_fault_point(self, cluster):
        """The ``cdi.write`` fault point fails the spec write before the
        atomic publish: the claim parks in PrepareStarted with no spec,
        and the next prepare rolls back and completes."""
        client, driver = cluster
        make_claim(client, "fp", count=1)
        claim = Allocator(client).allocate(
            client.get("ResourceClaim", "fp", "default"))
        uid = claim["metadata"]["uid"]
        with faultpoints.injected("cdi.write=first:100:oserror"):
            r = driver.prepare_resource_claims([claim])[uid]
        assert isinstance(r.error, OSError)
        assert driver.cdi.read_claim_spec(uid) is None
        assert driver.state.prepared_claims()[uid].state == \
            STATE_PREPARE_STARTED
        r = driver.prepare_resource_claims([claim])[uid]
        assert r.error is None and driver.cdi.read_claim_spec(uid)

    def test_boot_id_invalidation(self, cluster, tmp_path):
        client, driver = cluster
        make_claim(client, "pre-reboot", count=1)
        claim, _ = prepare(client, driver, "pre-reboot")
        uid = claim["metadata"]["uid"]
        assert driver.cdi.read_claim_spec(uid) is not None
        boot_file = tmp_path / "boot_id"
        boot_file.write_text("new-boot-epoch\n")
        cfg = DriverConfig(
            node_name="node-a", state_dir=driver.config.state_dir,
            cdi_root=driver.config.cdi_root,
            env={"GPU_DRA_ALT_BOOT_ID_PATH": str(boot_file)},
            retry_timeout=0.5)
        driver2 = GpuDriver(client, cfg, device_lib=MockDeviceLib("h100-8"))
        assert driver2.state.prepared_claims() == {}
        assert driver2.cdi.read_claim_spec(uid) is None

    def test_unreadable_boot_id_does_not_wipe(self, cluster, tmp_path):
        client, driver = cluster
        make_claim(client, "keepme", count=1)
        claim, _ = prepare(client, driver, "keepme")
        uid = claim["metadata"]["uid"]
        cfg = DriverConfig(
            node_name="node-a", state_dir=driver.config.state_dir,
            cdi_root=driver.config.cdi_root,
            env={"GPU_DRA_ALT_BOOT_ID_PATH": str(tmp_path / "missing")},
            retry_timeout=0.5)
        d2 = GpuDriver(client, cfg, device_lib=MockDeviceLib("h100-8"))
        assert uid in d2.state.prepared_claims()
        assert d2.cdi.read_claim_spec(uid) is not None

    def test_startup_sweeps_stray_cdi_specs(self, cluster):
        client, driver = cluster
        driver.cdi.create_claim_spec_file("stray-uid", [CDIDevice(name="x")])
        driver2 = GpuDriver(client, driver.config,
                            device_lib=MockDeviceLib("h100-8"))
        assert driver2.cdi.read_claim_spec("stray-uid") is None

    def test_overlap_check_survives_dead_gpu(self, cluster):
        client, driver = cluster
        make_claim(client, "holder", count=1,
                   selectors=["device.attributes['index'] == 0"])
        _, ra = prepare(client, driver, "holder")
        assert ra.error is None
        lib = MockDeviceLib("h100-8")
        real_enum = lib.enumerate_gpus
        lib.enumerate_gpus = lambda: [g for g in real_enum() if g.index != 0]
        d2 = GpuDriver(client, driver.config, device_lib=lib).start()
        forged = make_claim(client, "racer", count=1)
        forged["status"] = {"allocation": {"devices": {"results": [
            {"request": "gpu", "driver": DRIVER_NAME,
             "pool": "node-a", "device": "gpu-0"}]}}}
        forged = client.update_status(forged)
        err = d2.prepare_resource_claims([forged])[
            forged["metadata"]["uid"]].error
        assert isinstance(err, PermanentError)

    def test_v1_checkpoint_upgrade_preserves_claims(self, cluster, tmp_path):
        client, driver = cluster
        state_dir = tmp_path / "v1state"
        state_dir.mkdir()
        (state_dir / "checkpoint.json").write_text(json.dumps(
            {"checksum": 0, "v1": {"legacy-uid": ["gpu-5"]}}))
        cfg = DriverConfig(node_name="node-a", state_dir=str(state_dir),
                           cdi_root=driver.config.cdi_root, env={},
                           retry_timeout=0.5)
        d2 = GpuDriver(client, cfg, device_lib=MockDeviceLib("h100-8"))
        pcs = d2.state.prepared_claims()
        assert pcs["legacy-uid"].state == STATE_PREPARE_COMPLETED


class TestCheckpointFormat:
    def test_on_batch_hook_runs_outside_commit_lock(self, tmp_path):
        seen = []
        mgr = CheckpointManager(
            str(tmp_path / "cp.json"),
            on_batch=lambda n: seen.append(
                (n, mgr._commit_mu.acquire(blocking=False))))
        mgr.transact(lambda cp: cp.prepared_claims.setdefault(
            "u1", PreparedClaimCP(state=STATE_PREPARE_COMPLETED)))
        assert seen and seen[0] == (1, True)
        mgr._commit_mu.release()

    def test_on_batch_hook_still_fires_when_batch_fails(self, tmp_path):
        seen = []
        mgr = CheckpointManager(str(tmp_path / "cp.json"),
                                on_batch=lambda n: seen.append(n))

        def boom(cp):
            raise RuntimeError("txn-level failure")

        with pytest.raises(RuntimeError):
            mgr.transact(boom)
        assert seen == [1]

    def test_roundtrip_and_checksum(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "cp.json"))
        cp = Checkpoint(node_boot_id="boot-1")
        cp.prepared_claims["u1"] = PreparedClaimCP(
            state=STATE_PREPARE_COMPLETED, name="c", namespace="ns",
            prepared_devices=[{"device": "gpu-0"}])
        mgr.write(cp)
        got = mgr.read()
        assert got.node_boot_id == "boot-1"
        assert got.prepared_claims["u1"].prepared_devices == \
            [{"device": "gpu-0"}]

    def test_corruption_detected(self, tmp_path):
        path = tmp_path / "cp.json"
        mgr = CheckpointManager(str(path))
        mgr.write(Checkpoint(node_boot_id="b"))
        doc = json.loads(path.read_text())
        doc["v2"]["nodeBootId"] = "tampered"
        path.write_text(json.dumps(doc))
        with pytest.raises(CorruptCheckpointError):
            mgr.read()

    @pytest.mark.parametrize("bad", ["null", "7", "[]", '"x"'])
    def test_non_object_json_is_corrupt(self, tmp_path, bad):
        p = tmp_path / "cp.json"
        p.write_text(bad)
        with pytest.raises(CorruptCheckpointError):
            CheckpointManager(str(p)).read()

    def test_corrupt_checkpoint_is_permanent(self):
        assert is_permanent(CorruptCheckpointError("x"))

    def test_v1_migration(self, tmp_path):
        path = tmp_path / "cp.json"
        path.write_text(json.dumps({"checksum": 0,
                                    "v1": {"old-uid": ["gpu-3", "gpu-4"]}}))
        pc = CheckpointManager(str(path)).read().prepared_claims["old-uid"]
        assert pc.state == STATE_PREPARE_COMPLETED
        assert [d["device"] for d in pc.prepared_devices] == ["gpu-3", "gpu-4"]

    def test_v1_shadow_written_and_protected(self, tmp_path):
        p = tmp_path / "cp.json"
        mgr = CheckpointManager(str(p))
        cp = Checkpoint(node_boot_id="b")
        cp.prepared_claims["u"] = PreparedClaimCP(
            state=STATE_PREPARE_COMPLETED, prepared_devices=[{"device": "gpu-7"}])
        mgr.write(cp)
        doc = json.loads(p.read_text())
        assert doc["v1"] == {"u": ["gpu-7"]}
        doc["v1"] = {"u": ["gpu-6"]}
        p.write_text(json.dumps(doc))
        with pytest.raises(CorruptCheckpointError, match="document checksum"):
            CheckpointManager(str(p)).read()


def _claims(mod):
    cp = mod.Checkpoint(node_boot_id="boot-7")
    cp.prepared_claims["u-done"] = mod.PreparedClaimCP(
        state=mod.STATE_PREPARE_COMPLETED, name="done", namespace="ns",
        results=[{"request": "gpu", "driver": "gpu.nvidia.com",
                  "pool": "node-a", "device": "gpu-1"}],
        prepared_devices=[{
            "device": "gpu-1", "requests": ["gpu"], "pool": "node-a",
            "cdiDeviceName": "u-done-gpu-1",
            "deviceNodes": ["/dev/nvidia1", "/dev/nvidiactl"],
            "env": {"NCCL_DEBUG": "INFO"}, "chipIndices": [1], "mounts": [],
            "vfio": {}}])
    cp.prepared_claims["u-started"] = mod.PreparedClaimCP(
        state=mod.STATE_PREPARE_STARTED, name="started", namespace="ns",
        results=[{"device": "gpu-2"}])
    cp.prepared_claims["u-aborted"] = mod.PreparedClaimCP(
        state=mod.STATE_PREPARE_ABORTED, name="aborted",
        aborted_expiry=1234.5)
    return cp


class TestCheckpointAcrossPackages:
    @pytest.mark.parametrize("writer,reader", [(jax_cp, port_cp),
                                               (port_cp, jax_cp)])
    def test_written_by_one_read_equal_by_the_other(self, tmp_path, writer,
                                                    reader):
        path = tmp_path / "checkpoint.json"
        written = _claims(writer)
        writer.CheckpointManager(str(path)).write(written)
        got = reader.CheckpointManager(str(path)).read()
        assert got.node_boot_id == "boot-7"
        assert {u: pc.__dict__ for u, pc in got.prepared_claims.items()} == \
            {u: pc.__dict__ for u, pc in written.prepared_claims.items()}

    def test_same_bytes_same_checksum(self, tmp_path):
        paths = []
        for mod in (jax_cp, port_cp):
            p = tmp_path / f"{mod.__name__.split('.')[0]}.json"
            mod.CheckpointManager(str(p)).write(_claims(mod))
            paths.append(p)
        a, b = (p.read_bytes() for p in paths)
        assert a == b
        assert json.loads(a)["checksum"] == json.loads(b)["checksum"] != 0

    def test_port_driver_state_read_by_the_jax_package(self, cluster):
        """A live prepare's checkpoint, read by the JAX package's manager:
        the same claim states, device names and CDI ids."""
        client, driver = cluster
        make_claim(client, "live", count=2)
        claim, result = prepare(client, driver, "live")
        uid = claim["metadata"]["uid"]
        path = os.path.join(driver.config.state_dir, "checkpoint.json")
        theirs = jax_cp.CheckpointManager(path).read()
        ours = driver.state.prepared_claims()
        assert theirs.node_boot_id == driver.state.node_boot_id
        assert theirs.prepared_claims[uid].__dict__ == ours[uid].__dict__
        assert theirs.prepared_claims[uid].state == STATE_PREPARE_COMPLETED
        ids = sorted(f"k8s.gpu.nvidia.com/claim={d['cdiDeviceName']}"
                     for d in theirs.prepared_claims[uid].prepared_devices)
        assert ids == sorted(i for d in result.devices
                             for i in d.cdi_device_ids)


class TestTaints:
    def test_taint_set_and_clear(self, cluster):
        client, driver = cluster
        driver.set_device_taint("gpu-3", DeviceTaint(
            key="gpu.nvidia.com/unhealthy", value="xid", effect="NoSchedule"))
        assert devices(client)["gpu-3"]["taints"][0]["key"] == \
            "gpu.nvidia.com/unhealthy"
        a = Allocator(client).allocate(make_claim(
            client, "avoid", count=1,
            selectors=["device.attributes['index'] == 3 || "
                       "device.attributes['index'] == 4"]))
        assert a["status"]["allocation"]["devices"]["results"][0]["device"] \
            == "gpu-4"
        driver.clear_device_taint("gpu-3", "gpu.nvidia.com/unhealthy")
        assert "taints" not in devices(client)["gpu-3"]

    def test_cordon_taints_every_device(self, cluster):
        client, driver = cluster
        assert driver.set_cordon("maintenance")
        assert not driver.set_cordon("maintenance")
        assert driver.cordoned
        assert all(d["taints"][0]["key"] == "gpu.nvidia.com/cordon"
                   for d in devices(client).values())
        with pytest.raises(AllocationError):
            Allocator(client).allocate(make_claim(client, "c", count=1))
        assert driver.clear_cordon()
        assert not any("taints" in d for d in devices(client).values())

    def test_all_prepared_claims(self, cluster):
        client, driver = cluster
        make_claim(client, "one", count=1)
        claim, _ = prepare(client, driver, "one")
        refs = driver.all_prepared_claims()
        assert [(r.uid, r.name) for r in refs] == \
            [(claim["metadata"]["uid"], "one")]
