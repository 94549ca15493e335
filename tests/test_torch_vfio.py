"""VFIO passthrough in the port's GPU kubelet plugin, held to
``tests/test_vfio.py``.

vfio-pci bind and unbind over the materialized ``h100-8`` tree, with
``FakeVfioKernel`` emulating the kernel's rebinding reaction; the
``PassthroughSupport`` gate; the CDI node shape (the group cdev or the
iommufd cdev per device, one IOMMU API node per claim); the restore ledger
in the checkpoint before the bind and the crash rollback; published
vfio-bound GPUs that are not re-offered while a claim holds them, and whose
scan index never aliases a GPU's. Every class of ``tests/test_vfio.py``
but ``TestPassthroughDemoSpec``, which waits for the GPU demo specs. A
GPU that leaves the NVIDIA driver also leaves ``/proc/driver/nvidia/gpus``;
the tests remove that entry by hand where an admin pre-binds a GPU, as the
JAX tests remove the chip's accel entry.
"""

import pathlib
import shutil

import pytest

from k8s_dra_driver_tpu_torch.api.configs import API_VERSION
from k8s_dra_driver_tpu_torch.gpulib import MockDeviceLib, SysfsDeviceLib
from k8s_dra_driver_tpu_torch.gpulib.device_lib import FakeVfioKernel
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
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
    partitions as P,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_STARTED,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    DRIVER_NAME,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.vfio import (
    VfioError,
    VfioPciManager,
)

BDF0 = "0000:18:00.0"   # gpu-0's PCI function in the h100-8 mock profile
BDF7 = "0000:db:00.0"   # gpu-7's: the last in bus order
BOTH = f"{DYNAMIC_MIG}=true,{PASSTHROUGH_SUPPORT}=true"


@pytest.fixture()
def tree(tmp_path):
    """Materialized h100-8 tree + kernel emulation + manager."""
    dev_root, sysfs_root, _ = MockDeviceLib("h100-8").materialize(tmp_path)
    kernel = FakeVfioKernel(sysfs_root, dev_root)
    mgr = VfioPciManager(sysfs_root, dev_root, kernel=kernel)
    return dev_root, sysfs_root, mgr


class TestVfioPciManager:
    def test_detection(self, tree):
        _, _, mgr = tree
        assert mgr.iommu_enabled()
        assert not mgr.iommufd_enabled()  # no /dev/iommu in the base tree
        assert mgr.module_loaded()
        assert mgr.current_driver(BDF0) == "nvidia"
        assert mgr.iommu_group(BDF0) == 0

    def test_configure_binds_and_returns_original(self, tree):
        dev_root, _, mgr = tree
        assert mgr.configure(BDF0) == "nvidia"
        assert mgr.current_driver(BDF0) == "vfio-pci"
        assert pathlib.Path(dev_root, "vfio", "0").exists()
        # Idempotent: already vfio-bound → nothing to restore.
        assert mgr.configure(BDF0) == ""

    def test_unconfigure_restores(self, tree):
        dev_root, _, mgr = tree
        original = mgr.configure(BDF0)
        mgr.unconfigure(BDF0, original)
        assert mgr.current_driver(BDF0) == "nvidia"
        assert not pathlib.Path(dev_root, "vfio", "0").exists()
        # original="" = not bound by us → untouched.
        mgr.configure(BDF0)
        mgr.unconfigure(BDF0, "")
        assert mgr.current_driver(BDF0) == "vfio-pci"

    def test_no_iommu_refuses(self, tmp_path):
        mgr = VfioPciManager(str(tmp_path / "sys"), str(tmp_path / "dev"))
        with pytest.raises(VfioError, match="IOMMU"):
            mgr.configure(BDF0)

    def test_iommu_api_node_selection(self, tree):
        dev_root, _, mgr = tree
        assert mgr.iommu_api_node(prefer_iommufd=False) == "/dev/vfio/vfio"
        # Preferred but unsupported → legacy fallback (vfio-cdi.go:68-77).
        assert mgr.iommu_api_node(prefer_iommufd=True) == "/dev/vfio/vfio"
        pathlib.Path(dev_root, "iommu").write_text("")
        assert mgr.iommu_api_node(prefer_iommufd=True) == "/dev/iommu"


def _vfio_cluster(tmp_path, gates=None, lib=None):
    """One node whose device library walks the materialized tree, with the
    kernel emulation wired into the driver's VFIO manager."""
    dev_root, sysfs_root, proc_root = MockDeviceLib("h100-8").materialize(
        tmp_path / "tree")
    kernel = FakeVfioKernel(sysfs_root, dev_root)
    mgr = VfioPciManager(sysfs_root, dev_root, kernel=kernel)
    lib = lib or SysfsDeviceLib(dev_root=dev_root, sysfs_root=sysfs_root,
                                proc_root=proc_root, env={})
    client = FakeClient()
    for name, expr in P.DEVICE_CLASS_SELECTORS.items():
        client.create(new_object("DeviceClass", name, spec={"selectors": [
            {"cel": {"expression": expr}}]}))
    driver = GpuDriver(client, DriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "state"),
        cdi_root=str(tmp_path / "cdi"),
        feature_gates=gates or new_feature_gates(BOTH), env={},
        retry_timeout=0.5), device_lib=lib)
    driver.state._vfio = mgr      # inject the kernel-emulating manager
    driver.start()
    return client, driver, mgr


def _vfio_claim(client, name, device_class=P.DEVICE_CLASS_GPU, iommu="",
                selectors=()):
    exactly = {"deviceClassName": device_class,
               "allocationMode": "ExactCount", "count": 1}
    if selectors:
        exactly["selectors"] = [{"cel": {"expression": s}} for s in selectors]
    params = {"apiVersion": API_VERSION, "kind": "VfioDeviceConfig"}
    if iommu:
        params["iommu"] = iommu
    spec = {"devices": {
        "requests": [{"name": "gpu", "exactly": exactly}],
        "config": [{"requests": ["gpu"],
                    "opaque": {"driver": DRIVER_NAME, "parameters": params}}],
    }}
    return client.create(new_object(
        "ResourceClaim", name, "default",
        api_version="resource.k8s.io/v1", spec=spec))


def _prepare(client, driver, name):
    claim = Allocator(client).allocate(
        client.get("ResourceClaim", name, "default"))
    results = driver.prepare_resource_claims([claim])
    return claim, results[claim["metadata"]["uid"]]


def _env(edits):
    return dict(e.split("=", 1) for e in edits.get("env", []))


def _release_from_nvidia(driver, bdf):
    """What the NVIDIA driver does when a GPU leaves it: its procfs entry
    goes (the JAX tests remove the chip's accel entry likewise)."""
    shutil.rmtree(pathlib.Path(driver.device_lib.proc_root, "driver",
                               "nvidia", "gpus", bdf))


def _devices(client):
    return client.list("ResourceSlice")[0]["spec"]["devices"]


def _vfio_devices(client):
    return [d for d in _devices(client)
            if d["attributes"].get("type") == {"string": "vfio-gpu"}]


class TestVfioPrepare:
    def test_end_to_end_bind_cdi_unbind(self, tmp_path):
        client, driver, mgr = _vfio_cluster(tmp_path)
        claim, result = _prepare(client, driver, _vfio_claim(
            client, "vm")["metadata"]["name"])
        assert result.error is None, result.error
        uid = claim["metadata"]["uid"]
        spec = driver.cdi.read_claim_spec(uid)
        nodes = [n["path"] for n in
                 spec["devices"][0]["containerEdits"]["deviceNodes"]]
        assert any(n.startswith("/dev/vfio/") and n != "/dev/vfio/vfio"
                   for n in nodes)
        assert not any(n.startswith("/dev/nvidia") for n in nodes)
        # The legacy IOMMU API node is claim-wide, exactly once
        # (vfio-cdi.go:52).
        claim_nodes = [n["path"] for n in
                       spec["containerEdits"]["deviceNodes"]]
        assert claim_nodes == ["/dev/vfio/vfio"]
        assert "/dev/vfio/vfio" not in nodes
        assert _env(spec["devices"][0]["containerEdits"])[
            "GPU_PASSTHROUGH"] == "1"
        claim_env = _env(spec["containerEdits"])
        # Passthrough claims get PCI addresses, not GPU visibility — but
        # always an EXPLICIT sentinel, never an absent variable that
        # unset-means-all runtimes would read as "every host GPU"
        # (vfio-cdi.go:55-58).
        assert claim_env["CUDA_VISIBLE_DEVICES"] == "void"
        assert claim_env["NVIDIA_VISIBLE_DEVICES"] == "void"
        bdf = claim_env["GPU_PASSTHROUGH_PCI_ADDRESSES"]
        assert mgr.current_driver(bdf) == "vfio-pci"
        # Restore ledger checkpointed for crash recovery.
        pc = driver.state.prepared_claims()[uid]
        assert pc.vfio_restore == {bdf: "nvidia"}

        # Unprepare restores the original driver and clears state.
        errs = driver.unprepare_resource_claims(
            [ClaimRef(uid=uid, name="vm", namespace="default")])
        assert errs[uid] is None
        assert mgr.current_driver(bdf) == "nvidia"
        assert driver.cdi.read_claim_spec(uid) is None
        assert uid not in driver.state.prepared_claims()

    def test_gate_off_refuses(self, tmp_path):
        client, driver, _ = _vfio_cluster(
            tmp_path, gates=new_feature_gates(f"{DYNAMIC_MIG}=true"))
        _vfio_claim(client, "vm")
        _, result = _prepare(client, driver, "vm")
        assert result.error is not None
        assert PASSTHROUGH_SUPPORT in str(result.error)

    def test_iommufd_preference(self, tmp_path):
        client, driver, mgr = _vfio_cluster(tmp_path)
        pathlib.Path(mgr.dev, "iommu").write_text("")  # host has iommufd
        claim, result = _prepare(client, driver, _vfio_claim(
            client, "vm", iommu="iommufd")["metadata"]["name"])
        assert result.error is None, result.error
        spec = driver.cdi.read_claim_spec(claim["metadata"]["uid"])
        claim_nodes = [n["path"] for n in
                       spec["containerEdits"]["deviceNodes"]]
        assert claim_nodes == ["/dev/iommu"]
        # iommufd mode injects the per-device iommufd cdev, NOT the legacy
        # group cdev (vfio-cdi.go:96-106).
        dev_nodes = [n["path"] for n in
                     spec["devices"][0]["containerEdits"]["deviceNodes"]]
        assert any(n.startswith("/dev/vfio/devices/vfio")
                   for n in dev_nodes), dev_nodes
        assert not any(n.startswith("/dev/vfio/") and
                       not n.startswith("/dev/vfio/devices/")
                       for n in dev_nodes), dev_nodes
        uid = claim["metadata"]["uid"]
        errs = driver.unprepare_resource_claims(
            [ClaimRef(uid=uid, name="vm", namespace="default")])
        assert errs[uid] is None

    def test_iommufd_cdev_missing_is_retryable(self, tmp_path):
        """A kernel without VFIO_DEVICE_CDEV: the bind lands but no
        vfio-dev/ entry appears → prepare fails retryably, never hands out
        a node the VMM cannot use."""
        client, driver, mgr = _vfio_cluster(tmp_path)
        pathlib.Path(mgr.dev, "iommu").write_text("")
        orig_probe = mgr.kernel._probe

        def probe_no_cdev(bdf):
            orig_probe(bdf)
            for d in pathlib.Path(mgr.sysfs, "bus", "pci",
                                  "devices").iterdir():
                vd = d.resolve() / "vfio-dev"
                if vd.is_dir():
                    for e in vd.iterdir():
                        e.rmdir()
                    vd.rmdir()
        mgr.kernel._probe = probe_no_cdev
        _, result = _prepare(client, driver, _vfio_claim(
            client, "vm", iommu="iommufd")["metadata"]["name"])
        assert result.error is not None
        assert "cdev" in str(result.error)

    def test_mig_device_with_vfio_config_refused(self, tmp_path):
        """A MIG device cannot be passed through (a VM gets whole PCI
        functions): the config/device type mismatch is refused before any
        instance is created or function bound."""
        lib = MockDeviceLib("h100-8", mig=True)
        client, driver, mgr = _vfio_cluster(tmp_path, lib=lib)
        _vfio_claim(client, "sub", device_class=P.DEVICE_CLASS_MIG,
                    selectors=["device.attributes['profile'] == '1g.10gb'"])
        _, result = _prepare(client, driver, "sub")
        assert result.error is not None
        assert "cannot target device gpu-0-mig-" in str(result.error)
        assert lib.mig_devices() == []
        assert mgr.current_driver(BDF0) == "nvidia"

    def test_crash_rollback_restores_driver(self, tmp_path, monkeypatch):
        """Die between bind and CDI write → PrepareStarted with a restore
        ledger; the retry rolls the bind back before re-preparing."""
        client, driver, mgr = _vfio_cluster(tmp_path)
        allocated = Allocator(client).allocate(_vfio_claim(client, "vm"))
        uid = allocated["metadata"]["uid"]
        monkeypatch.setattr(
            driver.cdi, "create_claim_spec_file",
            lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("boom")))
        results = driver.prepare_resource_claims([allocated])
        assert results[uid].error is not None
        pc = driver.state.prepared_claims()[uid]
        assert pc.state == STATE_PREPARE_STARTED
        bdf = next(iter(pc.vfio_restore))
        assert pc.vfio_restore[bdf] == "nvidia"
        assert mgr.current_driver(bdf) == "vfio-pci"  # bind leaked by crash

        monkeypatch.undo()
        results = driver.prepare_resource_claims([allocated])
        assert results[uid].error is None
        pc = driver.state.prepared_claims()[uid]
        assert pc.vfio_restore == {bdf: "nvidia"}
        assert mgr.current_driver(bdf) == "vfio-pci"
        driver.unprepare_resource_claims(
            [ClaimRef(uid=uid, name="vm", namespace="default")])
        assert mgr.current_driver(bdf) == "nvidia"

    def test_ledger_written_before_the_bind(self, tmp_path, monkeypatch):
        """The restore record is durable before the function is rebound:
        a bind that fails leaves the record (a harmless no-op restore),
        never a bound function without one."""
        client, driver, mgr = _vfio_cluster(tmp_path)
        allocated = Allocator(client).allocate(_vfio_claim(client, "vm"))
        uid = allocated["metadata"]["uid"]
        seen = []

        def configure(bdf):
            seen.append(dict(driver.state.prepared_claims()[uid]
                             .vfio_restore))
            raise VfioError("bind refused")
        monkeypatch.setattr(mgr, "configure", configure)
        assert driver.prepare_resource_claims([allocated])[uid].error
        assert seen and all(s == {BDF0: "nvidia"} for s in seen)


class TestVfioOverlapAndRepublish:
    def test_claim_bound_gpu_not_republished(self, tmp_path):
        """A GPU the plugin vfio-binds for claim A must not resurface as a
        fresh allocatable passthrough device on republish (it would hand
        claim B the same /dev/vfio group)."""
        client, driver, _ = _vfio_cluster(tmp_path)
        _vfio_claim(client, "vm")
        claim, result = _prepare(client, driver, "vm")
        assert result.error is None, result.error
        driver.republish()  # health-monitor path: re-scan + republish
        assert _vfio_devices(client) == []
        # After unprepare + republish the GPU is back as a regular device.
        uid = claim["metadata"]["uid"]
        driver.unprepare_resource_claims(
            [ClaimRef(uid=uid, name="vm", namespace="default")])
        driver.republish()
        assert _vfio_devices(client) == []
        assert any(d["name"] == "gpu-0" for d in _devices(client))

    def test_vfio_scan_index_does_not_alias_a_gpu(self, tmp_path):
        """An admin pre-binds gpu-7's function; its positional vfio-scan
        index (0) must not collide with the real GPU 0 in the overlap check
        — the PCI address is a passthrough device's identity."""
        client, driver, mgr = _vfio_cluster(tmp_path)
        mgr.configure(BDF7)
        _release_from_nvidia(driver, BDF7)
        driver.republish()
        (vfio_dev,) = _vfio_devices(client)
        assert vfio_dev["name"] == "vfio-gpu-0"
        assert vfio_dev["attributes"]["pciAddress"] == {"string": BDF7}

        # Claim A: the whole GPU 0. Claim B: the passthrough device.
        client.create(new_object(
            "ResourceClaim", "a", "default",
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{"name": "gpu", "exactly": {
                "deviceClassName": P.DEVICE_CLASS_GPU,
                "allocationMode": "ExactCount", "count": 1,
                "selectors": [{"cel": {"expression":
                    "device.attributes['index'] == 0"}}]}}]}}))
        _, res_a = _prepare(client, driver, "a")
        assert res_a.error is None, res_a.error
        client.create(new_object(
            "ResourceClaim", "b", "default",
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{"name": "gpu", "exactly": {
                "deviceClassName": P.DEVICE_CLASS_VFIO,
                "allocationMode": "ExactCount", "count": 1}}]}}))
        _, res_b = _prepare(client, driver, "b")
        # Different physical GPUs → both prepares succeed.
        assert res_b.error is None, res_b.error


class TestPublishedVfioDevices:
    def test_prebound_gpu_published_and_prepared(self, tmp_path):
        """An admin pre-binds a GPU to vfio-pci → it leaves the NVIDIA
        driver and surfaces as a vfio-gpu device; preparing it writes CDI
        without rebinding, and unprepare leaves the admin's bind."""
        client, driver, mgr = _vfio_cluster(tmp_path)
        mgr.configure(BDF7)  # admin action
        _release_from_nvidia(driver, BDF7)
        driver.republish()
        vfio_devs = _vfio_devices(client)
        assert len(vfio_devs) == 1
        name = vfio_devs[0]["name"]
        assert vfio_devs[0]["attributes"]["pciAddress"] == {"string": BDF7}
        assert [d["name"] for d in _devices(client)
                if d["name"].startswith("gpu-")] == [f"gpu-{i}"
                                                     for i in range(7)]

        client.create(new_object(
            "ResourceClaim", "vm2", "default",
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{"name": "gpu", "exactly": {
                "deviceClassName": P.DEVICE_CLASS_VFIO,
                "allocationMode": "ExactCount", "count": 1}}]}}))
        claim, result = _prepare(client, driver, "vm2")
        assert result.error is None, result.error
        assert result.devices[0].device == name
        uid = claim["metadata"]["uid"]
        pc = driver.state.prepared_claims()[uid]
        assert pc.vfio_restore == {BDF7: ""}  # not ours to unbind
        driver.unprepare_resource_claims(
            [ClaimRef(uid=uid, name="vm2", namespace="default")])
        assert mgr.current_driver(BDF7) == "vfio-pci"  # admin bind intact

    def test_gate_off_publishes_no_passthrough_device(self, tmp_path):
        client, driver, mgr = _vfio_cluster(
            tmp_path, gates=new_feature_gates(f"{DYNAMIC_MIG}=true"))
        mgr.configure(BDF7)
        _release_from_nvidia(driver, BDF7)
        driver.republish()
        assert _vfio_devices(client) == []
        assert driver.state.vfio_gpus == []
