"""The port's feature-gate wiring, held to ``tests/test_featuregate_wiring.py``:
the strict-fabric gate (``CrashOnNVLinkFabricErrors``, the JAX package's
``CrashOnICIFabricErrors``) through the GPU and ComputeDomain kubelet
plugins, and the DeviceMetadata gate (KEP-5304) with its dependency on
PassthroughSupport, checked when every binary parses ``--feature-gates``
and when each plugin driver is built. A node's GPUs "disagree" here as
the port's fabric check sees it: two of them share a device minor."""

import argparse
import pathlib
import time

import pytest

from k8s_dra_driver_tpu.pkg import featuregates as jax_fg
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin.prepared import (
    PreparedDevice as JaxPreparedDevice,
)
from k8s_dra_driver_tpu_torch.gpulib import MockDeviceLib
from k8s_dra_driver_tpu_torch.gpulib.device_lib import (
    EnumerationError,
    fabric_consistency_problems,
)
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    CRASH_ON_NVLINK_FABRIC_ERRORS,
    DEVICE_METADATA,
    DYNAMIC_MIG,
    PASSTHROUGH_SUPPORT,
    new_feature_gates,
    validate_gate_dependencies,
)
from k8s_dra_driver_tpu_torch.pkg.flags import parse_feature_gates
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.driver import (
    CdDriver,
    CdDriverConfig,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    partitions as P,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    DRIVER_NAME,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.prepared import (
    PreparedDevice,
)
from tests.test_torch_vfio import BDF0, _prepare, _vfio_claim, _vfio_cluster

METADATA_ON = f"{PASSTHROUGH_SUPPORT}=true,{DEVICE_METADATA}=true"


def _driver(tmp_path, client, gates, lib=None):
    return GpuDriver(client, DriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "state"),
        cdi_root=str(tmp_path / "cdi"),
        feature_gates=gates, env={}, retry_timeout=0.5,
    ), device_lib=lib or MockDeviceLib("h100-8"))


def _cd_driver(tmp_path, client, gates, lib=None):
    return CdDriver(client, CdDriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "cd"),
        cdi_root=str(tmp_path / "cdi"), feature_gates=gates, env={}),
        device_lib=lib or MockDeviceLib("h100-8"))


class _BrokenFabricLib(MockDeviceLib):
    """An ``h100-8`` node whose GPU 1 reports GPU 0's device minor (a
    node the driver cannot tell apart)."""

    def enumerate_gpus(self):
        gpus = super().enumerate_gpus()
        gpus[1].minor = gpus[0].minor
        return gpus


class TestCrashOnNVLinkFabricErrors:
    def test_problems_detected(self):
        problems = fabric_consistency_problems(
            _BrokenFabricLib("h100-8").enumerate_gpus())
        assert problems and "share minor 0" in problems[0]

    def test_strict_refuses_to_serve(self, tmp_path):
        with pytest.raises(EnumerationError, match="strict mode"):
            _driver(tmp_path, FakeClient(),
                    new_feature_gates(f"{CRASH_ON_NVLINK_FABRIC_ERRORS}=true"),
                    lib=_BrokenFabricLib("h100-8"))

    def test_lenient_serves(self, tmp_path):
        client = FakeClient()
        _driver(tmp_path, client, new_feature_gates(),
                lib=_BrokenFabricLib("h100-8")).start()
        (s,) = client.list("ResourceSlice")
        assert len(s["spec"]["devices"]) == 8

    def test_cd_plugin_strict(self, tmp_path):
        client = FakeClient()
        cd = _cd_driver(tmp_path, client, new_feature_gates(
            f"{CRASH_ON_NVLINK_FABRIC_ERRORS}=true"),
            lib=_BrokenFabricLib("h100-8"))
        with pytest.raises(EnumerationError, match="strict mode"):
            cd.start()
        assert client.list("ResourceSlice") == []

    def test_consistent_node_serves_strict(self, tmp_path):
        client = FakeClient()
        _driver(tmp_path, client, new_feature_gates(
            f"{CRASH_ON_NVLINK_FABRIC_ERRORS}=true")).start()
        assert len(client.list("ResourceSlice")[0]["spec"]["devices"]) == 8


def _jax_vfio_metadata(tmp_path):
    """The JAX package's prepared VFIO device metadata on its own tree."""
    from tests.test_vfio import _prepare as jax_prepare
    from tests.test_vfio import _vfio_claim as jax_claim
    from tests.test_vfio import _vfio_cluster as jax_cluster
    client, driver, _ = jax_cluster(tmp_path, gates=jax_fg.new_feature_gates(
        f"{jax_fg.PASSTHROUGH_SUPPORT}=true,{jax_fg.DEVICE_METADATA}=true"))
    jax_claim(client, "vm")
    _, result = jax_prepare(client, driver, "vm")
    assert result.error is None, result.error
    return result.devices[0].metadata


class TestDeviceMetadata:
    def test_requires_passthrough(self, tmp_path):
        with pytest.raises(ValueError, match=PASSTHROUGH_SUPPORT):
            _driver(tmp_path, FakeClient(),
                    new_feature_gates(f"{DEVICE_METADATA}=true"))

    def test_cd_plugin_requires_passthrough(self, tmp_path):
        with pytest.raises(ValueError, match=PASSTHROUGH_SUPPORT):
            _cd_driver(tmp_path, FakeClient(),
                       new_feature_gates(f"{DEVICE_METADATA}=true"))

    def test_validate_helper(self):
        validate_gate_dependencies(new_feature_gates())  # defaults fine
        validate_gate_dependencies(new_feature_gates(METADATA_ON))

    def _vfio_prepare(self, tmp_path, gates):
        client, driver, _ = _vfio_cluster(tmp_path, gates=gates)
        _vfio_claim(client, "vm", selectors=[
            "device.attributes['index'] == 0"])
        claim, result = _prepare(client, driver, "vm")
        assert result.error is None, result.error
        return driver, claim, result

    def test_metadata_on_prepared_vfio_device(self, tmp_path):
        driver, claim, result = self._vfio_prepare(
            tmp_path, new_feature_gates(METADATA_ON))
        md = result.devices[0].metadata
        assert md["attributes"]["pciAddress"] == BDF0
        group = (pathlib.Path(driver.device_lib.sysfs_root) / "bus" / "pci"
                 / "devices" / BDF0 / "iommu_group").resolve().name
        assert md["attributes"]["iommuGroup"] == group
        # The checkpoint's idempotent replay returns the same metadata.
        again = driver.prepare_resource_claims([claim])[
            claim["metadata"]["uid"]]
        assert again.devices[0].metadata == md

    def test_no_metadata_when_gate_off(self, tmp_path):
        _, _, result = self._vfio_prepare(
            tmp_path, new_feature_gates(f"{PASSTHROUGH_SUPPORT}=true"))
        assert result.devices[0].metadata == {}

    def test_whole_gpu_carries_none(self, tmp_path):
        """Only a passthrough device has metadata, as in the JAX package
        (the reference's device_state.go:977-987)."""
        client, driver, _ = _vfio_cluster(
            tmp_path, gates=new_feature_gates(METADATA_ON))
        client.create(new_object(
            "ResourceClaim", "plain", "default",
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{"name": "gpu", "exactly": {
                "deviceClassName": P.DEVICE_CLASS_GPU,
                "allocationMode": "ExactCount", "count": 1}}]}}))
        _, result = _prepare(client, driver, "plain")
        assert result.error is None and result.devices[0].metadata == {}

    def test_the_jax_form_for_the_same_record(self, tmp_path):
        """The port's metadata has the JAX package's keys, and the JAX
        package's ``to_ref`` on the port's checkpoint record of the same
        tree gives the port's metadata."""
        driver, claim, result = self._vfio_prepare(
            tmp_path / "port", new_feature_gates(METADATA_ON))
        md = result.devices[0].metadata
        assert set(md["attributes"]) == set(
            _jax_vfio_metadata(tmp_path / "jax")["attributes"])
        (record,) = driver.state.prepared_claims()[
            claim["metadata"]["uid"]].prepared_devices
        port_ref = PreparedDevice.from_dict(record).to_ref(
            "k8s.gpu.nvidia.com/claim=x", with_metadata=True)
        jax_ref = JaxPreparedDevice.from_dict(record).to_ref(
            "k8s.gpu.nvidia.com/claim=x", with_metadata=True)
        assert port_ref.metadata == jax_ref.metadata == md
        assert (PreparedDevice.from_dict(record).to_ref("x").metadata
                == JaxPreparedDevice.from_dict(record).to_ref("x").metadata
                == {})

    @pytest.mark.parametrize("gates", [METADATA_ON,
                                       f"{PASSTHROUGH_SUPPORT}=true"])
    def test_metadata_on_the_claim_status(self, tmp_path, gates):
        """The claim watcher carries a prepared device's metadata to the
        claim's status, and a device without it carries none."""
        client, driver, _ = _vfio_cluster(
            tmp_path, gates=new_feature_gates(gates))
        loop = NodePrepareLoop(client, driver, DRIVER_NAME, "node-a",
                               namespace="default").start()
        try:
            _vfio_claim(client, "vm", selectors=[
                "device.attributes['index'] == 0"])
            Allocator(client).allocate(
                client.get("ResourceClaim", "vm", "default"),
                reserved_for=[{"resource": "pods", "name": "vm-pod"}],
                node="node-a")
            deadline = time.monotonic() + 10
            while not (client.get("ResourceClaim", "vm", "default")
                       .get("status") or {}).get("devices"):
                assert time.monotonic() < deadline, "claim never Ready"
                time.sleep(0.01)
            (dev,) = client.get("ResourceClaim", "vm",
                                "default")["status"]["devices"]
            if DEVICE_METADATA in gates:
                assert dev["metadata"]["attributes"]["pciAddress"] == BDF0
                assert set(dev["metadata"]["attributes"]) == {
                    "pciAddress", "iommuGroup", "iommu"}
            else:
                assert "metadata" not in dev
        finally:
            loop.stop()
            claim = client.get("ResourceClaim", "vm", "default")
            driver.unprepare_resource_claims([ClaimRef.from_claim(claim)])
            driver.stop()

    def test_parse_feature_gates_exits_on_the_bad_combination(self):
        with pytest.raises(SystemExit, match="invalid --feature-gates: "
                           f".*{DEVICE_METADATA}.*{PASSTHROUGH_SUPPORT}"):
            parse_feature_gates(argparse.Namespace(
                feature_gates=f"{DEVICE_METADATA}=true"))
        gates = parse_feature_gates(argparse.Namespace(
            feature_gates=METADATA_ON))
        assert gates.enabled(DEVICE_METADATA)


#: The port's gate names as the JAX package spells them.
_JAX_NAMES = {DYNAMIC_MIG: jax_fg.DYNAMIC_SUBSLICE,
              CRASH_ON_NVLINK_FABRIC_ERRORS: jax_fg.CRASH_ON_ICI_FABRIC_ERRORS,
              DEVICE_METADATA: jax_fg.DEVICE_METADATA,
              PASSTHROUGH_SUPPORT: jax_fg.PASSTHROUGH_SUPPORT}


def _verdict(validate, gates):
    try:
        validate(gates)
    except ValueError as e:
        return str(e)
    return "ok"


@pytest.mark.parametrize("metadata", [None, False, True])
@pytest.mark.parametrize("passthrough", [None, False, True])
@pytest.mark.parametrize("other", [{}, {DYNAMIC_MIG: True},
                                   {CRASH_ON_NVLINK_FABRIC_ERRORS: True}])
def test_dependency_verdicts_match_jax(metadata, passthrough, other):
    values = dict(other)
    if metadata is not None:
        values[DEVICE_METADATA] = metadata
    if passthrough is not None:
        values[PASSTHROUGH_SUPPORT] = passthrough
    port = _verdict(validate_gate_dependencies,
                    new_feature_gates(values=values))
    jax = _verdict(jax_fg.validate_gate_dependencies,
                   jax_fg.new_feature_gates(values={
                       _JAX_NAMES[k]: v for k, v in values.items()}))
    assert port == jax
    assert (port == "ok") == (not metadata or bool(passthrough))


def test_the_smokes_gates_phase_on_mock_nodes(tmp_path, monkeypatch,
                                             capsys):
    """``chip_smoke.phase_gates`` as the card runs it, with a one-GPU mock
    profile file in place of NVML and a small CPU engine: both binaries
    refuse DeviceMetadata without PassthroughSupport, the strict plugin
    refuses the broken-fabric node and the lenient one publishes it, the
    VFIO claim's status carries the tree's metadata only with the gate on;
    the strict plugin process publishes the GPU, its whole-GPU claim is
    Ready without metadata and serves the batch, and nothing is left."""
    import json

    import chip_smoke
    from k8s_dra_driver_tpu_torch.compute import _build
    from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl
    from tests.test_torch_crashlab import SMALL_CHECK_WIDTH

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    profile = dl._h100_8_profile(0)
    profile["gpus"] = profile["gpus"][:1]
    path = tmp_path / "one-gpu.json"
    path.write_text(json.dumps(profile))
    gpu = dl.MockDeviceLib(profile).enumerate_gpus()[0]
    out = chip_smoke.phase_gates(
        "mock", 0, gpu, width={**SMALL_CHECK_WIDTH, "uuids": {gpu.uuid: 0}},
        profile=str(path))
    host = out["host"]
    assert all(host[k] < chip_smoke.GATES_EXIT_S * 1e3 for k in (
        "bad_gpu_exit_ms", "bad_cd_exit_ms", "strict_exit_ms"))
    assert host["lenient_published"] and host["children"] == []
    attrs = host["vfio_metadata"]["attributes"]
    assert set(attrs) == {"pciAddress", "iommuGroup", "iommu"}
    assert host["vfio_without"] is None
    assert out["launches"] == 0 and out["decode_steps"] > 0  # plain on CPU
    assert out["residue"] == [] and out["children"] == []
    text = capsys.readouterr().out
    assert text.count("[gates] leg=host") == 1
    assert text.count("[gates] leg=card") == 1
