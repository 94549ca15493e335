"""A claim watcher that starts over a node whose checkpoint already holds
prepared claims (a restarted loop, or a restarted plugin process).

A claim released or deleted while no loop ran sends no event that the new
loop's in-memory record knows, so the loop adopts the checkpoint's
completed prepares at start: a released claim is unprepared on its next
event (the start's LIST, or a resumed watch's replay), a deleted one once a
lookup after the start finds it gone, and a claim still reserved stays
prepared and Ready."""
from __future__ import annotations

import time

import pytest

from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)

GPU = "gpu.nvidia.com"


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.01)


def _ready(client, name):
    c = client.try_get("ResourceClaim", name, "default") or {}
    return any(d.get("driver") == GPU
               for d in (c.get("status") or {}).get("devices") or [])


def _held(driver):
    return sorted(pc.name for pc in
                  driver.state.prepared_claims_nolock().values())


@pytest.fixture
def node(tmp_path):
    client = FakeClient()
    client.create(new_object("DeviceClass", GPU, spec={"selectors": [{
        "cel": {"expression": "device.attributes['type'] == 'gpu'"}}]}))
    driver = GpuDriver(client, DriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "s"),
        cdi_root=str(tmp_path / "c"), env={}, retry_timeout=0.3),
        device_lib=MockDeviceLib("h100-8")).start()
    loops = []

    def loop(**kw):
        lp = NodePrepareLoop(client, driver, GPU, "node-a",
                             namespace="default", retry_delay=0.2,
                             **kw).start()
        loops.append(lp)
        return lp

    def prepared_claim(name, count=2):
        claim = client.create(new_object(
            "ResourceClaim", name, "default", spec={"devices": {"requests": [{
                "name": "gpu", "exactly": {"deviceClassName": GPU,
                                           "allocationMode": "ExactCount",
                                           "count": count}}]}}))
        Allocator(client).allocate(
            claim, reserved_for=[{"resource": "pods", "name": f"pod-{name}"}],
            node="node-a")
        _until(lambda: _ready(client, name))
        return claim

    yield client, driver, loop, prepared_claim
    for lp in loops:
        lp.stop()
    driver.stop()


def _unreserve(client, name):
    c = client.get("ResourceClaim", name, "default")
    c["status"].pop("reservedFor", None)
    client.update_status(c)


@pytest.mark.parametrize("resume", [False, True],
                         ids=["relist", "resumed-watch"])
class TestRestartedLoop:
    def test_a_claim_released_while_down_is_unprepared(
            self, node, tmp_path, resume):
        client, driver, loop, prepared_claim = node
        kw = {"state_dir": str(tmp_path / "rv")} if resume else {}
        first = loop(**kw)
        prepared_claim("released")
        first.stop()
        _unreserve(client, "released")
        second = loop(**kw)
        assert second._informer.resumed_from_checkpoint is resume
        _until(lambda: not _held(driver))
        _until(lambda: not _ready(client, "released"))
        assert driver.cdi.list_claim_uids() == []

    def test_a_claim_deleted_while_down_is_unprepared(
            self, node, tmp_path, resume):
        client, driver, loop, prepared_claim = node
        kw = {"state_dir": str(tmp_path / "rv")} if resume else {}
        first = loop(**kw)
        prepared_claim("deleted")
        first.stop()
        client.delete("ResourceClaim", "deleted", "default")
        loop(**kw)
        _until(lambda: not _held(driver))
        assert driver.cdi.list_claim_uids() == []

    def test_a_claim_still_reserved_stays_prepared(
            self, node, tmp_path, resume):
        client, driver, loop, prepared_claim = node
        kw = {"state_dir": str(tmp_path / "rv")} if resume else {}
        first = loop(**kw)
        prepared_claim("kept")
        first.stop()
        loop(**kw)
        time.sleep(0.3)
        assert _held(driver) == ["kept"]
        assert _ready(client, "kept")
        # And the adopted claim unprepares on its release as usual.
        _unreserve(client, "kept")
        _until(lambda: not _held(driver))
        assert driver.cdi.list_claim_uids() == []


def test_the_released_claims_devices_go_to_the_next_claim(node):
    """The scale harness's fault: the next claim on the freed devices is
    prepared, not refused as overlapping the leaked one."""
    client, driver, loop, prepared_claim = node
    first = loop()
    prepared_claim("old", count=8)
    first.stop()
    _unreserve(client, "old")
    client.delete("ResourceClaim", "old", "default")
    loop()
    prepared_claim("new", count=8)
    assert _held(driver) == ["new"]


def test_other_namespaces_claims_are_not_adopted(node):
    client, driver, loop, prepared_claim = node
    first = loop()
    prepared_claim("mine")
    first.stop()
    other = NodePrepareLoop(client, driver, GPU, "node-a",
                            namespace="elsewhere").start()
    try:
        assert other._adopted == {}
        assert _held(driver) == ["mine"]
    finally:
        other.stop()
