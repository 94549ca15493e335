"""The GPU plugin's per-claim record of its Prepare/Unprepare requests, and
the smoke's check that reads it (``chip_smoke.prepare_record``).

``gpu_dra_requests_total`` counts requests, not claims: the claim watcher
republishes a claim whose Ready entry a racing whole-status writer dropped
through one more (idempotent) prepare, in the port as in the JAX package.
The processes phase therefore checks, per claim and from the plugin's log,
that every claim prepared was unprepared and that each repeated request is
explained by a logged republish or retry."""
from __future__ import annotations

import logging
import time

import pytest

import chip_smoke
from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxFakeClient
from k8s_dra_driver_tpu.k8sclient.client import new_object as jax_new_object
from k8s_dra_driver_tpu.kubeletplugin import Allocator as JaxAllocator
from k8s_dra_driver_tpu.kubeletplugin.claimwatcher import (
    NodePrepareLoop as JaxNodePrepareLoop,
)
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import TpuDriver
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import (
    DriverConfig as JaxDriverConfig,
)
from k8s_dra_driver_tpu.tpulib.device_lib import (
    MockDeviceLib as JaxMockDeviceLib,
)
from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)

GPU, TPU = "gpu.nvidia.com", "tpu.google.com"


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.01)


def _port_stack(tmp_path):
    client = FakeClient()
    client.create(new_object("DeviceClass", GPU, spec={"selectors": [{
        "cel": {"expression": "device.attributes['type'] == 'gpu'"}}]}))
    driver = GpuDriver(client, DriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "ps"),
        cdi_root=str(tmp_path / "pc"), env={}, retry_timeout=0.3),
        device_lib=MockDeviceLib("h100-8")).start()
    loop = NodePrepareLoop(client, driver, GPU, "node-a",
                           retry_delay=0.2).start()
    return client, new_object, Allocator(client), driver, loop, GPU


def _jax_stack(tmp_path):
    client = JaxFakeClient()
    client.create(jax_new_object("DeviceClass", TPU, spec={"selectors": [{
        "cel": {"expression": "device.attributes['type'] == 'tpu'"}}]}))
    driver = TpuDriver(client, JaxDriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "js"),
        cdi_root=str(tmp_path / "jc"), env={}, retry_timeout=0.3),
        device_lib=JaxMockDeviceLib("v5e-8")).start()
    loop = JaxNodePrepareLoop(client, driver, TPU, "node-a",
                              retry_delay=0.2).start()
    return client, jax_new_object, JaxAllocator(client), driver, loop, TPU


def _clobbered_claim(stack, tmp_path):
    """A claim prepared and published; a whole-status writer then drops its
    Ready entry (as a racing allocator or release write does); the claim
    is unreserved and deleted. Returns the request counters, the claim's
    UID and whether the Ready entry came back."""
    client, mk, allocator, driver, loop, name = stack(tmp_path)
    try:
        claim = client.create(mk(
            "ResourceClaim", "c", "default", api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{"name": "r", "exactly": {
                "deviceClassName": name, "allocationMode": "ExactCount",
                "count": 1}}]}}))
        uid = claim["metadata"]["uid"]
        allocator.allocate(claim, reserved_for=[
            {"resource": "pods", "name": "p", "uid": "p1"}], node="node-a")

        def ready():
            st = client.get("ResourceClaim", "c", "default")["status"]
            return any(d.get("driver") == name
                       for d in st.get("devices") or [])

        _until(ready)
        c = client.get("ResourceClaim", "c", "default")
        c["status"].pop("devices")
        client.update_status(c)
        _until(ready)
        republished = ready()
        c = client.get("ResourceClaim", "c", "default")
        c["status"].pop("reservedFor")
        client.update_status(c)
        _until(lambda: not ready())
        client.delete("ResourceClaim", "c", "default")
        counts = {op: driver.metrics.requests_total.value(
            driver=name, operation=op) for op in ("prepare", "unprepare")}
        return counts, uid, republished
    finally:
        loop.stop()
        driver.stop()


class TestRepublishAgainstJax:
    def test_both_watchers_republish_through_one_more_prepare(
            self, tmp_path, caplog):
        """On the same events both packages make the same requests: two
        prepares (the first, then the republish) and one unprepare for one
        claim, so prepares == unprepares does not hold for either."""
        with caplog.at_level(logging.INFO):
            port, uid, port_back = _clobbered_claim(_port_stack, tmp_path)
        jax, _, jax_back = _clobbered_claim(_jax_stack, tmp_path)
        assert port == jax == {"prepare": 2.0, "unprepare": 1.0}
        assert port_back and jax_back
        log = "\n".join(f" {r.getMessage()}" for r in caplog.records)
        record = chip_smoke.prepare_record(log)
        assert record["requests"] == [("prepare", [(uid, "ok")]),
                                      ("prepare", [(uid, "ok")]),
                                      ("unprepare", [(uid, "ok")])]
        assert record["repeats"]["prepare"][uid] == 1
        assert chip_smoke.prepare_record_problems(record, port) == []


def _log(*lines):
    return "\n".join(f"gpu-kubelet-plugin 2026 x INFO {ln}" for ln in lines)


class TestRecordCheck:
    def test_clean_record_with_a_traced_claim(self):
        log = _log("prepare request: a=ok trace=0af7651916cd43dd8448eb211c80319c",
                   "prepare request: b=ok",
                   "unprepare request: b=ok",
                   "unprepare request: a=ok trace=0af7651916cd43dd8448eb211c80319c")
        record = chip_smoke.prepare_record(log)
        assert record["requests"][0] == ("prepare", [("a", "ok")])
        assert chip_smoke.prepare_record_problems(
            record, {"prepare": 2, "unprepare": 2}) == []

    @pytest.mark.parametrize("lines,counted,problem", [
        (("prepare request: a=ok",), (1, 0), "a prepared and never"),
        (("prepare request: a=ok", "unprepare request: a=failed"), (1, 1),
         "a prepared and never"),
        (("unprepare request: a=ok", "prepare request: a=ok"), (1, 1),
         "unprepare of a before any prepare"),
        (("prepare request: a=ok", "prepare request: a=ok",
          "unprepare request: a=ok"), (2, 1),
         "2 prepare requests for a, 0 logged"),
        (("prepare request: a=ok", "unprepare request: a=ok",
          "unprepare request: a=ok"), (1, 2),
         "2 unprepare requests for a, 0 logged"),
        (("prepare request: a=ok", "unprepare request: a=ok"), (2, 1),
         "2 prepare requests counted, 1 logged"),
    ])
    def test_each_fault_is_named(self, lines, counted, problem):
        problems = chip_smoke.prepare_record_problems(
            chip_smoke.prepare_record(_log(*lines)),
            dict(zip(("prepare", "unprepare"), counted)))
        assert any(problem in p for p in problems), problems

    @pytest.mark.parametrize("why", [
        "claim a prepared but its status entry is missing: republishing",
        "node prepare of claim a failed: boom",
        "status publish of claim a failed: retry armed",
    ])
    def test_a_repeated_prepare_is_matched_by_its_logged_cause(self, why):
        log = _log("prepare request: a=failed" if "node prepare" in why
                   else "prepare request: a=ok", why,
                   "prepare request: a=ok", "unprepare request: a=ok")
        assert chip_smoke.prepare_record_problems(
            chip_smoke.prepare_record(log),
            {"prepare": 2, "unprepare": 1}) == []

    def test_a_failed_unprepare_retried(self):
        log = _log("prepare request: a=ok", "unprepare request: a=failed",
                   "node unprepare of claim a failed: boom",
                   "unprepare request: a=ok")
        assert chip_smoke.prepare_record_problems(
            chip_smoke.prepare_record(log),
            {"prepare": 1, "unprepare": 2}) == []
