"""Set-up through the port's claim path: a ResourceClaim for the card,
prepared by the port's GPU kubelet plugin, read back as a CDI spec.

A FakeClient with the ``gpu.nvidia.com`` DeviceClass and a node; the GPU
kubelet plugin (``GpuDriver``) on the device library that found the card
and the claim watcher (``NodePrepareLoop``); a claim that selects the card
by its UUID, allocated by the port's ``Allocator`` and reserved for a pod.
``claim_ready_ms`` is the host clock from the claim's create to its Ready
condition. ``close`` unreserves the claim, waits for the watcher to
unprepare it, deletes it and stops the plugin, and returns what was left.
"""

from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass
from typing import Optional

from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    DRIVER_NAME,
)

NODE = "node-0"
NAMESPACE = "default"


def _wait(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError(f"{what} within {timeout} s")
        time.sleep(0.001)


def claim_ready(client, name: str) -> bool:
    """Whether the claim's status carries the GPU driver's Ready entry."""
    c = client.try_get("ResourceClaim", name, NAMESPACE) or {}
    return any(d.get("driver") == DRIVER_NAME and any(
        k.get("type") == "Ready" and k.get("status") == "True"
        for k in d.get("conditions") or [])
        for d in (c.get("status") or {}).get("devices") or [])


@dataclass
class Claim:
    """A prepared claim and the plugin that prepared it."""
    name: str
    spec: dict
    claim_ready_ms: float
    client: FakeClient
    driver: GpuDriver
    loop: NodePrepareLoop
    tmp: tempfile.TemporaryDirectory

    def close(self) -> list:
        """Unreserve, unprepare and delete the claim, stop the plugin;
        returns the residue (claims, checkpoint entries, CDI specs and
        files), which is empty when nothing was left behind."""
        try:
            c = self.client.get("ResourceClaim", self.name, NAMESPACE)
            c["status"].pop("reservedFor", None)
            self.client.update_status(c)
            _wait(lambda: not any(
                d.get("driver") == DRIVER_NAME for d in (self.client.get(
                    "ResourceClaim", self.name, NAMESPACE).get("status")
                    or {}).get("devices") or []), "claim unprepared")
            self.client.delete("ResourceClaim", self.name, NAMESPACE)
        finally:
            self.loop.stop()
            self.driver.stop()
        residue = ([c["metadata"]["name"]
                    for c in self.client.list("ResourceClaim")]
                   + sorted(self.driver.state.prepared_claims_nolock())
                   + self.driver.cdi.list_claim_uids()
                   + sorted(p.name for p in self.driver.cdi.cdi_root.iterdir()))
        self.tmp.cleanup()
        return residue


def open_claim(device_lib, gpu_uuid: str, name: str = "bench-claim",
               tmp_dir: Optional[str] = None) -> Claim:
    """Start the plugin on ``device_lib``, claim the GPU ``gpu_uuid`` and
    wait for Ready; the plugin's state and CDI roots live in a temporary
    directory (under ``tmp_dir``, else the process's ``TMPDIR``)."""
    tmp = tempfile.TemporaryDirectory(prefix="perfbench-", dir=tmp_dir)
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", DRIVER_NAME, spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    client.create(new_object("Node", NODE))
    driver = GpuDriver(client, DriverConfig(
        node_name=NODE, state_dir=f"{tmp.name}/state",
        cdi_root=f"{tmp.name}/cdi", env={}, retry_timeout=5.0),
        device_lib=device_lib).start()
    loop = NodePrepareLoop(client, driver, DRIVER_NAME, NODE,
                           namespace=NAMESPACE).start()
    try:
        t0 = time.monotonic()
        claim = client.create(new_object(
            "ResourceClaim", name, NAMESPACE,
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{"name": "gpu", "exactly": {
                "deviceClassName": DRIVER_NAME,
                "allocationMode": "ExactCount", "count": 1,
                "selectors": [{"cel": {"expression":
                    f"device.attributes['uuid'] == '{gpu_uuid}'"}}]}}]}}))
        claim = Allocator(client).allocate(
            claim, reserved_for=[{"resource": "pods", "name": "bench-pod"}],
            node=NODE)
        _wait(lambda: claim_ready(client, name), "claim Ready")
        ready_ms = (time.monotonic() - t0) * 1e3
        spec = driver.cdi.read_claim_spec(claim["metadata"]["uid"])
    except BaseException:
        loop.stop()
        driver.stop()
        tmp.cleanup()
        raise
    return Claim(name, spec, ready_ms, client, driver, loop, tmp)
