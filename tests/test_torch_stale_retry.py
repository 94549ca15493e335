"""A claim watcher's retry that waited for the lock while the claim was deleted.

A failed prepare arms a timer that reads the claim from the API server and
reconciles it under the watcher's lock. The watcher read the claim before
taking the lock. Another handler can hold the lock for a long time (a
prepare's checkpoint fsyncs on a loaded disk), so the claim's delete event
could be handled first, with nothing of the claim tracked yet, and the
retry then prepared the deleted claim from its last object: a completed
checkpoint entry and a CDI spec that no event would ever undo, holding the
GPU against the next claim. The node-kill soak's incident leg
(``tests/test_torch_blackbox.py::TestIncidentLeg``) failed on such a leak
(node 0's checkpoint and CDI spec kept a deleted claim; the next claim on
its GPU was refused six times) in 1 of 48 soaks beside fsyncing writers
and other test processes on an 8-core machine. The port's retry reads the
claim under the lock; the JAX package's watcher keeps the early read
(pinned last).

The order is made by holding the watcher's lock in the test while the
timer fires, not by sleeps.
"""

import threading

from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxFakeClient
from k8s_dra_driver_tpu.k8sclient.client import new_object as jax_new_object
from k8s_dra_driver_tpu.kubeletplugin import Allocator as JaxAllocator
from k8s_dra_driver_tpu.kubeletplugin.claimwatcher import (
    NodePrepareLoop as JaxNodePrepareLoop,
)
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import (
    DriverConfig as JaxDriverConfig,
)
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import TpuDriver
from k8s_dra_driver_tpu.tpulib import MockDeviceLib as JaxMockDeviceLib
from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)

# How long the test waits for the timer's read while it holds the lock:
# the early read happens at once; a read under the lock never comes while
# the test holds it.
READ_WAIT_S = 0.5


class _Node:
    """One node's driver and claim watcher (the port's, or with ``jax`` the
    JAX package's), with no informer running: the test delivers the delete
    event itself."""

    def __init__(self, tmp_path, jax=False):
        if jax:
            kind, self.driver_name = "tpu", "tpu.google.com"
            self.client, self.new_object = JaxFakeClient(), jax_new_object
            self.driver = TpuDriver(self.client, JaxDriverConfig(
                node_name="node-a", state_dir=str(tmp_path / "jax-state"),
                cdi_root=str(tmp_path / "jax-cdi"), env={},
                retry_timeout=0.6), device_lib=JaxMockDeviceLib("v5e-8"))
            loop_cls, self.alloc = JaxNodePrepareLoop, JaxAllocator(self.client)
        else:
            kind, self.driver_name = "gpu", "gpu.nvidia.com"
            self.client, self.new_object = FakeClient(), new_object
            self.driver = GpuDriver(self.client, DriverConfig(
                node_name="node-a", state_dir=str(tmp_path / "state"),
                cdi_root=str(tmp_path / "cdi"), env={}, retry_timeout=0.6),
                device_lib=MockDeviceLib("h100-8"))
            loop_cls, self.alloc = NodePrepareLoop, Allocator(self.client)
        self.kind = kind
        self.client.create(self.new_object(
            "DeviceClass", self.driver_name, spec={"selectors": [{"cel": {
                "expression": f"device.attributes['type'] == '{kind}'"}}]}))
        self.loop = loop_cls(self.client, self.driver.start(),
                             self.driver_name, "node-a", namespace="default",
                             retry_delay=0.0)

    def create_allocated(self, name, index):
        claim = self.client.create(self.new_object(
            "ResourceClaim", name, "default",
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{"name": self.kind, "exactly": {
                "deviceClassName": self.driver_name,
                "allocationMode": "ExactCount", "count": 1,
                "selectors": [{"cel": {"expression":
                               f"device.attributes['index'] == {index}"}}],
            }}]}}))
        self.alloc.allocate(claim,
                            reserved_for=[{"resource": "pods", "name": name}],
                            node="node-a")
        return self.client.get("ResourceClaim", name, "default")


def _retry_behind_a_delete(node) -> tuple[str, str]:
    """Claim A's retry fires while another handler holds the lock; A is
    deleted and its delete event handled before the retry gets the lock.
    Returns what the driver holds for A after the retry (its checkpoint
    state, "" if none) and the error of claim B's prepare on A's GPU ("" if
    none)."""
    a = node.create_allocated("a", 2)
    uid = a["metadata"]["uid"]
    read = threading.Event()
    try_get = node.client.try_get

    def observed_try_get(kind, name, namespace=None):
        out = try_get(kind, name, namespace)
        if (kind, name) == ("ResourceClaim", "a"):
            read.set()
        return out

    node.client.try_get = observed_try_get
    before = set(threading.enumerate())
    with node.loop._mu:
        node.loop._schedule_retry("a", "default")
        (timer,) = [t for t in set(threading.enumerate()) - before
                    if isinstance(t, threading.Timer)]
        read.wait(READ_WAIT_S)
        node.client.delete("ResourceClaim", "a", "default")
        # A's delete event, handled while the retry waits for the lock.
        node.loop._unprepare_deleted(uid)
    timer.join(timeout=10.0)
    assert not timer.is_alive()
    node.client.try_get = try_get
    record = node.driver.state.prepared_claims_nolock().get(uid)
    held = record.state if record is not None else ""
    if uid in node.driver.cdi.list_claim_uids():
        held += "+cdi"
    b = node.create_allocated("b", 2)
    res = node.driver.prepare_resource_claims([b])[b["metadata"]["uid"]]
    return held, (str(res.error) if res.error is not None else "")


def test_a_retry_behind_the_delete_prepares_nothing(tmp_path):
    node = _Node(tmp_path)
    held, refused = _retry_behind_a_delete(node)
    assert held == "", "the deleted claim was prepared by its retry"
    assert refused == ""
    assert not node.loop._prepared and not node.loop._adopted


def test_jax_retry_prepares_the_deleted_claim(tmp_path):
    """The JAX package's watcher, which stays as it is, reads the claim
    before it takes the lock: the deleted claim stays prepared and the next
    claim on its device is refused."""
    held, refused = _retry_behind_a_delete(_Node(tmp_path, jax=True))
    assert held == "PrepareCompleted+cdi"
    assert "already prepared" in refused
