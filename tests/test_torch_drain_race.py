"""A drain that lands while a claim's prepare is being retried.

The claim watcher asks the driver to prepare claim A; the first attempt
registers A's devices (PrepareStarted) and fails at the
``devicestate.prepare`` fault point. Before the in-batch retry, the drain
controller drains A (a PrepareAborted tombstone) and, in one case, writes
its reallocation annotation. The retry meets the tombstone; the watcher
must not act on its event's object, which predates the drain, and a
prepare that failed must stay tracked, so that when the reallocator
releases A the watcher unprepares whatever record the failed prepares
left. Then claim B, allocated A's GPU, prepares.

The order is fixed by a wrapper around the device state's ``prepare``
(the drain runs inside the first attempt's failure), not by sleeps; the
claim watcher is driven by calling its event handler with the objects a
watch would deliver.

The JAX package's claim watcher has the same race and stays as it is: its
run of the same sequence leaves A's failed prepare holding the device, so
B is refused (a deliberate difference, ROADMAP.md).
"""

import pytest

from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxFakeClient
from k8s_dra_driver_tpu.k8sclient.client import new_object as jax_new_object
from k8s_dra_driver_tpu.kubeletplugin import Allocator as JaxAllocator
from k8s_dra_driver_tpu.kubeletplugin import remediation as jax_remediation
from k8s_dra_driver_tpu.kubeletplugin.claimwatcher import (
    NodePrepareLoop as JaxNodePrepareLoop,
)
from k8s_dra_driver_tpu.pkg import faultpoints as jax_faultpoints
from k8s_dra_driver_tpu.pkg.metrics import (
    RemediationMetrics as JaxRemediationMetrics,
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
from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
    ANN_DRAIN,
    ClaimReallocator,
    DrainController,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg import faultpoints
from k8s_dra_driver_tpu_torch.pkg.metrics import RemediationMetrics
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_ABORTED,
    STATE_PREPARE_COMPLETED,
)


class _Node:
    """One node's driver, claim watcher, drain controller and reallocator
    (the port's, or with ``jax`` the JAX package's), with no thread
    running: the test delivers every event itself."""

    def __init__(self, tmp_path, jax=False):
        self.jax = jax
        if jax:
            self.kind, self.driver_name = "tpu", "tpu.google.com"
            self.fp = jax_faultpoints
            self.client = JaxFakeClient()
            self.client.create(jax_new_object(
                "DeviceClass", self.driver_name, spec={"selectors": [{"cel": {
                    "expression": "device.attributes['type'] == 'tpu'"}}]}))
            self.driver = TpuDriver(self.client, JaxDriverConfig(
                node_name="node-a", state_dir=str(tmp_path / "jax-state"),
                cdi_root=str(tmp_path / "jax-cdi"), env={},
                retry_timeout=0.6), device_lib=JaxMockDeviceLib("v5e-8"))
            self.loop = JaxNodePrepareLoop(
                self.client, self.driver.start(), self.driver_name, "node-a",
                namespace="default")
            self.drainer = jax_remediation.DrainController(
                self.client, self.driver,
                metrics=JaxRemediationMetrics())
            self.realloc = jax_remediation.ClaimReallocator(
                self.client, metrics=JaxRemediationMetrics())
            self.alloc = JaxAllocator(self.client)
            self.new_object = jax_new_object
            self.ann_drain = jax_remediation.ANN_DRAIN
        else:
            self.kind, self.driver_name = "gpu", "gpu.nvidia.com"
            self.fp = faultpoints
            self.client = FakeClient()
            self.client.create(new_object(
                "DeviceClass", self.driver_name, spec={"selectors": [{"cel": {
                    "expression": "device.attributes['type'] == 'gpu'"}}]}))
            self.driver = GpuDriver(self.client, DriverConfig(
                node_name="node-a", state_dir=str(tmp_path / "state"),
                cdi_root=str(tmp_path / "cdi"), env={}, retry_timeout=0.6),
                device_lib=MockDeviceLib("h100-8"))
            self.loop = NodePrepareLoop(
                self.client, self.driver.start(), self.driver_name, "node-a",
                namespace="default")
            self.drainer = DrainController(self.client, self.driver,
                                           metrics=RemediationMetrics())
            self.realloc = ClaimReallocator(self.client,
                                            metrics=RemediationMetrics())
            self.alloc = Allocator(self.client)
            self.new_object = new_object
            self.ann_drain = ANN_DRAIN
        # A failed reconcile arms a retry timer; the test delivers events
        # itself, so it only counts them.
        self.retries = []
        self.loop._schedule_retry = lambda name, ns: self.retries.append(name)

    def claim(self, name):
        return self.client.try_get("ResourceClaim", name, "default")

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
        return self.claim(name)

    def deliver(self, claim):
        """One watch event for ``claim``; a failed reconcile is what the
        informer would log."""
        try:
            self.loop._on_change(claim)
        except RuntimeError:
            pass


def _drain_during_retry(node, annotate: bool,
                        every_attempt: bool = True) -> tuple[str, object]:
    """Claim A on device 0: its first prepare attempt fails after
    registering, the drain (and, with ``annotate``, the drain controller's
    reallocation annotation) lands before the retry, and with
    ``every_attempt`` every later attempt fails too (else only the first
    does). The watcher gets A's event from before the drain; then the
    reallocator releases A and the watcher gets that event. Returns the
    error of claim B's prepare on device 0 ("" if none) and the state of
    A's record just after the stale event (None where it has none)."""
    a = node.create_allocated("a", 0)
    uid = a["metadata"]["uid"]
    ref = ClaimRef(uid=uid, name="a", namespace="default")
    device = f"{node.kind}-0"
    state = node.driver.state
    prepare = state.prepare
    attempts = []

    def prepare_with_drain(claim):
        attempts.append(claim)
        faults = ("devicestate.prepare=every:1"
                  if every_attempt or len(attempts) == 1 else "")
        with node.fp.injected(faults):
            try:
                return prepare(claim)
            finally:
                if len(attempts) == 1:
                    # The drain controller, between the first attempt and
                    # the in-batch retry.
                    assert node.driver.drain_claim(ref)
                    if annotate:
                        assert node.drainer._annotate_drained(ref, device)

    state.prepare = prepare_with_drain
    node.deliver(a)
    state.prepare = prepare
    record = state.prepared_claims_nolock().get(uid)
    after_stale = record.state if record is not None else None
    assert after_stale != STATE_PREPARE_COMPLETED, (
        "a's stale event prepared it onto its drained GPU")
    assert len(attempts) >= 2
    assert node.retries, "the failed prepare armed no retry"
    if annotate:
        assert node.ann_drain in node.claim("a")["metadata"]["annotations"]
    # The reallocator releases A's allocation; the watcher sees it.
    assert node.realloc._release_allocation("a", "default")
    node.deliver(node.claim("a"))
    b = node.create_allocated("b", 0)
    res = node.driver.prepare_resource_claims([b])[b["metadata"]["uid"]]
    return (str(res.error) if res.error is not None else "", after_stale)


@pytest.mark.parametrize("annotate", [True, False],
                         ids=["annotated", "before_annotation"])
def test_drain_during_prepare_retry_releases_the_device(tmp_path, annotate):
    node = _Node(tmp_path)
    err, _ = _drain_during_retry(node, annotate)
    assert err == "", f"claim b refused on a's released GPU: {err}"
    uid = node.claim("a")["metadata"]["uid"]
    left = node.driver.state.prepared_claims_nolock().get(uid)
    assert left is None or left.state == STATE_PREPARE_ABORTED
    # Nothing of a's is left tracked: its failed prepares were unprepared.
    assert uid not in node.loop._adopted and uid not in node.loop._prepared


def test_a_stale_event_does_not_prepare_onto_the_drained_gpu(tmp_path):
    """Only the first attempt faults, and the drain annotation is written
    before the in-batch retry, which meets the tombstone. The event's
    object predates the drain and lacks the annotation: resolving the
    tombstone on it would prepare A onto the drained GPU, and that prepare
    would now succeed. The watcher decides on the claim read afresh, which
    carries the annotation, so A's record stays the tombstone."""
    node = _Node(tmp_path)
    err, after_stale = _drain_during_retry(node, annotate=True,
                                           every_attempt=False)
    assert after_stale == STATE_PREPARE_ABORTED
    assert err == "", f"claim b refused on a's released GPU: {err}"


def test_jax_watcher_keeps_the_failed_prepare(tmp_path):
    """The same sequence through the JAX package: its watcher leaves the
    failed prepare's record holding the device, and B is refused."""
    err, _ = _drain_during_retry(_Node(tmp_path, jax=True), annotate=True)
    assert "already prepared for claim" in err
