"""A Ready status implies a committed checkpoint, on the GPU kubelet plugin.

A claim's ``status.devices`` entry of this driver with ``Ready: True`` on
device D says that the node's checkpoint holds the claim as
``PrepareCompleted`` with D. The claim watcher publishes Ready only after the
prepare committed, and only while the record still reads so (under the
claim's flight lock); it clears Ready before the node-side unprepare of a
moved or released claim; and a drain retracts Ready (``Ready: False``,
reason ``Drained``) before it undoes the devices and leaves its tombstone.

``ReadyProbe`` samples the claim's status, then the checkpoint, then the
status again, hundreds of times while the claim is prepared, moved, drained
and re-allocated. A sample counts when the status did not change across the
checkpoint read, so the status it saw held while the checkpoint was read: a
sample with Ready on D and no ``PrepareCompleted`` entry with D breaks the
rule. The other tests force each ordering the rule depends on with a hook,
without load. The JAX package's watcher and drain, which stay as they are,
leave Ready standing over an unprepared or drained record.
"""

import threading

import pytest

from k8s_dra_driver_tpu_torch.k8sclient.client import ConflictError
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import (
    REASON_DRAINED,
    drain_marked,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
    ClaimReallocator,
    parse_gpu_index,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_ABORTED,
    STATE_PREPARE_COMPLETED,
)
from tests.test_torch_remediation import DRIVER, Stack, _JaxStack


def ready_devices(claim, driver=DRIVER):
    """The devices ``driver``'s status entries of ``claim`` say are Ready."""
    if claim is None:
        return set()
    return {d.get("device") for d in
            (claim.get("status") or {}).get("devices") or []
            if d.get("driver") == driver and any(
                c.get("type") == "Ready" and c.get("status") == "True"
                for c in d.get("conditions") or [])}


class ReadyProbe:
    """Samples one claim's Ready devices against the node's checkpoint on a
    thread of its own until stopped."""

    def __init__(self, stack, name, driver=DRIVER):
        self.stack, self.name, self.driver = stack, name, driver
        self.samples = 0        # Ready samples confirmed across the read
        self.unconfirmed = 0    # status changed during the checkpoint read
        self.violations = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            before = self.stack.claim(self.name)
            ready = ready_devices(before, self.driver)
            if not ready:
                continue
            uid = before["metadata"]["uid"]
            pc = self.stack.driver.state.prepared_claims_nolock().get(uid)
            after = self.stack.claim(self.name)
            if (after is None or after["metadata"]["resourceVersion"]
                    != before["metadata"]["resourceVersion"]):
                self.unconfirmed += 1
                continue
            self.samples += 1
            held = ({d.get("device") for d in pc.prepared_devices}
                    if pc is not None and pc.state == STATE_PREPARE_COMPLETED
                    else set())
            if not ready <= held:
                self.violations.append(
                    (sorted(ready), pc.state if pc is not None else None,
                     sorted(held)))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10.0)


@pytest.fixture()
def stack(tmp_path):
    s = Stack(tmp_path)
    yield s
    s.stop()


def rewrite_allocation(stack, name, device):
    """Point the claim's allocation at ``device``, as a reallocation that
    the claim watcher sees as one update would."""
    while True:
        fresh = stack.claim(name)
        fresh["status"]["allocation"]["devices"]["results"][0]["device"] = \
            device
        try:
            stack.client.update_status(fresh)
            return
        except ConflictError:
            continue


def ref_of(stack, name):
    c = stack.claim(name)
    return ClaimRef(uid=c["metadata"]["uid"], name=name,
                    namespace="default")


class TestReadyImpliesCommitted:
    def test_probe_across_rewrite_drain_and_reallocation(self, stack):
        """Three rounds: the allocation rewritten under the prepared claim,
        then its device faulted, the claim drained, re-allocated by the
        reallocator and prepared again. No sample may show Ready ahead of
        or after the record."""
        realloc = ClaimReallocator(stack.client, retry_delay=0.05,
                                   metrics=stack.drainer.metrics).start()
        try:
            with ReadyProbe(stack, "c1") as probe:
                stack.allocate(stack.make_claim("c1"))
                assert stack.wait(lambda: stack.ready("c1"))
                for _ in range(3):
                    dev = stack.allocated_device("c1")
                    target = f"gpu-{(parse_gpu_index(dev) + 3) % 8}"
                    rewrite_allocation(stack, "c1", target)
                    assert stack.wait(lambda: ready_devices(
                        stack.claim("c1")) == {target})

                    stack.lib.set_unhealthy(parse_gpu_index(target),
                                            "XID 79", xid_errors=1)
                    stack.monitor.poll_once()
                    stack.drainer.repair = lambda device: None
                    assert stack.drainer.poll_once()["drained"] == 1
                    assert stack.wait(lambda: (
                        stack.allocated_device("c1") not in (None, target)
                        and ready_devices(stack.claim("c1"))
                        == {stack.allocated_device("c1")}))
                    stack.drainer.repair = stack.repair

                    def settled():
                        stack.drainer.poll_once()
                        return not stack.drainer.draining
                    assert stack.wait(settled)
                    stack.monitor.poll_once()
        finally:
            realloc.stop()
        assert probe.violations == []
        assert probe.samples >= 100, (probe.samples, probe.unconfirmed)


class TestOrderings:
    def test_unprepare_of_a_moved_claim_clears_ready_first(self, stack):
        stack.allocate(stack.make_claim(
            "c1", selector="device.attributes['index'] == 1"))
        assert stack.wait(lambda: stack.ready("c1"))
        seen = []
        unprepare = stack.driver.unprepare_resource_claims

        def hooked(refs):
            seen.append(ready_devices(stack.claim("c1")))
            return unprepare(refs)
        stack.driver.unprepare_resource_claims = hooked
        rewrite_allocation(stack, "c1", "gpu-6")
        assert stack.wait(
            lambda: ready_devices(stack.claim("c1")) == {"gpu-6"})
        # The node-side unprepare of gpu-1 ran with no Ready left on it.
        assert seen and all(s == set() for s in seen), seen

    def test_drain_retracts_ready_before_its_tombstone(self, stack):
        stack.allocate(stack.make_claim("c1"))
        assert stack.wait(lambda: stack.ready("c1"))
        ref = ref_of(stack, "c1")
        seen = []
        transact = stack.driver.state.checkpoints.transact

        def hooked(mutate):
            seen.append(ready_devices(stack.claim("c1")))
            return transact(mutate)
        stack.driver.state.checkpoints.transact = hooked
        assert stack.driver.drain_claim(ref, reason="test")
        assert seen == [set()]
        claim = stack.claim("c1")
        assert drain_marked(claim, DRIVER)
        (entry,) = [d for d in claim["status"]["devices"]
                    if d["driver"] == DRIVER]
        assert entry["conditions"] == [{"type": "Ready", "status": "False",
                                        "reason": REASON_DRAINED}]
        assert stack.checkpoint_entry("c1").state == STATE_PREPARE_ABORTED

    def test_no_ready_for_a_claim_drained_before_its_publish(self, stack):
        """A drain that takes the record between the watcher's prepare and
        its publish: the publish is dropped, not made over the
        tombstone."""
        prepare = stack.driver.prepare_resource_claims
        drained = []

        def hooked(claims):
            out = prepare(claims)
            if not drained:
                c = claims[0]
                drained.append(stack.driver.drain_claim(ClaimRef(
                    uid=c["metadata"]["uid"], name=c["metadata"]["name"],
                    namespace=c["metadata"]["namespace"])))
            return out
        stack.driver.prepare_resource_claims = hooked
        stack.allocate(stack.make_claim("c1"))
        uid = stack.claim("c1")["metadata"]["uid"]

        def handled():
            with stack.loop._mu:
                return uid in stack.loop._prepared
        assert stack.wait(handled)
        assert drained == [True]
        assert not stack.ready("c1")
        assert stack.checkpoint_entry("c1").state == STATE_PREPARE_ABORTED

    def test_ready_restored_when_a_drain_stops_before_its_tombstone(
            self, stack, monkeypatch):
        stack.allocate(stack.make_claim("c1"))
        assert stack.wait(lambda: stack.ready("c1"))
        undo = stack.driver.state._undo_devices
        calls = []

        def failing(pc):
            calls.append(pc)
            raise OSError("device busy")
        monkeypatch.setattr(stack.driver.state, "_undo_devices", failing)
        with pytest.raises(OSError):
            stack.driver.drain_claim(ref_of(stack, "c1"))
        assert calls
        monkeypatch.setattr(stack.driver.state, "_undo_devices", undo)
        # Retracted by the drain, then restored by the watcher: the record
        # still reads completed.
        assert stack.wait(lambda: stack.ready("c1"))
        assert not drain_marked(stack.claim("c1"), DRIVER)
        assert stack.checkpoint_entry("c1").state == STATE_PREPARE_COMPLETED


class TestAgainstJax:
    def test_jax_drain_leaves_ready_over_its_tombstone(self, tmp_path):
        """The JAX package's drain, which stays as it is, undoes the devices
        and leaves its tombstone with the claim still Ready; the port's
        retracts Ready first. The claim watchers are stopped first: a late
        event would have the JAX watcher prepare the claim again."""
        from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin.checkpoint import (
            STATE_PREPARE_ABORTED as JAX_ABORTED,
        )

        (tmp_path / "jax").mkdir()
        (tmp_path / "port").mkdir()
        jax = _JaxStack(tmp_path / "jax")
        port = Stack(tmp_path / "port")
        try:
            for s in (jax, port):
                s.allocate(s.make_claim("c1"))
                assert s.wait(lambda s=s: s.ready("c1"))
                s.loop.stop()
                s.loop = None
                assert s.driver.drain_claim(ref_of(s, "c1"))
            assert jax.checkpoint_entry("c1").state == JAX_ABORTED
            assert jax.ready("c1")
            assert port.checkpoint_entry("c1").state == STATE_PREPARE_ABORTED
            assert not port.ready("c1")
        finally:
            jax.stop()
            port.stop()
