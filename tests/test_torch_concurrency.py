"""Concurrent-prepare semantics on the GPU port: the JAX package's
``tests/test_concurrency.py`` on the port's GPU kubelet plugin, checkpoint,
claim flight table, controller worker pool and allocator indexes.

The contract:

- prepares of DISJOINT claims overlap in time (held open with a
  ``devicestate.prepare=latency:…`` fault schedule);
- prepare/unprepare of the SAME claim still serialize — an unprepare
  issued mid-prepare lands after it and fully cleans up;
- the overlap run and the worker pool run clean under the sanitizer's
  race mode (``GPU_DRA_SANITIZE=race``): no lock-order inversion, no
  unguarded mutation, no frozen watch snapshot mutated, no data race;
- concurrent checkpoint transactions coalesce into group-commit batches,
  one mutation's failure does not poison its batch-mates;
- the allocator's generation-stamped indexes hit while the cluster is
  quiet, invalidate on writes, and never serve stale candidates.
"""

import contextlib
import threading
import time

import pytest

from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg import faultpoints, racelab, sanitizer
from k8s_dra_driver_tpu_torch.pkg.errors import PermanentError
from k8s_dra_driver_tpu_torch.pkg.metrics import AllocatorMetrics
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_COMPLETED,
    Checkpoint,
    CheckpointManager,
    PreparedClaimCP,
)
from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib

DRIVER = "gpu.nvidia.com"


@pytest.fixture(autouse=True)
def _port_faultpoints_guard():
    """No port fault plan may outlive its test."""
    assert faultpoints.active_plan() is None
    yield
    leaked = faultpoints.active_plan() is not None
    faultpoints.deactivate()
    assert not leaked, "test left a fault plan active"


PREP_LATENCY = 0.4  # devicestate.prepare stall used to hold prepares open


@contextlib.contextmanager
def _race_mode(monkeypatch):
    """The sanitizer's race mode for the stack built inside the block
    (locks and guarded maps are chosen when they are created), with the
    order graph and the detector clean on both sides."""
    monkeypatch.setenv(sanitizer.ENV_SANITIZE, "race")
    was_active = racelab.active()
    racelab.enable()
    sanitizer.reset()
    racelab.reset()
    try:
        yield
    finally:
        if not was_active:
            racelab.disable()
        monkeypatch.delenv(sanitizer.ENV_SANITIZE)


def _cluster(tmp_path, sub="", retry_timeout=5.0):
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", DRIVER,
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    cfg = DriverConfig(
        node_name="node-a",
        state_dir=str(tmp_path / f"state{sub}"),
        cdi_root=str(tmp_path / f"cdi{sub}"),
        env={},
        retry_timeout=retry_timeout,
    )
    driver = GpuDriver(client, cfg, device_lib=MockDeviceLib("h100-8")).start()
    return client, driver


def _alloc_claim(client, name):
    client.create(new_object(
        "ResourceClaim", name, "default",
        api_version="resource.k8s.io/v1",
        spec={"devices": {"requests": [{
            "name": "gpu", "exactly": {
                "deviceClassName": DRIVER,
                "allocationMode": "ExactCount", "count": 1}}]}}))
    return Allocator(client).allocate(
        client.get("ResourceClaim", name, "default"), node="node-a")


def _run_overlapping_prepares(driver, claims):
    """Prepare each claim in its own thread; returns per-claim
    (start, end, result) keyed by uid."""
    barrier = threading.Barrier(len(claims))
    out = {}
    out_mu = threading.Lock()

    def work(claim):
        uid = claim["metadata"]["uid"]
        barrier.wait()
        t0 = time.monotonic()
        res = driver.prepare_resource_claims([claim])[uid]
        t1 = time.monotonic()
        with out_mu:
            out[uid] = (t0, t1, res)

    threads = [threading.Thread(target=work, args=(c,)) for c in claims]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(out) == len(claims)
    return out


class TestDisjointClaimOverlap:
    def test_disjoint_prepares_overlap_in_time(self, tmp_path):
        """Two claims over different GPUs, each stalled PREP_LATENCY s
        inside the device-prep window: with per-claim serialization they
        run concurrently — intervals overlap and the pair finishes in
        well under 2× the stall."""
        client, driver = _cluster(tmp_path)
        a = _alloc_claim(client, "wl-a")
        b = _alloc_claim(client, "wl-b")
        with faultpoints.injected(
                f"devicestate.prepare=latency:{PREP_LATENCY}"):
            spans = _run_overlapping_prepares(driver, [a, b])
        for t0, t1, res in spans.values():
            assert res.error is None
            assert t1 - t0 >= PREP_LATENCY  # the stall was really inside
        starts = [s[0] for s in spans.values()]
        ends = [s[1] for s in spans.values()]
        assert max(starts) < min(ends), "prepare intervals did not overlap"
        assert max(ends) - min(starts) < 2 * PREP_LATENCY * 0.9, \
            "two disjoint prepares took serial time"
        # Both really prepared.
        prepared = driver.state.prepared_claims()
        assert {a["metadata"]["uid"], b["metadata"]["uid"]} <= set(prepared)

    def test_same_claim_prepare_unprepare_serialize(self, tmp_path):
        """An unprepare issued while the claim's own prepare is mid-flight
        must wait for it — running inside the prepare would unwind half a
        transaction. Afterwards the claim is fully cleaned up."""
        client, driver = _cluster(tmp_path)
        claim = _alloc_claim(client, "wl-serial")
        uid = claim["metadata"]["uid"]
        ref = ClaimRef(uid=uid, name="wl-serial", namespace="default")
        prep_done = {}
        with faultpoints.injected(
                f"devicestate.prepare=latency:{PREP_LATENCY}"):
            t = threading.Thread(target=lambda: prep_done.setdefault(
                "res", driver.prepare_resource_claims([claim])[uid]))
            t0 = time.monotonic()
            t.start()
            time.sleep(PREP_LATENCY / 3)  # prepare is now inside the stall
            errs = driver.unprepare_resource_claims([ref])
            t_unprep = time.monotonic() - t0
            t.join(timeout=30)
        assert prep_done["res"].error is None
        assert errs[uid] is None
        # The unprepare could only finish after the prepare released the
        # claim (it waited out the stall)…
        assert t_unprep >= PREP_LATENCY * 0.9
        # …and it unwound the COMPLETED claim: nothing leaks.
        assert driver.state.prepared_claims() == {}
        assert driver.cdi.list_claim_uids() == []

    def test_overlap_run_clean_under_sanitizer(self, tmp_path, monkeypatch):
        """The concurrent path under the sanitizer's race mode: every new
        lock (flight table, per-claim locks, commit pipeline) is tracked,
        and a full overlap + unprepare cycle leaves no lock-order or
        guarded-mutation violation, no race report, and nothing behind."""
        with _race_mode(monkeypatch):
            client, driver = _cluster(tmp_path, sub="-san")
            assert isinstance(driver.state.checkpoints._commit_mu,
                              sanitizer.TrackedLock)
            claims = [_alloc_claim(client, f"wl-san-{i}") for i in range(3)]
            with faultpoints.injected("devicestate.prepare=latency:0.1"):
                spans = _run_overlapping_prepares(driver, claims)
            for _, _, res in spans.values():
                assert res.error is None
            for c in claims:
                errs = driver.unprepare_resource_claims([ClaimRef(
                    uid=c["metadata"]["uid"], name=c["metadata"]["name"],
                    namespace="default")])
                assert errs[c["metadata"]["uid"]] is None
            violations, races = sanitizer.violations(), racelab.reports()
            sanitizer.reset()
            racelab.reset()
        assert violations == []
        assert races == []
        assert driver.state.prepared_claims() == {}
        assert driver.cdi.list_claim_uids() == []


class TestClaimWaitBounds:
    def test_same_claim_wait_times_out_retryably(self):
        """A wedged operation must not park same-claim retries forever:
        waiting out the claim-lock budget raises a retryable error and
        leaves the flight table balanced."""
        from k8s_dra_driver_tpu_torch.pkg.errors import is_permanent
        from k8s_dra_driver_tpu_torch.pkg.inflight import (
            ClaimBusyError,
            ClaimFlightTable,
        )
        table = ClaimFlightTable("T")
        entered, release = threading.Event(), threading.Event()

        def hold():
            with table.claim("u"):
                entered.set()
                release.wait(5)

        t = threading.Thread(target=hold)
        t.start()
        assert entered.wait(2)
        with pytest.raises(ClaimBusyError) as ei:
            with table.claim("u", timeout=0.1):
                pass
        assert not is_permanent(ei.value)
        release.set()
        t.join(timeout=5)
        assert table.inflight() == 0


class TestControlPlaneWorkers:
    """Multi-worker reconcile (docs/performance.md, "Control plane"): the
    CD controller's workqueue pool never runs one ComputeDomain on two
    workers at once, while distinct CDs overlap — proven by holding every
    reconcile open with the ``cd.controller.reconcile`` latency point."""

    RECONCILE_LATENCY = 0.08

    def _live_controller(self, workers=4):
        from k8s_dra_driver_tpu_torch.api.computedomain import new_compute_domain
        from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.controller import (  # noqa: E501
            ComputeDomainController,
        )
        client = FakeClient()
        ctrl = ComputeDomainController(client, workers=workers)
        ctrl.cleanup.interval = 3600.0
        return client, ctrl, new_compute_domain

    def _track_overlaps(self, ctrl):
        """Wrap the queue callback to record per-key concurrency."""
        mu = threading.Lock()
        state = {"active": {}, "same_key_overlaps": 0, "max_cross_key": 0,
                 "runs": 0}
        orig = ctrl._reconcile_key

        def tracked(key):
            with mu:
                state["runs"] += 1
                if state["active"].get(key):
                    state["same_key_overlaps"] += 1
                state["active"][key] = state["active"].get(key, 0) + 1
                state["max_cross_key"] = max(state["max_cross_key"],
                                             len(state["active"]))
            try:
                return orig(key)
            finally:
                with mu:
                    state["active"][key] -= 1
                    if not state["active"][key]:
                        del state["active"][key]

        ctrl._reconcile_key = tracked
        return state

    def test_per_key_exclusive_cross_key_parallel(self):
        client, ctrl, new_cd = self._live_controller(workers=4)
        state = self._track_overlaps(ctrl)
        with faultpoints.injected(
                f"cd.controller.reconcile=latency:{self.RECONCILE_LATENCY}"):
            ctrl.start()
            try:
                cds = [client.create(new_cd(f"dom-{i}", "default",
                                            num_nodes=1))
                       for i in range(4)]
                # Hammer ONE key with updates while its reconcile stalls:
                # absent per-key exclusivity these overlap immediately.
                for r in range(6):
                    obj = client.get("ComputeDomain", "dom-0", "default")
                    obj["spec"]["numNodes"] = 1 + r % 2
                    try:
                        client.update(obj)
                    except Exception:  # noqa: BLE001 — rv race with the loop
                        pass
                    time.sleep(self.RECONCILE_LATENCY / 3)
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline and (
                        len(ctrl.queue) or state["active"]):
                    time.sleep(0.02)
            finally:
                ctrl.stop()
        assert state["runs"] >= len(cds)
        assert state["same_key_overlaps"] == 0, \
            "one ComputeDomain reconciled on two workers at once"
        assert state["max_cross_key"] >= 2, \
            "worker pool never overlapped distinct CDs"

    def test_worker_pool_clean_under_sanitizer(self, monkeypatch):
        """The multi-worker loop's cross-key shared state (uid map, clique
        index, workqueue internals, fan-out snapshots) audited live under
        the race mode: locks tracked, guarded dicts checked, shared watch
        events frozen, accesses fed to the detector; the fleet converges
        Ready with no violation and no race report."""
        with _race_mode(monkeypatch):
            self._converge_fleet()
            violations, races = sanitizer.violations(), racelab.reports()
            sanitizer.reset()
            racelab.reset()
        assert violations == []
        assert races == []

    def _converge_fleet(self):
        """Six one-node ComputeDomains, each with a Ready clique, through
        a four-worker controller until every one is Ready."""
        from k8s_dra_driver_tpu_torch.api.computedomain import (
            STATUS_READY,
            new_clique,
        )
        client, ctrl, new_cd = self._live_controller(workers=4)
        with faultpoints.injected("cd.controller.reconcile=latency:0.01"):
            ctrl.start()
            try:
                cds = [client.create(new_cd(f"dom-{i}", "default",
                                            num_nodes=1))
                       for i in range(6)]
                for cd in cds:
                    clique = new_clique(cd["metadata"]["uid"], "s0",
                                        "default",
                                        owner_cd_name=cd["metadata"]["name"])
                    clique["daemons"] = [{"nodeName": "n0", "index": 0,
                                          "status": STATUS_READY}]
                    client.create(clique)
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline:
                    if all((client.get("ComputeDomain",
                                       cd["metadata"]["name"],
                                       "default").get("status") or {}
                            ).get("status") == STATUS_READY for cd in cds):
                        break
                    time.sleep(0.02)
                else:
                    pytest.fail("fleet never converged under sanitizer")
            finally:
                ctrl.stop()


class TestGroupCommit:
    def test_concurrent_transactions_coalesce(self, tmp_path):
        """8 threads transact against one manager while every physical
        write is slowed: the later transactions pile into shared batches —
        total transactions committed is 8, in fewer than 8 batches, and
        every mutation landed."""
        batches = []
        mgr = CheckpointManager(str(tmp_path / "cp.json"),
                                on_batch=batches.append)
        barrier = threading.Barrier(8)

        def add(i):
            def mutate(c: Checkpoint):
                c.prepared_claims[f"uid-{i}"] = PreparedClaimCP(
                    state=STATE_PREPARE_COMPLETED,
                    prepared_devices=[{"device": f"gpu-{i}"}])
            barrier.wait()
            mgr.transact(mutate)

        with faultpoints.injected("checkpoint.write=latency:0.1"):
            threads = [threading.Thread(target=add, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        assert sum(batches) == 8
        assert len(batches) < 8, "no coalescing happened"
        assert set(mgr.read().prepared_claims) == {
            f"uid-{i}" for i in range(8)}

    def test_failed_mutation_does_not_poison_batchmates(self, tmp_path):
        """A mutation that raises fails only its own caller; other
        transactions in the same commit window land."""
        mgr = CheckpointManager(str(tmp_path / "cp.json"))
        mgr.transact(lambda c: c.prepared_claims.__setitem__(
            "uid-ok", PreparedClaimCP(state=STATE_PREPARE_COMPLETED)))

        def bad(c: Checkpoint):
            raise PermanentError("validate-before-mutate refusal")

        with pytest.raises(PermanentError):
            mgr.transact(bad)
        mgr.transact(lambda c: c.prepared_claims.__setitem__(
            "uid-after", PreparedClaimCP(state=STATE_PREPARE_COMPLETED)))
        assert set(mgr.read().prepared_claims) == {"uid-ok", "uid-after"}

    def test_transact_returns_mutation_value(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "cp.json"))
        assert mgr.transact(lambda c: len(c.prepared_claims)) == 0

    def test_flock_timeout_fails_whole_batch_without_stranding(
            self, tmp_path, monkeypatch):
        """A commit that cannot take the node flock (another process holds
        it past the budget) must fail EVERY queued transaction promptly —
        followers must not sit out COMMIT_WAIT_TIMEOUT with their
        mutations silently dropped."""
        import k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint as ck
        from k8s_dra_driver_tpu_torch.pkg.flock import Flock, FlockTimeout
        monkeypatch.setattr(ck, "COMMIT_FLOCK_TIMEOUT", 0.2)
        flock = Flock(str(tmp_path / "l"))
        mgr = CheckpointManager(str(tmp_path / "cp.json"), flock=flock)
        mgr.write(Checkpoint())
        # A second instance on the same path plays the other process.
        other = Flock(str(tmp_path / "l"))
        release = other.acquire(timeout=1.0)
        errors = []

        def txn(i):
            try:
                mgr.transact(lambda c: c.prepared_claims.__setitem__(
                    f"uid-{i}", PreparedClaimCP(
                        state=STATE_PREPARE_COMPLETED)))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        try:
            t0 = time.monotonic()
            threads = [threading.Thread(target=txn, args=(i,))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            elapsed = time.monotonic() - t0
        finally:
            release()
        assert len(errors) == 3
        assert all(isinstance(e, FlockTimeout) for e in errors), errors
        assert elapsed < 5, "followers were stranded waiting out the batch"
        # Nothing landed, and the manager recovers once the lock frees.
        mgr.transact(lambda c: c.prepared_claims.__setitem__(
            "uid-after", PreparedClaimCP(state=STATE_PREPARE_COMPLETED)))
        assert set(mgr.read().prepared_claims) == {"uid-after"}

    def test_failed_batch_leaves_no_phantom_state(self, tmp_path):
        """A mutation applied in memory whose batch WRITE then fails must
        not be visible to later transactions or reads — the commit cache
        is dropped with the failed batch."""
        from k8s_dra_driver_tpu_torch.pkg.faultpoints import InjectedFault
        mgr = CheckpointManager(str(tmp_path / "cp.json"))
        mgr.write(Checkpoint())
        with faultpoints.injected("checkpoint.replace=nth:1"):
            with pytest.raises(InjectedFault):
                mgr.transact(lambda c: c.prepared_claims.__setitem__(
                    "uid-phantom",
                    PreparedClaimCP(state=STATE_PREPARE_COMPLETED)))
        assert "uid-phantom" not in mgr.transact(
            lambda c: set(c.prepared_claims))
        assert "uid-phantom" not in mgr.read().prepared_claims


class TestConcurrentOverlapValidation:
    def test_racing_claims_for_same_gpu_cannot_both_win(self, tmp_path):
        """Two claims allocated (illegitimately) to the SAME GPU prepared
        concurrently: exactly one passes the registration transaction, the
        other gets the overlap refusal — never both. The refusal is
        RETRYABLE (a transient unprepare-window flavor exists), so the
        loser keeps failing through its whole (short) retry budget here."""
        client, driver = _cluster(tmp_path, retry_timeout=1.0)
        a = _alloc_claim(client, "wl-x")
        # Forge a second claim onto the same device (scheduler-race
        # artifact: the real allocator would refuse).
        gpu = a["status"]["allocation"]["devices"]["results"][0]["device"]
        b = client.create(new_object(
            "ResourceClaim", "wl-y", "default",
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{"name": "gpu"}]}}))
        b["status"] = {"allocation": {"devices": {"results": [{
            "request": "gpu", "driver": DRIVER,
            "pool": "node-a", "device": gpu}]}}}
        b = client.update_status(b)
        with faultpoints.injected("devicestate.prepare=latency:0.1"):
            spans = _run_overlapping_prepares(driver, [a, b])
        errors = [res.error for _, _, res in spans.values()]
        assert sum(1 for e in errors if e is None) == 1
        losers = [e for e in errors if e is not None]
        assert len(losers) == 1
        assert "refusing overlapping prepare" in str(losers[0])


class TestAllocatorIndexes:
    def _cluster(self):
        c = FakeClient()
        c.create({"apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
                  "metadata": {"name": "s1"},
                  "spec": {"driver": DRIVER,
                           "pool": {"name": "node-a"},
                           "devices": [{
                               "name": f"gpu-{i}",
                               "attributes": {"type": {"string": "gpu"}},
                               "capacity": {"memory": {"value": 80 << 30}}}
                               for i in range(4)]}})
        return c

    def _claim(self, c, name, count=1):
        return c.create({
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"devices": {"requests": [{"name": "r", "exactly": {
                "allocationMode": "ExactCount", "count": count,
                "selectors": [{"cel": {"expression":
                               "device.attributes['type'] == 'gpu'"}}]}}]}}})

    def test_indexes_hit_across_allocations(self):
        c = self._cluster()
        metrics = AllocatorMetrics()
        alloc = Allocator(c, metrics=metrics)
        self._claim(c, "a")
        self._claim(c, "b")
        alloc.allocate(c.get("ResourceClaim", "a", "default"))
        # Slice index: built once, reused (no ResourceSlice writes since).
        alloc.allocate(c.get("ResourceClaim", "b", "default"))
        assert metrics.cache_hits_total.value(cache="slices") >= 1
        assert metrics.cache_misses_total.value(cache="slices") == 1
        assert metrics.cache_hits_total.value(cache="candidates") >= 1
        # Usage: the allocator's own status write re-stamps in place, so
        # the second allocation is a hit despite the claim-create writes…
        # unless those creates intervened — both claims were created first,
        # so allocation b reads the stamped cache.
        assert metrics.cache_hits_total.value(cache="usage") >= 1

    def test_slice_write_invalidates_candidates(self):
        c = self._cluster()
        alloc = Allocator(c, metrics=AllocatorMetrics())
        for i in range(4):
            self._claim(c, f"w-{i}")
            alloc.allocate(c.get("ResourceClaim", f"w-{i}", "default"))
        # All 4 devices taken; a 5th claim must fail…
        from k8s_dra_driver_tpu_torch.kubeletplugin import AllocationError
        self._claim(c, "w-4")
        with pytest.raises(AllocationError):
            alloc.allocate(c.get("ResourceClaim", "w-4", "default"))
        # …until a NEW slice is published; the stale candidate index must
        # not hide it.
        c.create({"apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
                  "metadata": {"name": "s2"},
                  "spec": {"driver": DRIVER,
                           "pool": {"name": "node-b"},
                           "devices": [{
                               "name": "gpu-new",
                               "attributes": {"type": {"string": "gpu"}}}]}})
        got = alloc.allocate(c.get("ResourceClaim", "w-4", "default"))
        results = got["status"]["allocation"]["devices"]["results"]
        assert results[0]["device"] == "gpu-new"

    def test_release_invalidates_usage(self):
        c = self._cluster()
        alloc = Allocator(c, metrics=AllocatorMetrics())
        self._claim(c, "r-0")
        first = alloc.allocate(c.get("ResourceClaim", "r-0", "default"))
        held = first["status"]["allocation"]["devices"]["results"][0]["device"]
        alloc.release(first)
        self._claim(c, "r-1")
        second = alloc.allocate(c.get("ResourceClaim", "r-1", "default"))
        # The released device is allocatable again (stale usage would
        # consider it held and pick another).
        devs = {r["device"]
                for r in second["status"]["allocation"]["devices"]["results"]}
        assert held in devs or len(devs) == 1  # first candidate reused

    def test_selector_compile_cache(self):
        from k8s_dra_driver_tpu_torch.kubeletplugin.allocator import eval_selector
        from k8s_dra_driver_tpu_torch.pkg.metrics import default_allocator_metrics
        m = default_allocator_metrics()
        expr = "device.attributes['concurrency-test-unique'] == 'yes'"
        dev = {"attributes": {"concurrency-test-unique": "yes"}}
        h0 = m.cache_hits_total.value(cache="selector")
        mi0 = m.cache_misses_total.value(cache="selector")
        assert eval_selector(expr, dev)
        assert eval_selector(expr, dev)
        assert eval_selector(expr, dev)
        assert m.cache_misses_total.value(cache="selector") == mi0 + 1
        assert m.cache_hits_total.value(cache="selector") >= h0 + 2
