"""The port's node-local primitives: the classes of the JAX package's
``tests/test_pkg.py`` that no other port test holds — ``TestFlock``,
``TestRateLimiters``, ``TestWorkQueue`` and ``TestWorkQueueWorkerPool`` —
on ``k8s_dra_driver_tpu_torch.pkg.flock`` and ``pkg.workqueue``; with them
the JAX package's ``TestTracedChurnSmoke`` (``tests/test_observability.py``)
and ``test_cross_kind_write_bench_runs`` (``tests/test_k8sclient.py``) on
the port's churn harness and ``FakeClient(sharded=False)``."""

import threading
import time

import pytest

from k8s_dra_driver_tpu_torch.pkg.errors import PermanentError
from k8s_dra_driver_tpu_torch.pkg.flock import Flock, FlockTimeout
from k8s_dra_driver_tpu_torch.pkg.workqueue import (
    BucketRateLimiter,
    ItemExponentialFailureRateLimiter,
    JitterRateLimiter,
    MaxOfRateLimiter,
    WorkQueue,
    default_prep_unprep_rate_limiter,
)


class FakeClock:
    """Deterministic clock: sleep() advances time instantly."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def sleep(self, dt):
        self.now += max(dt, 0.0)


class TestFlock:
    def test_exclusion_and_release(self, tmp_path):
        lock = Flock(str(tmp_path / "pu.lock"))
        release = lock.acquire()
        other = Flock(str(tmp_path / "pu.lock"))
        with pytest.raises(FlockTimeout):
            other.acquire(timeout=0.2, poll_period=0.02)
        release()
        release2 = other.acquire(timeout=1.0, poll_period=0.02)
        release2()

    def test_context_manager(self, tmp_path):
        lock = Flock(str(tmp_path / "x.lock"))
        with lock.held():
            with pytest.raises(FlockTimeout):
                Flock(str(tmp_path / "x.lock")).acquire(
                    timeout=0.1, poll_period=0.02)
        with lock.held(timeout=1.0):
            pass

    def test_cancel_event(self, tmp_path):
        lock = Flock(str(tmp_path / "c.lock"))
        release = lock.acquire()
        cancel = threading.Event()
        cancel.set()
        with pytest.raises(InterruptedError):
            lock.acquire(poll_period=0.01, cancel=cancel)
        release()

    def test_creates_parent_dir(self, tmp_path):
        lock = Flock(str(tmp_path / "deep" / "dir" / "f.lock"))
        lock.acquire()()


class TestRateLimiters:
    def test_item_exponential(self):
        lim = ItemExponentialFailureRateLimiter(0.25, 3.0)
        delays = [lim.when("a", 0.0) for _ in range(6)]
        assert delays == [0.25, 0.5, 1.0, 2.0, 3.0, 3.0]  # capped
        assert lim.when("b", 0.0) == 0.25  # independent per item
        lim.forget("a")
        assert lim.when("a", 0.0) == 0.25

    def test_bucket(self):
        lim = BucketRateLimiter(qps=5.0, burst=2)
        assert lim.when("x", 0.0) == 0.0
        assert lim.when("x", 0.0) == 0.0
        assert lim.when("x", 0.0) == pytest.approx(0.2)  # empty: 1/qps
        # After a second, tokens refill.
        assert lim.when("x", 10.0) == 0.0

    def test_max_of(self):
        lim = MaxOfRateLimiter(
            ItemExponentialFailureRateLimiter(1.0, 8.0),
            BucketRateLimiter(qps=1000.0, burst=1000))
        assert lim.when("k", 0.0) == 1.0  # expo dominates

    def test_jitter_bounds(self):
        import random
        lim = JitterRateLimiter(
            ItemExponentialFailureRateLimiter(1.0, 1.0), 0.5,
            rng=random.Random(42))
        for _ in range(20):
            d = lim.when("k", 0.0)
            assert 0.5 <= d <= 1.5


class TestWorkQueue:
    def _queue(self):
        clock = FakeClock()
        q = WorkQueue(default_prep_unprep_rate_limiter(),
                      clock=clock, sleep=clock.sleep)
        return q, clock

    def test_success_first_try(self):
        q, _ = self._queue()
        q.enqueue("claim-1", {"n": 1}, lambda obj: obj["n"] * 10)
        results, errors = q.run_until_deadline(45.0)
        assert results == {"claim-1": 10}
        assert errors == {}

    def test_retry_until_success(self):
        q, clock = self._queue()
        attempts = []

        def flaky(obj):
            attempts.append(clock())
            if len(attempts) < 4:
                raise RuntimeError("transient")
            return "ok"

        q.enqueue("c", None, flaky)
        results, errors = q.run_until_deadline(45.0)
        assert results == {"c": "ok"} and errors == {}
        assert len(attempts) == 4
        # Exponential spacing: gaps grow (0.25, 0.5, 1.0 between attempts).
        gaps = [b - a for a, b in zip(attempts, attempts[1:])]
        assert gaps[0] < gaps[1] < gaps[2]

    def test_permanent_error_short_circuits(self):
        q, _ = self._queue()
        calls = []

        def perma(obj):
            calls.append(1)
            raise PermanentError("bad config")

        q.enqueue("c", None, perma)
        results, errors = q.run_until_deadline(45.0)
        assert results == {}
        assert isinstance(errors["c"], PermanentError)
        assert len(calls) == 1  # not retried

    def test_wrapped_permanent_short_circuits(self):
        q, _ = self._queue()

        def perma(obj):
            try:
                raise PermanentError("root")
            except PermanentError as e:
                raise RuntimeError("wrapper") from e

        q.enqueue("c", None, perma)
        _, errors = q.run_until_deadline(45.0)
        assert "c" in errors

    def test_deadline_exhaustion(self):
        q, clock = self._queue()

        def always_fail(obj):
            raise RuntimeError("still broken")

        q.enqueue("c", None, always_fail)
        t0 = clock()
        results, errors = q.run_until_deadline(2.0)
        assert results == {}
        assert "still broken" in str(errors["c"])
        assert clock() - t0 <= 2.5  # bounded by the deadline

    def test_batch_mixed_outcomes(self):
        q, _ = self._queue()
        q.enqueue("good", None, lambda o: "ok")
        q.enqueue("bad", None,
                  lambda o: (_ for _ in ()).throw(PermanentError("no")))
        state = {"tries": 0}

        def eventually(obj):
            state["tries"] += 1
            if state["tries"] < 3:
                raise RuntimeError("wait")
            return "done"

        q.enqueue("slow", None, eventually)
        results, errors = q.run_until_deadline(45.0)
        assert results == {"good": "ok", "slow": "done"}
        assert set(errors) == {"bad"}

    def test_coalescing_same_key(self):
        q, _ = self._queue()
        seen = []
        q.enqueue("k", "old", lambda o: seen.append(o))
        q.enqueue("k", "new", lambda o: seen.append(o))
        q.run_until_deadline(45.0)
        assert seen == ["new"]  # newest object wins, ran once

    def test_threaded_run_mode(self):
        q = WorkQueue(default_prep_unprep_rate_limiter())
        done = threading.Event()
        q.enqueue("k", None, lambda o: done.set())
        t = threading.Thread(target=q.run, daemon=True)
        t.start()
        assert done.wait(5.0)
        q.shut_down()
        t.join(5.0)
        assert not t.is_alive()


class TestWorkQueueWorkerPool:
    """run(workers=N): client-go-style per-key exclusivity across a pool."""

    def _pool(self, workers=4):
        q = WorkQueue(default_prep_unprep_rate_limiter(), name="test-pool")
        t = threading.Thread(target=q.run, kwargs={"workers": workers},
                             daemon=True)
        t.start()
        return q, t

    def test_same_key_never_processed_concurrently(self):
        """A key enqueued repeatedly while its callback is mid-flight is
        never handed to a second worker — and still re-runs afterwards
        (the mid-flight event is parked, not dropped)."""
        q, t = self._pool(workers=4)
        mu = threading.Lock()
        active = {"n": 0, "max": 0, "runs": 0}
        started = threading.Event()

        def slow(obj):
            with mu:
                active["n"] += 1
                active["max"] = max(active["max"], active["n"])
                active["runs"] += 1
            started.set()
            time.sleep(0.1)
            with mu:
                active["n"] -= 1

        q.enqueue("cd/one", 1, slow, rate_limited=False)
        assert started.wait(5.0)
        # Mid-flight re-enqueues: must coalesce into exactly one more run.
        q.enqueue("cd/one", 2, slow, rate_limited=False)
        q.enqueue("cd/one", 3, slow, rate_limited=False)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and active["runs"] < 2:
            time.sleep(0.01)
        time.sleep(0.25)  # would expose a spurious third run / overlap
        q.shut_down()
        t.join(5.0)
        assert active["max"] == 1, "one key ran on two workers at once"
        assert active["runs"] == 2  # initial + exactly one parked re-queue

    def test_distinct_keys_overlap_across_workers(self):
        q, t = self._pool(workers=4)
        mu = threading.Lock()
        active = {"n": 0, "max": 0}
        done = threading.Barrier(5, timeout=10)

        def slow(obj):
            with mu:
                active["n"] += 1
                active["max"] = max(active["max"], active["n"])
            time.sleep(0.15)
            with mu:
                active["n"] -= 1
            done.wait()

        for i in range(4):
            q.enqueue(f"cd/{i}", i, slow, rate_limited=False)
        done.wait()  # all four callbacks completed
        q.shut_down()
        t.join(5.0)
        assert active["max"] >= 2, "worker pool never ran two keys at once"

    def test_mid_flight_enqueue_runs_newest_object(self):
        q, t = self._pool(workers=2)
        seen = []
        gate = threading.Event()

        def cb(obj):
            seen.append(obj)
            if not gate.is_set():
                gate.set()
                time.sleep(0.1)

        q.enqueue("k", "first", cb, rate_limited=False)
        assert gate.wait(5.0)
        q.enqueue("k", "stale", cb, rate_limited=False)
        q.enqueue("k", "newest", cb, rate_limited=False)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and len(seen) < 2:
            time.sleep(0.01)
        q.shut_down()
        t.join(5.0)
        assert seen == ["first", "newest"]  # coalesced onto the newest

    def test_failed_retry_yields_to_newer_mid_flight_enqueue(self):
        """A retryable failure's re-enqueue must not clobber a NEWER
        object enqueued while the failing run was mid-flight — the fresh
        object supersedes the stale retry, never the reverse."""
        q, t = self._pool(workers=2)
        seen = []
        gate = threading.Event()

        def cb(obj):
            seen.append(obj)
            if obj == "v1":
                gate.set()
                time.sleep(0.1)  # v2 arrives while v1 is mid-flight
                raise RuntimeError("transient failure of v1")

        q.enqueue("k", "v1", cb, rate_limited=False)
        assert gate.wait(5.0)
        q.enqueue("k", "v2", cb, rate_limited=False)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and "v2" not in seen:
            time.sleep(0.01)
        time.sleep(0.3)  # a stale v1 retry would land in this window
        q.shut_down()
        t.join(5.0)
        assert seen == ["v1", "v2"]  # v2 superseded v1's retry

    def test_idle_enqueue_wakes_promptly(self):
        """Lost-wakeup regression: with the wake event cleared before the
        queue scan, an enqueue into an idle (wait-parked) pool is picked up
        immediately — never parked for the 0.2 s poll tick."""
        q, t = self._pool(workers=2)
        time.sleep(0.3)  # workers are now parked in wait()
        done = threading.Event()
        t0 = time.monotonic()
        q.enqueue("k", None, lambda o: done.set(), rate_limited=False)
        assert done.wait(5.0)
        elapsed = time.monotonic() - t0
        q.shut_down()
        t.join(5.0)
        assert elapsed < 0.15, f"idle enqueue took {elapsed:.3f}s (poll tick?)"

    def test_depth_latency_duration_metrics(self):
        from k8s_dra_driver_tpu_torch.pkg.metrics import WorkQueueMetrics
        m = WorkQueueMetrics()
        clock = FakeClock()
        q = WorkQueue(default_prep_unprep_rate_limiter(),
                      clock=clock, sleep=clock.sleep,
                      name="metered", metrics=m)
        q.enqueue("a", None, lambda o: "ok")
        assert m.depth.value(queue="metered") == 1.0
        q.run_until_deadline(45.0)
        assert m.depth.value(queue="metered") == 0.0
        assert m.queue_latency_seconds.count(queue="metered") == 1
        assert m.work_duration_seconds.count(queue="metered") == 1
        text = m.registry.expose_text()
        assert "gpu_dra_workqueue_depth" in text
        assert "gpu_dra_workqueue_queue_latency_seconds" in text
        assert "gpu_dra_workqueue_work_duration_seconds" in text


class TestTracedChurnSmoke:
    def test_short_traced_churn_complete(self):
        """Every churn claim yields a complete, well-formed trace with a
        per-phase breakdown."""
        from k8s_dra_driver_tpu_torch.internal.stresslab import (
            run_claim_churn,
        )
        from k8s_dra_driver_tpu_torch.pkg import tracing

        r = run_claim_churn(duration_s=1.0, n_nodes=2, workers_per_node=1,
                            trace=True)
        assert not tracing.enabled()
        assert r["error_count"] == 0, r["errors"]
        assert not r["leaks"], r["leaks"]
        t = r["tracing"]
        assert t["traces"] > 0
        assert t["complete"] == t["traces"], t["audit_problems"]
        assert t["dropped_spans"] == 0
        assert {"allocate", "prepare", "total"} <= set(t["phases"])


# The shard-vs-single-lock comparison at this tiny scale: an arm lasts
# 30-60 ms, so one stall of the process under load (a busy host, a
# neighbouring test process) can double it. Three alternating rounds, of
# which each arm keeps its fastest, outlast such a stall.
CROSS_KIND_ARGS = {"n_kinds": 2, "writes_per_kind": 40,
                   "commit_hold_s": 0.0005, "rounds": 3}


class TestInformerResume:
    def test_cross_kind_write_bench_runs(self):
        """The same-run shard-vs-single-lock comparison (a soft floor at
        this tiny scale)."""
        from k8s_dra_driver_tpu_torch.internal.stresslab import (
            run_cross_kind_writes,
        )
        out = run_cross_kind_writes(**CROSS_KIND_ARGS)
        assert out["single_lock_s"] > 0 and out["sharded_s"] > 0
        assert out["speedup"] > 1.2, out

    def test_cross_kind_floor_outlasts_one_stalled_arm(self, monkeypatch):
        """A 50 ms stall of the first sharded arm, as a starved process
        sees it: the comparison keeps each arm's fastest round, so the
        floor holds."""
        import sys

        from k8s_dra_driver_tpu_torch.internal import stresslab

        real = time.perf_counter
        calls = [0]

        def stalled():
            # Only the arms' own clock reads count: the first sharded arm
            # ends at the fourth.
            if sys._getframe(1).f_code.co_name == "one":
                calls[0] += 1
                if calls[0] >= 4:
                    return real() + 0.05
            return real()
        monkeypatch.setattr(stresslab.time, "perf_counter", stalled)
        out = stresslab.run_cross_kind_writes(**CROSS_KIND_ARGS)
        assert calls[0] == 4 * CROSS_KIND_ARGS["rounds"]
        assert out["speedup"] > 1.2, out

    def test_single_lock_store_keeps_kinds_apart(self):
        """``FakeClient(sharded=False)`` puts every kind in one shard:
        lists, watches and generations still see only their own kind."""
        from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
        from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
        client = FakeClient(sharded=False)
        w = client.watch("ConfigMap")
        client.create(new_object("ConfigMap", "a"))
        client.create(new_object("Secret", "a"))
        assert [o["kind"] for o in client.list("ConfigMap")] == ["ConfigMap"]
        assert [o["kind"] for o in client.list("Secret")] == ["Secret"]
        ev = w.next(timeout=1.0)
        assert ev.object["kind"] == "ConfigMap"
        assert w.next(timeout=0.05) is None
        assert client.kind_generation("ConfigMap", "Secret") == (1, 1)
        assert client.watch_events_delivered() == 1
        w.stop()
