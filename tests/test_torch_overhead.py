"""The port's observability overhead legs and what they measure.

The JAX package's ``tests/test_telemetry.py::TestRunFleetwatch`` (its
short windows), ``tests/test_blackbox.py::TestProfiler``, the
``TestLockContention`` cases but ``test_tracked_lock_feeds_the_same_table``
(which waits for the sanitizer's ``TrackedLock``),
``test_overhead_harness_interleaves_cleanly`` and
``tests/test_canary.py::TestCanaryHarness::test_overhead_harness_smoke``,
with their assertions, on the port's ``run_fleetwatch``,
``run_blackbox_overhead``, ``run_canary_overhead``, profiler and lock
table. Then the chip smoke's ``overhead`` phase on mock nodes.
"""

import threading
import time

import pytest

from k8s_dra_driver_tpu_torch.internal.stresslab import (
    run_blackbox_overhead,
    run_canary_overhead,
    run_fleetwatch,
)
from k8s_dra_driver_tpu_torch.pkg import sanitizer, slo as slolib
from k8s_dra_driver_tpu_torch.pkg.blackbox import (
    BlackboxMetrics,
    ContinuousProfiler,
    attach_profiler_burst,
)

#: the JAX test's compressed fleetwatch windows
SHORT_FLEETWATCH = dict(baseline_s=0.5, clean_s=1.0, burst_s=1.8,
                        baseline2_s=0.3, n_nodes=2, workers_per_node=1)


class TestRunFleetwatch:
    def test_burst_fires_clean_stays_quiet(self):
        """Compressed: the telemetered clean arm is alert-free under scrape
        faults, the burst fires the fast-burn alert within the bound,
        everything clears, no leaks."""
        r = run_fleetwatch(**SHORT_FLEETWATCH)
        assert r["error_count"] == 0, r["errors"]
        assert not r["leaks"], r["leaks"]
        assert r["false_positives"] == 0, r["false_positive_samples"]
        assert r["fired_page"], r["transitions"]
        assert r["detection_delay_s"] <= r["detect_bound_s"]
        assert r["cleared"], r["transitions"]
        assert r["scrapes"]["error"] > 0  # the scrape leg fired
        assert r["scrapes"]["success"] > 0
        assert r["slo_events"]["high"] >= 1
        assert r["slo_events"]["cleared"] >= 1
        assert r["series_dropped"] == 0
        assert r["prepare_fault_failures"] > 0  # the prepare point fired


class TestProfiler:
    def test_samples_fold_running_threads(self):
        prof = ContinuousProfiler(metrics=BlackboxMetrics())
        done = threading.Event()

        def parked_worker():
            done.wait(5.0)

        t = threading.Thread(target=parked_worker, name="bb-test-worker",
                             daemon=True)
        t.start()
        try:
            assert prof.sample_once() > 0
            snap = prof.snapshot()
            stacks = [s["stack"] for s in snap["stacks"]]
            assert any("bb-test-worker" in s and "parked_worker" in s
                       for s in stacks)
            folded = prof.folded()
            assert all(line.rsplit(" ", 1)[1].isdigit()
                       for line in folded)
        finally:
            done.set()

    def test_stack_cap_is_counted_not_silent(self):
        m = BlackboxMetrics()
        prof = ContinuousProfiler(max_stacks=1, metrics=m)
        evs = [threading.Event() for _ in range(3)]

        def w0(ev=evs[0]):
            ev.wait(5.0)

        def w1(ev=evs[1]):
            ev.wait(5.0)

        def w2(ev=evs[2]):
            ev.wait(5.0)

        threads = [threading.Thread(target=f, daemon=True)
                   for f in (w0, w1, w2)]
        for t in threads:
            t.start()
        try:
            prof.sample_once()
            snap = prof.snapshot()
            assert snap["distinct_stacks"] == 1
            assert snap["dropped_stacks"] > 0
            assert m.profile_stacks_dropped_total.value() > 0
        finally:
            for ev in evs:
                ev.set()

    def test_burst_and_pause_modes(self):
        prof = ContinuousProfiler(metrics=BlackboxMetrics())
        prof.sample_once()
        prof.set_burst(True)
        prof.sample_once()
        snap = prof.snapshot()
        assert snap["burst"]
        assert snap["samples"]["base"] > 0
        assert snap["samples"]["burst"] > 0
        prof.pause()
        assert prof.snapshot()["paused"]
        prof.resume()
        assert not prof.snapshot()["paused"]

    def test_engine_subscription_drives_burst(self):
        engine = slolib.SloEngine(rules=None, slos=slolib.default_slos(),
                                  metrics=slolib.SloMetrics())
        prof = ContinuousProfiler(metrics=BlackboxMetrics())
        attach_profiler_burst(engine, prof)
        # Drive the state machine directly (evaluate() needs rules data;
        # the subscription contract is what is under test).
        engine._transition(engine.slos[0], engine.windows[0], "fired",
                           20.0, 16.0, 1.0)
        assert prof.snapshot()["burst"]
        engine._transition(engine.slos[0], engine.windows[0], "cleared",
                           0.0, 0.0, 2.0)
        assert not prof.snapshot()["burst"]

    def test_sampler_thread_runs_and_stops(self):
        prof = ContinuousProfiler(base_interval_s=0.01,
                                  metrics=BlackboxMetrics()).start()
        deadline = time.monotonic() + 2.0
        while (time.monotonic() < deadline
               and prof.snapshot()["samples"]["base"] == 0):
            time.sleep(0.01)
        prof.stop()
        assert prof.snapshot()["samples"]["base"] > 0


class TestLockContention:
    def setup_method(self):
        sanitizer.reset_lock_contention()
        sanitizer.set_lock_profiling(True)

    def teardown_method(self):
        sanitizer.set_lock_profiling(False)
        sanitizer.reset_lock_contention()

    def _contend(self, lock):
        acquired = threading.Event()
        release = threading.Event()

        def holder():
            with lock:
                acquired.set()
                release.wait(5.0)

        t = threading.Thread(target=holder, daemon=True)
        t.start()
        assert acquired.wait(5.0)
        timer = threading.Timer(0.05, release.set)
        timer.start()
        with lock:      # blocks ~50 ms behind the holder
            pass
        t.join(timeout=5.0)

    def test_contention_lock_records_blocked_waits(self):
        lock = sanitizer.ContentionLock("TestBB.lock")
        self._contend(lock)
        rows = sanitizer.lock_contention_snapshot()
        row = next(r for r in rows if r["lock"] == "TestBB.lock")
        assert row["waits"] >= 1
        assert row["wait_total_s"] > 0.0
        assert row["wait_max_s"] >= row["wait_total_s"] / row["waits"]

    def test_uncontended_acquire_records_nothing(self):
        lock = sanitizer.ContentionLock("TestBB.quiet")
        with lock:
            pass
        assert not any(r["lock"] == "TestBB.quiet"
                       for r in sanitizer.lock_contention_snapshot())

    def test_tracked_lock_feeds_the_same_table(self):
        lock = sanitizer.TrackedLock("TestBB.tracked")
        self._contend(lock)
        assert any(r["lock"] == "TestBB.tracked"
                   for r in sanitizer.lock_contention_snapshot())

    def test_new_lock_returns_contention_lock_while_profiling(self):
        lock = sanitizer.new_lock("TestBB.newlock", environ={})
        assert isinstance(lock, sanitizer.ContentionLock)
        sanitizer.set_lock_profiling(False)
        plain = sanitizer.new_lock("TestBB.plain", environ={})
        assert isinstance(plain, type(threading.Lock()))

    def test_disabled_flag_suppresses_recording(self):
        sanitizer.set_lock_profiling(False)
        lock = sanitizer.ContentionLock("TestBB.off")
        self._contend(lock)
        assert not any(r["lock"] == "TestBB.off"
                       for r in sanitizer.lock_contention_snapshot())


def test_overhead_harness_interleaves_cleanly():
    r = run_blackbox_overhead(cycles=60)
    assert r["error_count"] == 0, r["errors"]
    assert r["ops"]["off"] > 0 and r["ops"]["on"] > 0
    assert r["profiler_samples"]["base"] >= 0
    assert r["recorder_captures"] == 0  # passive without alerts


def test_canary_overhead_harness_smoke():
    r = run_canary_overhead(cycles=40, probe_every=4)
    assert r["error_count"] == 0, r["errors"]
    assert r["ops"]["off"] > 0 and r["ops"]["on"] > 0
    assert r["probes"] >= 1
    assert r["probe_failures"] == 0 and r["probe_leaked"] == 0
    assert r["meter_observe_failures"] == 0


def test_the_smokes_overhead_phase_on_mock_nodes(capsys):
    """``chip_smoke.phase_overhead`` as the card runs it, with the short
    fleetwatch windows and short overhead legs: the oracles hold, both
    injected points fired, and one ``overhead`` line is printed."""
    import chip_smoke

    out = chip_smoke.phase_overhead(
        "mock", fleetwatch=dict(SHORT_FLEETWATCH),
        blackbox=dict(cycles=40), canary=dict(cycles=40, probe_every=4))
    fw = out["fleetwatch"]
    assert fw["fired_page"] and fw["cleared"]
    assert fw["false_positives"] == 0
    assert out["canary"]["probes"] >= 1
    text = capsys.readouterr().out
    assert text.count("[overhead]") == 1 and "fired_page=True" in text


def test_the_smokes_overhead_phase_fails_on_a_missed_page(monkeypatch):
    """No fallback: a fleetwatch run whose page never fired fails the
    phase."""
    import chip_smoke

    def quiet(**kw):
        return {"fired_page": False, "detection_delay_s": None,
                "detect_bound_s": 2.5, "cleared": True, "clear_delay_s": 1.0,
                "clear_bound_s": 10.0, "false_positives": 0,
                "false_positive_samples": [], "prepare_fault_failures": 3,
                "scrapes": {"success": 9, "error": 2},
                "overhead": {"overhead_pct": 0.0}, "error_count": 0,
                "errors": [], "leaks": {}}

    monkeypatch.setattr(chip_smoke, "run_fleetwatch", quiet)
    with pytest.raises(SystemExit, match="page fired False"):
        chip_smoke.phase_overhead(
            "mock", fleetwatch=dict(SHORT_FLEETWATCH),
            blackbox=dict(cycles=4), canary=dict(cycles=4))
