"""The port's race detector and schedule fuzzer (``pkg/racelab.py``) and its
planted-race corpus (``internal/racecorpus.py``), held against the JAX
package's ``tests/test_racelab.py`` case for case: every planted positive
is reported (with both stacks, deduplicated, bounded), every negative —
each exercising one happens-before edge source (mutex, thread create/join,
hand-off channel, Timer arming) — produces ZERO findings, and the fuzzer's
decision log is a pure function of its seed. Then against the JAX package
itself: the corpus's verdict per scenario on seeds 1-3 (JAX's run in a
child process, so that only one detector is on in a process), and one
seeded preemption sequence through both fuzzers. The port's Thread hooks
and the JAX package's coexist in one process, each on while the other is
off. Last, the port's threaded suites re-run under
``GPU_DRA_SANITIZE=race`` with the port's guard."""

import json
import os
import subprocess
import sys
import threading

import pytest

from k8s_dra_driver_tpu.pkg import racelab as jax_racelab
from k8s_dra_driver_tpu_torch.internal import racecorpus
from k8s_dra_driver_tpu_torch.pkg import racelab, sanitizer
from k8s_dra_driver_tpu_torch.pkg.sanitizer import TrackedLock
from tests.test_torch_sanitizer import ROOT, SANITIZED_SUITES, run_sanitized


@pytest.fixture()
def race():
    """Detector on for the test, state clean on both sides; restores the
    prior activation (the suite itself may be running in race mode)."""
    was_active = racelab.active()
    racelab.enable()
    racelab.reset()
    yield racelab
    racelab.reset()
    if not was_active:
        racelab.disable()


def _run(*fns):
    ts = []
    for fn in fns:
        t = threading.Thread(target=fn)
        ts.append(t)
        t.start()
    for t in ts:
        t.join()


class TestDetectorPositives:
    def test_unordered_writes_reported_with_both_stacks(self, race):
        d = racelab.TrackedDict("t.ww")
        _run(lambda: d.__setitem__("k", 1), lambda: d.__setitem__("k", 2))
        reps = racelab.reports()
        assert reps, "two unordered writes to one key must be a race"
        rep = reps[0]
        assert rep["current"]["stack"] and rep["previous"]["stack"]
        assert rep["current"]["tid"] != rep["previous"]["tid"]
        assert rep["kind"] in ("write-write", "read-write", "write-read")
        racelab.reset()

    def test_unjoined_publication_reported(self, race):
        """A child's write read by the parent with no join() in between
        races whichever side physically lands first — the HB property."""
        d = racelab.TrackedDict("t.unjoined")
        wrote = threading.Event()
        t = threading.Thread(target=lambda: (d.__setitem__("k", 1),
                                             wrote.set()))
        t.start()
        wrote.wait(2.0)     # physical order only; Event is NOT an HB edge
        d.get("k")
        t.join()            # cleanup — the read above already raced
        assert racelab.reports()
        racelab.reset()

    def test_note_cells_race(self, race):
        """Explicit note_read/note_write instrumentation (state no
        wrapper fits) feeds the same epochs."""
        cell = sanitizer.new_cell("t.cell")
        _run(lambda: sanitizer.note_write(cell),
             lambda: sanitizer.note_write(cell))
        assert any(r["kind"] == "write-write" for r in racelab.reports())
        racelab.reset()

    def test_tracked_set_unordered_add(self, race):
        s = racelab.TrackedSet("t.set")
        _run(lambda: s.add("x"), lambda: s.add("x"))
        assert racelab.reports()
        racelab.reset()

    def test_dedup_bumps_count_not_reports(self, race):
        """The same racing pair from the same two sites is ONE report
        whose count grows — 10k hits of one bug must not evict 199
        other bugs (bounded + counted, never silent)."""
        d = racelab.TrackedDict("t.dedup")

        def hammer():
            for _ in range(50):
                d["k"] = 1

        _run(hammer, hammer)
        reps = racelab.reports()
        summary = racelab.report_summary()
        assert summary["race_hits"] >= len(reps)
        # Everything reported came from the one loop line per thread.
        assert len(reps) <= 4
        racelab.reset()

    def test_one_site_pair_many_keys_is_one_report(self, race):
        """Dedup is per SITE PAIR, not per cell: one racy loop over 50
        claim uids must not burn 50 of the MAX_REPORTS slots."""
        d = racelab.TrackedDict("t.manykeys", {f"u{i}": 0 for i in range(50)})

        def hammer():
            for i in range(50):
                d[f"u{i}"] = 1

        _run(hammer, hammer)
        reps = racelab.reports()
        assert reps
        # At most one report per race KIND for the single site pair.
        assert len(reps) <= 3, [r["cell"] for r in reps]
        racelab.reset()

    def test_reports_bounded_and_counted(self, race, monkeypatch):
        monkeypatch.setattr(racelab, "MAX_REPORTS", 1)
        d1 = racelab.TrackedDict("t.bound1")
        d2 = racelab.TrackedDict("t.bound2")
        # Two distinct racing structures; only one report fits the bound.
        _run(lambda: d1.__setitem__("k", 1), lambda: d1.__setitem__("k", 2))
        _run(lambda: d2.__setitem__("k", 1), lambda: d2.__setitem__("k", 2))
        assert len(racelab.reports()) == 1
        assert racelab.report_summary()["reports_dropped"] >= 1
        racelab.reset()


class TestDetectorNegatives:
    def test_lock_ordered_writes_clean(self, race):
        lk = TrackedLock("t.neg.lk")
        d = racelab.TrackedDict("t.neg.locked")

        def worker():
            for _ in range(5):
                with lk:
                    d["n"] = d.get("n", 0) + 1

        _run(worker, worker, worker)
        assert racelab.reports() == []

    def test_join_edge_clean(self, race):
        d = racelab.TrackedDict("t.neg.join")
        t = threading.Thread(target=lambda: d.__setitem__("k", 1))
        t.start()
        t.join()
        d["k"] = d.get("k", 0) + 1      # ordered: child end -> join return
        assert racelab.reports() == []

    def test_start_edge_clean(self, race):
        """Everything the parent wrote before start() is visible to the
        child: thread create is an HB edge."""
        d = racelab.TrackedDict("t.neg.start")
        d["cfg"] = 1
        t = threading.Thread(target=lambda: d.get("cfg"))
        t.start()
        t.join()
        assert racelab.reports() == []

    def test_channel_handoff_clean(self, race):
        """hb_send/hb_recv order a publication with no common lock and
        no join — the workqueue/informer hand-off shape."""
        d = racelab.TrackedDict("t.neg.chan")
        sent = threading.Event()

        def producer():
            d["payload"] = 42
            racelab.hb_send(("ch", "t"))
            sent.set()

        t = threading.Thread(target=producer)
        t.start()
        sent.wait(2.0)      # physical order; the EDGE comes from the recv
        racelab.hb_recv(("ch", "t"))
        d.get("payload")
        t.join()
        assert racelab.reports() == []

    def test_recv_without_send_establishes_nothing(self, race):
        """An hb_recv on an unknown channel must not invent an ordering:
        the unjoined publication still races."""
        d = racelab.TrackedDict("t.neg.norecv")
        wrote = threading.Event()
        t = threading.Thread(target=lambda: (d.__setitem__("k", 1),
                                             wrote.set()))
        t.start()
        wrote.wait(2.0)
        racelab.hb_recv(("ch", "never-sent"))
        d.get("k")
        t.join()
        assert racelab.reports()
        racelab.reset()

    def test_timer_edge_clean(self, race):
        d = racelab.TrackedDict("t.neg.timer")
        d["armed"] = 1
        t = threading.Timer(0.01, lambda: d.get("armed"))
        t.start()
        t.join()
        assert racelab.reports() == []

    def test_distinct_keys_do_not_conflict(self, race):
        """Per-key cells: two threads writing different EXISTING keys is
        not a race (the key set is untouched)."""
        d = racelab.TrackedDict("t.neg.keys", {"a": 0, "b": 0})
        _run(lambda: d.__setitem__("a", 1), lambda: d.__setitem__("b", 1))
        assert racelab.reports() == []

    def test_concurrent_inserts_race_structurally(self, race):
        """...but two concurrent INSERTS mutate the key set: an iteration
        racing either one would see a dict changing size."""
        d = racelab.TrackedDict("t.pos.keys")
        _run(lambda: d.__setitem__("a", 1), lambda: d.__setitem__("b", 1))
        assert any("<keys>" in r["cell"] for r in racelab.reports())
        racelab.reset()


class TestActivationAndWrappers:
    def test_inactive_is_silent(self):
        was_active = racelab.active()
        racelab.disable()
        try:
            d = racelab.TrackedDict("t.off")
            _run(lambda: d.__setitem__("k", 1),
                 lambda: d.__setitem__("k", 2))
            assert racelab.reports() == []
        finally:
            if was_active:
                racelab.enable()

    def test_track_state_passthrough_off_wrapped_on(self):
        plain = sanitizer.track_state({"a": 1}, "t.ts", environ={})
        assert type(plain) is dict
        wrapped = sanitizer.track_state(
            {"a": 1}, "t.ts", environ={sanitizer.ENV_SANITIZE: "race"})
        assert isinstance(wrapped, racelab.TrackedDict)
        assert wrapped == {"a": 1}
        wrapped_set = sanitizer.track_state(
            {1, 2}, "t.ts2", environ={sanitizer.ENV_SANITIZE: "race"})
        assert isinstance(wrapped_set, racelab.TrackedSet)

    def test_race_enabled_parsing(self):
        assert sanitizer.race_enabled({sanitizer.ENV_SANITIZE: "race"})
        assert sanitizer.enabled({sanitizer.ENV_SANITIZE: "race"})
        assert not sanitizer.race_enabled({sanitizer.ENV_SANITIZE: "1"})
        assert not sanitizer.race_enabled({"TPU_DRA_SANITIZE": "race"})
        assert not sanitizer.race_enabled({})

    def test_guarded_dict_race_mode_keeps_guard_contract(self, race):
        """The race-mode guarded_dict still asserts guarded mutation —
        detection REPLACES nothing, it adds the read side."""
        env = {sanitizer.ENV_SANITIZE: "race"}
        lk = sanitizer.new_lock("t.gd.lk", environ=env)
        d = sanitizer.guarded_dict(lk, "t.gd", environ=env)
        assert isinstance(d, racelab.TrackedDict)
        sanitizer.reset()
        with lk:
            d["ok"] = 1                 # guarded: fine
        with pytest.raises(sanitizer.SanitizerError,
                           match="unguarded mutation"):
            d["bad"] = 2                # unguarded mutation raises, same
            #                             contract as GuardedDict
        assert any("unguarded mutation" in v
                   for v in sanitizer.violations())
        sanitizer.reset()
        racelab.reset()

    def test_new_cell_identities_never_reused(self):
        a = sanitizer.new_cell("t.same-name")
        b = sanitizer.new_cell("t.same-name")
        assert a != b


class TestScheduleFuzzer:
    def test_decisions_are_pure_function_of_seed(self):
        def drive(seed):
            f = racelab.ScheduleFuzzer(seed=seed, max_sleep_s=0.0)
            for p in ("a", "b", "c"):
                for _ in range(60):
                    f.preempt(p)
            return f.log()

        assert drive(7) == drive(7)
        assert drive(7) != drive(8)

    def test_preempt_fires_at_tracked_lock_acquire(self):
        with racelab.fuzz(seed=1, yield_rate=1.0, max_sleep_s=0.0) as fz:
            lk = TrackedLock("t.fz.lk")
            with lk:
                pass
        assert ("t.fz.lk", 1, "yield") in fz.log()
        sanitizer.reset()

    def test_fuzz_context_restores_previous(self):
        outer = racelab.ScheduleFuzzer(seed=1)
        prev = racelab.set_fuzzer(outer)
        try:
            with racelab.fuzz(seed=2):
                assert racelab.current_fuzzer() is not outer
            assert racelab.current_fuzzer() is outer
        finally:
            racelab.set_fuzzer(prev)

    def test_no_fuzzer_is_noop(self):
        assert racelab.current_fuzzer() is None
        racelab.maybe_preempt("t.nofz")     # must not raise

    def test_reprio_rate_sets_the_share_of_priority_changes(self):
        def reprios(rate):
            f = racelab.ScheduleFuzzer(seed=4, yield_rate=0.0,
                                       max_sleep_s=0.0, reprio_rate=rate)
            for _ in range(200):
                f.preempt("p")
            return sum(1 for e in f.log() if e[2] == "reprio")

        assert reprios(0.0) == 0
        assert reprios(1.0) == 200
        assert 0 < reprios(0.02) < 20


class TestPlantedCorpus:
    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_full_detection_zero_false_positives(self, race, seed):
        """The acceptance bar: 100% of planted positives detected, zero
        findings on the negative set, per seed."""
        corpus = racecorpus.run_corpus(seed)
        bad = [s for s in corpus["scenarios"] if not s["ok"]]
        assert not bad, bad
        assert corpus["positives_detected"] == corpus["positives_total"]
        assert corpus["false_positives"] == 0

    def test_same_seed_same_log_same_verdict(self, race):
        a = racecorpus.run_corpus(5)
        b = racecorpus.run_corpus(5)
        assert a["fuzz_log"] == b["fuzz_log"]
        assert ([s["detected"] for s in a["scenarios"]]
                == [s["detected"] for s in b["scenarios"]])

    def test_race_smoke(self):
        """The smoke the card runs: every positive on seeds 1-3, no false
        positive, a race-free and leak-free claim churn in race mode, the
        fuzzer deterministic, and the environment restored."""
        before = os.environ.get(sanitizer.ENV_SANITIZE)
        r = racecorpus.run_race_smoke(churn_s=0.4)
        assert r["all_positives_detected"] and r["false_positives"] == 0
        assert r["churn_races"] == 0 and r["churn_errors"] == 0
        assert not r["churn_leaks"] and r["deterministic"]
        assert all(s["churn"]["cells"] > 0 for s in r["per_seed"])
        assert os.environ.get(sanitizer.ENV_SANITIZE) == before
        assert not racelab.active()


_JAX_CORPUS = r"""
import json
from k8s_dra_driver_tpu.internal import racecorpus
from k8s_dra_driver_tpu.pkg import racelab
racelab.enable()
print(json.dumps({s: [[r["scenario"], r["detected"]]
                      for r in racecorpus.run_corpus(s)["scenarios"]]
                  for s in (1, 2, 3)}))
"""


class TestAgainstJax:
    def test_corpus_verdicts_match_jax(self, race):
        """Scenario for scenario, seed for seed, the port's detector flags
        exactly what the JAX package's flags (JAX's in a child process, so
        one detector is on in each process)."""
        proc = subprocess.run(
            [sys.executable, "-c", _JAX_CORPUS], cwd=ROOT,
            capture_output=True, text=True, timeout=120,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert proc.returncode == 0, proc.stderr[-2000:]
        want = json.loads(proc.stdout.strip().splitlines()[-1])
        got = {str(s): [[r["scenario"], r["detected"]]
                        for r in racecorpus.run_corpus(s)["scenarios"]]
               for s in (1, 2, 3)}
        assert got == want
        assert [n for n, _, _ in racecorpus.SCENARIOS] == \
            [n for n, _ in want["1"]]

    @pytest.mark.parametrize("seed", [0, 7, 11])
    def test_fuzzer_log_matches_jax(self, seed):
        """One preemption sequence (detector off: every thread shares
        tid 0) through both fuzzers gives the same decision log."""
        logs = []
        for mod in (racelab, jax_racelab):
            f = mod.ScheduleFuzzer(seed=seed, max_sleep_s=0.0,
                                   reprio_rate=0.1)
            for i in range(300):
                f.preempt(("WorkQueue._lock", "checkpoint.write",
                           "k8sclient.fake.read")[i % 3])
            logs.append(f.log())
        assert logs[0] == logs[1] and logs[0]

    def test_hooks_coexist_with_the_jax_detectors(self):
        """Whichever package's Thread hooks went on first, each detector
        keeps its start/join edges while it alone is on."""
        jax_was, port_was = jax_racelab.active(), racelab.active()
        jax_racelab.disable()
        racelab.disable()
        try:
            for mod in (racelab, jax_racelab, racelab):
                mod.enable()
                mod.reset()
                d = mod.TrackedDict("t.coexist")
                d["k"] = 1
                t = threading.Thread(target=lambda: d.__setitem__("k", 2))
                t.start()
                t.join()
                d["k"] = 3
                timer = threading.Timer(0.01, lambda: d.get("k"))
                timer.start()
                timer.join()
                assert mod.reports() == [], mod.__name__
                mod.reset()
                mod.disable()
        finally:
            if jax_was:
                jax_racelab.enable()
            if port_was:
                racelab.enable()


class TestRaceMode:
    def test_threaded_suites_pass_race_mode(self):
        """Re-run the port's threaded suites with GPU_DRA_SANITIZE=race:
        every tracked structure feeds the detector and the port's guard
        fails any test that leaves a race report behind."""
        proc = run_sanitized(SANITIZED_SUITES, "race")
        assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
        assert " passed" in proc.stdout


def test_the_smokes_race_phase_on_a_mock_node(tmp_path, monkeypatch, capsys):
    """``chip_smoke.phase_race`` as the card runs it, on a mock node of one
    GPU with a small CPU engine: the race smoke, then the claim served in
    race mode with no race report or violation, the environment and the
    detector restored."""
    import chip_smoke
    from k8s_dra_driver_tpu_torch.compute import _build
    from tests.test_torch_crashlab import SMALL_CHECK_WIDTH, _one_gpu_node

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    before = os.environ.get(sanitizer.ENV_SANITIZE)
    lib, gpu = _one_gpu_node()
    out = chip_smoke.phase_race("mock", 0, lib, gpu, width={
        **SMALL_CHECK_WIDTH, "uuids": {gpu.uuid: 0}}, churn_s=0.3)
    assert out["reports"] == [] and out["violations"] == []
    assert out["cells"] > 0 and out["fuzz_decisions"] > 0
    assert out["launches"] == 0 and out["decode_steps"] > 0  # plain on CPU
    assert out["residue"] == [] and out["max_abs_err"] is None
    assert os.environ.get(sanitizer.ENV_SANITIZE) == before
    assert not racelab.active()
    text = capsys.readouterr().out
    assert text.count("[race]") == 2 and "races=0" in text


def test_the_smokes_race_phase_holds_the_corpus(monkeypatch):
    """No fallback: a smoke with a false positive fails the phase before
    the card's claim."""
    import chip_smoke
    from tests.test_torch_crashlab import SMALL_CHECK_WIDTH, _one_gpu_node

    def noisy(**kw):
        return dict(racecorpus.run_race_smoke(**kw), false_positives=1)

    monkeypatch.setattr(chip_smoke, "run_race_smoke", noisy)
    lib, gpu = _one_gpu_node()
    with pytest.raises(SystemExit, match="race: corpus"):
        chip_smoke.phase_race("mock", 0, lib, gpu, width={
            **SMALL_CHECK_WIDTH, "uuids": {gpu.uuid: 0}}, seeds=(1,),
            churn_s=0.2)
