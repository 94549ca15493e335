"""The port's runtime lock sanitizer (``pkg/sanitizer.py``), held against
the JAX package's ``tests/test_sanitizer.py`` case for case: the lock-order
graph, guarded mutations, the factories and their ``GPU_DRA_SANITIZE``
switch, and the sanitizer-mode re-run of the port's threaded suites under
the port's own pytest guard (``internal/sanitizer_guard.py``). Beside them:
the frozen watch snapshots that ``FakeClient`` delivers under the
sanitizer, one sequence of acquisitions through both packages' lock-order
graphs giving the same violations, and a run that shows the guard failing
a test that leaves a violation behind."""

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from k8s_dra_driver_tpu.pkg import sanitizer as jax_sanitizer
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.pkg import sanitizer
from k8s_dra_driver_tpu_torch.pkg.sanitizer import (
    FrozenDict,
    FrozenList,
    GuardedDict,
    SanitizerError,
    TrackedLock,
)

ROOT = Path(__file__).resolve().parent.parent

# The port files that hold the JAX package's SANITIZED_SUITES
# (tests/test_pkg.py, test_k8sclient.py, test_claimwatcher.py), re-run with
# GPU_DRA_SANITIZE set by TestSanitizerMode here and TestRaceMode in
# tests/test_torch_racelab.py. This file is deliberately absent.
SANITIZED_SUITES = ["tests/test_torch_pkg.py", "tests/test_torch_k8sclient.py",
                    "tests/test_torch_claimwatcher_restart.py"]
GUARD = "k8s_dra_driver_tpu_torch.internal.sanitizer_guard"


def run_sanitized(paths: list, mode: str, cwd: Path = ROOT,
                  timeout: float = 420) -> subprocess.CompletedProcess:
    """``paths`` in a child pytest under ``GPU_DRA_SANITIZE=mode`` with the
    port's guard loaded."""
    return subprocess.run(
        [sys.executable, "-m", "pytest", *paths, "-q", "-m", "not slow",
         "-p", "no:cacheprovider", "-p", GUARD],
        cwd=cwd, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": str(ROOT),
             sanitizer.ENV_SANITIZE: mode, "JAX_PLATFORMS": "cpu"})


@pytest.fixture(autouse=True)
def _fresh_graph():
    sanitizer.reset()
    yield
    sanitizer.reset()


class TestTrackedLock:
    def test_consistent_order_is_fine(self):
        a, b = TrackedLock("t1.a"), TrackedLock("t1.b")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert sanitizer.violations() == []

    def test_inversion_detected(self):
        a, b = TrackedLock("t2.a"), TrackedLock("t2.b")
        with a:
            with b:
                pass
        with pytest.raises(SanitizerError, match="lock-order inversion"):
            with b:
                with a:
                    pass
        assert any("inversion" in v for v in sanitizer.violations())

    def test_transitive_inversion_detected(self):
        a, b, c = (TrackedLock("t3.a"), TrackedLock("t3.b"),
                   TrackedLock("t3.c"))
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with pytest.raises(SanitizerError):
            with c:
                with a:
                    pass

    def test_reentrant_reacquire_no_self_edge(self):
        r = TrackedLock("t4.r", reentrant=True)
        with r:
            with r:
                pass
        assert sanitizer.violations() == []

    def test_held_by_current_thread(self):
        a = TrackedLock("t5.a")
        assert not a.held_by_current_thread()
        with a:
            assert a.held_by_current_thread()
            seen_in_other = {}

            def peek():
                seen_in_other["held"] = a.held_by_current_thread()

            t = threading.Thread(target=peek)
            t.start()
            t.join()
            assert seen_in_other["held"] is False
        assert not a.held_by_current_thread()

    def test_inversion_across_threads_detected(self):
        """The order graph is global: thread 1 records a→b, thread 2's
        b→a attempt trips even though neither thread deadlocks alone."""
        a, b = TrackedLock("t6.a"), TrackedLock("t6.b")
        errs = []

        def first():
            with a:
                with b:
                    pass

        t = threading.Thread(target=first)
        t.start()
        t.join()

        def second():
            try:
                with b:
                    with a:
                        pass
            except SanitizerError as e:
                errs.append(e)

        t2 = threading.Thread(target=second)
        t2.start()
        t2.join()
        assert errs


#: Sequences of nested acquisitions (outer, inner) by lock name.
ORDER_SEQUENCES = {
    "consistent": [("a", "b"), ("a", "b"), ("b", "c")],
    "direct": [("a", "b"), ("b", "a")],
    "transitive": [("a", "b"), ("b", "c"), ("c", "a")],
    "reentrant": [("a", "a"), ("a", "b")],
}


def _violations_of(mod, seq: list) -> list:
    mod.reset()
    locks = {n: mod.TrackedLock(f"diff.{n}", reentrant=True)
             for pair in seq for n in pair}
    for outer, inner in seq:
        try:
            with locks[outer]:
                with locks[inner]:
                    pass
        except mod.SanitizerError:
            pass
    out = mod.violations()
    mod.reset()
    return out


@pytest.mark.parametrize("name", sorted(ORDER_SEQUENCES))
def test_order_graph_matches_jax(name):
    """The same acquisitions through both packages' TrackedLocks record
    the same violations, word for word."""
    seq = ORDER_SEQUENCES[name]
    got = _violations_of(sanitizer, seq)
    assert got == _violations_of(jax_sanitizer, seq)
    assert bool(got) == (name in ("direct", "transitive"))


class TestGuardedDict:
    def test_mutation_without_lock_raises(self):
        lk = TrackedLock("g1.lk")
        d = GuardedDict(lk, "g1.d")
        with pytest.raises(SanitizerError, match="unguarded mutation"):
            d["k"] = 1
        assert any("g1.d" in v for v in sanitizer.violations())

    def test_mutation_under_lock_ok(self):
        lk = TrackedLock("g2.lk")
        d = GuardedDict(lk, "g2.d")
        with lk:
            d["k"] = 1
            d.update(x=2)
            d.setdefault("y", 3)
            assert d.pop("k") == 1
            d.clear()
        assert sanitizer.violations() == []

    def test_reads_unchecked(self):
        lk = TrackedLock("g3.lk")
        d = GuardedDict(lk, "g3.d")
        with lk:
            d["k"] = 1
        assert d.get("k") == 1 and "k" in d and list(d) == ["k"]
        assert sanitizer.violations() == []


class TestFrozenSnapshots:
    @pytest.mark.parametrize("mutate", [
        lambda o: o.__setitem__("x", 1),
        lambda o: o.pop("metadata"),
        lambda o: o.update(x=1),
        lambda o: o.__ior__({"x": 1}),
        lambda o: o.setdefault("x", 1),
        lambda o: o["metadata"].__setitem__("name", "y"),
        lambda o: o["spec"]["items"].append(4),
        lambda o: o["spec"]["items"].sort(),
    ])
    def test_every_mutation_raises(self, mutate):
        obj = sanitizer.deep_freeze({"metadata": {"name": "n"},
                                     "spec": {"items": [3, 1, 2]}})
        with pytest.raises(SanitizerError, match="shared watch snapshot"):
            mutate(obj)
        assert obj == {"metadata": {"name": "n"}, "spec": {"items": [3, 1, 2]}}

    def test_reads_and_read_only_setdefault_pass(self):
        obj = sanitizer.deep_freeze({"a": [1, {"b": 2}]})
        assert isinstance(obj, FrozenDict)
        assert isinstance(obj["a"], FrozenList)
        assert obj.setdefault("a") == [1, {"b": 2}]
        assert obj == {"a": [1, {"b": 2}]} and sanitizer.violations() == []

    def test_fanout_delivers_frozen_copies_under_the_sanitizer(
            self, monkeypatch):
        """Under ``GPU_DRA_SANITIZE`` every watcher gets a frozen copy, so
        a handler that mutates its event raises instead of corrupting its
        peers' view; without it, the store's own object."""
        client = FakeClient()
        plain = client.watch("ConfigMap")
        monkeypatch.setenv(sanitizer.ENV_SANITIZE, "1")
        frozen = client.watch("ConfigMap")
        client.create(new_object("ConfigMap", "cm", "default",
                                 data={"k": "v"}))
        ev = frozen.next(timeout=2.0)
        assert isinstance(ev.object, FrozenDict)
        with pytest.raises(SanitizerError):
            ev.object["data"]["k"] = "w"
        assert isinstance(plain.next(timeout=2.0).object, FrozenDict)
        monkeypatch.delenv(sanitizer.ENV_SANITIZE)
        client.create(new_object("ConfigMap", "cm2", "default"))
        assert not isinstance(frozen.next(timeout=2.0).object, FrozenDict)
        assert client.get("ConfigMap", "cm", "default")["data"] == {"k": "v"}
        sanitizer.reset()


class TestFactories:
    def test_disabled_returns_plain(self):
        lk = sanitizer.new_lock("x", environ={})
        assert not isinstance(lk, TrackedLock)
        d = sanitizer.guarded_dict(lk, "x.d", {"a": 1}, environ={})
        assert type(d) is dict and d == {"a": 1}

    def test_enabled_returns_tracked(self):
        env = {"GPU_DRA_SANITIZE": "1"}
        lk = sanitizer.new_lock("y", environ=env)
        assert isinstance(lk, TrackedLock)
        d = sanitizer.guarded_dict(lk, "y.d", environ=env)
        assert isinstance(d, GuardedDict)

    def test_enabled_parsing(self):
        assert sanitizer.enabled({"GPU_DRA_SANITIZE": "1"})
        assert sanitizer.enabled({"GPU_DRA_SANITIZE": "true"})
        assert sanitizer.enabled({"GPU_DRA_SANITIZE": "ON"})
        assert not sanitizer.enabled({"GPU_DRA_SANITIZE": "0"})
        assert not sanitizer.enabled({"TPU_DRA_SANITIZE": "1"})
        assert not sanitizer.enabled({})

    def test_workqueue_constructs_tracked_lock(self, monkeypatch):
        monkeypatch.setenv(sanitizer.ENV_SANITIZE, "1")
        from k8s_dra_driver_tpu_torch.pkg.workqueue import WorkQueue
        q = WorkQueue()
        assert isinstance(q._lock, TrackedLock)
        assert isinstance(q._items, GuardedDict)


class TestSanitizerMode:
    def test_threaded_suites_pass_sanitized(self):
        """Re-run the port's workqueue/informer/claim-watcher suites with
        GPU_DRA_SANITIZE=1: every lock is tracked, every guarded dict
        checked, and the port's guard asserts zero violations leak."""
        proc = run_sanitized(SANITIZED_SUITES, "1")
        assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
        assert " passed" in proc.stdout

    def test_guard_fails_a_test_that_leaves_a_violation(self, tmp_path):
        """The guard is live: a test whose inversion is swallowed inside a
        thread (as a daemon thread's would be) fails at teardown, and a
        clean one passes."""
        (tmp_path / "test_planted.py").write_text(
            "import threading\n"
            "from k8s_dra_driver_tpu_torch.pkg import sanitizer\n\n\n"
            "def test_clean():\n"
            "    with sanitizer.TrackedLock('p.a'):\n"
            "        pass\n\n\n"
            "def test_swallowed_inversion():\n"
            "    a, b = sanitizer.TrackedLock('p.a'), "
            "sanitizer.TrackedLock('p.b')\n"
            "    with a:\n"
            "        with b:\n"
            "            pass\n\n"
            "    def other():\n"
            "        try:\n"
            "            with b:\n"
            "                with a:\n"
            "                    pass\n"
            "        except sanitizer.SanitizerError:\n"
            "            pass\n\n"
            "    t = threading.Thread(target=other)\n"
            "    t.start()\n"
            "    t.join()\n")
        proc = run_sanitized(["test_planted.py"], "1", cwd=tmp_path,
                             timeout=120)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        errors = [ln for ln in proc.stdout.splitlines()
                  if ln.startswith("ERROR ")]
        assert len(errors) == 1, proc.stdout
        assert "test_swallowed_inversion" in errors[0]
        assert "AssertionError: sanitizer violations: [\"lock-order " \
            "inversion" in proc.stdout
