"""Runtime lock sanitizer: lock-order, unguarded-access and race tracking,
and lock-contention profiling.

The driver's control paths are threaded (workqueue drains, informer
dispatch, claim-watcher reconciles); this module checks them at run time,
the analogue of ``go test -race`` for the Go reference driver:

- :class:`TrackedLock` wraps a real lock and keeps a process-global
  lock-*name* acquisition-order graph. Acquiring B while holding A records
  the edge A→B; if the reverse path B→…→A was ever observed, that is a
  lock-order inversion (two threads interleaving those paths can deadlock)
  and the sanitizer raises :class:`SanitizerError` at the acquisition site.
- :func:`guarded_dict` wraps a shared dict so every *mutation* asserts the
  associated lock is held by the calling thread (reads are unchecked).
- :func:`deep_freeze` turns a watch event's shared snapshot read-only, so a
  handler that mutates what ``FakeClient``'s fan-out delivered raises.
- Race mode (``GPU_DRA_SANITIZE=race``) adds the vector-clock
  happens-before detector of ``pkg/racelab.py``: every TrackedLock feeds it
  lock edges, :func:`track_state` and :func:`guarded_dict` structures feed
  it per-key cells, and the schedule fuzzer preempts at every acquire.

Everything is keyed by lock *name* (``"WorkQueue._lock"``), not instance:
an inversion between two instances of the same class pair is the same bug.

Activation: ``GPU_DRA_SANITIZE=1`` (or ``race``) in the environment when a
lock or structure is created. Off (the default), :func:`new_lock` returns
a plain ``threading.Lock``/``RLock`` and :func:`guarded_dict` a plain
``dict``. Run a suite with the flag set and load
``k8s_dra_driver_tpu_torch.internal.sanitizer_guard`` as a pytest plugin
(``-p``) to fail every test that leaves a violation or a race report.

Lock-contention profiling (``GPU_DRA_LOCK_PROFILE=1`` or
:func:`set_lock_profiling`, the binaries' ``--lock-profile``) makes
:func:`new_lock` return a :class:`ContentionLock` that times blocked
acquires into a table the continuous profiler (``pkg/blackbox.py``) serves;
a TrackedLock feeds the same table.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional

from k8s_dra_driver_tpu_torch.pkg import racelab

ENV_SANITIZE = "GPU_DRA_SANITIZE"
ENV_LOCK_PROFILE = "GPU_DRA_LOCK_PROFILE"


def enabled(environ: Optional[dict] = None) -> bool:
    env = os.environ if environ is None else environ
    return env.get(ENV_SANITIZE, "").strip().lower() in (
        "1", "true", "on", "race")


def race_enabled(environ: Optional[dict] = None) -> bool:
    """``GPU_DRA_SANITIZE=race``: everything plain sanitize mode does,
    PLUS the vector-clock happens-before detector (``pkg/racelab``) fed
    by every TrackedLock and every :func:`track_state` structure, and the
    cooperative preemption points the schedule fuzzer drives."""
    env = os.environ if environ is None else environ
    return env.get(ENV_SANITIZE, "").strip().lower() == "race"


# -- lock-contention accounting ----------------------------------------------
#
# The continuous profiler (pkg/blackbox.py) answers "where do the threads
# spend their time"; this table answers the complementary "what do they
# WAIT on". Grown from the TrackedLock machinery below: the same
# name-keyed wrapper pattern, but recording blocked-acquire wait time
# instead of acquisition order. Recording happens only while lock
# profiling is enabled, and the instrumented fast path is one non-blocking try-acquire, so an
# uncontended lock pays a few nanoseconds, not a timestamp.

_contention_mu = threading.Lock()
# lock name -> [blocked acquires, total wait seconds, max wait seconds]
_contention: dict[str, list] = {}
_lock_profile_flag = [False]


def set_lock_profiling(on: bool) -> None:
    """Enable/disable contention recording AND make :func:`new_lock`
    return contention-instrumented locks from now on (locks created
    while off stay plain — flip this before assembly)."""
    _lock_profile_flag[0] = bool(on)


def lock_profiling_enabled(environ: Optional[dict] = None) -> bool:
    if _lock_profile_flag[0]:
        return True
    env = os.environ if environ is None else environ
    return env.get(ENV_LOCK_PROFILE, "").strip().lower() in (
        "1", "true", "on")


def _record_contention(name: str, wait_s: float) -> None:
    with _contention_mu:
        row = _contention.get(name)
        if row is None:
            row = _contention[name] = [0, 0.0, 0.0]
        row[0] += 1
        row[1] += wait_s
        row[2] = max(row[2], wait_s)


def lock_contention_snapshot() -> list[dict]:
    """Per-lock-name contention rows, worst total wait first — included
    in profiler snapshots and incident bundles."""
    with _contention_mu:
        rows = [{"lock": name, "waits": c, "wait_total_s": round(t, 6),
                 "wait_max_s": round(mx, 6)}
                for name, (c, t, mx) in _contention.items()]
    rows.sort(key=lambda r: -r["wait_total_s"])
    return rows


def reset_lock_contention() -> None:
    with _contention_mu:
        _contention.clear()


class ContentionLock:
    """A plain lock wrapper that times BLOCKED acquires into the
    contention table. Unlike :class:`TrackedLock` it keeps no order
    graph and never raises — it is safe always-on instrumentation, not
    an assertion."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(blocking=False):
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        ok = self._lock.acquire(True, timeout)
        if _lock_profile_flag[0] or lock_profiling_enabled():
            _record_contention(self.name, time.perf_counter() - t0)
        return ok

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "ContentionLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked() if hasattr(self._lock, "locked") else True

    def __repr__(self) -> str:
        return f"ContentionLock({self.name!r})"


class SanitizerError(AssertionError):
    """A lock-order inversion or unguarded mutation was observed."""


# -- process-global state ----------------------------------------------------

_tls = threading.local()

_graph_mu = threading.Lock()
# lock name -> names acquired at least once while it was held
_edges: dict[str, set[str]] = {}
# every violation ever observed (kept even though we also raise: a raise
# inside a daemon thread is swallowed by that thread's error handling, so
# tests additionally assert this list is empty).
_violations: list[str] = []


def _held_stack() -> list["TrackedLock"]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def violations() -> list[str]:
    with _graph_mu:
        return list(_violations)


def reset() -> None:
    """Clear the order graph and violation log (test isolation)."""
    with _graph_mu:
        _edges.clear()
        _violations.clear()


def _record_violation(msg: str) -> None:
    with _graph_mu:
        _violations.append(msg)
    raise SanitizerError(msg)


def _path_exists(src: str, dst: str) -> bool:
    """DFS over the order graph. Caller holds ``_graph_mu``."""
    seen = set()
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_edges.get(n, ()))
    return False


def _add_edge(a: str, b: str) -> None:
    inversion = None
    with _graph_mu:
        if b not in _edges.get(a, set()) and _path_exists(b, a):
            inversion = (f"lock-order inversion: acquiring {b!r} while "
                         f"holding {a!r}, but the order {b!r} -> {a!r} was "
                         "also observed (potential deadlock)")
        _edges.setdefault(a, set()).add(b)
    if inversion is not None:
        with _graph_mu:
            _violations.append(inversion)
        raise SanitizerError(inversion)


class TrackedLock:
    """A ``threading.Lock``/``RLock`` wrapper feeding the order graph."""

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def held_by_current_thread(self) -> bool:
        return any(t is self for t in _held_stack())

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Cooperative preemption point for the schedule fuzzer (race
        # mode): one module-global read when no fuzzer is installed.
        racelab.maybe_preempt(self.name)
        held = _held_stack()
        if not (self.reentrant and self.held_by_current_thread()):
            for h in held:
                if h.name != self.name:
                    _add_edge(h.name, self.name)
        # Contention accounting shares the machinery (see ContentionLock):
        # a sanitize-mode run with lock profiling on feeds the same table
        # (flag OR env — the same opt-ins ContentionLock honors).
        if blocking and lock_profiling_enabled():
            ok = self._lock.acquire(blocking=False)
            if not ok:
                t0 = time.perf_counter()
                ok = self._lock.acquire(True, timeout)
                _record_contention(self.name, time.perf_counter() - t0)
        else:
            ok = self._lock.acquire(blocking, timeout)
        if ok:
            held.append(self)
            # HB edge: joining the lock's release clock orders this
            # thread after every previous critical section (race mode).
            racelab.on_acquire(self)
        return ok

    def release(self) -> None:
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        # Publish this thread's clock on the lock BEFORE the underlying
        # release — the next acquirer must see everything done here.
        racelab.on_release(self)
        self._lock.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked() if hasattr(self._lock, "locked") else True

    def __repr__(self) -> str:
        return f"TrackedLock({self.name!r})"


class GuardedDict(dict):
    """A dict whose mutations must happen with ``lock`` held."""

    def __init__(self, lock: TrackedLock, name: str,
                 initial: Optional[dict] = None):
        super().__init__(initial or {})
        self._san_lock = lock
        self._san_name = name

    def _check(self, op: str) -> None:
        if not self._san_lock.held_by_current_thread():
            _record_violation(
                f"unguarded mutation: {self._san_name}.{op}() without "
                f"holding {self._san_lock.name!r}")

    def __setitem__(self, k: Any, v: Any) -> None:
        self._check("__setitem__")
        super().__setitem__(k, v)

    def __delitem__(self, k: Any) -> None:
        self._check("__delitem__")
        super().__delitem__(k)

    def pop(self, *a: Any, **kw: Any) -> Any:
        self._check("pop")
        return super().pop(*a, **kw)

    def popitem(self) -> Any:
        self._check("popitem")
        return super().popitem()

    def clear(self) -> None:
        self._check("clear")
        super().clear()

    def update(self, *a: Any, **kw: Any) -> None:
        self._check("update")
        super().update(*a, **kw)

    def setdefault(self, *a: Any, **kw: Any) -> Any:
        self._check("setdefault")
        return super().setdefault(*a, **kw)


# -- read-only snapshot enforcement ------------------------------------------
#
# The fake client's watch fan-out delivers ONE shared snapshot per event to
# every matching watcher (client-go's read-only informer contract). A
# handler mutating its event would silently corrupt every other watcher's
# view — so in sanitize mode the shared snapshot is deep-frozen: any
# mutation raises :class:`SanitizerError` at the mutation site instead.
# Both wrappers stay dict/list subclasses so json serialization, equality,
# and iteration behave exactly like the plain shapes.

class FrozenDict(dict):
    """A dict wrapper whose mutations raise (shared watch snapshot)."""

    def _frozen(self, op: str) -> None:
        _record_violation(
            f"mutation of a shared watch snapshot: dict.{op}() — delivered "
            "watch events are read-only (client-go informer contract); "
            "copy the object before mutating")

    def __setitem__(self, k: Any, v: Any) -> None:
        self._frozen("__setitem__")

    def __delitem__(self, k: Any) -> None:
        self._frozen("__delitem__")

    def pop(self, *a: Any, **kw: Any) -> Any:
        self._frozen("pop")

    def popitem(self) -> Any:
        self._frozen("popitem")

    def clear(self) -> None:
        self._frozen("clear")

    def update(self, *a: Any, **kw: Any) -> None:
        self._frozen("update")

    def __ior__(self, other: Any) -> Any:
        # dict.__ior__ is C-level dict_update and would mutate in place
        # WITHOUT dispatching to the overridden update() — the one |=
        # path must be blocked explicitly.
        self._frozen("__ior__")

    def setdefault(self, k: Any, default: Any = None) -> Any:
        # Read-only setdefault on a present key is a common read idiom
        # (``meta(obj)``); only the inserting case is a mutation.
        if k in self:
            return self[k]
        self._frozen("setdefault")
        return None  # unreachable; _record_violation raises


class FrozenList(list):
    """A list wrapper whose mutations raise (shared watch snapshot)."""

    def _frozen(self, op: str) -> None:
        _record_violation(
            f"mutation of a shared watch snapshot: list.{op}() — delivered "
            "watch events are read-only (client-go informer contract); "
            "copy the object before mutating")

    def __setitem__(self, i: Any, v: Any) -> None:
        self._frozen("__setitem__")

    def __delitem__(self, i: Any) -> None:
        self._frozen("__delitem__")

    def __iadd__(self, other: Any) -> Any:
        self._frozen("__iadd__")

    def __imul__(self, other: Any) -> Any:
        self._frozen("__imul__")

    def append(self, v: Any) -> None:
        self._frozen("append")

    def extend(self, it: Any) -> None:
        self._frozen("extend")

    def insert(self, i: Any, v: Any) -> None:
        self._frozen("insert")

    def remove(self, v: Any) -> None:
        self._frozen("remove")

    def pop(self, *a: Any) -> Any:
        self._frozen("pop")

    def clear(self) -> None:
        self._frozen("clear")

    def sort(self, *a: Any, **kw: Any) -> None:
        self._frozen("sort")

    def reverse(self) -> None:
        self._frozen("reverse")


def deep_freeze(obj: Any) -> Any:
    """Recursively wrap a JSON-shaped object so mutations raise."""
    if isinstance(obj, dict):
        return FrozenDict({k: deep_freeze(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return FrozenList(deep_freeze(v) for v in obj)
    return obj


def new_lock(name: str, reentrant: bool = False,
             environ: Optional[dict] = None):
    """A lock for ``name`` — tracked when the sanitizer is enabled,
    contention-instrumented when lock profiling is (sanitize wins: its
    TrackedLock feeds the contention table too)."""
    if enabled(environ):
        return TrackedLock(name, reentrant=reentrant)
    if lock_profiling_enabled(environ):
        return ContentionLock(name, reentrant=reentrant)
    return threading.RLock() if reentrant else threading.Lock()


def guarded_dict(lock: Any, name: str, initial: Optional[dict] = None,
                 environ: Optional[dict] = None) -> dict:
    """A shared dict guarded by ``lock`` — checked when sanitizing.

    ``lock`` must be the value :func:`new_lock` returned for the owning
    class; when the sanitizer is off (so ``lock`` is a plain lock), this
    is just ``dict(initial)``. In race mode the dict additionally feeds
    the happens-before detector (reads included — the half GuardedDict
    cannot check), keeping the guarded-mutation assertion.
    """
    if race_enabled(environ) and isinstance(lock, TrackedLock):
        def on_unguarded(n: str) -> None:
            _record_violation(
                f"unguarded mutation: {n} without holding {lock.name!r}")
        return racelab.TrackedDict(name, initial, guard=lock,
                                   on_unguarded=on_unguarded)
    if enabled(environ) and isinstance(lock, TrackedLock):
        return GuardedDict(lock, name, initial)
    return dict(initial or {})


def new_cell(name: str) -> Any:
    """A fresh detector-cell identity for :func:`note_read` /
    :func:`note_write` instrumentation of state no wrapper fits. Built on
    a never-reused serial so a GC'd owner's cell cannot be grafted onto a
    new object (``racelab.new_cell``)."""
    return racelab.new_cell(name)


def note_read(cell: Any) -> None:
    """Explicit detector feed for shared state no wrapper fits (a cache
    tuple swapped wholesale on an attribute, a scalar counter): record a
    read of ``cell`` by the current thread. One module-global read when
    race mode is off."""
    racelab.on_read(cell)


def note_write(cell: Any) -> None:
    """Explicit detector feed: record a write of ``cell``."""
    racelab.on_write(cell)


def track_state(obj: Any, name: str, environ: Optional[dict] = None) -> Any:
    """Wrap a known shared structure so every access feeds the
    happens-before detector (race mode only; otherwise ``obj`` is
    returned untouched — zero overhead).

    Dicts and sets are supported; per-key/-element cells plus one
    structural ``<keys>`` cell (see ``pkg/racelab``). Unlike
    :func:`guarded_dict` this asserts no lock discipline — it reports
    *unordered* access pairs, whichever locks (or none) the code used,
    which is what catches the cross-lock and read-side races the guarded
    wrappers cannot."""
    if not race_enabled(environ):
        return obj
    if isinstance(obj, dict):
        return racelab.TrackedDict(name, obj)
    if isinstance(obj, (set, frozenset)):
        return racelab.TrackedSet(name, obj)
    return obj


# Race mode is decided at import/creation time like the rest of the
# sanitizer: flip the env var before the process (or harness) builds its
# locks. In-process harnesses (bench arms, the race smoke) call
# racelab.enable()/disable() around stack construction instead.
if race_enabled():
    racelab.enable()
