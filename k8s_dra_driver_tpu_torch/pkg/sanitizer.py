"""Lock and shared-state constructors, and lock-contention profiling.

The JAX package's ``pkg/sanitizer.py`` can wrap every lock and shared
structure for lock-order and race checking (``TPU_DRA_SANITIZE``); off, its
constructors return plain objects, which is all this package does for those
modes: the copied modules build their locks and shared maps through these
names so that a checked mode can be added here without touching them.

Its lock-contention profiling is here in full (``pkg/sanitizer.py:78-158``
there): while lock profiling is on (``GPU_DRA_LOCK_PROFILE=1`` or
:func:`set_lock_profiling`, i.e. the binaries' ``--lock-profile``),
:func:`new_lock` returns a :class:`ContentionLock` that times blocked
acquires into a table the continuous profiler (``pkg/blackbox.py``) serves.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional

from k8s_dra_driver_tpu_torch.pkg import racelab

ENV_LOCK_PROFILE = "GPU_DRA_LOCK_PROFILE"

# -- lock-contention accounting ----------------------------------------------
#
# The continuous profiler (pkg/blackbox.py) answers "where do the threads
# spend their time"; this table answers the complementary "what do they
# WAIT on". Recording happens only while lock profiling is enabled, and the
# instrumented fast path is one non-blocking try-acquire, so an uncontended
# lock pays a few nanoseconds, not a timestamp.

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
    in profiler snapshots."""
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
    contention table. It keeps no order graph and never raises — it is
    safe always-on instrumentation, not an assertion."""

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


def new_lock(name: str, reentrant: bool = False,
             environ: Optional[dict] = None):
    """A lock for ``name``: contention-instrumented while lock profiling
    is on, else a plain ``threading.Lock`` (``RLock`` when
    ``reentrant``)."""
    if lock_profiling_enabled(environ):
        return ContentionLock(name, reentrant=reentrant)
    return threading.RLock() if reentrant else threading.Lock()


def guarded_dict(lock: Any, name: str, initial: Optional[dict] = None) -> dict:
    """A plain dict, meant to be mutated only under ``lock``."""
    return dict(initial or {})


def track_state(obj: Any, name: str) -> Any:
    """``obj`` itself: shared-state tracking is off."""
    return obj


def new_cell(name: str) -> Any:
    return racelab.new_cell(name)


def note_read(cell: Any) -> None:
    racelab.on_read(cell)


def note_write(cell: Any) -> None:
    racelab.on_write(cell)
