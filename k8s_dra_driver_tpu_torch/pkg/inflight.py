"""Per-claim in-flight serialization for concurrent prepare/unprepare.

The reference driver serializes every Prepare behind one mutex plus the
node flock held across the whole transaction
(``cmd/gpu-kubelet-plugin/device_state.go`` holds ``sync.Mutex`` for the
full prepare). That is correct but collapses under churn: BENCH_r05
measured a 29× p50→p99 blowup once several kubelet workers prepare
concurrently, because every disjoint claim queues behind whichever claim
happens to be fsyncing its checkpoint.

:class:`ClaimFlightTable` replaces the monolithic critical section with
the minimum serialization the state machine actually needs:

- operations on the SAME claim UID serialize (prepare/unprepare/replayed
  prepare of one claim must never interleave — the
  PrepareStarted→PrepareCompleted transaction is per-claim);
- operations on DISTINCT claims overlap freely; cross-claim invariants
  (the no-overlapping-devices validator, checkpoint consistency) are
  enforced atomically inside the checkpoint group-commit instead
  (``checkpoint.CheckpointManager.transact``).

Locks come from :func:`sanitizer.new_lock`, so under
``GPU_DRA_SANITIZE=1`` the table lock and every per-claim lock feed the
process-global lock-order graph (all per-claim locks share one name —
an inversion against any claim lock is the same bug).

Lock hierarchy (see docs/performance.md): the short table lock is never
held while acquiring a claim lock, and a claim lock may be held while
acquiring the checkpoint commit locks — never the reverse.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import time
import weakref
from typing import Callable, Iterator, Optional

from k8s_dra_driver_tpu_torch.pkg import sanitizer

# Live-table registry for the /debug/inflight endpoint (weak: tables die
# with their DeviceState).
_live_tables: "weakref.WeakSet[ClaimFlightTable]" = weakref.WeakSet()
_live_tables_mu = sanitizer.new_lock("inflight._live_tables_mu")


def inflight_debug_snapshot() -> list[dict]:
    """One row per live flight table (docs/observability.md, "Debug
    endpoints"): which claim UIDs hold or wait on an in-flight lock right
    now — the first stop when a prepare looks wedged."""
    with _live_tables_mu:
        tables = list(_live_tables)
    rows = []
    for t in tables:
        with t._mu:
            claims = {uid: fl.refs for uid, fl in t._flights.items()}
        rows.append({
            "table": t._name,
            "inflight": len(claims),
            "claims": dict(sorted(claims.items())),
        })
    rows.sort(key=lambda r: r["table"])
    return rows

# How long a same-claim operation waits for its predecessor before failing
# retryably. Generous against slow devices, but bounded: a wedged prepare
# must surface an error through the kubelet's retry budget, not park one
# handler thread per retry forever.
DEFAULT_CLAIM_WAIT_TIMEOUT = 30.0


class ClaimBusyError(TimeoutError):
    """Another operation on the same claim is still executing. Retryable
    (not a PermanentError): the predecessor finishing — or being declared
    wedged by ITS caller — lets the retry proceed."""


class _Flight:
    """One claim's in-flight record: its lock plus a refcount of waiters
    (the entry may only be dropped once nobody holds or waits on it)."""

    __slots__ = ("lock", "refs")

    def __init__(self, lock) -> None:
        self.lock = lock
        self.refs = 0


class ClaimFlightTable:
    """uid → in-flight lock, with automatic entry lifecycle.

    ``on_change`` (optional) is called with the number of claims that
    currently have an operation in flight, after every change — the hook
    the ``gpu_dra_prepare_inflight`` gauge hangs off.
    """

    def __init__(self, name: str = "ClaimFlightTable",
                 on_change: Optional[Callable[[int], None]] = None,
                 lock_dir: Optional[str] = None):
        self._name = name
        self._mu = sanitizer.new_lock(f"{name}._mu")
        self._flights: dict[str, _Flight] = sanitizer.guarded_dict(
            self._mu, f"{name}._flights")
        self._on_change = on_change
        # Cross-PROCESS same-claim exclusion (more than one plugin process
        # may run during upgrades — the case the old whole-prepare flock
        # covered): a per-claim flock file under lock_dir, held for the
        # operation. Disjoint claims still overlap; only the same claim's
        # operations serialize across processes.
        self._lock_dir = lock_dir
        if lock_dir:
            os.makedirs(lock_dir, exist_ok=True)
        with _live_tables_mu:
            _live_tables.add(self)

    def inflight(self) -> int:
        with self._mu:
            return len(self._flights)

    def _lock_path(self, uid: str) -> str:
        # Hashed name: claim UIDs are caller input and must not become
        # path components verbatim.
        digest = hashlib.sha256(uid.encode()).hexdigest()[:24]
        return os.path.join(self._lock_dir, f"{digest}.lck")

    def _acquire_cross_process(self, uid: str, deadline: float) -> int:
        """flock the claim's lock file; returns the held fd. Polls with
        the remaining in-process budget; raises ClaimBusyError on
        timeout."""
        fd = os.open(self._lock_path(uid), os.O_RDWR | os.O_CREAT, 0o644)
        try:
            while True:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    return fd
                except BlockingIOError:
                    pass
                if time.monotonic() >= deadline:
                    raise ClaimBusyError(
                        f"claim {uid}: held by another plugin process")
                time.sleep(0.01)
        except BaseException:
            os.close(fd)
            raise

    @contextlib.contextmanager
    def claim(self, uid: str,
              timeout: float = DEFAULT_CLAIM_WAIT_TIMEOUT,
              unlink_on_exit: bool = False) -> Iterator[None]:
        """Serialize the enclosed block against every other operation on
        ``uid`` — in this process AND (when ``lock_dir`` is configured)
        across processes; distinct UIDs proceed concurrently. Waiting out
        ``timeout`` raises :class:`ClaimBusyError` (retryable).

        ``unlink_on_exit``: remove the claim's cross-process lock file on
        the way out — used by unprepare (the claim's terminal operation)
        so lock files don't accumulate. A third process racing the unlink
        against a second's blocked open can in principle split the lock;
        every such interleaving additionally requires the same-claim
        checkpoint transaction (node-flock-atomic) to interleave too, so
        the residual window needs three live plugin processes on one node.
        """
        deadline = time.monotonic() + (timeout if timeout
                                       and timeout > 0 else 3600.0)
        with self._mu:
            fl = self._flights.get(uid)
            if fl is None:
                # All claim locks share one sanitizer name: the ordering
                # contract is identical for every claim.
                fl = _Flight(sanitizer.new_lock(f"{self._name}.claim"))
                self._flights[uid] = fl
            fl.refs += 1
            n = len(self._flights)
        self._notify(n)
        # Acquired OUTSIDE the table lock: waiting for a busy claim must
        # not block other claims' entry/exit.
        ok = (fl.lock.acquire(timeout=timeout) if timeout and timeout > 0
              else fl.lock.acquire())
        fd = None
        try:
            if not ok:
                raise ClaimBusyError(
                    f"claim {uid}: another prepare/unprepare has held the "
                    f"in-flight lock for over {timeout}s")
            if self._lock_dir:
                fd = self._acquire_cross_process(uid, deadline)
            yield
        finally:
            if fd is not None:
                if unlink_on_exit:
                    try:
                        os.unlink(self._lock_path(uid))
                    except OSError:
                        pass
                os.close(fd)  # releases the flock
            if ok:
                fl.lock.release()
            with self._mu:
                fl.refs -= 1
                if fl.refs <= 0:
                    self._flights.pop(uid, None)
                n = len(self._flights)
            self._notify(n)

    def _notify(self, n: int) -> None:
        if self._on_change is not None:
            try:
                self._on_change(n)
            except Exception:  # noqa: BLE001 — a metrics hook must never
                pass           # fail a prepare.
