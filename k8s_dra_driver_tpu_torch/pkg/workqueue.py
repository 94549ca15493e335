"""Rate-limited retry work queue.

Analogue of the reference's ``pkg/workqueue`` wrapper over client-go
(``workqueue.go:31-110``) plus the retry-until-deadline semantics of the
ComputeDomain kubelet plugin (``cmd/compute-domain-kubelet-plugin/
driver.go:60-80,178-207``): every enqueued item is retried with per-item
exponential backoff bounded by a global token bucket, until it succeeds, its
error is permanent, or the deadline expires.

Limiters mirror the reference's presets:
- prep/unprep: per-item expo 250 ms → 3 s, max-of a global 5/s bucket
  (burst 10) — ``workqueue.go:49-66``.
- CD daemon: jittered expo 5 ms → 6 s (±50 %) — ``jitterlimiter.go:31-66``.
- controller default: expo 5 ms → 1000 s, max-of a 10/s bucket (burst 100).

Clock and sleep are injectable so tests run instantly on a fake clock.
"""

from __future__ import annotations

import heapq
import logging
import random
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Protocol

from k8s_dra_driver_tpu_torch.pkg import racelab, sanitizer
from k8s_dra_driver_tpu_torch.pkg.errors import is_permanent
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    WorkQueueMetrics,
    default_workqueue_metrics,
)

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Rate limiters
# --------------------------------------------------------------------------

class RateLimiter(Protocol):
    def when(self, key: str, now: float) -> float:
        """Seconds from ``now`` until ``key`` may run again."""
        ...

    def forget(self, key: str) -> None: ...


class ItemExponentialFailureRateLimiter:
    """Per-item exponential backoff: base * 2^failures, capped. Mutex-guarded
    like client-go's limiters — queues are driven from multiple threads."""

    def __init__(self, base: float, cap: float):
        self.base = base
        self.cap = cap
        self._failures: dict[str, int] = {}
        self._mu = sanitizer.new_lock(
            "ItemExponentialFailureRateLimiter._mu")

    def when(self, key: str, now: float) -> float:
        with self._mu:
            n = self._failures.get(key, 0)
            self._failures[key] = n + 1
        return min(self.base * (2 ** n), self.cap)

    def forget(self, key: str) -> None:
        with self._mu:
            self._failures.pop(key, None)

    def num_requeues(self, key: str) -> int:
        with self._mu:
            return self._failures.get(key, 0)


class BucketRateLimiter:
    """Global token bucket: ``qps`` refill rate, ``burst`` capacity."""

    def __init__(self, qps: float, burst: int):
        self.qps = qps
        self.burst = burst
        self._tokens = float(burst)
        self._last: Optional[float] = None
        self._mu = sanitizer.new_lock("BucketRateLimiter._mu")

    def when(self, key: str, now: float) -> float:
        with self._mu:
            if self._last is not None:
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.qps)
            self._last = now
            self._tokens -= 1.0
            if self._tokens >= 0:
                return 0.0
            return -self._tokens / self.qps

    def forget(self, key: str) -> None:
        pass


class MaxOfRateLimiter:
    """Combines limiters by taking the longest delay — per-item backoff AND
    global rate are both respected (cf. workqueue.go:49-58)."""

    def __init__(self, *limiters: RateLimiter):
        self.limiters = limiters

    def when(self, key: str, now: float) -> float:
        return max(lim.when(key, now) for lim in self.limiters)

    def forget(self, key: str) -> None:
        for lim in self.limiters:
            lim.forget(key)


class JitterRateLimiter:
    """Adds ±``factor`` random jitter on top of an inner limiter's delay —
    avoids thundering-herd retries across per-CD daemons
    (jitterlimiter.go:31-66)."""

    def __init__(self, inner: RateLimiter, factor: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.inner = inner
        self.factor = factor
        self.rng = rng or random.Random()

    def when(self, key: str, now: float) -> float:
        d = self.inner.when(key, now)
        if d <= 0:
            return d
        return d * (1.0 + self.factor * (2.0 * self.rng.random() - 1.0))

    def forget(self, key: str) -> None:
        self.inner.forget(key)


def default_prep_unprep_rate_limiter() -> RateLimiter:
    return MaxOfRateLimiter(
        ItemExponentialFailureRateLimiter(0.25, 3.0),
        BucketRateLimiter(5.0, 10),
    )


def default_cd_daemon_rate_limiter(rng: Optional[random.Random] = None) -> RateLimiter:
    return JitterRateLimiter(
        ItemExponentialFailureRateLimiter(0.005, 6.0), 0.5, rng=rng)


def default_controller_rate_limiter() -> RateLimiter:
    return MaxOfRateLimiter(
        ItemExponentialFailureRateLimiter(0.005, 1000.0),
        BucketRateLimiter(10.0, 100),
    )


# --------------------------------------------------------------------------
# Work queue
# --------------------------------------------------------------------------

# Live-queue registry for the /debug/workqueue endpoint. Weak: the
# per-request queues the kubelet plugins mint are transient and must
# vanish from introspection when collected.
_live_queues: "weakref.WeakSet[WorkQueue]" = weakref.WeakSet()
_live_queues_mu = sanitizer.new_lock("workqueue._live_queues_mu")


def workqueue_debug_snapshot() -> list[dict]:
    """One row per live queue (docs/observability.md, "Debug endpoints"):
    depth, keys mid-processing, parked re-queues, shutdown state."""
    with _live_queues_mu:
        queues = list(_live_queues)
    rows = []
    for q in queues:
        with q._lock:
            rows.append({
                "name": q.name,
                "depth": len(q._items),
                "processing": sorted(q._processing),
                "parked": len(q._blocked),
                "shutdown": q._shutdown,
            })
    rows.sort(key=lambda r: r["name"])
    return rows


@dataclass(order=True)
class _Scheduled:
    due: float
    seq: int
    key: str = field(compare=False)


@dataclass
class WorkItem:
    key: str
    obj: Any
    callback: Callable[[Any], Any]
    enqueued_at: float = 0.0


class WorkQueue:
    """Keyed retry queue. ``enqueue`` schedules an item through the rate
    limiter; re-enqueueing the same key coalesces onto the newest object
    (informer semantics). ``run_until_deadline`` drains synchronously —
    the prepare/unprepare request-handler mode; ``run`` drains forever —
    the controller mode, optionally with a worker pool (``workers=N``).

    Worker-pool semantics are client-go's (workqueue.Type's dirty/processing
    sets): a key handed to one worker is *in processing* and is never handed
    to a second worker concurrently; a key enqueued while its reconcile is
    in flight is parked and re-queued the moment that run completes, so the
    newest object is always reconciled exactly once more — never dropped,
    never run twice at once."""

    def __init__(
        self,
        limiter: Optional[RateLimiter] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        name: str = "default",
        metrics: Optional[WorkQueueMetrics] = None,
    ):
        self.limiter = limiter or default_controller_rate_limiter()
        self.clock = clock
        self.sleep = sleep
        self.name = name
        self.metrics = metrics or default_workqueue_metrics()
        self._lock = sanitizer.new_lock("WorkQueue._lock")
        self._heap: list[_Scheduled] = []
        self._items: dict[str, WorkItem] = sanitizer.guarded_dict(
            self._lock, "WorkQueue._items")
        # Per-key exclusivity state (client-go's processing/dirty sets):
        # keys currently inside a worker's callback, and items whose key
        # was due while in processing — parked until _task_done re-queues.
        # Race-mode: tracked, so an access outside _lock surfaces as an
        # unordered pair instead of a silent lost update.
        self._processing: set[str] = sanitizer.track_state(
            set(), "WorkQueue._processing")
        self._blocked: dict[str, WorkItem] = sanitizer.guarded_dict(
            self._lock, "WorkQueue._blocked")
        self._seq = 0
        self._wake = threading.Event()
        self._shutdown = False
        with _live_queues_mu:
            _live_queues.add(self)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items) + len(self._blocked)

    def _set_depth_locked(self) -> None:
        """Caller holds ``_lock``."""
        self.metrics.depth.set(
            float(len(self._items) + len(self._blocked)), queue=self.name)

    def enqueue(self, key: str, obj: Any, callback: Callable[[Any], Any],
                rate_limited: bool = True) -> None:
        now = self.clock()
        delay = self.limiter.when(key, now) if rate_limited else 0.0
        with self._lock:
            # A parked (mid-flight) copy is superseded by this newer object;
            # the fresh heap entry below carries the re-queue instead.
            self._blocked.pop(key, None)
            self._items[key] = WorkItem(key=key, obj=obj, callback=callback,
                                        enqueued_at=now)
            self._seq += 1
            heapq.heappush(self._heap, _Scheduled(now + delay, self._seq, key))
            self._set_depth_locked()
        # HB edge: everything the producer did before enqueueing ``key``
        # is ordered before the worker that pops it (race mode; the item
        # object itself crosses threads here).
        racelab.hb_send(("wq", self.name, key))
        self._wake.set()

    def forget(self, key: str) -> None:
        self.limiter.forget(key)

    def shut_down(self) -> None:
        self._shutdown = True
        self._wake.set()

    def _pop_due(self, now: float) -> Optional[WorkItem]:
        with self._lock:
            while self._heap:
                if self._heap[0].due > now:
                    return None
                sched = heapq.heappop(self._heap)
                item = self._items.pop(sched.key, None)
                if item is None:
                    continue  # stale heap entries (coalesced keys) skipped
                if sched.key in self._processing:
                    # Another worker is mid-flight on this key: park it.
                    # _task_done re-queues it, preserving the guarantee
                    # that an event arriving during a reconcile triggers
                    # one more reconcile of the newest object.
                    self._blocked[sched.key] = item
                    continue
                self._processing.add(sched.key)
                self._set_depth_locked()
                self.metrics.queue_latency_seconds.observe(
                    max(0.0, now - item.enqueued_at), queue=self.name)
                racelab.hb_recv(("wq", self.name, sched.key))
                return item
            return None

    def _requeue_failed(self, item: WorkItem) -> None:
        """Schedule a retry of a failed item — UNLESS a newer enqueue for
        its key is already pending (queued or parked mid-flight): the
        coalesce-onto-newest contract means the fresh object supersedes
        the stale failed one, never the other way around. The limiter is
        still charged either way (the item did fail)."""
        now = self.clock()
        delay = self.limiter.when(item.key, now)
        with self._lock:
            if item.key in self._items or item.key in self._blocked:
                return
            self._items[item.key] = WorkItem(
                key=item.key, obj=item.obj, callback=item.callback,
                enqueued_at=now)
            self._seq += 1
            heapq.heappush(
                self._heap, _Scheduled(now + delay, self._seq, item.key))
            self._set_depth_locked()
        racelab.hb_send(("wq", self.name, item.key))
        self._wake.set()

    def _task_done(self, key: str) -> None:
        """A worker finished ``key``; re-queue any event parked mid-flight."""
        requeued = False
        with self._lock:
            self._processing.discard(key)
            item = self._blocked.pop(key, None)
            if item is not None and key not in self._items:
                self._items[key] = item
                self._seq += 1
                heapq.heappush(
                    self._heap, _Scheduled(self.clock(), self._seq, key))
                requeued = True
            self._set_depth_locked()
        if requeued:
            racelab.hb_send(("wq", self.name, key))
            self._wake.set()

    def _next_due(self) -> Optional[float]:
        with self._lock:
            while self._heap and self._heap[0].key not in self._items:
                heapq.heappop(self._heap)
            return self._heap[0].due if self._heap else None

    def _process_one(self, item: WorkItem, deadline: Optional[float],
                     results: dict[str, Any], errors: dict[str, Exception]) -> None:
        t0 = self.clock()
        try:
            results[item.key] = item.callback(item.obj)
            errors.pop(item.key, None)
            self.limiter.forget(item.key)
        except Exception as e:  # noqa: BLE001 — taxonomy decides below
            errors[item.key] = e
            results.pop(item.key, None)
            if is_permanent(e):
                logger.warning("workqueue item %s failed permanently: %s",
                               item.key, e)
                self.limiter.forget(item.key)
                return
            now = self.clock()
            if deadline is not None and now >= deadline:
                return  # out of budget; caller sees the last error
            logger.debug("workqueue item %s failed (will retry): %s",
                         item.key, e)
            self._requeue_failed(item)
        finally:
            self.metrics.work_duration_seconds.observe(
                max(0.0, self.clock() - t0), queue=self.name)

    def run_until_deadline(
        self, deadline_seconds: float
    ) -> tuple[dict[str, Any], dict[str, Exception]]:
        """Drain the queue synchronously, retrying retryable failures until
        the queue is empty or the deadline passes. Returns (results, errors)
        keyed by item key — an item appears in exactly one of the two.
        This is the 45-second request-handler mode (driver.go:61-66)."""
        deadline = self.clock() + deadline_seconds
        results: dict[str, Any] = {}
        errors: dict[str, Exception] = {}
        while True:
            now = self.clock()
            item = self._pop_due(now)
            if item is not None:
                try:
                    self._process_one(item, deadline, results, errors)
                finally:
                    self._task_done(item.key)
                continue
            nxt = self._next_due()
            if nxt is None:
                break  # queue drained
            if now >= deadline:
                # Deadline passed with items still pending: report them as
                # timed out using their last error if any.
                with self._lock:
                    pending = [*self._items.values(), *self._blocked.values()]
                    self._items.clear()
                    self._blocked.clear()
                    self._heap.clear()
                    self._set_depth_locked()
                for p in pending:
                    errors.setdefault(
                        p.key, TimeoutError(f"{p.key}: retry budget exhausted"))
                break
            self.sleep(min(nxt, deadline) - now + 1e-4)
        return results, errors

    def run(self, stop: Optional[threading.Event] = None,
            workers: int = 1) -> None:
        """Process items until ``shut_down`` (or ``stop``) — controller mode.
        Failed retryable items are re-enqueued indefinitely.

        ``workers``: size of the worker pool. The calling thread is worker
        0; ``workers - 1`` extra daemon threads are spawned and joined when
        the queue shuts down. Per-key exclusivity holds across the pool
        (see the class docstring)."""
        if workers > 1:
            extra = [
                threading.Thread(target=self._run_worker, args=(stop,),
                                 name=f"workqueue-{self.name}-{i + 1}",
                                 daemon=True)
                for i in range(workers - 1)]
            for t in extra:
                t.start()
            try:
                self._run_worker(stop)
            finally:
                for t in extra:
                    t.join(timeout=5.0)
        else:
            self._run_worker(stop)

    def _run_worker(self, stop: Optional[threading.Event]) -> None:
        """One worker's drain loop. The wake event is cleared BEFORE the
        queue is scanned: any enqueue committed before the clear is visible
        to the scan, any enqueue after it re-sets the event so the wait
        below returns immediately — a set landing between ``wait()``
        returning and a post-wait ``clear()`` (the old ordering) could be
        consumed without being acted on, parking a just-enqueued item for
        a full poll tick."""
        while not self._shutdown and (stop is None or not stop.is_set()):
            self._wake.clear()
            now = self.clock()
            item = self._pop_due(now)
            if item is not None:
                try:
                    self._process_one(item, None, {}, {})
                finally:
                    self._task_done(item.key)
                continue
            nxt = self._next_due()
            timeout = 0.2 if nxt is None else max(0.0, min(nxt - now, 0.2))
            self._wake.wait(timeout=timeout)
