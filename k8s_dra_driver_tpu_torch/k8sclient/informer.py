"""Informer: cached watch with event handlers.

The minimal slice of client-go informer behavior the controllers here use
(cf. the reference's informer wiring, ``cmd/compute-domain-controller/
computedomain.go:136-143``): initial LIST replayed as adds, then watch
events keep a local cache fresh and fan out to handlers on a dedicated
thread. ``wait_for_cache_sync`` gates controller startup.

resourceVersion tracking (docs/performance.md, "API machinery"): the
informer remembers the newest resourceVersion it has seen — from the
initial paginated LIST, every delivered event, and periodic BOOKMARK
events the server sends while the stream is idle. When the watch dies it
first tries to RESUME from that rv (the server replays the missed events
from its backlog — no relist, no O(cache) diff); only a "resourceVersion
too old" rejection (:class:`ExpiredError` / HTTP 410 Gone) falls back to
the full relist-and-diff resync.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Callable, Optional

from k8s_dra_driver_tpu_torch.k8sclient.client import (
    ExpiredError,
    FakeClient,
    Obj,
    meta,
)
from k8s_dra_driver_tpu_torch.pkg import sanitizer
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    InformerMetrics,
    default_informer_metrics,
)
from k8s_dra_driver_tpu_torch.pkg.workqueue import (
    ItemExponentialFailureRateLimiter,
    JitterRateLimiter,
    RateLimiter,
)

logger = logging.getLogger(__name__)

#: a re-established watch that stays alive this long counts as stable —
#: the next death starts the reconnect backoff over from the base delay.
RECONNECT_STABLE_AFTER = 5.0

#: page size for the informer's chunked LISTs — each apiserver critical
#: section copies at most this many objects, not the whole kind.
LIST_PAGE_LIMIT = 500


def default_reconnect_limiter() -> RateLimiter:
    """Jittered expo 50 ms → 5 s: even if every informer in the fleet loses
    its stream at the same instant (API-server restart), their relists
    spread out instead of stampeding the recovering server."""
    return JitterRateLimiter(
        ItemExponentialFailureRateLimiter(0.05, 5.0), 0.5)

Handler = Callable[[Obj], None]
UpdateHandler = Callable[[Optional[Obj], Obj], None]

# Live-informer registry for the /debug/informers endpoint: weak so a
# dropped informer vanishes from introspection with no unregister step.
_live_informers: "weakref.WeakSet[Informer]" = weakref.WeakSet()
_live_informers_mu = sanitizer.new_lock("informer._live_informers_mu")


def informer_debug_snapshot() -> list[dict]:
    """One row per live informer (docs/observability.md, "Debug
    endpoints"): cache size, resume point, and stream-health counters —
    the first thing to read when a controller looks deaf."""
    with _live_informers_mu:
        informers = list(_live_informers)
    rows = []
    for inf in informers:
        with inf._cache_lock:
            cached = len(inf._cache)
        watch = inf._watch
        rows.append({
            "kind": inf.kind,
            "namespace": inf.namespace,
            "field_name": inf.name,
            "cache_objects": cached,
            "last_rv": inf._last_rv,
            "synced": inf._synced.is_set(),
            "stopped": inf._stop.is_set(),
            "watch_alive": bool(watch is not None
                                and getattr(watch, "alive", False)),
            "reconnects": inf.reconnect_count,
            "resumes": inf.resume_count,
            "relists": inf.relist_count,
        })
    rows.sort(key=lambda r: (r["kind"], r["namespace"] or ""))
    return rows


def _rv(obj: Obj) -> int:
    try:
        return int(meta(obj).get("resourceVersion", 0))
    except (TypeError, ValueError):
        return 0


class Informer:
    def __init__(
        self,
        client: FakeClient,
        kind: str,
        namespace: Optional[str] = None,
        on_add: Optional[Handler] = None,
        on_update: Optional[UpdateHandler] = None,
        on_delete: Optional[Handler] = None,
        name: Optional[str] = None,
        reconnect_limiter: Optional[RateLimiter] = None,
        reconnect_stable_after: float = RECONNECT_STABLE_AFTER,
        metrics: Optional[InformerMetrics] = None,
        resume_rv: Optional[int] = None,
        on_rv: Optional[Callable[[int], None]] = None,
    ):
        """``name``: track only the object with this metadata.name — the
        ``fieldSelector metadata.name=<x>`` analogue (e.g. the CD daemon
        watching exactly its own pod, podmanager.go:49-51). Other objects
        are neither cached nor dispatched.

        ``reconnect_limiter``/``reconnect_stable_after``: backoff between
        attempts to replace a dead watch. A flapping API server (streams
        die the moment they are re-established) would otherwise spin the
        resync loop hot — every spin a full LIST. The limiter resets only
        after a reconnected watch survives ``reconnect_stable_after``
        seconds, so success alone does not defeat the backoff.

        ``resume_rv``: a resourceVersion persisted by a PREVIOUS process
        (e.g. alongside a kubelet plugin's checkpoint). When set (>= 0),
        ``start()`` skips the initial LIST entirely and opens the watch at
        that rv — the server replays everything missed while the process
        was down, so a restart costs O(missed events), not O(cluster).
        A 410 (backlog outran the checkpoint) falls back to the normal
        LIST+watch start and counts as a relist. The cache starts empty
        and warms from replayed/live events; every dispatch path the
        consumer relies on is already idempotent against that (the same
        property resyncs rely on).

        ``on_rv``: called (from the informer's threads) each time the
        newest-seen resourceVersion advances — the persistence hook
        ``resume_rv`` reads back. Must be cheap; throttling is the
        callback's job."""
        self.client = client
        self.kind = kind
        self.namespace = namespace
        self.name = name
        self.on_add = on_add
        self.on_update = on_update
        self.on_delete = on_delete
        self._cache_lock = sanitizer.new_lock("Informer._cache_lock")
        self._cache: dict[tuple[str, str], Obj] = sanitizer.guarded_dict(
            self._cache_lock, "Informer._cache")
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._watch = None
        # Serializes the resync's watch swap against stop(): without it,
        # stop() can close the OLD watch while resync installs a fresh one
        # that then leaks (socket + reader thread) forever.
        self._watch_lock = sanitizer.new_lock("Informer._watch_lock")
        self._thread: Optional[threading.Thread] = None
        self._reconnect_limiter = reconnect_limiter or default_reconnect_limiter()
        self._reconnect_stable_after = reconnect_stable_after
        self._metrics = metrics or default_informer_metrics()
        self._established_at: Optional[float] = None
        # Incremented from the watch thread, read from test/metrics
        # threads — guarded, not a bare += (torn read-modify-write).
        self._reconnect_mu = sanitizer.new_lock("Informer._reconnect_mu")
        self.reconnect_count = 0
        # Newest resourceVersion seen (list metadata, events, bookmarks) —
        # only ever touched from the start()/watch thread; reads from
        # other threads are informational. -1 = unknown (never listed
        # against an rv-capable server); 0 is a VALID resume point (a
        # fresh store with nothing committed yet).
        self._last_rv = -1
        # How dead watches were replaced: resume_count via
        # watch(resource_version=...) backlog replay, relist_count via the
        # full LIST+diff fallback (after a 410 or when no rv is known).
        self.resume_count = 0
        self.relist_count = 0
        self._resume_rv = resume_rv
        self._on_rv = on_rv
        # Whether start() resumed from a checkpointed rv instead of
        # paying the initial LIST (restart tests assert on this).
        self.resumed_from_checkpoint = False
        with _live_informers_mu:
            _live_informers.add(self)

    @staticmethod
    def _key(obj: Obj) -> tuple[str, str]:
        m = meta(obj)
        return (m.get("namespace", ""), m.get("name", ""))

    def _selected(self, obj: Obj) -> bool:
        return self.name is None or meta(obj).get("name") == self.name

    def _list_all(self) -> tuple[list[Obj], int]:
        """Full LIST via resourceVersion-consistent pages: each apiserver
        critical section copies at most LIST_PAGE_LIMIT objects, and the
        returned rv is the snapshot every page was served at. A crawl
        whose continue token expires mid-way (backlog outran it) restarts
        from scratch — same contract as a real apiserver's 410. Clients
        without ``list_page`` (test stubs) fall back to one full list."""
        lister = getattr(self.client, "list_page", None)
        if lister is None:
            # rv unknown (-1): stub clients without pagination can never
            # be resumed against, only relisted.
            return list(self.client.list(self.kind, self.namespace)), -1
        while True:
            items: list[Obj] = []
            token = ""
            try:
                while True:
                    if self._stop.is_set():
                        # A churn-heavy server can expire crawl after
                        # crawl — stop() must still terminate the thread.
                        return items, -1
                    page = lister(self.kind, self.namespace,
                                  limit=LIST_PAGE_LIMIT,
                                  continue_token=token)
                    items.extend(page["items"])
                    token = page["metadata"].get("continue", "")
                    if not token:
                        try:
                            rv = int(page["metadata"].get(
                                "resourceVersion", 0))
                        except (TypeError, ValueError):
                            rv = 0
                        return items, rv
            except ExpiredError:
                logger.info("informer %s: list continue expired; "
                            "restarting list", self.kind)
                # Brief pause (stop-aware) so continuous write pressure
                # cannot pin this thread in a full-speed LIST hot loop.
                if self._stop.wait(0.05):
                    return items, -1
                continue

    def start(self) -> "Informer":
        if self._resume_rv is not None and self._resume_rv >= 0:
            if self._start_resumed(self._resume_rv):
                return self
            # Backlog outran the checkpointed rv (410) or the server is
            # unreachable at this instant: fall through to the normal
            # LIST+watch start, counted as a relist so restart tests can
            # tell the two paths apart.
            with self._reconnect_mu:
                self.relist_count += 1
            self._metrics.relists_total.inc(kind=self.kind)
        # Subscribe BEFORE listing so no event between list and watch is lost
        # (the fake client buffers events per watch). The watch is created
        # outside the lock (network call) and installed under it — same
        # discipline as _resync, and it keeps the _watch handoff to stop()
        # well-ordered even if stop() races a slow start().
        watch = self.client.watch(self.kind, self.namespace)
        with self._watch_lock:
            if self._stop.is_set():
                # stop() won the race; it saw _watch as None and closed
                # nothing, so ours must not leak.
                watch.stop()
                return self
            self._watch = watch
        self._established_at = time.monotonic()
        listed, list_rv = self._list_all()
        if list_rv > self._last_rv:
            self._last_rv = list_rv
        initial = [o for o in listed if self._selected(o)]
        with self._cache_lock:
            for obj in initial:
                self._cache[self._key(obj)] = obj
            n = len(self._cache)
        self._set_cache_gauge(n)
        for obj in initial:
            self._dispatch_add(obj)
        if list_rv > 0 and list_rv == self._last_rv:
            # Persisted only after the initial adds dispatched: a crash
            # mid-dispatch must restart from the PRE-list checkpoint (the
            # not-yet-dispatched objects are at or before list_rv and
            # would never be replayed by a resume taken past it).
            self._notify_rv(list_rv)
        self._synced.set()
        self._start_thread()
        return self

    def _start_resumed(self, rv: int) -> bool:
        """Checkpoint-resume start: open the watch AT the persisted rv —
        the server's backlog replays everything this process missed while
        down; no LIST, no O(cluster) copy. Returns False when the resume
        is not possible (410 / server down) and the caller must relist."""
        try:
            watch = self.client.watch(self.kind, self.namespace,
                                      resource_version=rv)
        except Exception as e:  # noqa: BLE001 — ExpiredError or transport;
            # either way the LIST fallback is the correct recovery.
            logger.info("informer %s: checkpoint resume from rv %d not "
                        "possible (%s); falling back to list", self.kind,
                        rv, e)
            return False
        with self._watch_lock:
            if self._stop.is_set():
                watch.stop()
                return True  # stopped before starting; nothing to run
            self._watch = watch
        self._established_at = time.monotonic()
        self._last_rv = max(self._last_rv, rv)
        self.resumed_from_checkpoint = True
        with self._reconnect_mu:
            self.resume_count += 1
        # The cache warms from replayed events; consumers treat a resumed
        # start exactly like a post-resync stream (idempotent dispatch).
        self._synced.set()
        logger.info("informer %s: resumed from checkpointed rv %d "
                    "(no relist)", self.kind, rv)
        self._start_thread()
        return True

    def _start_thread(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"informer-{self.kind}", daemon=True)
        self._thread.start()

    def _notify_rv(self, rv: int) -> None:
        if self._on_rv is None:
            return
        try:
            self._on_rv(rv)
        except Exception:  # noqa: BLE001 — a persistence hiccup must not
            # kill the event thread; the next advance retries.
            logger.exception("informer %s: on_rv hook failed", self.kind)

    def _set_cache_gauge(self, n: int) -> None:
        """``n`` is captured inside the caller's already-held cache-lock
        section — no second acquisition on the hot event path."""
        self._metrics.cache_objects.set(float(n), kind=self.kind)

    def _dispatch_add(self, obj: Obj) -> None:
        if self.on_add:
            try:
                self.on_add(obj)
            except Exception:  # noqa: BLE001
                logger.exception("informer %s on_add handler failed", self.kind)

    def _try_resume(self) -> bool:
        """Replace the dead watch by RESUMING from the newest
        resourceVersion seen: the server replays the missed events from
        its per-kind backlog into the fresh watch, so the cache needs no
        relist and no diff — the missed transitions arrive as ordinary
        events. Returns False when resumption isn't possible (no rv yet,
        or the backlog no longer reaches back: ExpiredError / 410 Gone)
        and the caller must fall back to the relist resync. Transport
        errors also return False — the relist attempt will surface them
        to the backoff path."""
        if self._last_rv < 0:
            return False
        try:
            new_watch = self.client.watch(
                self.kind, self.namespace, resource_version=self._last_rv)
        except ExpiredError:
            logger.info("informer %s: resume from rv %d expired (410); "
                        "falling back to relist", self.kind, self._last_rv)
            return False
        except Exception as e:  # noqa: BLE001 — server down; relist path
            # will fail the same way and feed the caller's backoff.
            logger.warning("informer %s: resume attempt failed (%s)",
                           self.kind, e)
            return False
        with self._watch_lock:
            if self._stop.is_set():
                new_watch.stop()
                return False
            old_watch, self._watch = self._watch, new_watch
        try:
            old_watch.stop()
        except Exception:  # noqa: BLE001
            pass
        with self._reconnect_mu:
            self.resume_count += 1
        logger.info("informer %s: watch resumed from rv %d (%d resumes, "
                    "%d relists so far)", self.kind, self._last_rv,
                    self.resume_count, self.relist_count)
        return True

    def _resync(self) -> bool:
        """The watch stream died (API server restart/blip): re-subscribe,
        re-list, and reconcile the cache — dispatching adds/updates/deletes
        for whatever changed while we were deaf. Client-go's
        relist-on-watch-expiry analogue; without it a long-running
        controller whose apiserver blips once goes silently stale forever.
        Returns whether the watch was re-established; pacing between
        attempts is the caller's (``_run``'s backoff), not ours."""
        new_watch = None
        try:
            new_watch = self.client.watch(self.kind, self.namespace)
            current_all, list_rv = self._list_all()
            current = [o for o in current_all if self._selected(o)]
        except Exception as e:  # noqa: BLE001 — server still down; back off
            if new_watch is not None:
                try:
                    new_watch.stop()  # don't leak one socket per retry
                except Exception:  # noqa: BLE001
                    pass
            logger.warning("informer %s: resync failed (%s); retrying",
                           self.kind, e)
            return False
        if list_rv > self._last_rv:
            self._last_rv = list_rv
            self._notify_rv(list_rv)
        with self._watch_lock:
            if self._stop.is_set():
                # stop() already closed the old watch; ours must not leak.
                # Not a reconnect — nothing was re-established, so the
                # caller must not count it (phantom metric increments).
                new_watch.stop()
                return False
            old_watch, self._watch = self._watch, new_watch
        try:
            old_watch.stop()
        except Exception:  # noqa: BLE001
            pass
        curr = {self._key(o): o for o in current}
        with self._cache_lock:
            old_cache = dict(self._cache)
            # In-place swap, not rebinding: the cache dict's identity is
            # what the sanitizer's guarded wrapper (and any snapshot-then-
            # diff reader) is tied to.
            self._cache.clear()
            self._cache.update(curr)
            n = len(self._cache)
        self._set_cache_gauge(n)
        for key, obj in curr.items():
            old = old_cache.get(key)
            try:
                if old is None:
                    self._dispatch_add(obj)
                elif obj != old and self.on_update:
                    # Value inequality, NOT rv ordering: a restarted server
                    # may hand out LOWER resourceVersions for recreated
                    # objects (fresh counter), and those changes must still
                    # dispatch.
                    self.on_update(old, obj)
            except Exception:  # noqa: BLE001
                logger.exception("informer %s resync handler failed",
                                 self.kind)
        if self.on_delete:
            for key, obj in old_cache.items():
                if key not in curr:
                    try:
                        self.on_delete(obj)
                    except Exception:  # noqa: BLE001
                        logger.exception("informer %s resync on_delete "
                                         "failed", self.kind)
        logger.info("informer %s: watch re-established (%d objects, "
                    "%d reconnects so far)",
                    self.kind, len(curr), self.reconnect_count + 1)
        return True

    def _handle_dead_watch(self) -> None:
        """Backoff-paced watch replacement. The limiter is keyed by kind
        and only forgotten after a reconnected stream proves stable, so
        neither a down server (resync fails) nor a flapping one (resync
        succeeds, stream dies immediately) can turn the LIST+watch cycle
        into a hot loop."""
        now = time.monotonic()
        if (self._established_at is not None
                and now - self._established_at >= self._reconnect_stable_after):
            self._reconnect_limiter.forget(self.kind)
        self._established_at = None  # consumed; failed retries keep backoff
        delay = self._reconnect_limiter.when(self.kind, now)
        if delay > 0 and self._stop.wait(delay):
            return
        if self._try_resume():
            # Backlog replay re-established the stream — no relist, no
            # diff; the missed events flow through _run as usual.
            with self._reconnect_mu:
                self.reconnect_count += 1
            self._established_at = time.monotonic()
            self._metrics.watch_reconnects_total.inc(kind=self.kind)
            return
        if self._stop.is_set():
            return
        if self._resync():
            with self._reconnect_mu:
                self.reconnect_count += 1
                self.relist_count += 1
            self._established_at = time.monotonic()
            self._metrics.watch_reconnects_total.inc(kind=self.kind)
            # Relist after a failed backlog resume — the consumer-side
            # tick of a server-side backpressure disconnect (or a 410).
            self._metrics.relists_total.inc(kind=self.kind)
        elif not self._stop.is_set():  # a stop-raced attempt is neither
            self._metrics.resync_failures_total.inc(kind=self.kind)

    def _run(self) -> None:
        assert self._watch is not None
        while not self._stop.is_set():
            event = self._watch.next(timeout=0.2)
            if event is None:
                if (not getattr(self._watch, "alive", True)
                        and not self._stop.is_set()):
                    self._handle_dead_watch()
                continue
            rv = _rv(event.object)
            advanced = rv > self._last_rv
            if advanced:
                self._last_rv = rv
            if event.type == "BOOKMARK":
                # Progress marker only: the rv advance above is the whole
                # point — the next resume starts past everything this
                # stream has (or was filtered from) seeing. No cache
                # change, no handler dispatch.
                if advanced:
                    self._notify_rv(rv)
                continue
            handler_failed = False
            try:
                if not self._selected(event.object):
                    continue
                key = self._key(event.object)
                stale = False
                with self._cache_lock:
                    old = self._cache.get(key)
                    if event.type == "DELETED":
                        self._cache.pop(key, None)
                    else:
                        # Skip events at or before the cached
                        # resourceVersion: the initial LIST may already
                        # reflect buffered events, and an older buffered
                        # event must never overwrite a newer cached object.
                        stale = (old is not None
                                 and _rv(event.object) <= _rv(old))
                        if not stale:
                            # The event object is the SHARED fan-out
                            # snapshot (client.py single-copy contract):
                            # cached as-is and handed to handlers as-is —
                            # read-only downstream.
                            self._cache[key] = event.object
                    n = len(self._cache)
                if stale:
                    continue
                self._set_cache_gauge(n)
                try:
                    if event.type == "ADDED" and old is None:
                        self._dispatch_add(event.object)
                    elif event.type == "DELETED":
                        # Only if the cache knew the object: a resync diff
                        # may already have dispatched this deletion, and a
                        # DELETED for a never-seen object is not a
                        # transition.
                        if self.on_delete and old is not None:
                            self.on_delete(event.object)
                    else:  # MODIFIED, or ADDED for an object the cache knew
                        if self.on_update:
                            self.on_update(old, event.object)
                        elif self.on_add and old is None:
                            self.on_add(event.object)
                except Exception:  # noqa: BLE001
                    handler_failed = True
                    logger.exception("informer %s handler failed", self.kind)
            finally:
                # The rv is persisted only AFTER the event's dispatch
                # completed or was legitimately skipped (filtered out /
                # stale) — and NOT when the handler raised: the only
                # recovery for a failed handler is in-memory (retry
                # timers), so persisting its rv would let a process that
                # crashes before the retry fires resume PAST the event it
                # never processed — silent permanent loss. Persist-after
                # gives at-least-once replay instead, which every
                # consumer is idempotent against (the same property
                # resyncs rely on).
                if advanced and not handler_failed:
                    self._notify_rv(rv)

    def wait_for_cache_sync(self, timeout: float = 5.0) -> bool:
        return self._synced.wait(timeout)

    def cached(self, name: str, namespace: str = "") -> Optional[Obj]:
        with self._cache_lock:
            return self._cache.get((namespace, name))

    def cached_list(self) -> list[Obj]:
        with self._cache_lock:
            return list(self._cache.values())

    def initiate_stop(self) -> None:
        """Signal-only half of :meth:`stop`: set the stop flag and close
        the watch, without joining the event thread. Fleet-scale teardown
        (stresslab) signals hundreds of informers first and joins them
        after — serialized stop()+join would pay up to one poll interval
        per informer."""
        self._stop.set()
        with self._watch_lock:
            watch = self._watch
        if watch is not None:
            watch.stop()

    def join(self, timeout: float = 5.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def stop(self) -> None:
        self.initiate_stop()
        self.join()
