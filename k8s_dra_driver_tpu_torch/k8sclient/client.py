"""The fake API server: typed CRUD + watch over dict-shaped objects.

Mirrors the behavioral contract the reference's controllers rely on from
client-go fakes (SURVEY.md §4.1): uid assignment, monotonically increasing
resourceVersion, optimistic-concurrency conflicts, finalizer-gated deletion
(delete with finalizers present → deletionTimestamp set + MODIFIED event;
the object is removed only when the last finalizer is removed), namespaced
and cluster-scoped objects, label-selector list filtering, and buffered
watches.

- **Per-kind shards.** Each kind gets its own lock, store, event backlog
  and notify FIFO, so writers to different kinds never contend. The only
  cross-shard state is the cluster-wide monotonic resourceVersion counter
  (its own short lock, acquired strictly inside a shard lock).
- **resourceVersion-consistent LIST+WATCH.** Every commit stamps a
  monotonic resourceVersion; ``watch(resource_version=...)`` replays the
  missed events from a bounded per-kind backlog, and a watcher past the
  backlog window gets :class:`ExpiredError` ("resourceVersion too old",
  410 Gone over HTTP) so the consumer relists instead of going stale.
  Idle watchers receive periodic BOOKMARK events carrying the shard's
  current resourceVersion so they can always resume cheaply.
- **Paginated LIST.** :meth:`FakeClient.list_page` serves ``limit``/
  ``continue`` chunks that are snapshot-consistent at the first page's
  resourceVersion (later pages roll concurrent writes back via the
  backlog).
- **Bounded watch queues.** A watcher that stops consuming is disconnected
  once ``max_queue`` events pile up (forcing a clean resync) instead of
  ballooning memory.
- **Copy-free fan-out.** Stored objects are copy-on-write (no verb
  mutates a published dict in place), so the committed object itself is
  a faithful immutable snapshot — fan-out delivers it to every matching
  watcher WITHOUT a deep copy. Delivered objects are READ-ONLY by
  contract — informer caches hand them out as-is and handlers must copy
  before mutating. ``fanout_copy=True`` restores the one-copy-per-event
  behavior (the wire-path harness's baseline arm); copies are counted
  either way.
- **Status-patch coalescing.** ``update_status`` group-commits: writers
  queue their status patch and a batch leader applies up to
  ``DEFAULT_COALESCE_MAX`` of them under ONE shard-lock acquisition and
  ONE fan-out drain (the checkpoint group-commit pattern), so N actors
  stamping statuses together pay one lock convoy instead of N. Window
  bounded and counted (``gpu_dra_status_coalesce_batch_size``);
  per-transaction errors (conflict, not-found, injected commit faults)
  are isolated to their own caller. ``coalesce_status=False`` restores
  direct writes (baseline arm).
- **Per-object wire memo.** The HTTP transport serializes each event's
  wire form once (:meth:`WatchEvent.wire`, spliced via :mod:`wirecodec`)
  and shares the bytes across every remote watcher; the LIST serve path
  (:meth:`FakeClient.list_page_wire`) additionally memoizes each
  committed object's encoded bytes per shard, keyed by resourceVersion,
  bounded and counted — a page of N unchanged objects is a byte splice,
  not N re-encodes.
- **Counted watcher backpressure.** A stalled watcher is disconnected at
  its queue bound, but never silently: disconnects and dropped events
  tick ``gpu_dra_watch_backpressure_*`` counters and the per-shard debug
  snapshot (:meth:`FakeClient.wire_path_snapshot`).

The counterpart of the JAX package's ``k8sclient/client.py``, with what
``k8sclient/httpapi.py`` serves from. Under the sanitizer
(``GPU_DRA_SANITIZE``) every delivered snapshot is a deep-frozen copy, so a
watcher that mutates what it was handed raises at the mutation.
"""

from __future__ import annotations

import bisect
import copy
import json
import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from k8s_dra_driver_tpu_torch.k8sclient import wirecodec
from k8s_dra_driver_tpu_torch.pkg import faultpoints, racelab, sanitizer

Obj = dict[str, Any]

#: committed events retained per kind for watch replay / paginated-list
#: rollback; a consumer further behind than this window gets ExpiredError.
DEFAULT_BACKLOG_WINDOW = 1024
#: events a watcher may leave unconsumed before it is disconnected.
DEFAULT_WATCH_QUEUE = 1024
#: idle time after which Watch.next synthesizes a BOOKMARK event.
DEFAULT_BOOKMARK_INTERVAL = 5.0
#: status-coalescing window: most patches a batch leader applies under
#: one shard-lock acquisition (bounds the latency any one writer can add
#: to a batch-mate; the batch-size histogram proves the bound holds).
DEFAULT_COALESCE_MAX = 64
#: followers never wait longer than this for their batch leader — past
#: it something is wedged and the caller should see an error, not a hang.
COALESCE_WAIT_TIMEOUT = 60.0
#: per-shard wire-bytes memo entries (one per live object, FIFO-evicted
#: past the cap, evictions counted) — bounds serve-path memory on kinds
#: with more objects than any LIST page re-serves.
WIRE_CACHE_MAX = 4096


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(ValueError):
    pass


class ConflictError(RuntimeError):
    """resourceVersion mismatch on update — caller must re-read and retry."""


class ExpiredError(RuntimeError):
    """resourceVersion too old: the requested watch/list-continue point has
    fallen out of the per-kind event backlog (HTTP 410 Gone, reason
    ``Expired``) — the consumer must relist and resume from fresh state."""


class PartitionError(RuntimeError):
    """The node is partitioned from the API server: every verb from its
    clients fails and its watch streams die (docs/self-healing.md,
    "Whole-node repair"). Retryable — the partition heals, the caller's
    backoff loops ride it out; meanwhile the node's lease expires and
    the cluster side fences + cordons it."""


# Fault points (docs/fault-injection.md). The fake-client verbs are the
# substrate every in-process stack rides, so injecting here reaches every
# controller/plugin retry loop at once; the watch-drop point is shared with
# the HTTP transport (httpapi streams consult the same name).
FP_FAKE_MUTATE = faultpoints.register(
    "k8sclient.fake.mutate",
    "FakeClient create/update/update_status/delete fails",
    errors={"conflict": ConflictError, "notfound": NotFoundError},
    default_error="")
FP_FAKE_READ = faultpoints.register(
    "k8sclient.fake.read", "FakeClient get/list fails")
FP_FAKE_COMMIT = faultpoints.register(
    "k8sclient.fake.commit",
    "fires INSIDE the shard lock on every store commit — latency mode "
    "holds the write critical section open (the apiserver-side work a "
    "real commit pays), error modes fail the commit with the store "
    "untouched",
    errors={"conflict": ConflictError})
FP_WATCH_DROP = faultpoints.register(
    "k8sclient.watch.drop",
    "watch stream dies behind the consumer (server blip / stream reset)")
FP_WATCH_EXPIRED = faultpoints.register(
    "k8sclient.watch.expired",
    "watch(resource_version=...) resume is rejected with ExpiredError "
    "(410 Gone) even though the backlog still covers it — forces the "
    "consumer's relist-and-resume path",
    errors={"expired": ExpiredError}, default_error="expired")
FP_PARTITION = faultpoints.register(
    "k8sclient.partition",
    "every API verb from one node's (PartitionedClient-wrapped) clients "
    "fails and its watch streams die — the node-scale network partition "
    "the lease/fence machinery exists for",
    errors={"partition": PartitionError}, default_error="partition")


def _copy_obj(o: Any) -> Any:
    """Deep copy specialized for JSON-shaped API objects (dict/list/scalar)
    — several times faster than ``copy.deepcopy``, which matters because
    every CRUD copies under the owning shard's lock. Non-JSON values
    (never produced by the API surface, but tests may sneak them in) fall
    back to ``copy.deepcopy``."""
    if o is None or isinstance(o, (str, int, float, bool)):
        return o
    if isinstance(o, dict):
        return {k: _copy_obj(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_copy_obj(v) for v in o]
    return copy.deepcopy(o)


def meta(obj: Obj) -> dict[str, Any]:
    return obj.setdefault("metadata", {})


def obj_key(obj: Obj) -> tuple[str, str, str]:
    m = meta(obj)
    return (obj.get("kind", ""), m.get("namespace", ""), m.get("name", ""))


def new_object(kind: str, name: str, namespace: str = "",
               api_version: str = "v1", **top_level: Any) -> Obj:
    o: Obj = {
        "apiVersion": api_version,
        "kind": kind,
        "metadata": {"name": name},
    }
    if namespace:
        o["metadata"]["namespace"] = namespace
    o.update(top_level)
    return o


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED | BOOKMARK
    object: Obj
    # Lazily memoized JSON wire form, shared by every HTTP watcher of this
    # event (encode-once fan-out). Benign race: two threads may both
    # encode, producing identical bytes; one wins the store.
    _wire: Optional[bytes] = field(default=None, repr=False, compare=False)

    def wire(self) -> bytes:
        w = self._wire
        if w is None:
            w = wirecodec.wire_watch_frame(
                self.type, wirecodec.encode_obj(self.object,
                                                site="watch_frame"))
            self._wire = w
        return w


class Watch:
    """A buffered event stream for one kind (optionally one namespace).

    The queue is BOUNDED (``max_queue``): a consumer that stops draining
    is disconnected (``alive`` goes False, further delivery stops) rather
    than growing server memory without limit — the consumer's informer
    then resyncs over a fresh watch, exactly as for a dropped stream.

    When ``bookmark_interval`` elapses with nothing to deliver, ``next``
    synthesizes a BOOKMARK event carrying the kind's current committed
    resourceVersion, so even watchers whose filter matches nothing (e.g.
    another namespace) can resume a replacement watch without a relist.
    """

    def __init__(self, kind: str, namespace: Optional[str],
                 unsubscribe: Callable[["Watch"], None],
                 current_rv: Optional[Callable[[], int]] = None,
                 max_queue: int = DEFAULT_WATCH_QUEUE,
                 bookmark_interval: float = DEFAULT_BOOKMARK_INTERVAL,
                 on_drop: Optional[Callable[["Watch", bool], None]] = None):
        self.kind = kind
        self.namespace = namespace
        self.events: "queue.Queue[WatchEvent]" = queue.Queue()
        self.max_queue = max_queue
        self.bookmark_interval = bookmark_interval
        self._unsubscribe = unsubscribe
        self._current_rv = current_rv
        self._on_drop = on_drop  # (watch, disconnected) — backpressure tick
        self._stopped = False
        self._dead = False  # fault-injected stream death (alive → False)
        self._overflowed = False  # consumer stalled past max_queue
        self.dropped = 0  # events not queued because this watch overflowed
        self._last_rv_out = 0   # newest rv handed to the consumer
        self._last_out_at = time.monotonic()
        # HB channel identity: a never-reused serial, NOT id(self) — a
        # recycled id would graft a dead watch's clock onto a fresh one,
        # inventing orderings that mask real races.
        self._race_chan = racelab.new_cell("watch")

    def matches(self, obj: Obj) -> bool:
        if obj.get("kind") != self.kind:
            return False
        if self.namespace is not None:
            return meta(obj).get("namespace", "") == self.namespace
        return True

    def deliver(self, event: WatchEvent, replay: bool = False) -> bool:
        """``replay``: initial-list / backlog-replay events generated
        synchronously under the shard lock — they bypass the stall bound
        (one bounded burst, not unbounded growth). Returns whether the
        event was actually queued (False for stopped, dropped and
        overflowed watches, so delivery counters don't count drops)."""
        if self._stopped or self._dead:
            # A commit-time watcher snapshot taken before the drop can
            # still aim events here; a dead stream takes nothing more.
            return False
        if self._overflowed:
            # Commit-time watcher snapshots taken before the disconnect
            # can still aim events here — counted, never silent.
            self.dropped += 1
            if self._on_drop is not None:
                self._on_drop(self, False)
            return False
        if not replay and self.events.qsize() >= self.max_queue:
            # Stalled consumer: cut it off. alive goes False, so an HTTP
            # stream serving this watch closes and the remote informer
            # resyncs (relist counted there); memory held is capped at
            # max_queue events.
            self._overflowed = True
            self.dropped += 1
            self._unsubscribe(self)
            if self._on_drop is not None:
                self._on_drop(self, True)
            return False
        # HB edge: watch delivery is a cross-thread hand-off — everything
        # the committer did before this event is ordered before the
        # consumer that receives it (race mode; the informer's dispatch
        # threads read the shared snapshot this queue carries).
        racelab.hb_send(self._race_chan)
        self.events.put(event)
        return True

    def next(self, timeout: Optional[float] = 5.0) -> Optional[WatchEvent]:
        if not self._dead and faultpoints.fires(FP_WATCH_DROP):
            # Simulated stream death: stop delivery, discard anything
            # buffered but undelivered (a real dropped stream loses its
            # in-flight events too), and report not-alive so the consumer
            # (Informer) exercises its resync path exactly as it would for
            # a dropped HTTP watch.
            self._dead = True
            self._unsubscribe(self)
            while not self.events.empty():
                try:
                    self.events.get_nowait()
                except queue.Empty:
                    break
        if self._dead:
            # Nothing after the drop: an event a racing fan-out queued
            # after the discard is newer than the discarded ones, and
            # handing it out would move the consumer's resume point past
            # them — lost for good instead of replayed.
            return None
        try:
            ev = self.events.get(timeout=timeout)
        except queue.Empty:
            return self._maybe_bookmark()
        racelab.hb_recv(self._race_chan)
        rv = _obj_rv(ev.object)
        if rv:
            self._last_rv_out = max(self._last_rv_out, rv)
        self._last_out_at = time.monotonic()
        return ev

    def _maybe_bookmark(self) -> Optional[WatchEvent]:
        if not self.alive:
            # A dead/overflowed/stopped watch has LOST events (drop
            # discards its queue) — a bookmark here would name rvs the
            # consumer never received and poison its resume point past
            # them (silent permanent loss instead of replay/relist).
            return None
        if self._current_rv is None or self.bookmark_interval <= 0:
            return None
        now = time.monotonic()
        if now - self._last_out_at < self.bookmark_interval:
            return None
        # Safe ordering: _drain_notify publishes to queues BEFORE advancing
        # delivered_rv, so once our queue is empty every event at or below
        # current_rv() has already been consumed — a resume from the
        # bookmark rv cannot skip anything.
        rv = self._current_rv()
        if rv <= self._last_rv_out or not self.events.empty():
            self._last_out_at = now  # nothing new; re-arm the interval
            return None
        self._last_rv_out = rv
        self._last_out_at = now
        return WatchEvent("BOOKMARK", {
            "kind": self.kind, "metadata": {"resourceVersion": str(rv)}})

    def stop(self) -> None:
        self._stopped = True
        self._unsubscribe(self)

    @property
    def alive(self) -> bool:
        """False once stopped, fault-dropped, or disconnected for stalling
        past ``max_queue`` — the HTTP transport's watch overrides this
        (real transport failures)."""
        return not self._stopped and not self._dead and not self._overflowed

    @property
    def overflowed(self) -> bool:
        return self._overflowed


def _obj_rv(obj: Obj) -> int:
    try:
        return int((obj.get("metadata") or {}).get("resourceVersion", 0))
    except (TypeError, ValueError):
        return 0


def match_labels(obj: Obj, selector: Optional[dict[str, str]]) -> bool:
    if not selector:
        return True
    labels = meta(obj).get("labels") or {}
    return all(labels.get(k) == v for k, v in selector.items())


def _observe_status_batch(kind: str, size: int) -> None:
    """Record one coalesced-status batch in the wire-path metrics. Never
    raises — metrics must not break the write path."""
    try:
        from k8s_dra_driver_tpu_torch.pkg.metrics import (
            default_wirepath_metrics,
        )
        default_wirepath_metrics().status_coalesce_batch_size.observe(
            size, kind=kind or "_all")
    except Exception:  # noqa: BLE001 — metrics hook
        pass


class _StatusTxn:
    """One queued ``update_status`` awaiting its batch's group commit
    (the checkpoint ``_Txn`` pattern on the apiserver write path)."""

    __slots__ = ("obj", "done", "result", "error", "chan")

    def __init__(self, obj: Obj):
        self.obj = obj
        self.done = threading.Event()
        self.result: Optional[Obj] = None
        self.error: Optional[BaseException] = None
        # HB channel identity: a never-reused serial, NOT id(self) —
        # txns are short-lived and CPython recycles addresses, so an
        # id-keyed channel would hand a fresh txn a dead txn's clock.
        self.chan = racelab.new_cell("status-txn")


class _Shard:
    """One kind's slice of the store: its own lock, objects, write
    generation, watcher set, bounded event backlog, and notify FIFO.
    All fields are guarded by ``lock`` except the FIFO drain, which is
    serialized by ``notify_mu`` (acquired strictly BEFORE ``lock``; the
    reverse order never occurs, so the pair cannot deadlock), and the
    status-coalescing pipeline (``status_pending_mu`` guards the queue,
    ``status_commit_mu`` serializes batch leaders; order:
    status_commit_mu → lock → pending/notify internals)."""

    __slots__ = ("lock", "objects", "gens", "usage_gens", "watches",
                 "backlog", "trim_rv", "delivered_rv", "pending_notify",
                 "notify_mu", "last_rv", "sorted_keys", "events_delivered",
                 "wire_cache", "wire_hits", "wire_misses", "wire_evictions",
                 "overflow_disconnects", "dropped_events",
                 "fanout_events", "fanout_copies",
                 "status_pending", "status_pending_mu", "status_commit_mu",
                 "status_batches", "status_batched")

    def __init__(self, backlog_window: int):
        self.lock = sanitizer.new_lock("FakeClient._Shard.lock",
                                       reentrant=True)
        # Keyed (kind, namespace, name): one shard serves one kind.
        self.objects: dict[tuple[str, str, str], Obj] = sanitizer.track_state(
            {}, "FakeClient.shard.objects")
        # Lazily rebuilt sorted view of objects' keys (guarded by lock,
        # invalidated on create/delete): paginated crawls and initial
        # snapshots iterate in key order, and re-sorting the whole kind
        # under the lock on EVERY page would cost more critical-section
        # time than the one-shot LIST pagination exists to replace.
        self.sorted_keys: Optional[list[tuple[str, str, str]]] = None
        self.gens: dict[str, int] = {}
        # Status-bearing writes only (see FakeClient.kind_usage_generation):
        # bumped when a commit changed some object's ``status`` — including
        # creating or deleting an object that carries one — and NOT by
        # spec/metadata-only writes. Caches over status-derived aggregates
        # (the allocator's usage index) key on this, so claim creates and
        # annotation RMWs stop invalidating them.
        self.usage_gens: dict[str, int] = {}
        self.watches: list[Watch] = []
        # (rv, etype, obj, prev) in commit order; prev is the displaced
        # stored object (MODIFIED/DELETED) for paginated-list rollback.
        self.backlog: deque[tuple[int, str, Obj, Optional[Obj]]] = deque(
            maxlen=backlog_window)
        self.trim_rv = 0        # highest rv ever evicted from the backlog
        self.last_rv = 0        # rv of the newest commit in this shard
        self.delivered_rv = 0   # rv of the newest FANNED-OUT commit
        self.pending_notify: deque[tuple[int, str, Obj, tuple[Watch, ...]]] \
            = deque()
        self.notify_mu = sanitizer.new_lock("FakeClient._Shard.notify_mu")
        self.events_delivered = 0  # per-watcher queue puts (guarded by
        # notify_mu — the only writer holds it)
        # Per-object encoded-bytes memo for the LIST serve path: key →
        # (resourceVersion, bytes). Guarded by ``lock``; bounded at
        # WIRE_CACHE_MAX (FIFO eviction, counted).
        self.wire_cache: dict[tuple[str, str, str], tuple[str, bytes]] = {}
        self.wire_hits = 0
        self.wire_misses = 0
        self.wire_evictions = 0
        # Backpressure accounting (guarded by ``lock``): stalled-watcher
        # disconnects and events dropped at/after the disconnect.
        self.overflow_disconnects = 0
        self.dropped_events = 0
        # Fan-out accounting (guarded by notify_mu, same as
        # events_delivered): events drained vs. deep copies paid — the
        # wire-path harness's copies-halved check reads these.
        self.fanout_events = 0
        self.fanout_copies = 0
        # Status-coalescing pipeline (checkpoint group-commit shape).
        self.status_pending: deque[_StatusTxn] = deque()
        self.status_pending_mu = sanitizer.new_lock(
            "FakeClient._Shard.status_pending_mu")
        self.status_commit_mu = sanitizer.new_lock(
            "FakeClient._Shard.status_commit_mu")
        self.status_batches = 0   # batches committed (guarded by lock)
        self.status_batched = 0   # txns committed via batches (ditto)

    def sorted_key_view(self) -> list[tuple[str, str, str]]:
        """Caller holds ``lock``. The returned list must not be mutated."""
        if self.sorted_keys is None:
            self.sorted_keys = sorted(self.objects)
        return self.sorted_keys


class FakeClient:
    """Thread-safe in-memory object store with k8s API semantics, one
    shard per kind.

    ``sharded=False`` collapses every kind onto ONE shard (one lock, one
    backlog, one notify FIFO): the single-lock baseline that
    ``run_cross_kind_writes`` and ``run_node_fleet`` compare against.
    ``fanout_copy=True`` and ``coalesce_status=False`` likewise restore
    copy-per-event fan-out and direct (uncoalesced) status writes — the
    baseline arm of ``run_wire_path``."""

    def __init__(self, sharded: bool = True,
                 fanout_copy: bool = False,
                 coalesce_status: bool = True) -> None:
        self._sharded = sharded
        self._fanout_copy = fanout_copy
        self._coalesce_status = coalesce_status
        self._shards: dict[str, _Shard] = {}
        self._shards_mu = sanitizer.new_lock("FakeClient._shards_mu")
        # Cluster-wide monotonic resourceVersion. Taken strictly INSIDE a
        # shard lock (shard.lock → _rv_mu); never the other way around.
        self._rv = 0
        self._rv_mu = sanitizer.new_lock("FakeClient._rv_mu")

    # -- internals ----------------------------------------------------------

    def _shard(self, kind: str) -> _Shard:
        key = kind if self._sharded else ""
        s = self._shards.get(key)
        if s is None:
            with self._shards_mu:
                s = self._shards.get(key)
                if s is None:
                    s = _Shard(DEFAULT_BACKLOG_WINDOW)
                    self._shards[key] = s
        return s

    def _next_rv(self) -> str:
        with self._rv_mu:
            self._rv += 1
            return str(self._rv)

    def _notify(self, shard: _Shard, etype: str, obj: Obj,
                prev: Optional[Obj] = None) -> None:
        """Record one committed event. Caller holds ``shard.lock``; the
        watcher set is snapshotted NOW so a watch registered after this
        commit sees the object only through its own initial list, never
        twice. Stored objects are copy-on-write (no verb mutates a
        published dict in place), so the reference stays a faithful
        snapshot until the fan-out in :meth:`_drain_notify` hands it out.
        ``prev`` is the displaced stored object, whose status decides
        whether the commit advances the status-write generation; it rides
        the backlog so paginated LISTs can roll late writes back to their
        snapshot."""
        kind = obj.get("kind", "")
        shard.gens[kind] = shard.gens.get(kind, 0) + 1
        # Status-write generation: advance only when this commit changed
        # some object's status (or added/removed an object carrying one).
        status_after = obj.get("status") or None
        status_before = (prev.get("status") or None) if prev is not None \
            else None
        if etype == "DELETED":
            status_dirty = (status_before is not None
                            or status_after is not None)
        elif etype == "ADDED":
            status_dirty = status_after is not None
        else:
            status_dirty = status_before != status_after
        if status_dirty:
            shard.usage_gens[kind] = shard.usage_gens.get(kind, 0) + 1
        rv = _obj_rv(obj)
        shard.last_rv = max(shard.last_rv, rv)
        if (shard.backlog.maxlen is not None
                and len(shard.backlog) == shard.backlog.maxlen
                and shard.backlog):
            shard.trim_rv = max(shard.trim_rv, shard.backlog[0][0])
        shard.backlog.append((rv, etype, obj, prev))
        shard.pending_notify.append((rv, etype, obj, tuple(shard.watches)))

    def _drain_notify(self, shard: _Shard) -> None:
        """Fan committed events out to their watchers, copy-free.

        Runs with the shard lock RELEASED. Stored objects are
        copy-on-write (no verb mutates a published dict in place), so the
        committed object IS an immutable snapshot and every matching
        watcher shares the same reference — the client-go read-only
        contract, with zero deep copies on the hot path. ``fanout_copy=True``
        (the wire-path harness's baseline arm) restores one deep copy per
        event. Copies paid are counted (``fanout_copies``) against events
        drained (``fanout_events``) — the harness's copies-halved check.

        The delivery lock ``notify_mu`` drains the FIFO one event at a
        time, so per-watcher delivery order always equals commit order
        even when several writers drain concurrently. ``delivered_rv``
        advances only AFTER the queue puts, so a bookmark taken at
        delivered_rv can never name an rv whose event is still in
        flight."""
        copy_fanout = self._fanout_copy
        while True:
            with shard.notify_mu:
                with shard.lock:
                    if not shard.pending_notify:
                        return
                    rv, etype, obj, watchers = shard.pending_notify.popleft()
                shard.fanout_events += 1
                if sanitizer.enabled():
                    snapshot = sanitizer.deep_freeze(_copy_obj(obj))
                    shard.fanout_copies += 1
                elif copy_fanout:
                    snapshot = _copy_obj(obj)
                    shard.fanout_copies += 1
                else:
                    snapshot = obj
                event = WatchEvent(etype, snapshot)
                for w in watchers:
                    if w.matches(snapshot) and w.deliver(event):
                        shard.events_delivered += 1
                shard.delivered_rv = max(shard.delivered_rv, rv)

    # -- generation stamps ----------------------------------------------------

    def kind_generation(self, *kinds: str) -> tuple[int, ...]:
        """Current write generation per kind, as one atomic-enough
        snapshot. A cache stamped with this tuple is valid exactly until
        any of these kinds is mutated again. (Across shards the reads are
        not one critical section, but each kind's generation is read under
        its own shard lock — a concurrent write to any requested kind
        yields a tuple that differs from the post-write stamp, which is
        all invalidation needs.)"""
        out = []
        for k in kinds:
            shard = self._shard(k)
            with shard.lock:
                out.append(shard.gens.get(k, 0))
        return tuple(out)

    def kind_usage_generation(self, *kinds: str) -> tuple[int, ...]:
        """Like :meth:`kind_generation`, but counting only STATUS-BEARING
        writes: commits that changed an object's ``status`` (update/
        update_status), or created/deleted an object carrying one.
        Spec, annotation, and label writes do not advance it.

        This is the invalidation stamp for caches over status-derived
        aggregates — the allocator's usage index depends only on
        ``status.allocation`` across claims, and keying it here means a
        burst of claim CREATES (10k pending claims arriving) no longer
        costs one full usage rescan per subsequent allocation
        (docs/performance.md, "Topology-aware allocation")."""
        out = []
        for k in kinds:
            shard = self._shard(k)
            with shard.lock:
                out.append(shard.usage_gens.get(k, 0))
        return tuple(out)

    def watch_events_delivered(self) -> int:
        """Total watcher-queue deliveries across all shards (the node
        fleet's events/s numerator)."""
        total = 0
        with self._shards_mu:
            shards = list(self._shards.values())
        for s in shards:
            with s.notify_mu:
                total += s.events_delivered
        return total

    # -- CRUD ---------------------------------------------------------------

    def create(self, obj: Obj) -> Obj:
        faultpoints.maybe_fail(FP_FAKE_MUTATE)
        key = obj_key(obj)
        if not key[0] or not key[2]:
            raise ValueError(f"object needs kind and metadata.name: {key}")
        shard = self._shard(key[0])
        with shard.lock:
            faultpoints.maybe_fail(FP_FAKE_COMMIT)
            if key in shard.objects:
                raise AlreadyExistsError(f"{key} already exists")
            stored = _copy_obj(obj)
            m = meta(stored)
            m.setdefault("uid", str(uuid.uuid4()))
            m["resourceVersion"] = self._next_rv()
            m.setdefault("creationTimestamp", time.time())
            m.setdefault("labels", m.get("labels") or {})
            shard.objects[key] = stored
            shard.sorted_keys = None  # key set grew
            self._notify(shard, "ADDED", stored)
            ret = _copy_obj(stored)
        self._drain_notify(shard)
        return ret

    def get(self, kind: str, name: str, namespace: str = "") -> Obj:
        faultpoints.maybe_fail(FP_FAKE_READ)
        shard = self._shard(kind)
        with shard.lock:
            key = (kind, namespace, name)
            if key not in shard.objects:
                raise NotFoundError(f"{key} not found")
            return _copy_obj(shard.objects[key])

    def try_get(self, kind: str, name: str, namespace: str = "") -> Optional[Obj]:
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def update(self, obj: Obj) -> Obj:
        faultpoints.maybe_fail(FP_FAKE_MUTATE)
        shard = self._shard(obj.get("kind", ""))
        with shard.lock:
            faultpoints.maybe_fail(FP_FAKE_COMMIT)
            ret = self._update_locked(shard, obj)
        self._drain_notify(shard)
        return ret

    def _update_locked(self, shard: _Shard, obj: Obj) -> Obj:
        """Core of update. Caller holds ``shard.lock`` and drains after."""
        key = obj_key(obj)
        if key not in shard.objects:
            raise NotFoundError(f"{key} not found")
        current = shard.objects[key]
        incoming_rv = meta(obj).get("resourceVersion")
        if incoming_rv is not None and incoming_rv != current["metadata"]["resourceVersion"]:
            raise ConflictError(
                f"{key}: resourceVersion {incoming_rv} != "
                f"{current['metadata']['resourceVersion']}")
        stored = _copy_obj(obj)
        m = meta(stored)
        m["uid"] = current["metadata"]["uid"]
        m["creationTimestamp"] = current["metadata"]["creationTimestamp"]
        if current["metadata"].get("deletionTimestamp") is not None:
            m.setdefault("deletionTimestamp",
                         current["metadata"]["deletionTimestamp"])
        m["resourceVersion"] = self._next_rv()
        # Finalizer-gated deletion: when a terminating object loses its
        # last finalizer, the update completes the delete.
        if m.get("deletionTimestamp") is not None and not m.get("finalizers"):
            del shard.objects[key]
            shard.sorted_keys = None  # key set shrank
            self._notify(shard, "DELETED", stored, prev=current)
            return _copy_obj(stored)
        shard.objects[key] = stored
        self._notify(shard, "MODIFIED", stored, prev=current)
        return _copy_obj(stored)

    def update_status(self, obj: Obj) -> Obj:
        """Status-subresource update: only ``status`` is taken from ``obj``
        (and its resourceVersion, when set, must match).

        Group-committed (the checkpoint ``transact`` pattern): concurrent
        status writers queue their patch and one batch leader applies up
        to ``DEFAULT_COALESCE_MAX`` of them under a single shard-lock
        acquisition followed by a single fan-out drain — N actors
        stamping statuses together pay one apply window instead of N
        lock convoys. The call stays synchronous (returns the committed
        object, raises this patch's own conflict/not-found/injected-fault
        error); the event is fanned out before the call returns."""
        faultpoints.maybe_fail(FP_FAKE_MUTATE)
        shard = self._shard(obj.get("kind", ""))
        if not self._coalesce_status:
            with shard.lock:
                ret = self._apply_status_locked(shard, obj)
            self._drain_notify(shard)
            return ret
        txn = _StatusTxn(obj)
        with shard.status_pending_mu:
            shard.status_pending.append(txn)
        # The bounded window means a leader may commit a full batch that
        # does not yet include us — loop until some leader (possibly this
        # caller) has committed our txn. FIFO pops guarantee progress.
        deadline = time.monotonic() + COALESCE_WAIT_TIMEOUT
        while not txn.done.is_set():
            batch_size = [0]
            try:
                with shard.status_commit_mu:
                    if not txn.done.is_set():
                        self._commit_status_batch(shard, batch_size)
            finally:
                # Histogram observation OUTSIDE the leadership lock:
                # followers of the next batch are already queued on
                # status_commit_mu.
                if batch_size[0]:
                    _observe_status_batch(obj.get("kind", ""), batch_size[0])
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "update_status group-commit made no progress within "
                    f"{COALESCE_WAIT_TIMEOUT}s")
        racelab.hb_recv(txn.chan)
        if txn.error is not None:
            raise txn.error
        assert txn.result is not None
        return txn.result

    def _apply_status_locked(self, shard: _Shard, obj: Obj) -> Obj:
        """Merge + commit one status patch. Caller holds ``shard.lock``
        and drains after. The commit fault point fires here, inside the
        lock, once per patch — exactly as it fires per call without
        coalescing (latency mode holds the critical section open; error
        modes fail only this patch)."""
        faultpoints.maybe_fail(FP_FAKE_COMMIT)
        key = obj_key(obj)
        if key not in shard.objects:
            raise NotFoundError(f"{key} not found")
        merged = _copy_obj(shard.objects[key])
        merged["status"] = _copy_obj(obj.get("status"))
        merged["metadata"]["resourceVersion"] = meta(obj).get(
            "resourceVersion", merged["metadata"]["resourceVersion"])
        return self._update_locked(shard, merged)

    def _commit_status_batch(self, shard: _Shard,
                             batch_size: Optional[list] = None) -> None:
        """Apply up to ``DEFAULT_COALESCE_MAX`` queued status patches as
        one batch: ONE shard-lock acquisition, per-txn error isolation, ONE
        fan-out drain, then wake every member. Caller holds
        ``status_commit_mu``."""
        with shard.status_pending_mu:
            batch = [shard.status_pending.popleft()
                     for _ in range(min(len(shard.status_pending),
                                        DEFAULT_COALESCE_MAX))]
        if batch_size is not None:
            batch_size[0] = len(batch)
        if not batch:
            return
        try:
            with shard.lock:
                shard.status_batches += 1
                shard.status_batched += len(batch)
                for txn in batch:
                    try:
                        txn.result = self._apply_status_locked(
                            shard, txn.obj)
                    except Exception as e:  # noqa: BLE001 — per-txn failure
                        txn.error = e
            self._drain_notify(shard)
        except BaseException as e:
            # Batch-level failure: every member that has no error of its
            # own failed with it (nobody may be left stranded in wait).
            for txn in batch:
                if txn.error is None and txn.result is None:
                    txn.error = e
            raise
        finally:
            for txn in batch:
                # HB edge: the leader ran this follower's merge on ITS
                # thread — order that work before the follower resuming.
                racelab.hb_send(txn.chan)
                txn.done.set()

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        faultpoints.maybe_fail(FP_FAKE_MUTATE)
        shard = self._shard(kind)
        with shard.lock:
            faultpoints.maybe_fail(FP_FAKE_COMMIT)
            key = (kind, namespace, name)
            if key not in shard.objects:
                raise NotFoundError(f"{key} not found")
            obj = shard.objects[key]
            if meta(obj).get("finalizers"):
                if meta(obj).get("deletionTimestamp") is None:
                    # Copy-on-write: the previously published dict may be
                    # referenced by an undelivered event snapshot-to-be.
                    terminating = _copy_obj(obj)
                    meta(terminating)["deletionTimestamp"] = time.time()
                    meta(terminating)["resourceVersion"] = self._next_rv()
                    shard.objects[key] = terminating
                    self._notify(shard, "MODIFIED", terminating, prev=obj)
            else:
                del shard.objects[key]
                shard.sorted_keys = None  # key set shrank
                # The deletion gets its own fresh resourceVersion (as on a
                # real apiserver): backlog replay is rv-ordered, so a
                # DELETED event carrying the object's stale rv would sort
                # before — and be skipped by — resumes taken after it.
                tombstone = _copy_obj(obj)
                meta(tombstone)["resourceVersion"] = self._next_rv()
                self._notify(shard, "DELETED", tombstone, prev=obj)
        self._drain_notify(shard)

    # -- list ---------------------------------------------------------------

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[dict[str, str]] = None) -> list[Obj]:
        return self.list_page(kind, namespace, label_selector)["items"]

    def list_page(self, kind: str, namespace: Optional[str] = None,
                  label_selector: Optional[dict[str, str]] = None,
                  limit: int = 0, continue_token: str = "") -> dict[str, Any]:
        """LIST with k8s-style chunking. Returns ``{"items": [...],
        "metadata": {"resourceVersion": str, "continue": str}}``.

        With ``limit`` > 0 only that many (filtered) items are copied per
        call; the returned ``continue`` token resumes after the last key.
        Every page is served from the store AS OF the first page's
        resourceVersion: writes committed after the snapshot are rolled
        back via the per-kind backlog, so a crawler never sees a
        half-old/half-new world. A token whose snapshot has fallen out of
        the backlog raises :class:`ExpiredError` (410 Gone) — restart the
        list, exactly as against a real apiserver."""
        selected, snapshot_rv, next_key = self._list_page_select(
            kind, namespace, label_selector, limit, continue_token)
        return {"items": [_copy_obj(o) for o in selected],
                "metadata": {"resourceVersion": str(snapshot_rv),
                             "continue": next_key}}

    def list_page_wire(self, kind: str, namespace: Optional[str] = None,
                       label_selector: Optional[dict[str, str]] = None,
                       limit: int = 0, continue_token: str = "") -> bytes:
        """:meth:`list_page`, already encoded: byte-identical to
        ``json.dumps(self.list_page(...)).encode()`` but each item's
        bytes come from the shard's per-object wire memo (hit = splice,
        no re-walk) — the LIST half of the serve path's encode-once
        discipline. The HTTP apiserver serves LIST from here."""
        shard = self._shard(kind)
        selected, snapshot_rv, next_key = self._list_page_select(
            kind, namespace, label_selector, limit, continue_token)
        return wirecodec.wire_list_page(
            [self._wire_obj_bytes(shard, o) for o in selected],
            str(snapshot_rv), next_key)

    def _list_page_select(self, kind: str, namespace: Optional[str],
                          label_selector: Optional[dict[str, str]],
                          limit: int, continue_token: str,
                          ) -> tuple[list[Obj], int, str]:
        """Shared LIST core: select the page's stored objects (refs, not
        copies — stored objects are immutable-by-contract, so holding
        them past the lock is safe) plus snapshot rv and continue token.
        Callers copy or encode per their serving shape."""
        faultpoints.maybe_fail(FP_FAKE_READ)
        shard = self._shard(kind)
        after_key: Optional[tuple[str, str, str]] = None
        snapshot_rv = 0
        if continue_token:
            snapshot_rv, after_key = _decode_continue(continue_token)
        with shard.lock:
            if continue_token:
                if snapshot_rv < shard.trim_rv:
                    raise ExpiredError(
                        f"continue token at resourceVersion {snapshot_rv} "
                        f"is too old (backlog starts past {shard.trim_rv})")
                if shard.last_rv <= snapshot_rv:
                    # Nothing committed since the snapshot — the common
                    # quiet-crawl case needs no store copy or rollback.
                    objects = shard.objects
                else:
                    objects = _rollback(shard, snapshot_rv)
            else:
                objects = shard.objects
                snapshot_rv = self._current_rv_locked(shard)
            items: list[Obj] = []
            next_key = ""
            last_key: Optional[tuple[str, str, str]] = None
            # The live store iterates its cached sorted view; only a
            # rolled-back snapshot (writes landed mid-crawl) pays a sort.
            keys = (shard.sorted_key_view() if objects is shard.objects
                    else sorted(objects))
            start = (bisect.bisect_right(keys, after_key)
                     if after_key is not None else 0)
            for key in keys[start:]:
                if key[0] != kind:
                    continue
                obj = objects[key]
                if namespace is not None and key[1] != namespace:
                    continue
                if not match_labels(obj, label_selector):
                    continue
                if limit and len(items) >= limit:
                    # Token records the last INCLUDED key; the next page
                    # resumes strictly after it (this key is served then).
                    next_key = _encode_continue(snapshot_rv, last_key)
                    break
                items.append(obj)
                last_key = key
            return items, snapshot_rv, next_key

    def _wire_obj_bytes(self, shard: _Shard, obj: Obj) -> bytes:
        """Encoded bytes of a stored object, via the shard's bounded
        per-object memo: valid exactly while the object's
        resourceVersion is unchanged (every commit mints a fresh rv, so
        rv equality IS content equality). Encoding happens OUTSIDE the
        shard lock — stored objects are immutable-by-contract."""
        key = obj_key(obj)
        rv = (obj.get("metadata") or {}).get("resourceVersion", "")
        with shard.lock:
            ent = shard.wire_cache.get(key)
            if ent is not None and ent[0] == rv:
                shard.wire_hits += 1
                return ent[1]
            shard.wire_misses += 1
        data = wirecodec.encode_obj(obj, site="list_item")
        with shard.lock:
            shard.wire_cache[key] = (rv, data)
            while len(shard.wire_cache) > WIRE_CACHE_MAX:
                shard.wire_cache.pop(next(iter(shard.wire_cache)))
                shard.wire_evictions += 1
        return data

    def wire_path_snapshot(self) -> dict[str, int]:
        """Aggregated wire-path accounting across shards (debug/harness
        surface; the metric families mirror the backpressure and
        coalescing rows). Copies-per-event is the wire-path harness's
        allocation check: 1.0 in baseline arms, 0.0 copy-free."""
        out = {"fanout_events": 0, "fanout_copies": 0,
               "overflow_disconnects": 0, "dropped_events": 0,
               "wire_cache_hits": 0, "wire_cache_misses": 0,
               "wire_cache_evictions": 0,
               "status_batches": 0, "status_batched": 0}
        with self._shards_mu:
            shards = list(self._shards.values())
        for s in shards:
            with s.notify_mu:
                out["fanout_events"] += s.fanout_events
                out["fanout_copies"] += s.fanout_copies
            with s.lock:
                out["overflow_disconnects"] += s.overflow_disconnects
                out["dropped_events"] += s.dropped_events
                out["wire_cache_hits"] += s.wire_hits
                out["wire_cache_misses"] += s.wire_misses
                out["wire_cache_evictions"] += s.wire_evictions
                out["status_batches"] += s.status_batches
                out["status_batched"] += s.status_batched
        return out

    def _current_rv_locked(self, shard: _Shard) -> int:
        """Snapshot rv for a fresh list: the global counter would overstate
        what this shard has committed only by rvs belonging to OTHER
        kinds, which never appear in this shard's backlog — so the
        shard's own last commit is the tightest safe stamp, and the
        global counter the safe fallback for an empty shard."""
        if shard.last_rv:
            return shard.last_rv
        with self._rv_mu:
            return self._rv

    # -- watch --------------------------------------------------------------

    def watch(self, kind: str, namespace: Optional[str] = None,
              send_initial: bool = False,
              resource_version: Optional[int] = None,
              max_queue: int = DEFAULT_WATCH_QUEUE,
              bookmark_interval: float = DEFAULT_BOOKMARK_INTERVAL) -> Watch:
        """Subscribe to ``kind`` events.

        ``resource_version``: resume point — every backlogged event with a
        newer rv is replayed into the watch before live delivery begins
        (atomically, under the shard lock), so a consumer that reconnects
        with its last-seen rv misses nothing and re-receives nothing. If
        the backlog no longer reaches back that far, raises
        :class:`ExpiredError` and the consumer must relist.

        Mutually exclusive with ``send_initial`` (as on a real
        apiserver): combining them would deliver each post-resume object
        twice — its snapshot ADDED at the latest rv AND its replayed
        events, with the replay arriving rv-backwards after the snapshot.
        """
        if send_initial and resource_version is not None:
            raise ValueError(
                "watch(): send_initial and resource_version are mutually "
                "exclusive — a resume replays the missed events, a "
                "snapshot restates the world; mixing them duplicates and "
                "reorders deliveries")
        shard = self._shard(kind)
        with shard.lock:
            if resource_version is not None:
                faultpoints.maybe_fail(FP_WATCH_EXPIRED)
                if resource_version < shard.trim_rv:
                    raise ExpiredError(
                        f"watch of {kind} from resourceVersion "
                        f"{resource_version} is too old (backlog starts "
                        f"past {shard.trim_rv})")
            w = Watch(kind, namespace,
                      lambda w, s=shard: self._remove_watch(s, w),
                      current_rv=lambda s=shard: s.delivered_rv,
                      max_queue=max_queue,
                      bookmark_interval=bookmark_interval,
                      on_drop=lambda w, disconnected, s=shard:
                          self._note_backpressure(s, w, disconnected))
            shard.watches.append(w)
            if send_initial:
                for key in shard.sorted_key_view():
                    if key[0] != kind:
                        continue
                    obj = shard.objects[key]
                    if w.matches(obj):
                        w.deliver(WatchEvent("ADDED", self._snapshot(obj)),
                                  replay=True)
            if resource_version is not None:
                for rv, etype, obj, _prev in shard.backlog:
                    if rv > resource_version and w.matches(obj):
                        w.deliver(WatchEvent(etype, self._snapshot(obj)),
                                  replay=True)
            return w

    def _snapshot(self, obj: Obj) -> Obj:
        """A delivery snapshot of a stored object: the object itself in
        copy-free mode (copy-on-write store + read-only contract), a deep
        copy in baseline mode, a frozen copy under sanitize."""
        if sanitizer.enabled():
            return sanitizer.deep_freeze(_copy_obj(obj))
        if self._fanout_copy:
            return _copy_obj(obj)
        return obj

    def _note_backpressure(self, shard: _Shard, w: Watch,
                           disconnected: bool) -> None:
        """Backpressure tick: a watcher overflowed (``disconnected``) or
        an already-overflowed watcher was aimed another event. Counted in
        the shard snapshot AND the wire-path metric families — the
        drop-to-relist is never silent."""
        with shard.lock:
            shard.dropped_events += 1
            if disconnected:
                shard.overflow_disconnects += 1
        try:
            from k8s_dra_driver_tpu_torch.pkg.metrics import (
                default_wirepath_metrics,
            )
            m = default_wirepath_metrics()
            m.backpressure_dropped_total.inc(kind=w.kind)
            if disconnected:
                m.backpressure_disconnects_total.inc(kind=w.kind)
        except Exception:  # noqa: BLE001 — metrics hook
            pass

    def _remove_watch(self, shard: _Shard, w: Watch) -> None:
        with shard.lock:
            if w in shard.watches:
                shard.watches.remove(w)

    # -- conveniences used across controllers -------------------------------

    def add_finalizer(self, kind: str, name: str, finalizer: str,
                      namespace: str = "") -> Obj:
        while True:
            obj = self.get(kind, name, namespace)
            fins = meta(obj).setdefault("finalizers", [])
            if finalizer in fins:
                return obj
            fins.append(finalizer)
            try:
                return self.update(obj)
            except ConflictError:
                continue

    def remove_finalizer(self, kind: str, name: str, finalizer: str,
                         namespace: str = "") -> Optional[Obj]:
        while True:
            obj = self.try_get(kind, name, namespace)
            if obj is None:
                return None
            fins = meta(obj).get("finalizers") or []
            if finalizer not in fins:
                return obj
            fins.remove(finalizer)
            try:
                return self.update(obj)
            except ConflictError:
                continue

    def patch_labels(self, kind: str, name: str,
                     labels: dict[str, Optional[str]],
                     namespace: str = "") -> Obj:
        """Merge-patch labels; a None value removes the label."""
        while True:
            obj = self.get(kind, name, namespace)
            lbls = meta(obj).setdefault("labels", {})
            for k, v in labels.items():
                if v is None:
                    lbls.pop(k, None)
                else:
                    lbls[k] = v
            try:
                return self.update(obj)
            except ConflictError:
                continue


def _encode_continue(snapshot_rv: int, after_key: tuple[str, str, str]) -> str:
    # Continue tokens ride inside LIST response bodies — encoded via the
    # blessed codec like every other serve-path byte (DL601).
    return wirecodec.encode_doc(
        {"rv": snapshot_rv, "after": list(after_key)}).decode()


def _decode_continue(token: str) -> tuple[int, tuple[str, str, str]]:
    try:
        doc = json.loads(token)
        after = doc["after"]
        return int(doc["rv"]), (str(after[0]), str(after[1]), str(after[2]))
    except (ValueError, KeyError, IndexError, TypeError):
        raise ExpiredError(f"malformed continue token: {token!r}") from None


# --------------------------------------------------------------------------
# Partition fencing (docs/self-healing.md, "Whole-node repair")
# --------------------------------------------------------------------------

class PartitionGate:
    """Which nodes are currently partitioned from the API server. One
    gate is shared by every :class:`PartitionedClient` of a harness."""

    def __init__(self) -> None:
        self._mu = sanitizer.new_lock("PartitionGate._mu")
        self._partitioned: set[str] = set()

    def partition(self, node: str) -> None:
        with self._mu:
            self._partitioned.add(node)

    def heal(self, node: Optional[str] = None) -> None:
        with self._mu:
            if node is None:
                self._partitioned.clear()
            else:
                self._partitioned.discard(node)

    def is_partitioned(self, node: str) -> bool:
        with self._mu:
            return node in self._partitioned


class _PartitionedWatch:
    """Wraps a live Watch: when the node partitions, the stream DIES
    (buffered events lost, ``alive`` False) exactly like a dropped HTTP
    stream — the informer's reconnect then fails at ``watch()`` until
    the partition heals, so a partitioned node goes fully deaf instead
    of continuing to act on a miraculously healthy event feed."""

    def __init__(self, watch: Watch, cut: Callable[[], bool]):
        self._watch = watch
        self._cut = cut

    def next(self, timeout: Optional[float] = 5.0) -> Optional[WatchEvent]:
        if self._cut() and self._watch.alive:
            self._watch.stop()
            return None
        return self._watch.next(timeout=timeout)

    def __getattr__(self, name: str):
        return getattr(self._watch, name)

    @property
    def alive(self) -> bool:
        return self._watch.alive and not self._cut()

    @property
    def overflowed(self) -> bool:
        return self._watch.overflowed


class PartitionedClient:
    """Per-node client wrapper: every verb consults the
    ``k8sclient.partition`` fault point and (when given) a
    :class:`PartitionGate` — while the node is partitioned every call
    raises :class:`PartitionError` and its watches die.

    Wrap ONLY a node's own components (drivers, claim loops, health/
    drain controllers, the lease heartbeat): the cluster side and the
    harness actors keep the unwrapped client, exactly as a real
    partition isolates one node's management network, not the world.
    Errors carry the injected-provenance marker so chaos oracles
    classify them as scheduled faults."""

    def __init__(self, inner, node_name: str,
                 gate: Optional[PartitionGate] = None):
        self._inner = inner
        self.node_name = node_name
        self._gate = gate

    def _is_cut(self) -> bool:
        return self._gate is not None and self._gate.is_partitioned(
            self.node_name)

    def _check(self) -> None:
        if self._is_cut():
            err = PartitionError(
                f"node {self.node_name} is partitioned from the API server")
            err._gpu_dra_injected = True  # type: ignore[attr-defined]
            raise err
        faultpoints.maybe_fail(FP_PARTITION)

    # -- verb surface (everything a node-side component calls) ---------------

    def create(self, obj: Obj) -> Obj:
        self._check()
        return self._inner.create(obj)

    def get(self, kind: str, name: str, namespace: str = "") -> Obj:
        self._check()
        return self._inner.get(kind, name, namespace)

    def try_get(self, kind: str, name: str,
                namespace: str = "") -> Optional[Obj]:
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def update(self, obj: Obj) -> Obj:
        self._check()
        return self._inner.update(obj)

    def update_status(self, obj: Obj) -> Obj:
        self._check()
        return self._inner.update_status(obj)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        self._check()
        return self._inner.delete(kind, name, namespace)

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[dict[str, str]] = None) -> list[Obj]:
        self._check()
        return self._inner.list(kind, namespace, label_selector)

    def list_page(self, kind: str, namespace: Optional[str] = None,
                  label_selector: Optional[dict[str, str]] = None,
                  limit: int = 0, continue_token: str = "") -> dict[str, Any]:
        self._check()
        return self._inner.list_page(kind, namespace, label_selector,
                                     limit, continue_token)

    def watch(self, *args: Any, **kwargs: Any):
        self._check()
        return _PartitionedWatch(self._inner.watch(*args, **kwargs),
                                 self._is_cut)

    def add_finalizer(self, kind: str, name: str, finalizer: str,
                      namespace: str = "") -> Obj:
        self._check()
        return self._inner.add_finalizer(kind, name, finalizer, namespace)

    def remove_finalizer(self, kind: str, name: str, finalizer: str,
                         namespace: str = "") -> Optional[Obj]:
        self._check()
        return self._inner.remove_finalizer(kind, name, finalizer, namespace)

    def patch_labels(self, kind: str, name: str,
                     labels: dict[str, Optional[str]],
                     namespace: str = "") -> Obj:
        self._check()
        return self._inner.patch_labels(kind, name, labels, namespace)

    def __getattr__(self, name: str):
        # Introspection surfaces (kind_generation, …) pass through
        # un-gated: they are harness/metrics reads, not the node's
        # management-network traffic.
        return getattr(self._inner, name)


def _rollback(shard: _Shard, snapshot_rv: int) -> dict[tuple[str, str, str], Obj]:
    """State of the shard as of ``snapshot_rv``: shallow-copy the store
    (values are immutable-by-contract, so sharing refs is safe) and undo
    every backlogged commit newer than the snapshot, newest first. Caller
    holds ``shard.lock`` and has verified the backlog covers the span."""
    objects = dict(shard.objects)
    for rv, etype, obj, prev in reversed(shard.backlog):
        if rv <= snapshot_rv:
            break
        key = obj_key(obj)
        if etype == "ADDED":
            objects.pop(key, None)
        else:  # MODIFIED / DELETED: restore what the commit displaced
            if prev is not None:
                objects[key] = prev
    return objects
