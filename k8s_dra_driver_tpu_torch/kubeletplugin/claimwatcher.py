"""API-driven node prepare: the kubelet-role stand-in for bare-process
clusters.

In a real cluster the kubelet invokes NodePrepareResources /
NodeUnprepareResources over the DRA gRPC socket when a pod referencing the
claim starts/stops (the surface the reference's plugin serves through the
k8s kubeletplugin helper, ``cmd/gpu-kubelet-plugin/driver.go:344-443``).
A cluster assembled from bare processes (``demo/clusters/local``) has no
kubelet, so this loop drives the same plugin entrypoints from the API
instead:

- a ResourceClaim allocated from THIS node's pool that is reserved
  (``status.reservedFor`` non-empty = a pod consuming it was scheduled)
  gets prepared; the prepared refs are published to ``status.devices``
  (the KEP-4817 ResourceClaim.Status.Devices shape) so other processes can
  observe readiness;
- unreservation or deletion unprepares and clears the published entries.

Prepare/unprepare stay idempotent (checkpoint-backed), so replays from
informer resyncs are harmless.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Optional

from k8s_dra_driver_tpu_torch.k8sclient.client import (
    ConflictError,
    FakeClient,
    NotFoundError,
    Obj,
)
from k8s_dra_driver_tpu_torch.k8sclient.informer import Informer
from k8s_dra_driver_tpu_torch.kubeletplugin.types import (
    ClaimRef,
    claim_allocation_results,
    claim_uid,
)
from k8s_dra_driver_tpu_torch.pkg import durability, faultpoints, sanitizer, tracing
from k8s_dra_driver_tpu_torch.pkg.errors import StaleAbortedClaimError

logger = logging.getLogger(__name__)

#: minimum seconds between informer-rv checkpoint writes. The rv advances
#: on every claim event; persisting each advance would add one disk write
#: per watch event to the hot path for no recovery benefit (an older rv
#: only means a few more replayed — idempotent — events on restart).
RV_PERSIST_INTERVAL = 0.25

RV_STATE_FILE = "informer-rv.json"

#: The reasons of the ``Ready: False`` condition :func:`set_ready` leaves
#: on a claim's status entries of a driver: a drain's, and the claim
#: watcher's before a node-side unprepare (the entry itself goes after it,
#: so that "no entry of ours" still means "unprepared").
REASON_DRAINED = "Drained"
REASON_UNPREPARING = "Unpreparing"


def _rv(obj: Obj) -> int:
    try:
        return int((obj.get("metadata") or {}).get("resourceVersion") or 0)
    except (TypeError, ValueError):
        return 0


def drain_marked(claim: Obj, driver_name: str) -> bool:
    """Whether a drain has retracted ``driver_name``'s Ready entries of
    ``claim`` (:func:`set_ready` with ``ready=False``): the node undid the
    claim's devices, or is undoing them, and the reallocation is to come."""
    return any(
        d.get("driver") == driver_name
        and any(c.get("type") == "Ready" and c.get("status") == "False"
                and c.get("reason") == REASON_DRAINED
                for c in d.get("conditions") or [])
        for d in (claim.get("status") or {}).get("devices") or [])


def set_ready(client, ref: ClaimRef, driver_name: str, pool: str,
              ready: bool, reason: str = REASON_DRAINED) -> bool:
    """Set the Ready condition of ``driver_name``'s status entries of the
    claim in ``pool``: ``False`` with ``reason`` before the node undoes the
    claim's devices (a Ready status says the node's checkpoint holds them
    prepared), ``True`` to restore it. The entries stay, so the claim
    watcher does not take a drain's retraction for a clobbered publish.
    Returns whether it wrote; a claim that is gone, has another uid or
    holds no such entry is left alone."""
    cond = ({"type": "Ready", "status": "True"} if ready else
            {"type": "Ready", "status": "False", "reason": reason})
    while True:
        try:
            fresh = client.get("ResourceClaim", ref.name, ref.namespace)
        except NotFoundError:
            return False
        if claim_uid(fresh) != ref.uid:
            return False
        entries = [d for d in (fresh.get("status") or {}).get("devices") or []
                   if d.get("driver") == driver_name and d.get("pool") == pool]
        if not entries or all(d.get("conditions") == [cond] for d in entries):
            return False
        for d in entries:
            d["conditions"] = [dict(cond)]
        try:
            client.update_status(fresh)
            return True
        except ConflictError:
            continue
        except NotFoundError:
            return False


class InformerRvStore:
    """Persists an informer's newest-seen resourceVersion next to the
    plugin checkpoint (``<state_dir>/informer-rv.json``), so a restarted
    plugin RESUMES its claim watch from where the dead process stopped
    instead of relisting the world (ROADMAP item 1 remainder; the watch
    backlog replays the downtime's events). Writes are atomic
    (tmp + rename, same contract as the checkpoint) and throttled."""

    def __init__(self, state_dir: str,
                 interval: float = RV_PERSIST_INTERVAL):
        self.path = os.path.join(state_dir, RV_STATE_FILE)
        self.interval = interval
        self._mu = sanitizer.new_lock("InformerRvStore._mu")
        self._latest = -1
        self._written = -1
        # -inf, NOT 0.0: time.monotonic() is seconds since boot, so on a
        # host up for less than `interval` a 0.0 sentinel throttles the
        # FIRST write too and nothing persists until uptime > interval.
        self._last_write = float("-inf")
        os.makedirs(state_dir, exist_ok=True)

    def load(self) -> Optional[int]:
        try:
            with open(self.path) as f:
                doc = json.load(f)
            rv = int(doc["rv"])
            return rv if rv >= 0 else None
        except (OSError, ValueError, KeyError, TypeError):
            return None  # absent/torn file → the normal LIST start

    def note(self, rv: int) -> None:
        """Record an rv advance; writes through at most every
        ``interval`` seconds (call :meth:`flush` at shutdown)."""
        now = time.monotonic()
        with self._mu:
            if rv <= self._latest:
                return
            self._latest = rv
            if now - self._last_write < self.interval:
                return
            self._last_write = now
            latest = self._latest
        self._write(latest)

    def flush(self) -> None:
        with self._mu:
            latest = self._latest
        if latest > self._written:
            self._write(latest)

    def _write(self, rv: int) -> None:
        try:
            durability.atomic_publish(
                self.path, lambda f: json.dump({"rv": rv}, f))
            with self._mu:
                self._written = max(self._written, rv)
        except (OSError, faultpoints.InjectedFault):
            # Best-effort persistence: ANY publish failure here — real
            # I/O or an injected durability.write/replace — degrades to
            # a relist on restart, never an exception into the event-
            # delivery thread. (FaultCrash stays uncatchable by design.)
            logger.warning("informer-rv checkpoint write failed (%s); "
                           "restart will relist", self.path)


class NodePrepareLoop:
    def __init__(
        self,
        client: FakeClient,
        driver,                      # DRAPlugin: prepare/unprepare_resource_claims
        driver_name: str,
        pool_name: str,
        namespace: Optional[str] = None,
        retry_delay: float = 2.0,
        state_dir: Optional[str] = None,
        fence: Optional[Callable[[], bool]] = None,
    ):
        """``state_dir``: when given, the claim informer's newest-seen
        resourceVersion is persisted there (:class:`InformerRvStore`,
        alongside the plugin checkpoint) and a restarted loop resumes the
        watch from it — no relist.

        ``fence``: node-fence gate (docs/self-healing.md, "Whole-node
        repair") — while it returns True (the node lease is fenced, or
        suspect after a partition) every reconcile DEFERS via the retry
        timer instead of acting: a just-healed node must not prepare or
        publish anything until its fence cleanup confirmed which claims
        still belong here. Wired to ``NodeLeaseHeartbeat`` as
        ``lambda: hb.fenced or hb.suspect``. A crashing gate reads as
        fenced (fail-safe)."""
        self.client = client
        self.driver = driver
        self.driver_name = driver_name
        self.pool_name = pool_name
        self.namespace = namespace
        self.retry_delay = retry_delay
        self._fence = fence
        self._rv_store = (InformerRvStore(state_dir)
                          if state_dir else None)
        self._informer: Optional[Informer] = None
        # Serialize claim handling: informer callbacks may interleave an
        # update and the delete of the same claim.
        self._mu = sanitizer.new_lock("NodePrepareLoop._mu")
        self._prepared: dict[str, ClaimRef] = sanitizer.guarded_dict(
            self._mu, "NodePrepareLoop._prepared")
        # What was prepared, as a (pool, device) signature per claim: a
        # prepared claim whose allocation RESULTS change underneath it (a
        # drained claim reallocated onto other devices,
        # docs/self-healing.md) must be unprepared and re-prepared, not
        # treated as already-done.
        self._prepared_sig: dict[str, tuple] = sanitizer.guarded_dict(
            self._mu, "NodePrepareLoop._prepared_sig")
        # The resourceVersion of the claim object each prepare was decided
        # on. The loop may decide on a fresh read, newer than events it has
        # still to handle (a drained claim bound again to its devices): a
        # release event older than that prepare must not unprepare it.
        self._prepared_rv: dict[str, int] = sanitizer.guarded_dict(
            self._mu, "NodePrepareLoop._prepared_rv")
        # Claims the driver may hold though this loop has no completed
        # prepare of them: those the driver's checkpoint holds as prepared
        # when this loop starts (a restarted loop or process: ``_prepared``
        # is empty then), and those whose prepare this loop asked for and
        # that failed (a failed prepare can leave a PrepareStarted record
        # that holds its devices; the kubelet likewise unprepares every
        # claim it asked to prepare). A claim released, moved or deleted
        # sends no event that reaches the tracked paths unless it is here,
        # so without this record it would stay prepared — its devices
        # refused to the next claim — forever.
        self._adopted: dict[str, ClaimRef] = sanitizer.guarded_dict(
            self._mu, "NodePrepareLoop._adopted")
        self._stopped = False

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "NodePrepareLoop":
        resume_rv = self._rv_store.load() if self._rv_store else None
        with self._mu:
            self._adopted.update(self._checkpointed_claims())
        self._informer = Informer(
            self.client, "ResourceClaim", self.namespace,
            on_add=self._on_change,
            on_update=lambda old, new: self._on_change(new),
            on_delete=self._on_delete,
            resume_rv=resume_rv,
            on_rv=self._rv_store.note if self._rv_store else None,
        ).start()
        self._informer.wait_for_cache_sync()
        with self._mu:
            adopted = list(self._adopted.values())
        for ref in adopted:
            self._check_adopted(ref)
        return self

    def _checkpointed_claims(self) -> dict[str, ClaimRef]:
        """The claims the driver's checkpoint holds as completed prepares
        in this loop's namespace. Drivers without a checkpoint surface
        (stub drivers in the fleet harness) hold none."""
        state = getattr(self.driver, "state", None)
        if state is None or not hasattr(state, "prepared_claims_nolock"):
            return {}
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
            STATE_PREPARE_COMPLETED,
        )
        try:
            held = state.prepared_claims_nolock()
        except Exception:  # noqa: BLE001 — unreadable state: nothing to
            # adopt; the request paths fail loudly on their own.
            return {}
        return {uid: ClaimRef(uid=uid, name=pc.name, namespace=pc.namespace)
                for uid, pc in held.items()
                if pc.state == STATE_PREPARE_COMPLETED and pc.name
                and self.namespace in (None, pc.namespace)}

    def _check_adopted(self, ref: ClaimRef) -> None:
        """An adopted claim that is gone from the API server (or whose name
        now belongs to another UID) was deleted while no loop ran: no event
        will ever come for it (a resumed watch does not dispatch the delete
        of an object its fresh cache never held), so unprepare it now. A
        failed lookup re-arms the check."""
        if self._stopped:
            return
        try:
            obj = self.client.try_get("ResourceClaim", ref.name,
                                      ref.namespace)
        except Exception:  # noqa: BLE001 — transient: look again later
            t = threading.Timer(self.retry_delay, self._check_adopted,
                                args=(ref,))
            t.daemon = True
            t.start()
            return
        if obj is not None and claim_uid(obj) == ref.uid:
            return
        with self._mu:
            if ref.uid in self._adopted:
                logger.info("claim %s prepared before this loop started is "
                            "gone: unpreparing", ref.uid)
                self._unprepare_deleted(ref.uid)

    def initiate_stop(self) -> None:
        """Signal-only stop (no join): fleet-scale teardown signals every
        node's loops first, then joins — see Informer.initiate_stop."""
        self._stopped = True
        if self._informer is not None:
            self._informer.initiate_stop()
        if self._rv_store is not None:
            # The throttle may be holding the newest rv; a clean shutdown
            # must not resume behind what this process already handled.
            self._rv_store.flush()

    def join(self, timeout: float = 5.0) -> None:
        if self._informer is not None:
            self._informer.join(timeout=timeout)

    def stop(self) -> None:
        self.initiate_stop()
        self.join()

    def _schedule_retry(self, name: str, namespace: str) -> None:
        """A retryably-failed prepare (e.g. CD daemons not Ready yet) gets
        another attempt without waiting for an unrelated claim event.

        The retry reads the claim and reconciles it under one hold of
        ``_mu``. A read taken before waiting for the lock goes stale while
        an event is handled: were it the claim's delete, the retry would
        prepare the deleted claim from its last object, and with no event
        left to come for it, its checkpoint entry and CDI spec held the GPU
        against the next claim for good."""
        def fire() -> None:
            if self._stopped:
                return
            with self._mu:
                try:
                    claim = self.client.try_get("ResourceClaim", name,
                                                namespace)
                except Exception:  # noqa: BLE001 — a transient/injected
                    # API failure here must NOT sever the retry chain:
                    # this timer is the claim's only pending recovery, and
                    # an exception would die silently with the timer
                    # thread.
                    self._schedule_retry(name, namespace)
                    return
                if claim is None:
                    return
                try:
                    self._handle(claim)
                except Exception:  # noqa: BLE001 — a still-failing retry
                    # re-arms itself inside _reconcile; the raise exists
                    # for the informer's rv gate, not for timer threads.
                    logger.debug("retry of claim %s/%s still failing",
                                 namespace, name)
        t = threading.Timer(self.retry_delay, fire)
        t.daemon = True
        t.start()

    # -- claim classification ------------------------------------------------

    def _our_results(self, claim: Obj) -> list[dict]:
        return [r for r in claim_allocation_results(claim)
                if r.get("driver") == self.driver_name
                and r.get("pool") == self.pool_name]

    @staticmethod
    def _reserved(claim: Obj) -> bool:
        return bool((claim.get("status") or {}).get("reservedFor"))

    def _driver_holds(self, uid: str) -> bool:
        """Whether the driver's durable state still holds ``uid`` as a
        completed prepare. The in-memory ``_prepared`` bookkeeping can go
        stale when a drain happens behind the loop's back AND the release
        event was coalesced away by a relist — the checkpoint is the
        truth. Drivers without a checkpoint surface (stub drivers in the
        fleet harness) are trusted as-is."""
        state = getattr(self.driver, "state", None)
        if state is None or not hasattr(state, "prepared_claims_nolock"):
            return True
        try:
            pc = state.prepared_claims_nolock().get(uid)
        except Exception:  # noqa: BLE001 — unreadable state must not
            # churn the loop; the request paths fail loudly on their own.
            return True
        # The state constant ("PrepareCompleted") lives with the shared
        # checkpoint format; imported lazily to keep this helper layer
        # import-light.
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
            STATE_PREPARE_COMPLETED,
        )
        return pc is not None and pc.state == STATE_PREPARE_COMPLETED

    def _status_ready(self, claim: Obj) -> bool:
        """Whether the claim's published status carries this driver's
        device entries, each Ready — read straight from the event's object,
        so checking it on the already-prepared path costs nothing. A
        tracked claim without them had its publish clobbered by a racing
        whole-status writer, or kept the retraction of an unprepare that
        failed, and must republish."""
        ours = [d for d in (claim.get("status") or {}).get("devices") or []
                if d.get("driver") == self.driver_name]
        return bool(ours) and all(
            {"type": "Ready", "status": "True"} in (d.get("conditions") or [])
            for d in ours)

    @staticmethod
    def _is_stale_aborted(err: BaseException) -> bool:
        seen: set[int] = set()
        cur: Optional[BaseException] = err
        while cur is not None and id(cur) not in seen:
            if isinstance(cur, StaleAbortedClaimError):
                return True
            seen.add(id(cur))
            cur = cur.__cause__ or cur.__context__
        return False

    def _signature(self, claim: Obj) -> tuple:
        """This driver's allocation results of ``claim`` as sorted (pool,
        device) pairs: what a prepare of it takes."""
        return tuple(sorted((r.get("pool", ""), r.get("device", ""))
                            for r in self._our_results(claim)))

    def _fresh(self, claim: Obj) -> Optional[Obj]:
        """The claim as the API server holds it now (None where it is
        gone or cannot be read: the caller then does not act on it)."""
        meta = claim.get("metadata") or {}
        try:
            return self.client.try_get("ResourceClaim", meta.get("name", ""),
                                       meta.get("namespace", ""))
        except Exception:  # noqa: BLE001 — a transient read failure: the
            # retry armed for the failed prepare looks again.
            return None

    @staticmethod
    def _drain_pending(claim: Obj) -> bool:
        """Whether the claim is inside the drain → reallocation window
        (or terminally failed) — the tombstone must stand then."""
        from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
            ANN_DRAIN,
            ANN_DRAIN_FAILED,
        )
        anns = (claim.get("metadata") or {}).get("annotations") or {}
        return ANN_DRAIN in anns or ANN_DRAIN_FAILED in anns

    # -- transitions ---------------------------------------------------------

    def _on_change(self, claim: Obj) -> None:
        # The claim-trace stitch point on the watch-consumer side: the gap
        # between the root span's start and this span's start is the watch
        # fan-out + informer dispatch wait ("watch_delivery" in the bench
        # breakdown). Untraced claims cost one annotation read.
        #
        # Failures PROPAGATE (no local swallow): the informer logs them,
        # keeps its event loop alive, and — decisively — withholds the
        # event's rv from the persisted checkpoint. Swallowing here would
        # persist the rv of an event whose only recovery is an in-memory
        # retry timer, so a crash inside the retry window would make a
        # checkpoint-resumed restart skip the claim forever.
        with self._mu:
            self._handle(claim)

    def _handle(self, claim: Obj) -> None:
        """Reconcile ``claim`` inside its ``node_prepare`` span. Caller
        holds ``_mu``."""
        with tracing.span_for_object(
                "node_prepare", claim,
                attributes={"driver": self.driver_name,
                            "claim": claim_uid(claim)}):
            self._reconcile(claim)

    def _reconcile(self, claim: Obj, current: bool = False) -> None:
        """``current``: ``claim`` was read from the API server just now,
        not taken from an event."""
        uid = claim_uid(claim)
        ref = ClaimRef(
            uid=uid,
            name=claim["metadata"].get("name", ""),
            namespace=claim["metadata"].get("namespace", ""))
        if self._fence is not None:
            try:
                fenced = bool(self._fence())
            except Exception:  # noqa: BLE001 — cannot prove unfenced
                fenced = True
            if fenced:
                # Defer, don't act: the retry timer re-fetches the claim
                # once the fence cleanup has settled ownership.
                logger.info("claim %s deferred: node fence active", uid)
                self._schedule_retry(ref.name, ref.namespace)
                return
        deleting = claim["metadata"].get("deletionTimestamp") is not None
        ours = self._our_results(claim)
        tracked = uid in self._prepared or uid in self._adopted
        if not ours and not tracked:
            return
        if deleting or not self._reserved(claim) or not ours:
            if (uid in self._prepared and not current
                    and _rv(claim) < self._prepared_rv.get(uid, 0)):
                logger.debug("claim %s: release event older than its "
                             "prepare: ignored", uid)
                return
            if tracked:
                if uid not in self._prepared:
                    logger.info("claim %s released while no loop ran: "
                                "unpreparing", uid)
                self._unprepare(ref)
            return
        sig = self._signature(claim)
        if uid in self._prepared:
            holds = self._driver_holds(uid)
            if self._prepared_sig.get(uid) == sig and holds:
                if drain_marked(claim, self.driver_name):
                    # Ready retracted by a drain while the record still
                    # reads completed: the drain is between its retraction
                    # and its tombstone, or failed in between. Restore
                    # Ready only if the record is still completed once the
                    # claim's flight lock is ours, which the drain holds
                    # throughout.
                    self._restore_ready(ref, claim)
                    return
                if self._status_ready(claim):
                    return  # already prepared; status published
                # Our Ready entry vanished from status (a racing
                # whole-status writer — allocator, release — clobbered
                # the publish) or is retracted: fall through to the
                # prepare below, whose idempotent completed fast path
                # returns the refs without device work, and republish.
                logger.info("claim %s prepared but its status entry is "
                            "missing or not Ready: republishing", uid)
            else:
                if not holds and not current:
                    # The record left its completed state behind the
                    # loop's back, by a drain most likely. Decide on the
                    # claim as it is now: an event older than the drain
                    # carries neither its retraction nor its annotation,
                    # and acting on it would undo the tombstone and prepare
                    # the drained devices again. A claim that is gone, or
                    # cannot be read, waits for its delete event or the
                    # retry.
                    fresh = self._fresh(claim)
                    if fresh is None or claim_uid(fresh) != uid:
                        self._schedule_retry(ref.name, ref.namespace)
                        return
                    self._reconcile(fresh, current=True)
                    return
                if not holds and (self._drain_pending(claim) or
                                  drain_marked(claim, self.driver_name)):
                    # Mid-drain: the node-side tombstone stands and the
                    # allocation still points at the drained devices. The
                    # drain's own retraction of Ready comes before its
                    # reallocation annotation, so either says so.
                    # Acting now (unprepare pops the tombstone, prepare
                    # re-enters the bad device) would resurrect exactly
                    # what the drain evicted — the reallocator's
                    # release/re-allocate events drive the next
                    # transition instead.
                    return
                # The allocation moved under a prepared claim (drain →
                # reallocation), OR the node-side record vanished/
                # tombstoned behind our back (a drain whose release event
                # was coalesced away by a relist): unwind before preparing
                # the current results.
                logger.info("claim %s drifted (results changed or node "
                            "record gone): re-preparing", uid)
                self._unprepare(ref)
                if uid in self._prepared:
                    # Old placement still holds; retry the transition.
                    self._schedule_retry(ref.name, ref.namespace)
                    raise RuntimeError(
                        f"unprepare of reallocated claim {uid} failed "
                        "(retry armed)")
        decided = claim
        results = self.driver.prepare_resource_claims([claim])
        res = results.get(uid)
        if (res is not None and res.error is not None
                and self._is_stale_aborted(res.error)):
            # The tombstone is newer than the event's object, which may
            # predate the drain: decide on the claim as it is now.
            fresh = self._fresh(claim)
            if (fresh is not None and claim_uid(fresh) == uid
                    and not self._drain_pending(fresh)
                    and not drain_marked(fresh, self.driver_name)
                    and self._reserved(fresh)
                    and self._signature(fresh) == sig):
                # The claim's CURRENT allocation matches the drained
                # version and no drain/reallocation is pending: the
                # reallocator legitimately re-picked the (repaired) device,
                # or the node's devices after an uncordon. Resolve the
                # tombstone and prepare the current allocation. The GPU
                # plugin resolves it by an unprepare, which drops a
                # tombstone of any kind; the CD plugin's unprepare leaves
                # every tombstone standing, so it drops only a drain's
                # tombstone of these results (a rolled-back prepare's waits
                # for the GC). While the drain annotation is present, or
                # the drain's retraction of Ready (it comes before the
                # annotation), this must NOT run: the allocation is the old
                # one and re-preparing would resurrect state onto the bad
                # device.
                logger.info("claim %s re-allocated onto its drained "
                            "devices: resolving tombstone", uid)
                errs = self.driver.resolve_drained_claims([fresh])
                if errs.get(uid) is None:
                    decided = fresh
                    results = self.driver.prepare_resource_claims([fresh])
                    res = results.get(uid)
        if res is None or res.error is not None:
            # Tracked until an unprepare succeeds: the failed prepare may
            # have left a record that holds the claim's devices.
            self._adopted[uid] = ref
            logger.warning("node prepare of claim %s failed: %s",
                           uid, res.error if res else "no result")
            self._schedule_retry(ref.name, ref.namespace)
            # Raise AFTER arming the retry: the in-process recovery is the
            # timer, but the raise tells the informer this event was NOT
            # processed, so its rv never reaches the persisted checkpoint
            # — a crash before the timer fires replays the event on the
            # resumed watch instead of skipping it.
            raise RuntimeError(
                f"prepare of claim {uid} failed (retry armed): "
                f"{res.error if res else 'no result'}")
        entries = [
            {"driver": self.driver_name,
             "pool": d.pool,
             "device": d.device,
             "cdiDeviceIDs": list(d.cdi_device_ids),
             "conditions": [{"type": "Ready", "status": "True"}],
             # KEP-5304 device metadata (set under the DeviceMetadata
             # gate) rides to status so consumers read it instead of
             # probing sysfs.
             **({"metadata": d.metadata} if d.metadata else {})}
            for d in res.devices
        ]
        try:
            published = self._while_prepared(
                uid, [e["device"] for e in entries],
                lambda: self._publish_status(ref, entries))
        except Exception:
            # Status publish failed (transient/injected API fault): arm a
            # retry and do NOT record the claim as prepared — the retry
            # re-prepares (idempotent fast path) and publishes again.
            # Recording it here would make the retry hit the
            # already-prepared early return and never publish, leaving a
            # Ready claim invisible forever.
            logger.warning("status publish of claim %s failed: retry armed",
                           uid)
            self._schedule_retry(ref.name, ref.namespace)
            raise
        self._prepared[uid] = ref
        self._prepared_sig[uid] = sig
        self._prepared_rv[uid] = max(self._prepared_rv.get(uid, 0),
                                     _rv(decided))
        self._adopted.pop(uid, None)
        if not published:
            # A drain or an unprepare took the claim's record between the
            # prepare and the publish: no Ready for devices the node no
            # longer holds. Its own events (the drain's annotation, the
            # release) drive the next transition.
            logger.info("claim %s left its prepared state before its status "
                        "was published: not publishing", uid)
            return
        logger.info("node-prepared claim %s (%d devices)",
                    uid, len(res.devices))

    def _while_prepared(self, uid: str, devices: list[str],
                        fn: Callable[[], None]) -> bool:
        """Run ``fn`` (a Ready publish) only while the driver's checkpoint
        holds ``uid`` as a completed prepare of exactly ``devices``, under
        the claim's flight lock, so that no drain or unprepare of the claim
        runs between the check and the publish. Both kubelet plugins'
        states have that surface; only the fleet harness's stub drivers
        lack it, and publish as they are."""
        guard = getattr(getattr(self.driver, "state", None),
                        "while_prepared", None)
        if guard is None:
            fn()
            return True
        return bool(guard(uid, devices, fn))

    def _restore_ready(self, ref: ClaimRef, claim: Obj) -> None:
        devices = [d.get("device", "") for d in
                   (claim.get("status") or {}).get("devices") or []
                   if d.get("driver") == self.driver_name
                   and d.get("pool") == self.pool_name]
        if self._while_prepared(
                ref.uid, devices,
                lambda: set_ready(self.client, ref, self.driver_name,
                                  self.pool_name, True)):
            logger.info("claim %s: its drain did not complete: Ready "
                        "restored", ref.uid)

    def _unprepare(self, ref: ClaimRef) -> None:
        # Retract Ready BEFORE the node-side unprepare: Ready says the
        # checkpoint holds the claim's devices prepared, so it goes before
        # the record does, never after. The entry itself goes after it.
        try:
            set_ready(self.client, ref, self.driver_name, self.pool_name,
                      False, REASON_UNPREPARING)
        except Exception:
            # Keep the claim tracked and arm a retry: nothing was
            # unprepared yet.
            logger.warning("status retraction of claim %s failed: retry "
                           "armed", ref.uid)
            self._schedule_retry(ref.name, ref.namespace)
            raise
        errs = self.driver.unprepare_resource_claims([ref])
        err = errs.get(ref.uid)
        if err is not None:
            logger.warning("node unprepare of claim %s failed: %s",
                           ref.uid, err)
            # Keep tracked AND arm a timer: "retried on the next event"
            # is not enough — the next event can put the claim back on
            # the already-prepared path (same results re-allocated) with
            # this unprepare still undone.
            self._schedule_retry(ref.name, ref.namespace)
            return
        try:
            self._publish_status(ref, None)
        except Exception:
            # Keep the claim tracked and arm a retry: dropping it now
            # would strand the retracted entry in status with nothing
            # left to clear it (the devices themselves are already
            # unprepared — the retry's unprepare is an idempotent noop).
            logger.warning("status clear of claim %s failed: retry armed",
                           ref.uid)
            self._schedule_retry(ref.name, ref.namespace)
            raise
        self._prepared.pop(ref.uid, None)
        self._prepared_sig.pop(ref.uid, None)
        self._prepared_rv.pop(ref.uid, None)
        self._adopted.pop(ref.uid, None)
        logger.info("node-unprepared claim %s", ref.uid)

    def _on_delete(self, claim: Obj) -> None:
        uid = claim_uid(claim)
        with self._mu:
            self._unprepare_deleted(uid)

    def _unprepare_deleted(self, uid: str) -> None:
        """Unprepare after the claim object is GONE. Unlike _schedule_retry
        this cannot re-fetch the claim (no further events will ever arrive
        for a deleted object), so a failed unprepare self-arms a timer on
        the stored ClaimRef — otherwise a PREPARE_COMPLETED orphan keeps its
        CDI spec and vfio-bound chips until a process restart. Caller holds
        ``_mu``."""
        ref = self._prepared.get(uid) or self._adopted.get(uid)
        if ref is None:
            return
        errs = self.driver.unprepare_resource_claims([ref])
        if errs.get(ref.uid) is None:
            self._prepared.pop(uid, None)
            self._prepared_sig.pop(uid, None)
            self._prepared_rv.pop(uid, None)
            self._adopted.pop(uid, None)
            return
        logger.warning("unprepare of deleted claim %s failed (%s); retrying "
                       "in %.1fs", uid, errs.get(ref.uid), self.retry_delay)

        def fire() -> None:
            if self._stopped:
                return
            with self._mu:
                self._unprepare_deleted(uid)

        t = threading.Timer(self.retry_delay, fire)
        t.daemon = True
        t.start()

    # -- status publication (KEP-4817 shape) ---------------------------------

    def _publish_status(self, ref: ClaimRef,
                        devices: Optional[list[dict]]) -> None:
        while True:
            try:
                fresh = self.client.get("ResourceClaim", ref.name,
                                        ref.namespace)
            except NotFoundError:
                return
            status = fresh.setdefault("status", {})
            others = [d for d in status.get("devices") or []
                      if d.get("driver") != self.driver_name]
            status["devices"] = others + (devices or [])
            if not status["devices"]:
                status.pop("devices")
            try:
                self.client.update_status(fresh)
                return
            except ConflictError:
                continue
            except NotFoundError:
                return
