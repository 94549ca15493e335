"""Usage metering: per-tenant GPU-seconds accounting.

The counterpart of the JAX package's ``pkg/usage.py``, billed in
GPU-seconds where that package bills chip-seconds. The other half of the
user-perspective plane (docs/observability.md, "Usage metering"): who is
actually consuming the fleet, in the unit a capacity market bills —
GPU-seconds, keyed by namespace (the tenant boundary every other
multi-tenant surface in the tree uses).

:class:`UsageMeter` is driven by allocation/release events from a claim
informer, with a generation-gated LIST reconcile as the restart/missed-
event safety net:

- an allocation OBSERVED opens an interval: the claim's GPU count is
  derived from its allocation results against the published
  ResourceSlices, the open time is stamped durably onto the claim as the
  ``gpu.nvidia.com/usage-since`` annotation (the reallocator discipline:
  the API carries the meter's only state, so a restarted meter rebuilds
  EXACTLY from an informer LIST — nothing lost, nothing double-counted);
- a release/deletion OBSERVED closes it: ``gpus × (release − since)``
  accrues to the tenant's ledger.

The **conservation contract** (asserted in tests and the canary soak):
Σ per-tenant GPU-seconds ≡ the allocator's draw ledger over any window
— every interval the scheduler opened is metered exactly once with the
same GPU count and tenant, across meter restarts and injected API
faults. Exactness is achievable because the ledger is computed from
interval ENDPOINTS (never accumulated in increments) and the endpoints
are durable.

Served surfaces: ``gpu_dra_usage_*`` families (fleet-mirrored through
the controller's local pseudo-target), ``/debug/usage`` (per-tenant
ledger + utilization), and a cluster-utilization gauge (allocated ÷
healthy un-cordoned capacity).

The ``usage.observe`` fault point fails one metering tick: the failure
is counted and the meter marks itself stale-visible — and never raises
into the hosting main.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Optional

from k8s_dra_driver_tpu_torch.pkg import faultpoints, sanitizer
from k8s_dra_driver_tpu_torch.pkg.metrics import Counter, Gauge, Registry
from k8s_dra_driver_tpu_torch.pkg.nodelease import mutate_with_retry

logger = logging.getLogger(__name__)

# Fault point (docs/fault-injection.md): one whole metering observe tick
# fails. The contract: counted + staleness-marked, never raised.
FP_OBSERVE = faultpoints.register(
    "usage.observe", "one usage-metering observe tick fails")

#: durable open-interval stamp — the meter's restart breadcrumb: a
#: rebuilt meter reads the interval's true start from the claim instead
#: of inventing one (the reallocator's annotations-as-state discipline).
ANN_USAGE_SINCE = "gpu.nvidia.com/usage-since"

#: bound on per-claim interval records kept for the conservation oracle;
#: evictions are counted (``intervals_evicted``) so a capped run can
#: never silently read as exactly conserved.
DEFAULT_INTERVALS_CAP = 8192


class UsageMetrics:
    """The metering plane's families (docs/observability.md, "Usage
    metering")."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.gpu_seconds_total = r.register(Counter(
            "gpu_dra_usage_gpu_seconds_total",
            "GPU-seconds consumed per tenant (namespace): completed "
            "allocation intervals plus live accrual.",
            ("namespace",)))
        self.gpus_allocated = r.register(Gauge(
            "gpu_dra_usage_gpus_allocated",
            "GPUs currently allocated per tenant (namespace).",
            ("namespace",)))
        self.cluster_utilization = r.register(Gauge(
            "gpu_dra_usage_cluster_utilization",
            "Allocated GPUs / healthy un-cordoned GPU capacity across "
            "the cluster.",
            ()))
        self.observe_failures_total = r.register(Counter(
            "gpu_dra_usage_observe_failures_total",
            "Metering observe ticks that failed (the meter is stale "
            "until the next clean tick).",
            ()))


_default_usage_metrics: Optional[UsageMetrics] = None


def default_usage_metrics() -> UsageMetrics:
    global _default_usage_metrics
    if _default_usage_metrics is None:
        _default_usage_metrics = UsageMetrics()
    return _default_usage_metrics


@dataclass
class _Live:
    uid: str
    name: str
    namespace: str
    gpus: int
    since: float
    stamped: bool = False
    #: resourceVersion the interval was opened from — a release event
    #: OLDER than it is a stale delivery, not a close (the event stream
    #: and the LIST reconcile race; rv order arbitrates).
    opened_rv: float = 0.0


#: every live meter in the process, for ``/debug/usage``.
_live_meters: "weakref.WeakSet[UsageMeter]" = weakref.WeakSet()


def usage_debug_snapshot() -> list[dict[str, Any]]:
    """The ``/debug/usage`` payload: per-tenant ledger, live
    allocations, and cluster utilization for every live meter. Empty in
    processes that never assemble one."""
    out = []
    for meter in list(_live_meters):
        try:
            out.append(meter.debug_snapshot())
        except Exception as e:  # noqa: BLE001 — one broken meter must
            # not blank the endpoint.
            out.append({"error": repr(e)})
    return out


class UsageMeter:
    """Per-tenant GPU-seconds accounting over the claim stream.

    Event-driven (:meth:`start` runs a claim informer) with
    :meth:`observe` as the periodic tick: accrual publication, pending
    annotation stamps, utilization, and a generation-gated LIST
    reconcile that re-opens/closes anything the event stream missed —
    also the restart path (a fresh meter's first observe rebuilds the
    live set from LIST, reading each interval's true start from its
    ``usage-since`` annotation).

    The exported counter advances with live accrual; the EXACT values
    live in :meth:`ledger`/:meth:`completed`, computed from interval
    endpoints (one multiplication per interval, never a sum of per-tick
    increments — so two observers of the same endpoints agree to the
    last bit).
    """

    def __init__(
        self,
        client,
        namespace: Optional[str] = None,
        metrics: Optional[UsageMetrics] = None,
        clock: Callable[[], float] = time.time,
        stamp_since: bool = True,
        intervals_cap: int = DEFAULT_INTERVALS_CAP,
    ):
        """``clock`` defaults to WALL time (injectable for tests): the
        ``usage-since`` stamp is durable and read by other meter
        incarnations — possibly on another host after a controller
        failover — so a process-local monotonic epoch would be
        meaningless there. NTP steps are tolerated: a backwards step
        clamps the interval at zero (``max(0, ...)``), never negative."""
        self.client = client
        self.namespace = namespace
        self.metrics = metrics or default_usage_metrics()
        self.clock = clock
        self.stamp_since = stamp_since
        self.intervals_cap = intervals_cap
        self._mu = sanitizer.new_lock("UsageMeter._mu")
        self._live: dict[str, _Live] = {}
        #: closed intervals whose ``usage-since`` stamp still needs
        #: removing (uid → (name, namespace)): a stale stamp surviving
        #: into a REOPENED interval (drain → reallocate keeps the uid)
        #: would bill the gap between the intervals. Retried each
        #: observe tick; bounded + counted (``clears_dropped``).
        self._pending_clears: dict[str, tuple[str, str]] = {}
        self.clears_dropped = 0
        self._completed: dict[str, float] = {}          # ns → GPU-seconds
        # uid → {"namespace","name","gpus","seconds","intervals"} —
        # the conservation oracle's per-claim view; bounded + counted.
        self._claims: dict[str, dict[str, Any]] = {}
        self._published: dict[str, float] = {}          # ns → counter value
        self._gen_of = getattr(client, "kind_generation", None)
        self._ugen_of = getattr(client, "kind_usage_generation", None)
        self._reconcile_stamp: Optional[tuple] = None
        # Slice-derived caches (device → GPU count, healthy capacity):
        # touched from the informer's event thread AND the observe loop,
        # guarded by their own leaf lock (acquired after _mu when both
        # are held — _open_locked → _gpus_of_results).
        self._slices_mu = sanitizer.new_lock("UsageMeter._slices_mu")
        self._device_gpus: dict[tuple[str, str], int] = {}
        self._capacity_stamp: Optional[tuple] = None
        self._healthy_capacity = 0
        self.stale = False
        self.observe_failures = 0
        self.intervals_evicted = 0
        self._informer = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _live_meters.add(self)

    # -- GPUs / capacity from the published slices ---------------------------

    def _refresh_slices_locked(self) -> None:
        """(Re)build the (pool, device) → GPU-count map and the healthy
        capacity, cached per ResourceSlice write generation. A GPU is a
        device drawing exactly one counter unit (or, in counterless
        pools, any published device); cordoned/tainted GPUs (NoSchedule
        / NoExecute) leave the healthy capacity. Caller holds
        ``_slices_mu``."""
        stamp = (self._gen_of("ResourceSlice")
                 if self._gen_of is not None else None)
        if stamp is not None and stamp == self._capacity_stamp:
            return
        gpus_of: dict[tuple[str, str], int] = {}
        healthy = 0
        for s in self.client.list("ResourceSlice"):
            spec = s.get("spec") or {}
            pool = (spec.get("pool") or {}).get("name", "")
            devices = spec.get("devices") or []
            has_counters = any(d.get("consumesCounters") for d in devices)
            for dev in devices:
                draws = 0
                for cc in dev.get("consumesCounters") or []:
                    for cval in cc.get("counters", {}).values():
                        draws += int(cval.get("value", 0) or 0)
                gpus_of[(pool, dev.get("name", ""))] = max(
                    1, draws if has_counters else 1)
                is_gpu = draws == 1 or not has_counters
                tainted = any(t.get("effect") in ("NoSchedule", "NoExecute")
                              for t in dev.get("taints") or [])
                if is_gpu and not tainted:
                    healthy += 1
        self._device_gpus = gpus_of
        self._healthy_capacity = healthy
        self._capacity_stamp = stamp

    def _gpus_of_results(self, results: list[dict]) -> int:
        with self._slices_mu:
            self._refresh_slices_locked()
            return sum(self._device_gpus.get((r.get("pool", ""),
                                               r.get("device", "")), 1)
                       for r in results)

    def _healthy_cap(self) -> int:
        with self._slices_mu:
            self._refresh_slices_locked()
            return self._healthy_capacity

    # -- the event face (informer callbacks) ----------------------------------

    @staticmethod
    def _results(claim: dict) -> list[dict]:
        return (((claim.get("status") or {}).get("allocation") or {})
                .get("devices", {}).get("results", []))

    @staticmethod
    def _rv(claim: dict) -> float:
        try:
            return float((claim.get("metadata") or {}).get(
                "resourceVersion") or 0)
        except (TypeError, ValueError):
            return 0.0

    def observe_claim(self, claim: dict) -> None:
        """One claim transition (informer add/update). Opens or closes
        the claim's interval at THIS clock reading."""
        meta = claim.get("metadata") or {}
        uid = meta.get("uid", "")
        if not uid:
            return
        results = self._results(claim)
        now = self.clock()
        with self._mu:
            if results and uid not in self._live:
                self._open_locked(claim, results, now)
            elif not results and uid in self._live:
                self._close_locked(uid, now, rv=self._rv(claim))

    def observe_claim_deleted(self, claim: dict) -> None:
        uid = (claim.get("metadata") or {}).get("uid", "")
        with self._mu:
            if uid in self._live:
                # A deleted uid can never reappear: close unconditionally.
                self._close_locked(uid, self.clock(), rv=float("inf"))

    def _open_locked(self, claim: dict, results: list[dict],
                     now: float) -> None:
        meta = claim.get("metadata") or {}
        uid = meta.get("uid", "")
        rv = self._rv(claim)
        entry = self._claims.get(uid)
        if entry is not None and rv <= entry.get("closed_rv", -1.0):
            # Stale delivery from BEFORE this uid's last close (the
            # informer catching up behind a LIST reconcile): reopening
            # would mint a phantom interval the draw ledger never saw.
            return
        anns = meta.get("annotations") or {}
        since, stamped = now, False
        raw = anns.get(ANN_USAGE_SINCE)
        # An annotation is trusted only for a uid THIS incarnation never
        # closed: for a reopened interval (drain → reallocate keeps the
        # uid) any surviving stamp belongs to the PREVIOUS interval —
        # using it would bill the released gap. The reopen starts fresh
        # at ``now`` and overwrites the stamp (stamped=False).
        if raw is not None and entry is None:
            try:
                since, stamped = float(raw), True
            except (TypeError, ValueError):
                pass  # unreadable stamp: open at now, restamp
        self._pending_clears.pop(uid, None)  # superseded by the reopen
        self._live[uid] = _Live(
            uid=uid, name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            gpus=self._gpus_of_results(results),
            since=since, stamped=stamped, opened_rv=rv)

    def _close_locked(self, uid: str, now: float,
                      rv: float = float("inf")) -> None:
        rec = self._live.get(uid)
        if rec is None:
            return
        if rv < rec.opened_rv:
            return  # stale delivery from before this interval opened
        self._live.pop(uid)
        if self.stamp_since:
            # The durable stamp is now stale: remove it (retried each
            # tick) so a cross-restart reopen cannot read it. Bounded +
            # counted — an unbounded fault streak drops the oldest
            # clears visibly rather than growing without bound.
            if len(self._pending_clears) >= self.intervals_cap:
                self._pending_clears.pop(next(iter(self._pending_clears)))
                self.clears_dropped += 1
            self._pending_clears[uid] = (rec.name, rec.namespace)
        seconds = rec.gpus * max(0.0, now - rec.since)
        self._completed[rec.namespace] = (
            self._completed.get(rec.namespace, 0.0) + seconds)
        entry = self._claims.get(uid)
        if entry is None:
            if len(self._claims) >= self.intervals_cap:
                self.intervals_evicted += 1
                return
            entry = self._claims[uid] = {
                "namespace": rec.namespace, "name": rec.name,
                "gpus": rec.gpus, "seconds": 0.0, "intervals": 0,
                "closed_rv": -1.0}
        entry["seconds"] += seconds
        entry["intervals"] += 1
        entry["closed_rv"] = max(entry.get("closed_rv", -1.0), rv)

    # -- the periodic tick ----------------------------------------------------

    def observe(self, now: Optional[float] = None) -> bool:
        """One metering tick: LIST reconcile (generation-gated),
        pending ``usage-since`` stamps, counter/gauge publication, and
        cluster utilization. Never raises; a failed tick is counted and
        leaves the meter stale-marked until the next clean one."""
        try:
            faultpoints.maybe_fail(FP_OBSERVE)
            t = self.clock() if now is None else now
            self._reconcile(t)
            if self.stamp_since:
                self._stamp_pending()
            self._publish(t)
            self.stale = False
            return True
        except Exception:  # noqa: BLE001 — the metering plane degrades
            # visibly (counted + stale), never into the hosting main.
            self.observe_failures += 1
            self.metrics.observe_failures_total.inc()
            self.stale = True
            logger.warning("usage observe tick failed; meter stale",
                           exc_info=True)
            return False

    def _reconcile_gen(self) -> Optional[tuple]:
        if self._gen_of is None:
            return None
        slice_gen = self._gen_of("ResourceSlice")
        claim_gen = (self._ugen_of("ResourceClaim")
                     if self._ugen_of is not None
                     else self._gen_of("ResourceClaim"))
        return (slice_gen, claim_gen)

    def _reconcile(self, now: float) -> None:
        """LIST-driven safety net: open/close anything the event stream
        missed — and the whole rebuild path for a restarted meter.
        Skipped while no allocation-bearing write landed (the claim
        STATUS-write generation, when the client offers one)."""
        stamp = self._reconcile_gen()
        if stamp is not None and stamp == self._reconcile_stamp:
            return
        current: dict[str, tuple[dict, list[dict]]] = {}
        released: dict[str, float] = {}
        behind: set[str] = set()
        for c in self.client.list("ResourceClaim", self.namespace):
            meta = c.get("metadata") or {}
            uid = meta.get("uid", "")
            if not uid:
                continue
            if not self._delivered(meta.get("name", ""),
                                   meta.get("namespace", ""), uid,
                                   self._rv(c)):
                behind.add(uid)
                continue
            results = self._results(c)
            if results:
                current[uid] = (c, results)
            else:
                released[uid] = self._rv(c)
        with self._mu:
            for uid in [u for u in self._live
                        if u not in current and u not in behind]:
                rec = self._live[uid]
                if uid not in released and not self._delivered(
                        rec.name, rec.namespace, uid, float("inf")):
                    behind.add(uid)  # its delete not delivered yet
                    continue
                # Present-but-unallocated closes at its rv (so a stale
                # event cannot reopen it); absent = deleted, final.
                self._close_locked(uid, now,
                                   rv=released.get(uid, float("inf")))
            for uid, (c, results) in current.items():
                if uid not in self._live:
                    self._open_locked(c, results, now)
        if not behind:
            self._reconcile_stamp = stamp

    def _delivered(self, name: str, namespace: str, uid: str,
                   rv: float) -> bool:
        """Whether the meter's claim informer has delivered the claim's
        state at ``rv`` (``inf``: its deletion). The LIST reconcile acts
        only on such claims: one the event stream has not reached yet is
        left to the stream, whose events arrive in order. Acting ahead of
        it opens the interval at the LIST's state, and the stream's older
        events — an earlier allocation and its release — then read as
        stale, so a drain → reallocate inside one tick loses an interval.
        Without an informer (a meter driven by hand) everything counts as
        delivered."""
        if self._informer is None:
            return True
        seen = self._informer.cached(name, namespace)
        if seen is None or (seen.get("metadata") or {}).get("uid") != uid:
            # Deleted from the cache (delivered, when rv is inf), or not
            # listed yet.
            return rv == float("inf")
        return rv != float("inf") and self._rv(seen) >= rv

    def _stamp_pending(self) -> None:
        """Write the durable ``usage-since`` annotation for intervals
        that still lack one, and REMOVE it for intervals that closed —
        both idempotent (the stamped value is the record's own
        ``since``, so retries and conflicts converge; a clear of an
        already-gone claim or annotation is moot)."""
        with self._mu:
            pending = [rec for rec in self._live.values()
                       if not rec.stamped]
            clears = dict(self._pending_clears)
        for rec in pending:
            value = repr(rec.since)

            def mutate(obj: dict, _value: str = value) -> bool:
                anns = obj["metadata"].setdefault("annotations", {})
                if anns.get(ANN_USAGE_SINCE) == _value:
                    return False
                anns[ANN_USAGE_SINCE] = _value
                return True

            if mutate_with_retry(self.client, "ResourceClaim", rec.name,
                                 rec.namespace, mutate, uid=rec.uid):
                with self._mu:
                    live = self._live.get(rec.uid)
                    if live is not None and live.since == rec.since:
                        live.stamped = True
        for uid, (name, ns) in clears.items():

            def unstamp(obj: dict, _uid: str = uid) -> bool:
                anns = obj["metadata"].get("annotations") or {}
                if ANN_USAGE_SINCE not in anns:
                    return False
                with self._mu:
                    live = self._live.get(_uid)
                    if (live is not None
                            and anns[ANN_USAGE_SINCE] == repr(live.since)):
                        return False  # a reopen owns this stamp now
                del obj["metadata"]["annotations"][ANN_USAGE_SINCE]
                return True

            if mutate_with_retry(self.client, "ResourceClaim", name, ns,
                                 unstamp, uid=uid):
                with self._mu:
                    # A reopen in the meantime superseded the clear (it
                    # popped the entry and owns the stamp now).
                    if self._pending_clears.get(uid) == (name, ns):
                        self._pending_clears.pop(uid, None)

    def _publish(self, now: float) -> None:
        with self._mu:
            values = dict(self._completed)
            live_gpus: dict[str, int] = {}
            for rec in self._live.values():
                values[rec.namespace] = (
                    values.get(rec.namespace, 0.0)
                    + rec.gpus * max(0.0, now - rec.since))
                live_gpus[rec.namespace] = (
                    live_gpus.get(rec.namespace, 0) + rec.gpus)
            known = set(values) | set(self._published)
            for ns in known:
                delta = values.get(ns, 0.0) - self._published.get(ns, 0.0)
                if delta > 0:
                    self.metrics.gpu_seconds_total.inc(delta, namespace=ns)
                    self._published[ns] = values.get(ns, 0.0)
                self.metrics.gpus_allocated.set(
                    float(live_gpus.get(ns, 0)), namespace=ns)
            total_live = sum(live_gpus.values())
        cap = self._healthy_cap()
        self.metrics.cluster_utilization.set(
            round(total_live / cap, 4) if cap else 0.0)

    # -- read side ------------------------------------------------------------

    def completed(self) -> dict[str, float]:
        """Per-tenant GPU-seconds of intervals CLOSED by this meter
        incarnation — the exact, endpoint-computed half of the ledger
        (restart accounting sums this across incarnations; live accrual
        belongs to whichever incarnation eventually closes it)."""
        with self._mu:
            return dict(self._completed)

    def ledger(self, now: Optional[float] = None) -> dict[str, Any]:
        """The conservation oracle's view: exact per-tenant totals
        (completed + live-at-``now``), per-claim interval records, and
        the live set."""
        t = self.clock() if now is None else now
        with self._mu:
            namespaces = dict(self._completed)
            for rec in self._live.values():
                namespaces[rec.namespace] = (
                    namespaces.get(rec.namespace, 0.0)
                    + rec.gpus * max(0.0, t - rec.since))
            return {
                "namespaces": namespaces,
                "claims": {uid: dict(e)
                           for uid, e in self._claims.items()},
                "live": [{"uid": r.uid, "name": r.name,
                          "namespace": r.namespace, "gpus": r.gpus,
                          "since": r.since, "stamped": r.stamped}
                         for r in self._live.values()],
                "intervals_evicted": self.intervals_evicted,
                "pending_clears": len(self._pending_clears),
                "clears_dropped": self.clears_dropped,
            }

    def debug_snapshot(self) -> dict[str, Any]:
        led = self.ledger()
        live = led["live"]
        total_live = sum(r["gpus"] for r in live)
        cap = self._healthy_cap()
        return {
            "namespace": self.namespace,
            "tenants": {ns: round(v, 6)
                        for ns, v in sorted(led["namespaces"].items())},
            "live": sorted(live, key=lambda r: r["uid"]),
            "gpus_allocated": total_live,
            "healthy_capacity": cap,
            "utilization": round(total_live / cap, 4) if cap else 0.0,
            "stale": self.stale,
            "observe_failures": self.observe_failures,
            "intervals": sum(e["intervals"]
                             for e in led["claims"].values()),
            "intervals_evicted": led["intervals_evicted"],
            "pending_clears": led["pending_clears"],
            "clears_dropped": led["clears_dropped"],
        }

    # -- lifecycle ------------------------------------------------------------

    def start(self, observe_interval_s: float = 5.0) -> "UsageMeter":
        from k8s_dra_driver_tpu_torch.k8sclient.informer import Informer
        self._informer = Informer(
            self.client, "ResourceClaim", self.namespace,
            on_add=self.observe_claim,
            on_update=lambda _old, new: self.observe_claim(new),
            on_delete=self.observe_claim_deleted,
        ).start()
        self._informer.wait_for_cache_sync()
        self.observe()  # rebuild-from-LIST on (re)start

        def _run() -> None:
            while not self._stop.wait(observe_interval_s):
                self.observe()

        self._thread = threading.Thread(target=_run, name="usage-meter",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._informer is not None:
            self._informer.stop()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
