"""Lease-claimed shard ownership for active-active controller sharding.

The counterpart of the JAX package's ``pkg/shardmap.py``. Active-active
controller sharding needs a partition of the reconcile keyspace with
**zero double-reconcile**: at no instant may two controller instances both
believe they own shard S. :class:`ShardMap` generalizes the
:class:`~k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.
election.LeaderElector` from one singleton lease to N shard leases: shard
``i`` is owned by whoever holds the Lease ``<prefix>-<i>``, with exactly
the client-go acquire/renew/step-down semantics per shard. Safety
therefore reduces to the elector's safety (``renew_deadline <
lease_duration`` keeps the believe-windows of consecutive holders
disjoint).

Three pieces make it a sharding substrate:

* :func:`shard_for` — the deterministic keyspace partition (crc32 of
  ``namespace/uid``, NOT ``hash()`` which is randomized per process), so
  every replica, every restart and both packages route a key to the same
  shard.
* **Hysteretic rebalancing** — when the live-member census says this
  replica holds more than its fair share (``ceil(shards/members)``), it
  sheds the excess via :meth:`LeaderElector.step_down` (lease emptied,
  successor acquires immediately), but at most
  ``rebalance_max_handoffs`` per ``rebalance_window``; the rest is
  *deferred* — counted in ``gpu_dra_shard_rebalance_deferred_total``,
  never silent — so a replica joining or leaving causes a bounded
  trickle of handoffs, not a storm.
* :class:`ShardOpLedger` — the epoch-stamped operation ledger the
  reconcile gate records into: ops carry the shard lease's
  ``leaseTransitions`` (bumped on every holder change), and the ledger's
  oracle rejects two identities sharing one (shard, epoch) or any
  per-shard epoch regression — the machine-checkable form of "zero
  double-reconcile".
"""

from __future__ import annotations

import time
import zlib
from typing import Callable, Optional

from k8s_dra_driver_tpu_torch.k8sclient.client import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    new_object,
)
from k8s_dra_driver_tpu_torch.pkg import sanitizer
from k8s_dra_driver_tpu_torch.pkg.metrics import ShardMetrics, default_shard_metrics
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.election import (
    KIND_LEASE,
    LEASE_DURATION,
    RENEW_DEADLINE,
    RETRY_PERIOD,
    LeaderElector,
)


def shard_lease_name(prefix: str, shard: int) -> str:
    return f"{prefix}-{shard}"


def member_lease_name(prefix: str, identity: str) -> str:
    """The membership lease a replica renews every sync round. The
    fair-share census counts live MEMBERS, not shard holders — a fresh
    replica that owns nothing yet must still count, or an incumbent
    owning every shard would never shed anything to it."""
    return f"{prefix}-member-{identity}"


def shard_for(namespace: str, uid: str, shards: int) -> int:
    """The shard-key function: stable across replicas, restarts, and
    Python processes (crc32, not the per-process-salted ``hash()``).
    Namespace is part of the key so a namespace's objects spread rather
    than herd, and uid (not name) so a delete+recreate may land
    elsewhere but a live object never migrates."""
    return zlib.crc32(f"{namespace}/{uid}".encode()) % shards


class ShardMap:
    """One controller instance's view of lease-claimed shard ownership.

    ``sync_once()`` is the whole protocol: renew every owned shard
    (stepping down exactly as the elector does when the renew deadline
    lapses or another holder appears), try to acquire unowned shards
    while under ``max_shards``, then rebalance hysteretically if the
    live-holder census says this instance is over its fair share.
    Instances scan shards in an identity-rotated order so a fresh fleet
    spreads across the keyspace instead of herding onto shard 0.

    ``on_acquired(shard)`` / ``on_released(shard)`` are the reconcile
    hooks, invoked from inside ``sync_once`` via the elector's
    started/stopped-leading callbacks — ``on_released`` fires on ANY
    loss of a shard (deadline lapse, definitive loss to another holder,
    rebalance shed, or ``release_all``), so the reconcile loop for that
    shard must stop before anyone else can have acquired it.

    ``last_events`` holds the most recent sync round's
    ``(reason, shard)`` tuples — ``acquire`` (fresh lease), ``takeover``
    (lease with prior holders), ``renew``, ``lost`` (involuntary),
    ``rebalance`` (voluntary shed), ``defer`` (shed suppressed by the
    hysteresis cap) — which the metrics families count and the protocol
    model checker's ``shard_rebalance`` universe labels its transitions
    from.

    ``max_shards`` caps how many shards this instance acquires (default:
    all). ``elector_factory`` exists for the model checker's planted-bug
    corpus (``pkg/protolab.py`` substitutes a deliberately broken
    elector); production callers never pass it.
    """

    def __init__(
        self,
        client,
        identity: str,
        shards: int,
        namespace: str = "default",
        lease_prefix: str = "controller-shard",
        max_shards: Optional[int] = None,
        lease_duration: float = LEASE_DURATION,
        renew_deadline: float = RENEW_DEADLINE,
        retry_period: float = RETRY_PERIOD,
        clock: Callable[[], float] = time.time,
        on_acquired: Optional[Callable[[int], object]] = None,
        on_released: Optional[Callable[[int], object]] = None,
        elector_factory: Optional[Callable[..., LeaderElector]] = None,
        rebalance_max_handoffs: int = 1,
        rebalance_window: Optional[float] = None,
        metrics: Optional[ShardMetrics] = None,
    ):
        if shards <= 0:
            raise ValueError(f"shards must be positive, got {shards}")
        self.client = client
        self.identity = identity
        self.shards = shards
        self.max_shards = max_shards if max_shards is not None else shards
        self.namespace = namespace
        self.lease_prefix = lease_prefix
        self.lease_duration = lease_duration
        self.clock = clock
        self.on_acquired = on_acquired
        self.on_released = on_released
        # Hysteresis: at most this many voluntary (rebalance) handoffs
        # per window; the default window is two lease durations so a
        # shed shard has settled on its new owner before the next shed.
        self.rebalance_max_handoffs = rebalance_max_handoffs
        self.rebalance_window = (rebalance_window if rebalance_window
                                 is not None else 2.0 * lease_duration)
        self.deferred = 0
        self.acquisitions = 0
        self.releases = 0
        self.last_events: list[tuple[str, int]] = []
        self.metrics = metrics if metrics is not None \
            else default_shard_metrics()
        self._window_start = clock()
        self._window_handoffs = 0
        # Shed shards are embargoed for a lease duration so this
        # instance does not immediately re-acquire what it just handed
        # off (the under-share peer needs a round to claim it).
        self._cooldown_until: dict[int, float] = {}
        self._electors: dict[int, LeaderElector] = {}
        factory = elector_factory or LeaderElector
        for shard in range(shards):
            self._electors[shard] = factory(
                client,
                shard_lease_name(lease_prefix, shard),
                identity,
                namespace=namespace,
                on_started_leading=self._started_cb(shard),
                on_stopped_leading=self._stopped_cb(shard),
                lease_duration=lease_duration,
                renew_deadline=renew_deadline,
                retry_period=retry_period,
                clock=clock,
            )

    def _started_cb(self, shard: int) -> Callable[[], None]:
        def started() -> None:
            self.acquisitions += 1
            if self.on_acquired is not None:
                self.on_acquired(shard)
        return started

    def _stopped_cb(self, shard: int) -> Callable[[], None]:
        def stopped() -> None:
            self.releases += 1
            if self.on_released is not None:
                self.on_released(shard)
        return stopped

    # -- introspection ---------------------------------------------------------

    def owned(self) -> set[int]:
        """Shards this instance currently believes it owns."""
        return {s for s, e in self._electors.items() if e.is_leader}

    def confident(self, shard: int) -> bool:
        """Whether this instance may act on ``shard`` RIGHT NOW: it
        believes it owns the shard and its last successful renewal is
        within the renew deadline. The reconcile loop must gate every
        write on this (the elector contract: beyond the deadline the
        next holder may already be acquiring)."""
        e = self._electors[shard]
        return e.is_leader and (self.clock() - e.last_renew
                                <= e.renew_deadline)

    def epoch(self, shard: int) -> int:
        """``leaseTransitions`` of this instance's current ownership
        incarnation of ``shard`` — the stamp every gated op records into
        the :class:`ShardOpLedger`."""
        return self._electors[shard].epoch

    def debug_snapshot(self) -> dict:
        now = self.clock()
        return {
            "identity": self.identity,
            "owned": sorted(self.owned()),
            "max_shards": self.max_shards,
            "acquisitions": self.acquisitions,
            "releases": self.releases,
            "deferred": self.deferred,
            "window_handoffs": self._window_handoffs,
            "renew_age_s": {
                s: round(now - e.last_renew, 3)
                for s, e in self._electors.items() if e.is_leader
            },
        }

    def _scan_order(self) -> list[int]:
        # Identity-rotated, NOT hash() (randomized per process): every
        # run and every replica of the same identity scans the same way.
        off = zlib.crc32(self.identity.encode()) % self.shards
        return [(off + i) % self.shards for i in range(self.shards)]

    # -- one sync round (the retry_period body; exposed for tests) -------------

    def sync_once(self) -> set[int]:
        """One full round: renew this replica's membership lease, take
        the live-member census, renew owned shards, acquire unowned ones
        up to min(``max_shards``, fair share), then shed over-fair-share
        shards under the hysteresis cap. Returns the post-round owned
        set."""
        events: list[tuple[str, int]] = []
        try:
            self._renew_membership()
        except Exception:  # noqa: BLE001 — partitioned/transport failure:
            pass           # membership lapses into expiry, as designed
        try:
            members: Optional[set[str]] = self._census()
        except Exception:  # noqa: BLE001 — no census this round: acquire
            members = None  # conservatively, shed nothing
        fair = (self.max_shards if not members
                else -(-self.shards // len(members)))  # ceil
        acquire_cap = min(self.max_shards, fair)
        for shard in self._scan_order():
            e = self._electors[shard]
            if e.is_leader:
                before = e.last_renew
                e.run_once()  # renew or step down
                if not e.is_leader:
                    events.append(("lost", shard))
                elif e.last_renew > before:
                    events.append(("renew", shard))
            elif len(self.owned()) < acquire_cap:
                if self.clock() < self._cooldown_until.get(shard, 0.0):
                    continue  # just shed it; let the under-share peer claim
                e.run_once()  # try to acquire
                if e.is_leader:
                    events.append(
                        ("takeover" if e.epoch > 1 else "acquire", shard))
        events.extend(self._maybe_rebalance(members, fair))
        self.last_events = events
        self._observe(events)
        return self.owned()

    def _renew_membership(self) -> None:
        """Create-or-renew this replica's membership lease. Lost CAS
        races are tolerated (we renew again next round); an expired
        membership drops this replica from every peer's census within
        one lease duration — exactly the handoff clock."""
        name = member_lease_name(self.lease_prefix, self.identity)
        spec = {"holderIdentity": self.identity,
                "leaseDurationSeconds": self.lease_duration,
                "renewTime": self.clock()}
        lease = self.client.try_get(KIND_LEASE, name, self.namespace)
        if lease is None:
            obj = new_object(KIND_LEASE, name, self.namespace,
                             api_version="coordination.k8s.io/v1",
                             spec=spec)
            try:
                self.client.create(obj)
            except AlreadyExistsError:
                pass  # a previous incarnation's lease; renew next round
            return
        lease["spec"] = spec
        try:
            self.client.update(lease)
        except (ConflictError, NotFoundError):
            pass

    def _census(self) -> set[str]:
        """Distinct identities with a live (non-expired) membership
        lease, self included — the fair-share denominator."""
        now = self.clock()
        members: set[str] = set()
        prefix = f"{self.lease_prefix}-member-"
        for lease in self.client.list(KIND_LEASE, self.namespace):
            name = (lease.get("metadata") or {}).get("name", "")
            if not name.startswith(prefix):
                continue
            spec = lease.get("spec") or {}
            holder = spec.get("holderIdentity", "")
            if not holder:
                continue
            if (now - float(spec.get("renewTime", 0)) >
                    float(spec.get("leaseDurationSeconds",
                                   self.lease_duration))):
                continue
            members.add(holder)
        return members

    def _maybe_rebalance(self, members: Optional[set[str]],
                         fair: int) -> list[tuple[str, int]]:
        """Shed shards above the fair share, hysteretically: at most
        ``rebalance_max_handoffs`` voluntary handoffs per window, the
        rest deferred (and counted) to later windows."""
        if not members:
            return []  # no census this round (partition/first boot)
        owned = self.owned()
        excess = len(owned) - fair
        if excess <= 0:
            return []
        now = self.clock()
        if now - self._window_start >= self.rebalance_window:
            self._window_start = now
            self._window_handoffs = 0
        events: list[tuple[str, int]] = []
        # Shed in reverse scan order: keep the shards nearest this
        # identity's rotation offset (the ones a fresh fleet would
        # assign here anyway), minimizing steady-state churn.
        to_shed = [s for s in reversed(self._scan_order())
                   if s in owned][:excess]
        for shard in to_shed:
            if self._window_handoffs >= self.rebalance_max_handoffs:
                self.deferred += 1
                events.append(("defer", shard))
                continue
            e = self._electors[shard]
            try:
                e.step_down()
            except Exception:  # noqa: BLE001 — release lost to transport;
                pass           # locally stepped down, lease expires instead
            if not e.is_leader:
                self._window_handoffs += 1
                self._cooldown_until[shard] = now + self.lease_duration
                events.append(("rebalance", shard))
        return events

    def _observe(self, events: list[tuple[str, int]]) -> None:
        m = self.metrics
        for reason, _shard in events:
            if reason == "defer":
                m.rebalance_deferred_total.inc()
            elif reason != "renew":
                m.handoffs_total.inc(reason=reason)
        m.owned_shards.set(float(len(self.owned())),
                           identity=self.identity)

    def release_all(self) -> None:
        """Step down from every owned shard and empty its lease
        (ReleaseOnCancel per shard): successors acquire immediately
        instead of waiting out the lease durations. The membership lease
        is emptied too — a leaving replica must drop out of the fair-
        share census at once, not a lease duration later."""
        for shard in sorted(self._electors):
            if self._electors[shard].is_leader:
                self.metrics.handoffs_total.inc(reason="release")
            self._electors[shard].stop()
        try:
            name = member_lease_name(self.lease_prefix, self.identity)
            lease = self.client.try_get(KIND_LEASE, name, self.namespace)
            if (lease is not None and (lease.get("spec") or {})
                    .get("holderIdentity") == self.identity):
                lease["spec"] = {"holderIdentity": "",
                                 "leaseDurationSeconds": 1, "renewTime": 0}
                self.client.update(lease)
        except Exception:  # noqa: BLE001 — partitioned mid-leave: the
            pass           # membership expires instead
        self.metrics.owned_shards.set(0.0, identity=self.identity)


class ShardOpLedger:
    """Epoch-stamped operation ledger — zero-double-reconcile, made
    machine-checkable. Every shard-gated operation records
    ``(shard, epoch, identity, op)`` where ``epoch`` is the shard
    lease's ``leaseTransitions`` at admission time. Because the epoch
    bumps on every holder change, two ownership incarnations never
    share one, so :meth:`violations` can reject:

    * ``double_reconcile`` — two identities recording under the same
      (shard, epoch): both believed they owned the same incarnation;
    * ``epoch_regression`` — an op stamped with an older epoch landing
      after a newer one: a stale owner acted after the handoff.

    Append order is the single-process observation order, which is
    exactly the happens-before the fake cluster gives us.
    """

    def __init__(self):
        self._lock = sanitizer.new_lock("ShardOpLedger._lock")
        self._ops: list[tuple[int, int, str, str]] = []

    def record(self, shard: int, epoch: int, identity: str,
               op: str) -> None:
        with self._lock:
            self._ops.append((shard, epoch, identity, op))

    def ops(self) -> list[tuple[int, int, str, str]]:
        with self._lock:
            return list(self._ops)

    def violations(self) -> list[str]:
        out: list[str] = []
        owner_of: dict[tuple[int, int], str] = {}
        high: dict[int, int] = {}
        for shard, epoch, identity, op in self.ops():
            prev = owner_of.setdefault((shard, epoch), identity)
            if prev != identity:
                out.append(
                    f"double_reconcile: shard {shard} epoch {epoch} "
                    f"claimed by {prev} and {identity} (op {op})")
            if epoch < high.get(shard, 0):
                out.append(
                    f"epoch_regression: shard {shard} op {op} stamped "
                    f"epoch {epoch} after epoch {high[shard]}")
            if epoch > high.get(shard, 0):
                high[shard] = epoch
        return out
