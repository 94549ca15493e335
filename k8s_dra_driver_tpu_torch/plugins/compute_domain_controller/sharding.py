"""Active-active controller sharding: N replicas, zero double-reconcile.

The counterpart of the JAX package's ``plugins/compute_domain_controller/
sharding.py``. The CD controller binary runs the reconciler, the
ClaimReallocator, the NodeLifecycleController and the observability
singletons in one process. This module turns it active-active
(docs/architecture.md, "Controller sharding"):

* every replica runs ALL its informers (watch is cheap and gives each
  replica a warm cache), but **work is admitted per shard**: a
  :class:`ShardGate` sits at each component's single gating point
  (``ComputeDomainController.reconcile``,
  ``ClaimReallocator.reconcile_once``,
  ``NodeLifecycleController.poll_once``) and admits an op only while
  this replica **confidently** owns ``shard_for(namespace, uid)`` —
  the elector's believe-window contract, so two replicas' admission
  windows for one shard never overlap;
* every admitted op is recorded in the :class:`ShardOpLedger` stamped
  with the shard lease's ``leaseTransitions`` epoch — the
  zero-double-reconcile claim is checked, not assumed;
* the components that must remain singletons (CanaryProber, UsageMeter,
  DefragPlanner, FlightRecorder) are **pinned to the leader shard**
  (:data:`LEADER_SHARD`): whichever replica owns shard 0 runs them.
  On failover the successor's factories build FRESH incarnations —
  the UsageMeter rebuilds its ledger exactly from the durable
  ``usage-since`` annotations, which is what makes the pinning safe.

Handoff inherits the lease math: a dead or partitioned replica stops
being confident within its renew deadline, the successor acquires
within one lease duration (at once after a graceful ``release_all``),
and the hysteresis cap in ``ShardMap._maybe_rebalance`` keeps a
join/leave to a bounded trickle of handoffs per window
(``gpu_dra_shard_handoffs_total`` /
``gpu_dra_shard_rebalance_deferred_total``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from k8s_dra_driver_tpu_torch.pkg.metrics import ShardMetrics, default_shard_metrics
from k8s_dra_driver_tpu_torch.pkg.shardmap import (
    ShardMap,
    ShardOpLedger,
    shard_for,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.election import (
    LEASE_DURATION,
    RENEW_DEADLINE,
    RETRY_PERIOD,
)

logger = logging.getLogger(__name__)

#: The shard the singleton components ride on. Shard 0 by convention:
#: it always exists (shards >= 1), and pinning to a shard rather than a
#: separate lease means singleton failover IS shard failover — one
#: proven protocol, not two.
LEADER_SHARD = 0


class ShardGate:
    """The single admission point sharded components call.

    ``admit(namespace, uid, component)`` returns True iff this replica
    confidently owns the key's shard *right now*, and records the
    admitted op in the epoch-stamped ledger. Components treat False as
    "not mine": skip without error, leave any per-replica pending state
    in place — the owning replica's own informer feeds it the same
    work."""

    def __init__(self, shard_map: ShardMap,
                 ledger: Optional[ShardOpLedger] = None,
                 metrics: Optional[ShardMetrics] = None):
        self.shard_map = shard_map
        self.ledger = ledger if ledger is not None else ShardOpLedger()
        self.metrics = metrics if metrics is not None \
            else default_shard_metrics()

    def shard_of(self, namespace: str, uid: str) -> int:
        return shard_for(namespace, uid, self.shard_map.shards)

    def admit(self, namespace: str, uid: str, component: str) -> bool:
        shard = self.shard_of(namespace, uid)
        if not self.shard_map.confident(shard):
            self.metrics.gated_ops_total.inc(component=component,
                                             outcome="skipped")
            return False
        self.ledger.record(shard, self.shard_map.epoch(shard),
                           self.shard_map.identity,
                           f"{component}:{namespace}/{uid}")
        self.metrics.gated_ops_total.inc(component=component,
                                         outcome="admitted")
        return True


class SingletonHandle:
    """Wraps a leader-pinned component whose teardown is more than one
    ``stop()`` call (the FlightRecorder incarnation must unsubscribe
    from the SLO engine; the defrag planner must detach AND stop).
    ``obj`` is the live component for introspection/tests."""

    def __init__(self, obj, stop: Callable[[], None]):
        self.obj = obj
        self._stop = stop

    def stop(self) -> None:
        self._stop()


class ShardedController:
    """One replica's shard membership: a ShardMap, its sync loop, the
    gate the components consult, and the leader-shard singleton pinning.

    ``singleton_factories`` maps a name to a zero-arg factory that
    builds AND starts a fresh incarnation, returning a handle with
    ``stop()``. The factories run when this replica acquires
    :data:`LEADER_SHARD` and their handles are stopped when it loses
    the shard — losing ANY shard fires ``on_released`` before a
    successor can have acquired it (the elector contract), so the old
    incarnation's singletons are down before the new ones start acting
    confidently.

    ``on_shard_acquired`` is the resync hook: the controller main wires
    it to re-enqueue the acquired shard's objects, so work the previous
    owner had in flight is replayed by the successor (reconciles are
    idempotent — that is what makes at-least-once-per-owner safe)."""

    def __init__(
        self,
        client,
        identity: str,
        shards: int,
        lease_namespace: str = "default",
        lease_prefix: str = "controller-shard",
        lease_duration: float = LEASE_DURATION,
        renew_deadline: float = RENEW_DEADLINE,
        retry_period: float = RETRY_PERIOD,
        clock: Callable[[], float] = time.time,
        ledger: Optional[ShardOpLedger] = None,
        metrics: Optional[ShardMetrics] = None,
        singleton_factories: Optional[
            dict[str, Callable[[], object]]] = None,
        on_shard_acquired: Optional[Callable[[int], None]] = None,
        rebalance_max_handoffs: int = 1,
        rebalance_window: Optional[float] = None,
    ):
        self.identity = identity
        self.retry_period = retry_period
        self.metrics = metrics if metrics is not None \
            else default_shard_metrics()
        self.singleton_factories = dict(singleton_factories or {})
        self.on_shard_acquired = on_shard_acquired
        self._singletons: dict[str, object] = {}
        self._singleton_mu = threading.Lock()
        #: incarnation counter per singleton name (observability + the
        #: failover tests' evidence that a fresh instance was built).
        self.singleton_incarnations: dict[str, int] = {}
        self.shard_map = ShardMap(
            client, identity, shards,
            namespace=lease_namespace, lease_prefix=lease_prefix,
            lease_duration=lease_duration,
            renew_deadline=renew_deadline, retry_period=retry_period,
            clock=clock,
            on_acquired=self._acquired, on_released=self._released,
            rebalance_max_handoffs=rebalance_max_handoffs,
            rebalance_window=rebalance_window, metrics=self.metrics)
        self.gate = ShardGate(self.shard_map, ledger=ledger,
                              metrics=self.metrics)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def ledger(self) -> ShardOpLedger:
        return self.gate.ledger

    # -- ownership callbacks (fired from inside sync_once) --------------------

    def _acquired(self, shard: int) -> None:
        if shard == LEADER_SHARD:
            self._start_singletons()
        if self.on_shard_acquired is not None:
            self.on_shard_acquired(shard)

    def _released(self, shard: int) -> None:
        if shard == LEADER_SHARD:
            self._stop_singletons()

    def _start_singletons(self) -> None:
        # Factories run OUTSIDE the lock: they build and start real
        # components and may take arbitrary time or call back into this
        # class; only the registry mutation is locked. Ownership
        # callbacks fire solely from the sync thread, so two starters
        # never race for the same name.
        with self._singleton_mu:
            # Insertion order, not sorted: a later factory may depend on
            # an earlier one's fresh incarnation (the FlightRecorder
            # bundles the leader's meter and prober).
            pending = [(name, factory)
                       for name, factory in self.singleton_factories.items()
                       if name not in self._singletons]
        for name, factory in pending:
            try:
                handle = factory()
            except Exception:  # noqa: BLE001 — one broken singleton
                # must not take down shard sync; the rest still run.
                logger.exception("starting singleton %s failed", name)
                continue
            with self._singleton_mu:
                self._singletons[name] = handle
                self.singleton_incarnations[name] = (
                    self.singleton_incarnations.get(name, 0) + 1)
                incarnation = self.singleton_incarnations[name]
            logger.info("%s: leader shard acquired; started "
                        "singleton %s (incarnation %d)",
                        self.identity, name, incarnation)

    def _stop_singletons(self) -> None:
        with self._singleton_mu:
            stopping = [(name, self._singletons.pop(name))
                        for name in reversed(list(self._singletons))]
        for name, handle in stopping:
            try:
                handle.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                logger.exception("stopping singleton %s failed", name)

    def running_singletons(self) -> list[str]:
        with self._singleton_mu:
            return sorted(self._singletons)

    def singleton(self, name: str):
        """The live handle of a leader-pinned singleton, or None when
        this replica does not hold the leader shard."""
        with self._singleton_mu:
            return self._singletons.get(name)

    # -- lifecycle -------------------------------------------------------------

    def sync_once(self) -> set[int]:
        return self.shard_map.sync_once()

    def start(self) -> "ShardedController":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"shard-sync-{self.identity}",
            daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.retry_period):
            try:
                self.sync_once()
            except Exception:  # noqa: BLE001 — sync must not die silently
                logger.exception("shard sync round failed; retrying")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.shard_map.release_all()  # fires _released → singletons stop
        self._stop_singletons()  # belt-and-braces if we owned nothing
