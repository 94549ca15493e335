"""Lease-based leader election with release-on-cancel.

Copied from the JAX package's ``plugins/compute_domain_controller/
election.py``. The analogue of the reference's controller election
(``cmd/compute-domain-controller/main.go:313-414``, client-go
leaderelection with ``ReleaseOnCancel: true``): candidates race to
create/renew a Lease object; the holder runs the controller; on shutdown
the holder empties the lease so the next candidate acquires immediately
instead of waiting out the lease duration.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from k8s_dra_driver_tpu_torch.k8sclient.client import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    new_object,
)

logger = logging.getLogger(__name__)

KIND_LEASE = "Lease"

# client-go defaults (main.go:377-383 uses 30s/20s/5s scaled down here; the
# fake-clock tests override all three).
LEASE_DURATION = 15.0
RENEW_DEADLINE = 10.0
RETRY_PERIOD = 2.0


class LeaderElector:
    """One candidate. ``on_started_leading`` runs when the lease is won;
    ``on_stopped_leading`` when leadership is lost or released."""

    def __init__(
        self,
        client,
        lease_name: str,
        identity: str,
        namespace: str = "default",
        on_started_leading: Optional[Callable[[], object]] = None,
        on_stopped_leading: Optional[Callable[[], object]] = None,
        lease_duration: float = LEASE_DURATION,
        renew_deadline: float = RENEW_DEADLINE,
        retry_period: float = RETRY_PERIOD,
        clock: Callable[[], float] = time.time,
    ):
        self.client = client
        self.lease_name = lease_name
        self.identity = identity
        self.namespace = namespace
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.clock = clock
        self.is_leader = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Renew-deadline clock (client-go RenewDeadline semantics): last
        # wall-clock instant a CAS round succeeded while we were leader.
        self._last_renew = 0.0
        # Set by try_acquire_or_renew when another identity holds a live
        # lease — a definitive loss, not a transient renewal failure.
        self._lost_to: Optional[str] = None
        # leaseTransitions value this candidate last wrote on a winning
        # CAS: the fencing epoch of its ownership incarnation.
        self._epoch = 0

    @property
    def epoch(self) -> int:
        """``leaseTransitions`` of this candidate's current ownership
        incarnation — bumped by every holder change, so two incarnations
        of ownership never share an epoch. Ops stamped with it are
        totally ordered across handoffs."""
        return self._epoch

    @property
    def last_renew(self) -> float:
        """``clock()`` instant of the last successful CAS round. A
        candidate may act as leader only within ``renew_deadline`` of
        this instant."""
        return self._last_renew

    # -- lease CAS ------------------------------------------------------------

    def _spec(self, acquisitions: int) -> dict:
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": self.lease_duration,
            "renewTime": self.clock(),
            "leaseTransitions": acquisitions,
        }

    def try_acquire_or_renew(self) -> bool:
        """One CAS round (the leaderelection tryAcquireOrRenew analogue).
        Returns True iff this candidate holds the lease afterwards."""
        now = self.clock()
        self._lost_to = None
        lease = self.client.try_get(KIND_LEASE, self.lease_name, self.namespace)
        if lease is None:
            obj = new_object(KIND_LEASE, self.lease_name, self.namespace,
                             api_version="coordination.k8s.io/v1",
                             spec=self._spec(acquisitions=1))
            try:
                self.client.create(obj)
                self._epoch = 1
                return True
            except AlreadyExistsError:
                return False  # lost the creation race; retry next round
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity", "")
        expired = (not holder or
                   now - float(spec.get("renewTime", 0)) >
                   float(spec.get("leaseDurationSeconds", self.lease_duration)))
        if holder != self.identity and not expired:
            self._lost_to = holder
            return False
        transitions = int(spec.get("leaseTransitions", 0))
        if holder != self.identity:
            transitions += 1
        lease["spec"] = self._spec(transitions)
        try:
            self.client.update(lease)
            self._epoch = transitions
            return True
        except (ConflictError, NotFoundError):
            return False  # racing candidate won; re-read next round

    def release(self) -> None:
        """Empty the lease iff we hold it (ReleaseOnCancel, main.go:393):
        the successor acquires immediately instead of waiting out the TTL."""
        lease = self.client.try_get(KIND_LEASE, self.lease_name, self.namespace)
        if lease is None:
            return
        if (lease.get("spec") or {}).get("holderIdentity") != self.identity:
            return
        lease["spec"] = {"holderIdentity": "", "leaseDurationSeconds": 1,
                         "renewTime": 0,
                         "leaseTransitions":
                             (lease.get("spec") or {}).get("leaseTransitions", 0)}
        try:
            self.client.update(lease)
        except (ConflictError, NotFoundError):
            pass  # someone already took over

    # -- loop ------------------------------------------------------------------

    def run_once(self) -> None:
        """One election round — exposed for deterministic tests.

        A leader tolerates renewal failures (transient CAS conflicts AND
        transport exceptions alike) until ``renew_deadline`` has elapsed
        since the last successful renewal — the client-go RenewDeadline
        clock. Observing another identity on a live lease is a definitive
        loss and steps down immediately. Both rules close the two gaps of
        the one-failed-round version: flapping on a single ConflictError,
        and an API outage leaving a zombie leader forever."""
        now = self.clock()
        try:
            won = self.try_acquire_or_renew()
        except Exception:  # noqa: BLE001 — transport failure: count it
            # against the renew deadline exactly like a failed CAS round.
            logger.exception("election round transport failure")
            won = False
        if won:
            self._last_renew = now
            if not self.is_leader:
                logger.info("%s acquired lease %s",
                            self.identity, self.lease_name)
                # Mark leadership only AFTER the start callback succeeds: a
                # failing start would otherwise leave a permanent leader with
                # no controller running (the callback would never be retried
                # while the lease keeps renewing).
                if self.on_started_leading is not None:
                    self.on_started_leading()
                self.is_leader = True
            return
        if not self.is_leader:
            return
        if self._lost_to:
            logger.warning("%s lost lease %s to %s; stepping down",
                           self.identity, self.lease_name, self._lost_to)
        elif now - self._last_renew > self.renew_deadline:
            logger.warning(
                "%s failed to renew lease %s within %.1fs; stepping down",
                self.identity, self.lease_name, self.renew_deadline)
        else:
            logger.warning(
                "%s renewal of lease %s failed; %.1fs left before the renew "
                "deadline", self.identity, self.lease_name,
                self.renew_deadline - (now - self._last_renew))
            return  # tolerate: still inside the renew deadline
        self.is_leader = False
        if self.on_stopped_leading is not None:
            self.on_stopped_leading()

    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(
            target=self._run, name=f"leader-elector-{self.identity}",
            daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.retry_period):
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 — electors must not die silently
                logger.exception("election round failed; retrying")

    def step_down(self) -> None:
        """Voluntarily stop leading and empty the lease (a rebalance
        handoff): ``stop()`` without touching the run loop, so
        a sync-driven elector can later re-acquire. The stopped-leading
        callback fires BEFORE the release lands — the reconcile loop for
        this lease must already be stopped by the time a successor can
        acquire."""
        if not self.is_leader:
            return
        self.is_leader = False
        if self.on_stopped_leading is not None:
            self.on_stopped_leading()
        self.release()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.step_down()
