"""SLO engine: error budgets + multi-window multi-burn-rate alerting.

The counterpart of the JAX package's ``pkg/slo.py``. The offline SLOs
(claim→ready p99, recovery p99 in the soak oracle) get an ONLINE
representation here (docs/observability.md, "Fleet telemetry"): each
:class:`Slo` defines an objective over the fleet aggregate's recording
rules (:class:`pkg.telemetry.RecordingRules`),
and :class:`SloEngine` evaluates Google-SRE-style multi-window
multi-burn-rate alerts over it — the fast pair (5 m / 1 h, 14.4×) pages,
the slow pair (6 h / 3 d, 1×) tickets. Both windows of a pair must burn
above the threshold to fire (the long window proves the burn is real,
the short window proves it is CURRENT), and the alert clears as soon as
the short window recovers — exactly the SRE-workbook shape.

Every transition is recorded as a ``SloBurnRateHigh`` /
``SloBurnRateCleared`` Event (``pkg/events.py``) and fanned out to
subscribers — the first consumer is remediation: the device health
monitor's GPU-vanish flap damping tightens from "damp" to "drain
immediately" while a fast-burn alert is firing
(``DeviceHealthMonitor(fast_drain=engine.fast_burn_firing)``).

Clocks and windows are injectable: tests and the soak harness run
seconds-compressed windows (:func:`compressed_windows`) against a
real or fake clock — the state machine is identical.
"""

from __future__ import annotations

import logging
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Optional

from k8s_dra_driver_tpu_torch.pkg import sanitizer
from k8s_dra_driver_tpu_torch.pkg.events import (
    REASON_SLO_BURN_RATE_CLEARED,
    REASON_SLO_BURN_RATE_HIGH,
    TYPE_NORMAL,
    TYPE_WARNING,
)
from k8s_dra_driver_tpu_torch.pkg.metrics import Counter, Gauge, Registry
from k8s_dra_driver_tpu_torch.pkg.telemetry import (
    FLEET_ALLOCATIONS_TOTAL,
    FLEET_CANARY_PROBES,
    FLEET_PREPARE_ERRORS,
    FLEET_RECOVERY_SECONDS,
    FLEET_REQUEST_DURATION,
    FLEET_REQUESTS_TOTAL,
    FLEET_SERVING_CLAIM_ATTEMPTS,
    RecordingRules,
)

logger = logging.getLogger(__name__)

SEVERITY_PAGE = "page"
SEVERITY_TICKET = "ticket"


@dataclass(frozen=True)
class BurnWindow:
    """One multi-window burn-rate alert condition: fire when BOTH the
    short and the long trailing windows burn budget faster than
    ``threshold``× the sustainable rate."""

    severity: str
    short_s: float
    long_s: float
    threshold: float


#: the SRE-workbook pairs: 14.4× over 5 m + 1 h pages (2 % of a 30-day
#: budget gone in an hour), 1× over 6 h + 3 d tickets (budget on track
#: to exhaust within the SLO period).
DEFAULT_BURN_WINDOWS: tuple[BurnWindow, ...] = (
    BurnWindow(SEVERITY_PAGE, short_s=300.0, long_s=3600.0, threshold=14.4),
    BurnWindow(SEVERITY_TICKET, short_s=6 * 3600.0, long_s=72 * 3600.0,
               threshold=1.0),
)


def compressed_windows(
    scale: float,
    windows: tuple[BurnWindow, ...] = DEFAULT_BURN_WINDOWS,
) -> tuple[BurnWindow, ...]:
    """The same alert shape with every window divided by ``scale`` —
    hours-compressed tests and the soak harness use this so the
    state machine under test is the production one."""
    if scale <= 0:
        raise ValueError(f"scale must be > 0, got {scale}")
    return tuple(
        BurnWindow(w.severity, w.short_s / scale, w.long_s / scale,
                   w.threshold)
        for w in windows)


class Slo:
    """One service-level objective.

    ``error_ratio(rules, window_s)`` returns the fraction of events in
    the trailing window that violated the objective — None when the
    window saw no traffic (no traffic burns no budget). ``objective`` is
    the target good fraction (0.999 → a 0.1 % error budget).
    """

    def __init__(self, name: str, objective: float,
                 error_ratio: Callable[[RecordingRules, float],
                                       Optional[float]],
                 description: str = ""):
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"SLO {name}: objective must be in (0, 1), got {objective}")
        self.name = name
        self.objective = objective
        self.error_ratio = error_ratio
        self.description = description

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def burn_rate(self, rules: RecordingRules,
                  window_s: float) -> Optional[float]:
        ratio = self.error_ratio(rules, window_s)
        if ratio is None:
            return None
        return ratio / self.budget


def ratio_slo(name: str, objective: float, bad_sample: str,
              total_sample: str,
              bad_match: Optional[dict[str, str]] = None,
              total_match: Optional[dict[str, str]] = None,
              description: str = "") -> Slo:
    """SLO over two counters: error ratio = increase(bad)/increase(total)."""
    return Slo(name, objective,
               lambda rules, w: rules.ratio(
                   bad_sample, total_sample, w,
                   num_match=bad_match, den_match=total_match),
               description)


def latency_slo(name: str, objective: float, family: str, threshold_le: float,
                match: Optional[dict[str, str]] = None,
                description: str = "") -> Slo:
    """SLO over a histogram: an event is good when it lands in the
    ``threshold_le`` bucket — the threshold must be one of the family's
    bucket bounds (the Prometheus way to make latency an SLI)."""

    def error_ratio(rules: RecordingRules, w: float) -> Optional[float]:
        good = rules.bucket_good_ratio(family, threshold_le, w, match)
        if good is None:
            return None
        return 1.0 - good

    return Slo(name, objective, error_ratio, description)


def default_slos() -> tuple[Slo, ...]:
    """The shipped fleet SLO set — the online forms of the SLOs the
    bench gate and soak oracle enforce offline (docs/observability.md):

    - ``claim_ready_latency``: 99.9 % of prepares complete within 0.8 s
      (the 0.05 s × 2⁴ histogram bound — well above the churn p99, well
      below the reference's retry horizon).
    - ``prepare_errors``: 99.9 % of prepare requests succeed.
    - ``remediation_recovery``: 99 % of device recoveries complete
      within 6.4 s (the soak's 5 s claim-recovery SLO rounded up to the
      recovery histogram's nearest bucket bound).
    """
    return (
        latency_slo("claim_ready_latency", 0.999,
                    FLEET_REQUEST_DURATION, threshold_le=0.8,
                    match={"operation": "prepare"},
                    description="prepare batches complete within 0.8s"),
        ratio_slo("prepare_errors", 0.999,
                  FLEET_PREPARE_ERRORS, FLEET_REQUESTS_TOTAL,
                  total_match={"operation": "prepare"},
                  description="prepare requests succeed"),
        latency_slo("remediation_recovery", 0.99,
                    FLEET_RECOVERY_SECONDS, threshold_le=6.4,
                    description="device recoveries complete within 6.4s"),
    )


#: the admission SLO's name — the defrag planner filters its subscribed
#: alert transitions on this (kubeletplugin/remediation.py).
SLO_ALLOCATION_ADMISSION = "allocation_admission"


def allocation_admission_slo(objective: float = 0.99) -> Slo:
    """Admission-health SLO (docs/performance.md, "Topology-aware
    allocation"): an allocation attempt is BAD when it bounced with
    ``outcome=fragmented`` — free capacity existed but no placement fit.
    Genuinely-full rejections (``unsatisfiable``) are capacity planning's
    problem, not placement's, and do not burn this budget. Opt-in (pass
    alongside :func:`default_slos` to the engine): its designed consumer
    is the defrag planner, the second ``subscribe()`` consumer after
    GPU-vanish flap damping — a ticket-severity burn means large claims
    are bouncing off fragmentation and migration can fix it."""
    return ratio_slo(
        SLO_ALLOCATION_ADMISSION, objective,
        FLEET_ALLOCATIONS_TOTAL, FLEET_ALLOCATIONS_TOTAL,
        bad_match={"outcome": "fragmented"},
        description="allocation attempts do not bounce off fragmentation")


#: the availability SLO's name — the canary-verdict consumers filter
#: their subscribed transitions on this.
SLO_CANARY_AVAILABILITY = "canary_availability"


def canary_availability_slo(objective: float = 0.99) -> Slo:
    """User-facing availability, measured from the OUTSIDE
    (docs/observability.md, "Synthetic probing"): a probe is BAD when
    the synthetic full-lifecycle canary (``pkg/canary.py``) failed or
    found residue — exactly what a tenant asking for a GPU right now
    would experience. Every non-``ok`` outcome burns (a leak is a
    user-facing defect even when the probe's own lifecycle completed).
    No probes in the window = no verdict (None), never a page. Opt-in,
    like :func:`allocation_admission_slo`: the controller main includes
    it whenever fleet telemetry is on — without a canary feeding the
    families it simply never evaluates to a ratio."""

    def error_ratio(rules: RecordingRules, w: float) -> Optional[float]:
        good = rules.ratio(FLEET_CANARY_PROBES, FLEET_CANARY_PROBES, w,
                           num_match={"outcome": "ok"})
        if good is None:
            return None
        return 1.0 - good

    return Slo(SLO_CANARY_AVAILABILITY, objective, error_ratio,
               description="synthetic canary probes complete the full "
                           "claim lifecycle")


#: the serving readiness SLO's name — the serving soak's gate filters
#: its subscribed alert transitions on this.
SLO_CLAIM_READY = "claim_ready"


def claim_ready_slo(objective: float = 0.99) -> Slo:
    """Serving readiness, measured from real tenant traffic
    (docs/observability.md, "Serving dataplane"): a replica serve
    session is BAD when its claim did not reach a first decoded batch
    inside the deadline — a tenant's replica asked for GPUs and could
    not start serving. Computed over the LIVE fleet mirror of
    ``gpu_dra_serving_claim_attempts_total`` (not an offline
    percentile), so the burn-rate windows see node loss the moment
    replicas start failing to re-claim. No attempts in the window = no
    verdict (None), never a page. Opt-in, like
    :func:`canary_availability_slo`: the serving soak plane includes it
    wherever replica fleets feed the family."""

    def error_ratio(rules: RecordingRules, w: float) -> Optional[float]:
        good = rules.ratio(FLEET_SERVING_CLAIM_ATTEMPTS,
                           FLEET_SERVING_CLAIM_ATTEMPTS, w,
                           num_match={"outcome": "ok"})
        if good is None:
            return None
        return 1.0 - good

    return Slo(SLO_CLAIM_READY, objective, error_ratio,
               description="tenant replica claims reach a first decoded "
                           "batch inside the deadline")


@dataclass(frozen=True)
class AlertTransition:
    """One state-machine edge, as delivered to subscribers and kept in
    the engine's bounded history."""

    slo: str
    severity: str
    transition: str            # fired | cleared
    burn_short: float
    burn_long: float
    threshold: float
    at: float                  # engine clock


class SloMetrics:
    """The SLO engine's own families (docs/observability.md)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.burn_rate = r.register(Gauge(
            "gpu_dra_slo_burn_rate",
            "Latest burn rate (error ratio / budget) per SLO, severity "
            "pair, and window leg (short / long).",
            ("slo", "severity", "window")))
        self.error_budget_remaining = r.register(Gauge(
            "gpu_dra_slo_error_budget_remaining",
            "Fraction of the error budget left over the longest "
            "configured window (1 = untouched, 0 = exhausted).",
            ("slo",)))
        self.alert_firing = r.register(Gauge(
            "gpu_dra_slo_alert_firing",
            "Whether the (slo, severity) burn-rate alert is firing.",
            ("slo", "severity")))
        self.alert_transitions_total = r.register(Counter(
            "gpu_dra_slo_alert_transitions_total",
            "Burn-rate alert transitions (fired / cleared).",
            ("slo", "severity", "transition")))


_default_slo_metrics: Optional[SloMetrics] = None


def default_slo_metrics() -> SloMetrics:
    global _default_slo_metrics
    if _default_slo_metrics is None:
        _default_slo_metrics = SloMetrics()
    return _default_slo_metrics


#: every live engine in the process, for the ``/debug/slo`` endpoint
#: (the informer/workqueue weakref-registry pattern).
_live_engines: "weakref.WeakSet[SloEngine]" = weakref.WeakSet()


def slo_debug_snapshot() -> list[dict[str, Any]]:
    """The ``/debug/slo`` payload: objective states, burn rates, firing
    alerts, and bounded transition history for every live engine — a
    load-bearing incident-bundle input (docs/observability.md)."""
    out = []
    for engine in list(_live_engines):
        try:
            out.append(engine.debug_snapshot())
        except Exception as e:  # noqa: BLE001 — one broken engine must
            # not blank the endpoint for the others.
            out.append({"error": repr(e)})
    return out


class SloEngine:
    """Evaluates every (SLO × burn window) pair against the recording
    rules; maintains the alert state machine.

    Fire condition: burn(short) ≥ threshold AND burn(long) ≥ threshold.
    Clear condition: burn(short) < threshold (the short window is the
    fast-moving leg; once it recovers the burn is no longer current —
    the long window alone re-fires nothing, both must exceed again).

    Transitions are (1) counted + gauged in :class:`SloMetrics`,
    (2) recorded as Events when an ``events`` recorder is supplied, and
    (3) fanned out to :meth:`subscribe` callbacks — subscriber failures
    are logged, never propagated into the evaluation loop.
    """

    def __init__(
        self,
        rules: RecordingRules,
        slos: tuple[Slo, ...] = (),
        windows: tuple[BurnWindow, ...] = DEFAULT_BURN_WINDOWS,
        clock: Callable[[], float] = time.monotonic,
        events: Optional[Any] = None,
        metrics: Optional[SloMetrics] = None,
        history_cap: int = 512,
    ):
        self.rules = rules
        self.slos = tuple(slos) or default_slos()
        self.windows = tuple(windows)
        self.clock = clock
        self.events = events
        self.metrics = metrics or default_slo_metrics()
        self.history_cap = history_cap
        self._mu = sanitizer.new_lock("SloEngine._mu")
        self._firing: dict[tuple[str, str], AlertTransition] = {}
        self._history: list[AlertTransition] = []
        self._subscribers: list[Callable[[AlertTransition], None]] = []
        _live_engines.add(self)

    # -- consumers -----------------------------------------------------------

    def subscribe(self, fn: Callable[[AlertTransition], None]) -> None:
        """Register an alert-transition consumer (remediation's drain
        tightening, a paging bridge, a test oracle)."""
        with self._mu:
            self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[AlertTransition], None]) -> None:
        """Detach a consumer (a leader-pinned FlightRecorder incarnation
        stepping down on shard handoff). Unknown fns are a no-op."""
        with self._mu:
            try:
                self._subscribers.remove(fn)
            except ValueError:
                pass

    def firing(self) -> dict[tuple[str, str], AlertTransition]:
        with self._mu:
            return dict(self._firing)

    def fast_burn_firing(self) -> bool:
        """Whether any page-severity alert is currently firing — the
        hook the health monitor's flap damping consults
        (docs/self-healing.md)."""
        with self._mu:
            return any(sev == SEVERITY_PAGE for _slo, sev in self._firing)

    def transitions(self) -> list[AlertTransition]:
        """Bounded transition history, oldest first."""
        with self._mu:
            return list(self._history)

    # -- evaluation ----------------------------------------------------------

    def evaluate(self) -> list[AlertTransition]:
        """One pass over every (SLO × window pair); returns this pass's
        transitions."""
        now = self.clock()
        out: list[AlertTransition] = []
        longest = max((w.long_s for w in self.windows), default=0.0)
        for slo in self.slos:
            if longest > 0:
                ratio_longest = slo.error_ratio(self.rules, longest)
                if ratio_longest is not None:
                    remaining = 1.0 - ratio_longest / slo.budget
                    self.metrics.error_budget_remaining.set(
                        max(0.0, min(1.0, remaining)), slo=slo.name)
            for w in self.windows:
                burn_short = slo.burn_rate(self.rules, w.short_s)
                burn_long = slo.burn_rate(self.rules, w.long_s)
                bs = burn_short if burn_short is not None else 0.0
                bl = burn_long if burn_long is not None else 0.0
                self.metrics.burn_rate.set(
                    bs, slo=slo.name, severity=w.severity, window="short")
                self.metrics.burn_rate.set(
                    bl, slo=slo.name, severity=w.severity, window="long")
                key = (slo.name, w.severity)
                with self._mu:
                    was_firing = key in self._firing
                if not was_firing and bs >= w.threshold and bl >= w.threshold:
                    out.append(self._transition(
                        slo, w, "fired", bs, bl, now))
                elif was_firing and bs < w.threshold:
                    out.append(self._transition(
                        slo, w, "cleared", bs, bl, now))
        return out

    def _transition(self, slo: Slo, w: BurnWindow, transition: str,
                    burn_short: float, burn_long: float,
                    now: float) -> AlertTransition:
        alert = AlertTransition(
            slo=slo.name, severity=w.severity, transition=transition,
            burn_short=round(burn_short, 3), burn_long=round(burn_long, 3),
            threshold=w.threshold, at=now)
        key = (slo.name, w.severity)
        with self._mu:
            if transition == "fired":
                self._firing[key] = alert
            else:
                self._firing.pop(key, None)
            self._history.append(alert)
            del self._history[:-self.history_cap]
            subscribers = list(self._subscribers)
        self.metrics.alert_firing.set(
            1.0 if transition == "fired" else 0.0,
            slo=slo.name, severity=w.severity)
        self.metrics.alert_transitions_total.inc(
            slo=slo.name, severity=w.severity, transition=transition)
        log = (logger.warning if transition == "fired" else logger.info)
        log("SLO %s %s burn-rate alert %s (short %.1fx / long %.1fx vs "
            "%.1fx threshold)", slo.name, w.severity, transition,
            burn_short, burn_long, w.threshold)
        if self.events is not None:
            self._record_event(slo, w, alert)
        for fn in subscribers:
            try:
                fn(alert)
            except Exception:  # noqa: BLE001 — a consumer must not be
                # able to break alerting for every other consumer.
                logger.exception("SLO alert subscriber failed for %s", alert)
        return alert

    def _record_event(self, slo: Slo, w: BurnWindow,
                      alert: AlertTransition) -> None:
        fired = alert.transition == "fired"
        reason = (REASON_SLO_BURN_RATE_HIGH if fired
                  else REASON_SLO_BURN_RATE_CLEARED)
        msg = (f"SLO {slo.name} ({slo.description or 'no description'}): "
               f"{w.severity} burn-rate alert {alert.transition} — "
               f"short {alert.burn_short}x / long {alert.burn_long}x vs "
               f"{w.threshold}x threshold "
               f"(objective {slo.objective}, budget {slo.budget:.4g})")
        try:
            self.events.event_for_ref(
                {"apiVersion": "v1", "kind": "GpuFleet",
                 "name": slo.name, "namespace": "", "uid": ""},
                reason, msg, TYPE_WARNING if fired else TYPE_NORMAL)
        except Exception:  # noqa: BLE001 — recording is fire-and-forget
            logger.exception("could not record %s Event for %s",
                             reason, slo.name)

    def debug_snapshot(self) -> dict[str, Any]:
        with self._mu:
            firing = {f"{s}/{sev}": t.at for (s, sev), t in
                      sorted(self._firing.items())}
            history = [vars(t) for t in self._history[-20:]]
        # Live burn rates, computed on demand (the debug endpoint is a
        # pull path; a rules hiccup degrades the field, not the payload).
        burn: dict[str, Any] = {}
        for slo in self.slos:
            for w in self.windows:
                try:
                    bs = slo.burn_rate(self.rules, w.short_s)
                    bl = slo.burn_rate(self.rules, w.long_s)
                except Exception as e:  # noqa: BLE001 — degrade visibly
                    bs = bl = None
                    burn[f"{slo.name}/{w.severity}/error"] = repr(e)
                    continue
                burn[f"{slo.name}/{w.severity}"] = {
                    "short": None if bs is None else round(bs, 3),
                    "long": None if bl is None else round(bl, 3),
                    "threshold": w.threshold,
                }
        return {
            "slos": [{"name": s.name, "objective": s.objective,
                      "description": s.description} for s in self.slos],
            "windows": [vars(w) for w in self.windows],
            "burn_rates": burn,
            "firing": firing,
            "recent_transitions": history,
        }
