"""blackbox: SLO-triggered incident bundles + continuous profiling.

The counterpart of the JAX package's ``pkg/blackbox.py``. The stack
DETECTS trouble (``pkg/slo.py`` multi-window burn-rate alerts) and leaves
forensics scattered across live, rotating state: the ``pkg/tracing.py``
ring buffer, deduplicated Events, ``pkg/telemetry.py`` sample rings,
``pkg/nodelease.py`` lease/fence/cordon state, allocator fragmentation,
and the ``/debug/*`` snapshots. By the
time an operator looks, the rings have rotated and the windows have slid.
This module is the flight recorder (docs/observability.md, "Incident
bundles"):

- :class:`FlightRecorder` is the SLO engine's **third** ``subscribe()``
  consumer (after GPU-vanish flap damping and the defrag planner). A
  FIRED transition opens an incident and captures a versioned **bundle**
  — every source snapshotted independently, each with bounded retries, a
  failing source marking the bundle ``partial`` (never silently
  complete, never raising: the EventRecorder discipline). The matching
  CLEARED transition re-captures and resolves the incident, so the final
  bundle carries the whole arc. Bundles are written atomically
  (``pkg/durability.atomic_publish``) under ``<state_dir>/incidents/``
  with bounded, COUNTED retention, and served via ``/debug/incidents`` on
  every main.
- The bundle's headline artifact is the **timeline**
  (:func:`build_timeline`): traces (span starts/ends + span events,
  including ``fault.injected``), Events, per-target metric samples, and
  SLO transitions joined into one causally-ordered list on the wall clock
  (monotonic sources converted through a captured anchor).
  :func:`audit_timeline_chain` is the completeness oracle the node-kill
  soak gates on: injection → burn → fence → repair → clear, present and
  ordered.
- :class:`ContinuousProfiler` is a sampling wall-clock profiler over all
  driver threads: a bounded map of folded stacks (flamegraph-ready),
  always-on at a low rate, **burst-sampled while an alert is firing**
  (:func:`attach_profiler_burst`), plus the lock-contention table grown
  from ``pkg/sanitizer.py``'s TrackedLock machinery. Snapshots ride in
  every bundle and serve ``/debug/profile``.

Everything here follows the EventRecorder discipline: never raises into
the paths it observes, rides out injected API faults, bounded
everywhere.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Optional

from k8s_dra_driver_tpu_torch.pkg import durability, sanitizer
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    exponential_buckets,
)

logger = logging.getLogger(__name__)

#: incident-bundle schema version (bump on breaking field changes; a
#: reader refuses unknown FUTURE versions rather than misparsing).
BUNDLE_VERSION = 1

#: default bundles kept on disk per recorder (oldest evicted, counted).
DEFAULT_RETENTION = 32

#: the completeness chain the node-kill soak's oracle audits: each stage
#: is a set of timeline ``kind`` markers that satisfy it.
INCIDENT_CHAIN: tuple[tuple[str, frozenset], ...] = (
    ("injection", frozenset({"PrepareFailed", "DeviceTainted",
                             "fault.injected"})),
    ("burn", frozenset({"SloBurnRateHigh"})),
    ("fence", frozenset({"NodeFenced"})),
    ("repair", frozenset({"NodeUncordoned", "DeviceRejoined"})),
    ("clear", frozenset({"SloBurnRateCleared"})),
)


#: every live profiler in the process, for ``/debug/profile`` (the
#: informer/workqueue weakref-registry pattern).
_live_profilers: "weakref.WeakSet[ContinuousProfiler]" = weakref.WeakSet()


class BlackboxMetrics:
    """The flight-recorder plane's own families (docs/observability.md,
    "Incident bundles" / "Continuous profiling"). Served by the CD
    controller main (NOT by scraped node endpoints — the fleet
    aggregator would otherwise mint ``gpu_dra_fleet_*`` mirrors for a
    controller-local plane)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.bundles_total = r.register(Counter(
            "gpu_dra_blackbox_bundles_total",
            "Incident-bundle captures by outcome (complete / partial — "
            "partial means at least one source failed its bounded "
            "retries and its section carries the error instead).",
            ("outcome",)))
        self.bundles_evicted_total = r.register(Counter(
            "gpu_dra_blackbox_bundles_evicted_total",
            "Incident bundles deleted by retention (bounded on-disk "
            "history; eviction is counted, never silent).", ()))
        self.capture_seconds = r.register(Histogram(
            "gpu_dra_blackbox_capture_seconds",
            "Wall time of one full incident-bundle capture.",
            exponential_buckets(0.005, 2, 10), ()))
        self.capture_section_failures_total = r.register(Counter(
            "gpu_dra_blackbox_capture_section_failures_total",
            "Bundle sections that failed capture after bounded retries "
            "(the bundle is marked partial).",
            ("section",)))
        self.open_incidents = r.register(Gauge(
            "gpu_dra_blackbox_open_incidents",
            "Incidents currently open (alert fired, not yet cleared).",
            ()))
        self.profile_samples_total = r.register(Counter(
            "gpu_dra_blackbox_profile_samples_total",
            "Profiler sampling ticks by mode (base = always-on low "
            "rate, burst = while an alert is firing).",
            ("mode",)))
        self.profile_stacks_dropped_total = r.register(Counter(
            "gpu_dra_blackbox_profile_stacks_dropped_total",
            "Samples whose folded stack was refused at the profiler's "
            "distinct-stack cap.", ()))


_default_blackbox_metrics: Optional[BlackboxMetrics] = None


def default_blackbox_metrics() -> BlackboxMetrics:
    global _default_blackbox_metrics
    if _default_blackbox_metrics is None:
        _default_blackbox_metrics = BlackboxMetrics()
    return _default_blackbox_metrics


class ContinuousProfiler:
    """Sampling wall-clock profiler over every thread in the process.

    Each tick walks ``sys._current_frames()`` and folds every thread's
    stack into ``thread;outermost;…;leaf`` (frames as ``file:function``),
    counting occurrences in a bounded map — the flamegraph "folded"
    format. Always-on at ``base_interval_s``; :meth:`set_burst` drops to
    ``burst_interval_s`` (wired to the SLO engine's alerts by
    :func:`attach_profiler_burst` or the flight recorder). Sampling cost
    is one GIL-held walk per tick.

    Bounds: at most ``max_stacks`` distinct folded stacks (excess
    COUNTED in ``gpu_dra_blackbox_profile_stacks_dropped_total``), at
    most ``max_frames`` frames per stack. Lock-contention rows come from
    ``pkg/sanitizer``'s table (see :func:`sanitizer.new_lock`) and ride
    in every snapshot.
    """

    def __init__(
        self,
        base_interval_s: float = 0.25,
        burst_interval_s: float = 0.02,
        max_stacks: int = 2048,
        max_frames: int = 48,
        metrics: Optional[BlackboxMetrics] = None,
    ):
        self.base_interval_s = base_interval_s
        self.burst_interval_s = burst_interval_s
        self.max_stacks = max_stacks
        self.max_frames = max_frames
        self.metrics = metrics or default_blackbox_metrics()
        self._mu = sanitizer.new_lock("ContinuousProfiler._mu")
        self._stacks: dict[str, int] = {}
        self._dropped = 0
        self._samples = {"base": 0, "burst": 0}
        self._burst = False
        self._paused = False
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _live_profilers.add(self)

    # -- control -------------------------------------------------------------

    def start(self) -> "ContinuousProfiler":
        self._thread = threading.Thread(
            target=self._run, name="blackbox-profiler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def set_burst(self, on: bool) -> None:
        """Burst sampling while an alert is firing; the wake-up makes the
        rate change take effect immediately, not a base interval later."""
        with self._mu:
            if self._burst == bool(on):
                return
            self._burst = bool(on)
        self._kick.set()

    def pause(self) -> None:
        """Suspend sampling (the overhead bench's interleaved OFF arm).
        Wakes the sampler like resume() does — a pause must take effect
        now, not up to one interval later."""
        with self._mu:
            self._paused = True
        self._kick.set()

    def resume(self) -> None:
        with self._mu:
            self._paused = False
        self._kick.set()

    # -- sampling ------------------------------------------------------------

    def sample_once(self) -> int:
        """One sampling tick (exposed for tests): folds every thread's
        stack except the profiler's own. Returns stacks folded."""
        with self._mu:
            mode = "burst" if self._burst else "base"
            self._samples[mode] += 1
        self.metrics.profile_samples_total.inc(mode=mode)
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        folded = 0
        for ident, frame in list(sys._current_frames().items()):
            if ident == me:
                continue
            frames: list[str] = []
            f = frame
            while f is not None and len(frames) < self.max_frames:
                code = f.f_code
                frames.append(
                    f"{os.path.basename(code.co_filename)}:{code.co_name}")
                f = f.f_back
            frames.reverse()
            key = ";".join([names.get(ident, f"thread-{ident}"), *frames])
            with self._mu:
                if key not in self._stacks and (
                        len(self._stacks) >= self.max_stacks):
                    self._dropped += 1
                    self.metrics.profile_stacks_dropped_total.inc()
                    continue
                self._stacks[key] = self._stacks.get(key, 0) + 1
            folded += 1
        return folded

    def _interval(self) -> float:
        with self._mu:
            return (self.burst_interval_s if self._burst
                    else self.base_interval_s)

    def _run(self) -> None:
        # Ticks ride a SCHEDULE (next_tick), not a restarted wait: a
        # kick (rate/pause toggle) re-times the cadence but can never
        # push the next tick later — pause/resume toggled faster than
        # the interval (the overhead bench's per-cycle arms) must not
        # starve the sampler.
        next_tick = time.monotonic() + self._interval()
        while not self._stop.is_set():
            self._kick.clear()
            now = time.monotonic()
            if now < next_tick:
                if self._kick.wait(next_tick - now) or self._stop.is_set():
                    next_tick = min(next_tick,
                                    time.monotonic() + self._interval())
                    continue
            with self._mu:
                paused = self._paused  # read AT tick time: a pause
                # during the wait suppresses this tick — exact arm
                # attribution for the interleaved overhead bench.
            next_tick = time.monotonic() + self._interval()
            if paused:
                continue
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — a sampling hiccup must
                # never kill the always-on profiler thread.
                logger.exception("profiler sample failed; continuing")

    # -- output --------------------------------------------------------------

    def folded(self, top: int = 200) -> list[str]:
        """Flamegraph folded-format lines (``stack count``), hottest
        first, bounded."""
        with self._mu:
            items = sorted(self._stacks.items(), key=lambda kv: -kv[1])
        return [f"{k} {v}" for k, v in items[:top]]

    def snapshot(self, top: int = 100) -> dict[str, Any]:
        """The ``/debug/profile`` + bundle payload: hottest folded
        stacks, sample counts by mode, drop accounting, and the
        sanitizer's lock-contention rows."""
        with self._mu:
            items = sorted(self._stacks.items(), key=lambda kv: -kv[1])
            samples = dict(self._samples)
            dropped = self._dropped
            burst = self._burst
            paused = self._paused
        return {
            "burst": burst,
            "paused": paused,
            "base_interval_s": self.base_interval_s,
            "burst_interval_s": self.burst_interval_s,
            "samples": samples,
            "distinct_stacks": len(items),
            "dropped_stacks": dropped,
            "stacks": [{"stack": k, "count": v} for k, v in items[:top]],
            "lock_contention": sanitizer.lock_contention_snapshot()[:50],
        }

    def reset(self) -> None:
        with self._mu:
            self._stacks.clear()
            self._dropped = 0
            self._samples = {"base": 0, "burst": 0}


def profile_debug_snapshot() -> list[dict[str, Any]]:
    """The ``/debug/profile`` payload: every live profiler's snapshot."""
    out = []
    for prof in list(_live_profilers):
        try:
            out.append(prof.snapshot())
        except Exception as e:  # noqa: BLE001 — ditto
            out.append({"error": repr(e)})
    return out


def attach_profiler_burst(engine, profiler: ContinuousProfiler) -> None:
    """Subscribe the profiler's burst mode to the SLO engine: sample fast
    while ANY alert is firing, drop back to base when the last clears.
    Subscriber failures are isolated by the engine; this hook itself
    never raises."""

    def on_alert(_transition) -> None:
        try:
            profiler.set_burst(bool(engine.firing()))
        except Exception:  # noqa: BLE001 — a burst-toggle hiccup must
            # not break alert fan-out.
            logger.exception("profiler burst toggle failed")

    engine.subscribe(on_alert)


# --------------------------------------------------------------------------
# Timeline: the bundle's headline artifact
# --------------------------------------------------------------------------

def build_timeline(
    events: Optional[Iterable[dict]] = None,
    transitions: Optional[Iterable[dict]] = None,
    spans: Optional[Iterable[dict]] = None,
    metric_points: Optional[Iterable[dict]] = None,
    mono_offset: float = 0.0,
    cap: int = 2000,
) -> tuple[list[dict[str, Any]], int]:
    """Join the four evidence streams into one causally-ordered list.

    Every entry is ``{"t": wall-clock seconds, "source": event|slo|span|
    metric, "kind": reason/span name/series, "detail": {...}}``, sorted
    by ``(t, source, kind)`` — a stable total order so equal timestamps
    cannot reshuffle between captures.

    - ``events``: API Event dicts (wall-clock ``firstTimestamp``; a
      count-aggregated Event also contributes its ``lastTimestamp`` so
      a long-running storm shows both edges).
    - ``transitions``: SLO transition dicts (``vars(AlertTransition)``);
      their ``at`` rides the ENGINE clock (monotonic by default) and is
      converted through ``mono_offset`` (wall − monotonic, captured at
      bundle time).
    - ``spans``: ``Span.to_dict()`` rows — start/end entries plus every
      span event (``fault.injected`` self-annotations included).
    - ``metric_points``: ``{"t": monotonic, "series", "value",
      "delta"}`` rows from the recording rules' rings (converted like
      transitions).

    Returns ``(entries, truncated)`` — past ``cap`` the OLDEST entries
    are dropped and counted (the incident's recent edge is the evidence
    that matters; silent truncation would read as a complete record).
    """
    out: list[dict[str, Any]] = []
    for ev in events or ():
        reason = ev.get("reason", "")
        detail = {
            "type": ev.get("type", ""),
            "count": ev.get("count", 1),
            "object": (ev.get("involvedObject") or {}).get("name", ""),
            "kind_of": (ev.get("involvedObject") or {}).get("kind", ""),
            "message": str(ev.get("message", ""))[:240],
        }
        first = ev.get("firstTimestamp")
        last = ev.get("lastTimestamp")
        if first is not None:
            out.append({"t": float(first), "source": "event",
                        "kind": reason, "detail": detail})
        if (last is not None and first is not None
                and float(last) > float(first)):
            out.append({"t": float(last), "source": "event",
                        "kind": reason,
                        "detail": {**detail, "edge": "last"}})
    for tr in transitions or ():
        out.append({
            "t": float(tr.get("at", 0.0)) + mono_offset,
            "source": "slo",
            "kind": ("SloBurnRateHigh" if tr.get("transition") == "fired"
                     else "SloBurnRateCleared"),
            "detail": {k: tr.get(k) for k in
                       ("slo", "severity", "transition", "burn_short",
                        "burn_long", "threshold")},
        })
    for s in spans or ():
        base = {"trace_id": s.get("trace_id", ""),
                "span_id": s.get("span_id", "")}
        if s.get("start"):
            out.append({"t": float(s["start"]), "source": "span",
                        "kind": s.get("name", ""),
                        "detail": {**base, "edge": "start"}})
        if s.get("end"):
            out.append({"t": float(s["end"]), "source": "span",
                        "kind": s.get("name", ""),
                        "detail": {**base, "edge": "end",
                                   "status": s.get("status", "")}})
        for ev in s.get("events") or ():
            out.append({"t": float(ev.get("time", 0.0)), "source": "span",
                        "kind": ev.get("name", ""),
                        "detail": {**base,
                                   **(ev.get("attributes") or {})}})
    for mp in metric_points or ():
        out.append({
            "t": float(mp.get("t", 0.0)) + mono_offset,
            "source": "metric",
            "kind": mp.get("series", ""),
            "detail": {"value": mp.get("value"),
                       "delta": mp.get("delta")},
        })
    out.sort(key=lambda e: (e["t"], e["source"], e["kind"]))
    truncated = max(0, len(out) - cap)
    return out[truncated:], truncated


def audit_timeline_chain(
    timeline: Iterable[dict],
    chain: tuple[tuple[str, frozenset], ...] = INCIDENT_CHAIN,
) -> list[str]:
    """The completeness oracle: greedily match ``chain`` against the
    timeline — each stage needs SOME entry whose ``kind`` is in its
    marker set at a time ≥ the previous stage's match. Empty return =
    every stage present and causally ordered."""
    problems: list[str] = []
    entries = sorted(timeline, key=lambda e: e.get("t", 0.0))
    t = float("-inf")
    for stage, kinds in chain:
        hit = next((e for e in entries
                    if e.get("kind") in kinds and e.get("t", 0.0) >= t),
                   None)
        if hit is None:
            problems.append(
                f"stage {stage!r} ({'/'.join(sorted(kinds))}) missing or "
                f"out of order (needed at t >= {t:.3f})")
            continue
        t = hit["t"]
    return problems


# --------------------------------------------------------------------------
# Flight recorder
# --------------------------------------------------------------------------

_live_recorders: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()


def incidents_debug_snapshot() -> list[dict[str, Any]]:
    """The ``/debug/incidents`` payload: every live recorder's bundle
    index (empty list where no recorder is assembled — the endpoint is
    mounted on every main regardless)."""
    out = []
    for rec in list(_live_recorders):
        try:
            out.append(rec.debug_snapshot())
        except Exception as e:  # noqa: BLE001 — one broken recorder
            # must not blank the endpoint.
            out.append({"error": repr(e)})
    return out


def _sanitize_name(s: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in str(s))[:48] or "incident"


class FlightRecorder:
    """Captures incident bundles on SLO alert transitions.

    Sources are all optional — a recorder wired with whatever the host
    process has still produces a useful bundle; missing sources are
    simply absent sections. Each present source is captured
    independently with ``section_retries`` bounded attempts; a source
    that keeps failing (an injected API fault, a broken snapshot) marks
    the bundle ``partial`` with the error recorded in its section —
    **never silently complete, never raising** into the alert fan-out.

    ``on_alert`` is the ``pkg.slo.SloEngine.subscribe`` consumer: FIRED
    opens an incident and writes its bundle; the matching CLEARED
    re-captures into the same bundle with ``status: resolved`` — the
    resolved bundle's timeline carries the full arc (detection through
    recovery), which is what the node-kill soak's completeness oracle
    audits. Profiler burst (if a profiler is attached) follows
    fired/cleared the same way.

    ``tracer``: None, or a ``pkg.tracing.Tracer`` whose store's newest
    ``max_spans`` spans (and its eviction count) become the bundle's
    trace section; a disabled tracer gives an empty one.

    Capture runs synchronously on the engine's evaluation thread:
    bounded sources keep it in the tens of milliseconds, ordering stays
    deterministic (the FIRED bundle exists before the CLEARED rewrite),
    and the engine already isolates subscriber cost/failures.
    """

    def __init__(
        self,
        state_dir: str,
        client: Any = None,
        engine: Any = None,
        telemetry: Any = None,
        tracer: Any = None,
        allocator: Any = None,
        alloc_mutex: Any = None,
        canary: Any = None,
        usage: Any = None,
        profiler: Optional[ContinuousProfiler] = None,
        debug: Optional[dict[str, Callable[[], Any]]] = None,
        namespace: Optional[str] = None,
        retention: int = DEFAULT_RETENTION,
        max_events: int = 400,
        max_spans: int = 400,
        max_timeline: int = 2000,
        window_s: float = 600.0,
        window_families: Optional[Iterable[str]] = None,
        section_retries: int = 3,
        metrics: Optional[BlackboxMetrics] = None,
        wall_clock: Callable[[], float] = time.time,
        mono_clock: Callable[[], float] = time.monotonic,
    ):
        self.dir = os.path.join(state_dir, "incidents")
        self.client = client
        self.engine = engine
        self.telemetry = telemetry
        self.tracer = tracer
        self.allocator = allocator
        # A capture reading the allocator's index/usage caches serializes
        # on the allocator's own reentrant mutex by default (the methods
        # self-lock too; the wrap keeps multi-read sections atomic).
        self.alloc_mutex = alloc_mutex if alloc_mutex is not None \
            else getattr(allocator, "mutex", None) or sanitizer.new_lock(
                "FlightRecorder.alloc_mutex")
        # The user-perspective plane (docs/observability.md, "Synthetic
        # probing" / "Usage metering"): a CanaryProber and UsageMeter —
        # any objects with a ``debug_snapshot()`` — snapshotted as
        # first-class bundle sections, so an incident shows what USERS
        # saw (probe history) and who was consuming the fleet.
        self.canary = canary
        self.usage = usage
        self.profiler = profiler
        self.debug = dict(debug or {})
        self.namespace = namespace
        self.retention = max(1, retention)
        self.max_events = max_events
        self.max_spans = max_spans
        self.max_timeline = max_timeline
        self.window_s = window_s
        if window_families is None:
            from k8s_dra_driver_tpu_torch.pkg.telemetry import (
                FLEET_PREPARE_ERRORS,
                FLEET_REQUESTS_TOTAL,
            )
            window_families = (FLEET_PREPARE_ERRORS, FLEET_REQUESTS_TOTAL)
        self.window_families = tuple(window_families)
        self.section_retries = max(1, section_retries)
        self.metrics = metrics or default_blackbox_metrics()
        self.wall_clock = wall_clock
        self.mono_clock = mono_clock
        self._mu = sanitizer.new_lock("FlightRecorder._mu")
        self._seq = 0
        self._open: dict[tuple[str, str], dict[str, Any]] = {}
        self._index: list[dict[str, Any]] = []  # newest last, bounded
        self.captures = 0
        self.partial_captures = 0
        self.capture_errors = 0      # exceptions escaping capture itself
        self.evicted = 0
        _live_recorders.add(self)

    # -- the subscribe() consumer --------------------------------------------

    def on_alert(self, transition) -> None:
        """Never raises. FIRED → open + capture; CLEARED → final capture
        + resolve. Unknown transition shapes are ignored."""
        try:
            tr = (vars(transition) if not isinstance(transition, dict)
                  else dict(transition))
            key = (tr.get("slo", ""), tr.get("severity", ""))
            if tr.get("transition") == "fired":
                with self._mu:
                    self._seq += 1
                    incident = {
                        "id": (f"incident-{self._seq:06d}-"
                               f"{_sanitize_name(key[0])}-"
                               f"{_sanitize_name(key[1])}"),
                        "trigger": tr,
                        "opened_at": self.wall_clock(),
                    }
                    self._open[key] = incident
                    self.metrics.open_incidents.set(
                        float(len(self._open)))
                self.capture(incident, status="open")
            elif tr.get("transition") == "cleared":
                with self._mu:
                    incident = self._open.pop(key, None)
                    self.metrics.open_incidents.set(
                        float(len(self._open)))
                if incident is not None:
                    incident["resolved_at"] = self.wall_clock()
                    incident["cleared"] = tr
                    self.capture(incident, status="resolved")
            if self.profiler is not None and self.engine is not None:
                self.profiler.set_burst(bool(self.engine.firing()))
        except Exception:  # noqa: BLE001 — the recorder must never
            # break alerting (or the other subscribers).
            self.capture_errors += 1
            logger.exception("flight recorder on_alert failed")

    # -- capture -------------------------------------------------------------

    def _section(self, name: str, fn: Callable[[], Any],
                 failed: list[str]) -> Any:
        last: Optional[BaseException] = None
        for _ in range(self.section_retries):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — bounded retry; an
                # injected API fault mid-capture must cost a section at
                # most, never the bundle, never an exception outward.
                last = e
                time.sleep(0.002)
        failed.append(name)
        self.metrics.capture_section_failures_total.inc(section=name)
        return {"error": repr(last)}

    def _events_section(self) -> list[dict[str, Any]]:
        evs = list(self.client.list("Event", self.namespace))
        evs.sort(key=lambda e: e.get("lastTimestamp") or 0.0)
        evs = evs[-self.max_events:]
        return [{
            "reason": e.get("reason", ""),
            "type": e.get("type", ""),
            "count": e.get("count", 1),
            "firstTimestamp": e.get("firstTimestamp"),
            "lastTimestamp": e.get("lastTimestamp"),
            "involvedObject": {
                k: (e.get("involvedObject") or {}).get(k, "")
                for k in ("kind", "name", "namespace")},
            "message": str(e.get("message", ""))[:240],
            "component": (e.get("source") or {}).get("component", ""),
        } for e in evs]

    def _nodelease_section(self) -> dict[str, Any]:
        from k8s_dra_driver_tpu_torch.pkg.nodelease import (
            ANN_CORDON,
            KIND_LEASE,
            LEASE_NAMESPACE,
            nodelease_debug_snapshot,
        )
        leases = []
        for lease in self.client.list(KIND_LEASE, LEASE_NAMESPACE):
            spec = lease.get("spec") or {}
            leases.append({
                "name": (lease.get("metadata") or {}).get("name", ""),
                "holder": spec.get("holderIdentity", ""),
                "epoch": spec.get("epoch"),
                "renewTime": spec.get("renewTime"),
                "fencedEpoch": spec.get("fencedEpoch"),
                "fencedIdentities": spec.get("fencedIdentities"),
                "renewers": sorted(spec.get("renewers") or {}),
            })
        cordons = []
        for node in self.client.list("Node"):
            ann = ((node.get("metadata") or {}).get("annotations")
                   or {}).get(ANN_CORDON)
            if ann:
                cordons.append({
                    "node": (node.get("metadata") or {}).get("name", ""),
                    "cordon": ann})
        return {"leases": leases, "cordons": cordons,
                "local": nodelease_debug_snapshot()}

    def _telemetry_section(self) -> dict[str, Any]:
        from k8s_dra_driver_tpu_torch.pkg.telemetry import collect_exemplars
        t = self.telemetry
        out: dict[str, Any] = {
            "rules": t.rule_values(),
            "targets": t.scraper.target_report(),
            "series": t.rules.series_count(),
            "windows": t.rules.dump_recent(self.window_families,
                                           self.window_s),
            "exemplars": collect_exemplars(t.scraper.target_families()),
        }
        return out

    def _metric_points(self) -> list[dict[str, Any]]:
        """Value-CHANGED points of the windowed series, as timeline
        rows — flat stretches carry no causal information."""
        t = self.telemetry
        points: list[dict[str, Any]] = []
        windows = t.rules.dump_recent(self.window_families, self.window_s)
        for series, pts in windows.items():
            prev = None
            for ts, v in pts:
                if prev is not None and v != prev:
                    points.append({"t": ts, "series": series,
                                   "value": v, "delta": v - prev})
                prev = v
        return points[-400:]

    def capture(self, incident: dict[str, Any],
                status: str = "open") -> Optional[dict[str, Any]]:
        """Snapshot every wired source into one bundle and publish it
        atomically. Returns the bundle (None if capture itself blew up —
        counted, never raised)."""
        try:
            t0 = self.mono_clock()
            failed: list[str] = []
            mono_offset = self.wall_clock() - self.mono_clock()
            sections: dict[str, Any] = {}
            raw_events: list[dict] = []
            raw_spans: list[dict] = []
            raw_transitions: list[dict] = []
            metric_points: list[dict] = []
            if self.engine is not None:
                sections["slo"] = self._section(
                    "slo", self.engine.debug_snapshot, failed)
                # Sections KEEP the error record on failure (the partial
                # bundle must say what was lost); only the timeline
                # inputs degrade to empty.
                out = self._section(
                    "slo_transitions",
                    lambda: [vars(t) for t in self.engine.transitions()],
                    failed)
                sections["slo_transitions"] = out
                raw_transitions = out if isinstance(out, list) else []
            if self.client is not None:
                out = self._section(
                    "events", self._events_section, failed)
                sections["events"] = out
                raw_events = out if isinstance(out, list) else []
                sections["nodelease"] = self._section(
                    "nodelease", self._nodelease_section, failed)
            if self.tracer is not None:
                out = self._section(
                    "traces",
                    lambda: self.tracer.store.spans()[-self.max_spans:],
                    failed)
                raw_spans = out if isinstance(out, list) else []
                sections["traces"] = {
                    "spans": out,
                    "dropped": self.tracer.store.dropped,
                }
            if self.telemetry is not None:
                sections["telemetry"] = self._section(
                    "telemetry", self._telemetry_section, failed)
                pts = self._section("metric_points", self._metric_points,
                                    failed)
                sections["metric_points"] = pts
                metric_points = pts if isinstance(pts, list) else []
            if self.allocator is not None:
                def alloc_section() -> dict[str, Any]:
                    with self.alloc_mutex:
                        return {
                            "fragmentation": self.allocator.
                            fragmentation_report(update_gauge=False),
                            "blocked": self.allocator.blocked_claims(),
                        }
                sections["allocator"] = self._section(
                    "allocator", alloc_section, failed)
            if self.canary is not None:
                sections["canary"] = self._section(
                    "canary", self.canary.debug_snapshot, failed)
            if self.usage is not None:
                sections["usage"] = self._section(
                    "usage", self.usage.debug_snapshot, failed)
            if self.profiler is not None:
                sections["profile"] = self._section(
                    "profile", self.profiler.snapshot, failed)
            for name, fn in self.debug.items():
                sections[f"debug.{name}"] = self._section(
                    f"debug.{name}", fn, failed)

            timeline, truncated = build_timeline(
                events=raw_events,
                transitions=raw_transitions,
                spans=raw_spans,
                metric_points=metric_points,
                mono_offset=mono_offset,
                cap=self.max_timeline,
            )
            bundle = {
                "version": BUNDLE_VERSION,
                "id": incident["id"],
                "status": status,
                "trigger": incident.get("trigger"),
                "cleared": incident.get("cleared"),
                "opened_at": incident.get("opened_at"),
                "resolved_at": incident.get("resolved_at"),
                "captured_at": self.wall_clock(),
                "clock_anchor": {"wall_minus_monotonic": mono_offset},
                "partial": bool(failed),
                "partial_sections": failed,
                "timeline_truncated": truncated,
                "timeline": timeline,
                "sections": sections,
            }
            self._publish(bundle)
            self.captures += 1
            if failed:
                self.partial_captures += 1
            self.metrics.bundles_total.inc(
                outcome="partial" if failed else "complete")
            self.metrics.capture_seconds.observe(self.mono_clock() - t0)
            return bundle
        except Exception:  # noqa: BLE001 — the recorder's own contract:
            # a capture can degrade, it can never raise or wedge.
            self.capture_errors += 1
            logger.exception("incident capture failed for %s",
                             incident.get("id"))
            return None

    # -- storage -------------------------------------------------------------

    def _publish(self, bundle: dict[str, Any]) -> None:
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"{bundle['id']}.json")
        durability.atomic_publish(path, lambda f: json.dump(bundle, f))
        meta = {
            "id": bundle["id"],
            "status": bundle["status"],
            "slo": (bundle.get("trigger") or {}).get("slo"),
            "severity": (bundle.get("trigger") or {}).get("severity"),
            "opened_at": bundle.get("opened_at"),
            "resolved_at": bundle.get("resolved_at"),
            "partial": bundle["partial"],
            "timeline_entries": len(bundle["timeline"]),
            "file": path,
        }
        with self._mu:
            self._index = ([m for m in self._index
                            if m["id"] != meta["id"]] + [meta])[-256:]
        self._retain()

    def _retain(self) -> None:
        """Bounded + counted on-disk retention: newest ``retention``
        bundles survive (ids are sequence-prefixed, so lexicographic
        order IS capture order)."""
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.endswith(".json"))
        except OSError:
            return
        for name in names[:-self.retention]:
            try:
                os.remove(os.path.join(self.dir, name))
                self.evicted += 1
                self.metrics.bundles_evicted_total.inc()
            except OSError:  # noqa: PERF203 — already gone is fine
                pass

    # -- read side -----------------------------------------------------------

    def list_bundles(self) -> list[dict[str, Any]]:
        """Bundle index rows, newest first."""
        with self._mu:
            return list(reversed(self._index))

    def bundle(self, incident_id: str) -> Optional[dict[str, Any]]:
        """Load one bundle from disk; refuses unknown FUTURE schema
        versions (an old reader must not misparse a newer writer)."""
        path = os.path.join(self.dir, f"{_sanitize_name(incident_id)}.json")
        if "/" in incident_id or not os.path.exists(path):
            return None
        with open(path) as f:
            doc = json.load(f)
        if int(doc.get("version", 0)) > BUNDLE_VERSION:
            raise ValueError(
                f"bundle {incident_id} has future schema version "
                f"{doc.get('version')} (this reader understands "
                f"<= {BUNDLE_VERSION})")
        return doc

    def debug_snapshot(self) -> dict[str, Any]:
        """The ``/debug/incidents`` payload: the index plus the newest
        bundle in full (bounded — ONE full bundle, so the endpoint stays
        a snapshot, not an archive download)."""
        with self._mu:
            index = list(reversed(self._index))
            open_ids = [i["id"] for i in self._open.values()]
        # Newest RESOLVED bundle first (the readable full arc); a
        # just-opened incident must not displace it from the endpoint.
        pick = next((m for m in index if m["status"] == "resolved"),
                    index[0] if index else None)
        latest = None
        if pick is not None:
            try:
                latest = self.bundle(pick["id"])
            except (OSError, ValueError, json.JSONDecodeError):
                latest = None
        return {
            "dir": self.dir,
            "retention": self.retention,
            "captures": self.captures,
            "partial_captures": self.partial_captures,
            "capture_errors": self.capture_errors,
            "evicted": self.evicted,
            "open": open_ids,
            "bundles": index[:32],
            "latest": latest,
        }
