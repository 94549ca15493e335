"""blackbox: the continuous profiler of every binary.

The part of the JAX package's ``pkg/blackbox.py`` that the node binaries
run: :class:`ContinuousProfiler`, a sampling wall-clock profiler over all
threads (a bounded map of folded stacks, flamegraph-ready, plus the
lock-contention table of ``pkg/sanitizer.py``), served as
``/debug/profile`` (:func:`profile_debug_snapshot`), and the plane's
metric families (:class:`BlackboxMetrics`). The binaries start the
profiler by default (``--profile-interval`` 0.25 s).

The rest of that module (the flight recorder and its incident bundles,
the timeline, the SLO-driven burst sampling of ``attach_profiler_burst``
and ``/debug/incidents``) waits for the observability plane, whose SLO
engine drives it.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import weakref
from typing import Any, Optional

from k8s_dra_driver_tpu_torch.pkg import sanitizer
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    exponential_buckets,
)

logger = logging.getLogger(__name__)

#: every live profiler in the process, for ``/debug/profile`` (the
#: informer/workqueue weakref-registry pattern).
_live_profilers: "weakref.WeakSet[ContinuousProfiler]" = weakref.WeakSet()


class BlackboxMetrics:
    """The flight-recorder plane's own families (docs/observability.md,
    "Incident bundles" / "Continuous profiling"), as the JAX package
    declares them. Only the profiler's two families are fed here: the
    bundle families wait for the flight recorder."""

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
    ``burst_interval_s`` (the JAX package wires it to its SLO alerts,
    which this package has not yet). Sampling cost is one GIL-held walk
    per tick.

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
