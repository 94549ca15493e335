"""Synthetic end-to-end probing — the user-perspective plane.

The counterpart of the JAX package's ``pkg/canary.py``, GPU-named, with its
``/debug/canary`` registry of live probers.

Nothing inside the driver measures what a *user* experiences: can a
tenant get a GPU right now, and how long does it take? The reference
driver gets this from external probers; here the driver carries it
(docs/observability.md, "Synthetic probing"):

- :class:`CanaryProber` runs full claim lifecycles — create → allocate
  (node-pinned) → prepare (wait Ready) → verify (CDI device ids published,
  ``CUDA_VISIBLE_DEVICES`` materialized in the node's CDI spec when an
  in-process hook is wired) → unprepare → delete — against every node,
  using 1-GPU claims annotated ``gpu.nvidia.com/canary`` so the allocator
  places them last-resort and the defrag planner treats them as
  free-to-evict.
- Each phase is individually timed into ``gpu_dra_canary_*`` histograms
  and failures are **classified by phase** — admission / prepare /
  verify / teardown — into ``gpu_dra_canary_probe_total{phase,outcome}``.
- A probe that finds **residue** from a prior probe (a leftover canary
  claim object, or — via the in-process hooks — a leaked checkpoint
  entry or CDI spec) reports ``outcome=leaked``: the canary is a
  continuous leak detector, not just a latency probe.
- The per-node verdict (:meth:`CanaryProber.node_failing`) feeds the
  node lifecycle controller as a second *corroborating* node-lost input
  (never sufficient alone), and the probe counters feed the
  ``canary_availability`` SLO (``pkg/slo.py``) through the fleet recording
  rules.

The ``canary.probe`` fault point fails one probe round against one node:
the failure is counted and classified, and can never raise into the
hosting main.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Callable, Iterable, Optional

from k8s_dra_driver_tpu_torch.kubeletplugin.allocator import ANN_CANARY
from k8s_dra_driver_tpu_torch.pkg import faultpoints, sanitizer, tracing
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    Counter,
    Histogram,
    Registry,
    exponential_buckets,
)

logger = logging.getLogger(__name__)

# Fault point (docs/fault-injection.md): one probe round against one
# node fails. The contract it proves: a failing probe is counted and
# phase-classified like any real user-visible failure — and never raises
# into the controller main hosting the prober.
FP_PROBE = faultpoints.register(
    "canary.probe", "one synthetic canary probe round against one node fails")


#: probe phases, in lifecycle order; every failure classifies into
#: exactly one of them (``residue`` carries only ok/leaked).
PROBE_PHASES = ("admission", "prepare", "verify", "teardown", "residue")

OUTCOME_OK = "ok"
OUTCOME_FAILED = "failed"
OUTCOME_LEAKED = "leaked"


class CanaryMetrics:
    """The canary plane's families (docs/observability.md, "Synthetic
    probing"). Controller-registered, fleet-mirrored through the
    controller's local pseudo-target so dashboards read
    ``gpu_dra_fleet_canary_*``."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.probe_total = r.register(Counter(
            "gpu_dra_canary_probe_total",
            "Canary probe phases by outcome: every phase of a green "
            "probe counts ok; a failure counts exactly its failing "
            "phase (admission / prepare / verify / teardown); residue "
            "from a prior probe counts (residue, leaked).",
            ("phase", "outcome")))
        self.probes_total = r.register(Counter(
            "gpu_dra_canary_probes_total",
            "Whole canary probes by node and outcome (ok / failed / "
            "leaked) — the availability SLO's signal.",
            ("node", "outcome")))
        self.phase_seconds = r.register(Histogram(
            "gpu_dra_canary_phase_seconds",
            "Wall time of each canary probe phase.",
            exponential_buckets(0.001, 4, 9), ("phase",),
            exemplars=True))
        self.probe_seconds = r.register(Histogram(
            "gpu_dra_canary_probe_seconds",
            "Wall time of one whole canary probe (create through delete "
            "and residue scan) per node.",
            exponential_buckets(0.01, 2, 10), ("node",),
            exemplars=True))


_default_canary_metrics: Optional[CanaryMetrics] = None


def default_canary_metrics() -> CanaryMetrics:
    global _default_canary_metrics
    if _default_canary_metrics is None:
        _default_canary_metrics = CanaryMetrics()
    return _default_canary_metrics


class _ProbeFailure(Exception):
    """One classified probe failure; ``phase`` names where it happened."""

    def __init__(self, phase: str, message: str):
        super().__init__(message)
        self.phase = phase


#: every live prober in the process, for ``/debug/canary`` (the
#: informer/workqueue/slo weakref-registry pattern).
_live_probers: "weakref.WeakSet[CanaryProber]" = weakref.WeakSet()


def canary_debug_snapshot() -> list[dict[str, Any]]:
    """The ``/debug/canary`` payload: per-node probe history, phase
    latencies, and last failure for every live prober. Empty in
    processes that never assemble one — the endpoint set stays uniform
    across binaries."""
    out = []
    for prober in list(_live_probers):
        try:
            out.append(prober.debug_snapshot())
        except Exception as e:  # noqa: BLE001 — one broken prober must
            # not blank the endpoint.
            out.append({"error": repr(e)})
    return out


class CanaryProber:
    """Continuous synthetic claim-lifecycle probing against every node.

    ``allocator`` is any object with the ``Allocator.allocate`` shape;
    ``alloc_mutex`` serializes it with the cluster's one scheduler actor
    (the same discipline the reallocator and defrag planner follow).
    ``nodes`` is a static list, a zero-arg callable returning node
    names, or None (derive from the cluster's Node objects per round).

    ``verify(node, claim) -> Optional[str]`` and ``residue(node,
    active_uids) -> Iterable[str]`` are optional node-local hooks (see
    :func:`driver_probe_hooks`): API-level verification — the Ready
    status entry carrying CDI device ids — always runs; the hooks add
    the node's actual CDI spec / checkpoint view when the prober runs
    in-process with the drivers (tests, the chip smoke).

    :meth:`probe_node` NEVER raises: every failure — injected
    ``canary.probe`` rounds included — is counted, phase-classified, and
    recorded in the node's bounded history.
    """

    def __init__(
        self,
        client,
        allocator,
        nodes: Optional[Iterable[str] | Callable[[], Iterable[str]]] = None,
        interval_s: float = 15.0,
        namespace: str = "default",
        device_class: str = "gpu.nvidia.com",
        driver_name: str = "gpu.nvidia.com",
        probe_deadline_s: float = 5.0,
        alloc_mutex: Optional[threading.Lock] = None,
        metrics: Optional[CanaryMetrics] = None,
        verify: Optional[Callable[[str, dict], Optional[str]]] = None,
        residue: Optional[Callable[[str, set], Iterable[str]]] = None,
        clock: Callable[[], float] = time.monotonic,
        history_cap: int = 32,
        fail_threshold: int = 2,
    ):
        self.client = client
        self.allocator = allocator
        self._nodes_spec = nodes
        self.interval_s = interval_s
        self.namespace = namespace
        self.device_class = device_class
        self.driver_name = driver_name
        self.probe_deadline_s = probe_deadline_s
        # Defaults to the allocator's own reentrant mutex when it has one
        # (Allocator.allocate serializes internally now); kept as an
        # attribute for callers that coordinate wider sections on it.
        self.alloc_mutex = alloc_mutex if alloc_mutex is not None \
            else getattr(allocator, "mutex", None) or sanitizer.new_lock(
                "CanaryProber.alloc_mutex")
        self.metrics = metrics or default_canary_metrics()
        self.verify = verify
        self.residue = residue
        self.clock = clock
        self.history_cap = history_cap
        self.fail_threshold = max(1, fail_threshold)
        self._mu = sanitizer.new_lock("CanaryProber._mu")
        self._state: dict[str, dict[str, Any]] = {}
        self._durations: deque = deque(maxlen=512)  # successful probes
        self._nonce = uuid.uuid4().hex[:8]
        self._seq = 0
        self.probes = 0
        self.failures = 0
        self.leaked = 0
        self._paused = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _live_probers.add(self)

    # -- node set -------------------------------------------------------------

    def node_names(self) -> list[str]:
        spec = self._nodes_spec
        try:
            if spec is None:
                # Probe every node with PUBLISHED capacity (the slices'
                # node pinning), not every Node object: a mixed cluster's
                # control-plane/CPU nodes publish no GPU slices, and
                # probing them would fail admission forever — a permanent
                # false availability page and a bogus node-lost
                # corroboration signal. A dead plugin's slices persist in
                # the API, so a crashed node keeps being probed (and
                # failing) exactly as it should.
                return sorted({
                    (s.get("spec") or {}).get("nodeName", "")
                    for s in self.client.list("ResourceSlice")
                    if (s.get("spec") or {}).get("nodeName")})
            if callable(spec):
                return list(spec())
            return list(spec)
        except Exception:  # noqa: BLE001 — a failed slice list costs one
            # round; the loop retries next interval.
            logger.warning("canary: could not resolve the node set")
            return []

    # -- the probe ------------------------------------------------------------

    def _claim_obj(self, name: str) -> Optional[dict]:
        try:
            return self.client.try_get("ResourceClaim", name,
                                       self.namespace)
        except Exception:  # noqa: BLE001 — transient read: retried by
            # the caller's poll loop.
            return None

    def _ready_entry(self, name: str) -> Optional[dict]:
        c = self._claim_obj(name)
        if c is None:
            return None
        for d in (c.get("status") or {}).get("devices") or []:
            if d.get("driver") == self.driver_name and any(
                    cond.get("type") == "Ready"
                    and cond.get("status") == "True"
                    for cond in d.get("conditions") or []):
                return d
        return None

    def _unreserve(self, name: str) -> None:
        for _ in range(40):
            c = self._claim_obj(name)
            if c is None:
                return
            st = c.setdefault("status", {})
            if not st.get("reservedFor"):
                return
            st.pop("reservedFor", None)
            try:
                self.client.update_status(c)
                return
            except Exception:  # noqa: BLE001 — conflict/transient
                time.sleep(0.005)
        raise _ProbeFailure("teardown", f"could not unreserve {name}")

    def _teardown(self, name: str) -> None:
        self._unreserve(name)
        deadline = self.clock() + self.probe_deadline_s
        while self.clock() < deadline:
            c = self._claim_obj(name)
            if c is None or not any(
                    d.get("driver") == self.driver_name
                    for d in (c.get("status") or {}).get("devices") or []):
                break
            time.sleep(0.01)
        else:
            raise _ProbeFailure(
                "teardown", f"node never unprepared {name} within "
                f"{self.probe_deadline_s}s")
        last: Optional[BaseException] = None
        for _ in range(20):
            try:
                self.client.delete("ResourceClaim", name, self.namespace)
                return
            except Exception as e:  # noqa: BLE001 — NotFound = done;
                # transient failures get a bounded retry.
                if type(e).__name__ == "NotFoundError":
                    return
                last = e
                time.sleep(0.005)
        raise _ProbeFailure("teardown",
                            f"could not delete {name}: {last!r}")

    def _cleanup(self, name: str) -> None:
        """Best-effort removal of a FAILED probe's claim — a failed
        probe must not itself become the next probe's residue."""
        try:
            self._unreserve(name)
        except Exception:  # noqa: BLE001 — best-effort
            pass
        try:
            self.client.delete("ResourceClaim", name, self.namespace)
        except Exception:  # noqa: BLE001 — gone or transient; the next
            # probe's residue scan is the backstop.
            pass

    def _residue_scan(self, node: str, exclude: str,
                      exclude_uid: str = "") -> list[str]:
        """Leftovers from PRIOR probes of ``node``: canary claim objects
        still in the API, plus whatever the node-local hook sees
        (checkpoint entries, CDI specs). The current probe's own claim
        is excluded — by name from the API scan AND by uid from the
        hook's active set: a FAILED probe's cleanup deletes the claim
        without waiting for the node-side unprepare, so its checkpoint
        entry may legitimately still be settling; the NEXT probe catches
        it if it truly leaked."""
        leaks: list[str] = []
        active_uids: set = {exclude_uid} if exclude_uid else set()
        try:
            for c in self.client.list("ResourceClaim", self.namespace):
                meta = c.get("metadata") or {}
                anns = meta.get("annotations") or {}
                if ANN_CANARY not in anns:
                    continue
                active_uids.add(meta.get("uid", ""))
                if anns.get(ANN_CANARY) != node:
                    continue
                if meta.get("name", "") == exclude:
                    continue
                leaks.append(f"claim:{meta.get('name', '')}")
        except Exception:  # noqa: BLE001 — a failed LIST is not a leak;
            # skip the hook too (active_uids would be incomplete and
            # every live probe would read as leaked).
            return leaks
        if self.residue is not None:
            try:
                leaks.extend(self.residue(node, active_uids))
            except Exception:  # noqa: BLE001 — a broken hook must not
                # fail the probe (the API-level scan already ran).
                logger.exception("canary residue hook failed for %s", node)
        return leaks

    def probe_node(self, node: str) -> dict[str, Any]:
        """One full synthetic lifecycle against ``node``. Never raises."""
        with self._mu:
            self._seq += 1
            seq = self._seq
        name = f"canary-{node}-{self._nonce}-{seq}"
        t_probe = self.clock()
        phases: dict[str, float] = {}
        result: dict[str, Any] = {
            "node": node, "name": name, "outcome": OUTCOME_OK,
            "phase": "", "error": "", "phases": phases,
            "at": time.time(), "leaks": [],
        }
        span = tracing.start_span("canary_probe",
                                  attributes={"node": node, "probe": name})
        phase = "admission"
        probe_uid = ""
        t0 = self.clock()

        def finish_phase(next_phase: str) -> None:
            nonlocal phase, t0
            phases[phase] = round(self.clock() - t0, 6)
            self.metrics.phase_seconds.observe(phases[phase], phase=phase)
            phase = next_phase
            t0 = self.clock()

        try:
            try:
                # -- admission: create + allocate node-pinned + reserve.
                faultpoints.maybe_fail(FP_PROBE)
                claim = {
                    "apiVersion": "resource.k8s.io/v1",
                    "kind": "ResourceClaim",
                    "metadata": {"name": name, "namespace": self.namespace,
                                 "annotations": {ANN_CANARY: node}},
                    "spec": {"devices": {"requests": [{
                        "name": "gpu", "exactly": {
                            "deviceClassName": self.device_class,
                            "allocationMode": "ExactCount", "count": 1}}]}},
                }
                tracing.inject(span, claim)
                created = self.client.create(claim)
                probe_uid = created["metadata"].get("uid", "")
                # allocate() serializes on the allocator's own mutex with
                # the entry read outside it — holding alloc_mutex here
                # would just re-stretch the section real claims queue on.
                self.allocator.allocate(
                    created,
                    reserved_for=[{"resource": "pods",
                                   "name": f"pod-{name}"}],
                    node=node)
                finish_phase("prepare")
                # -- prepare: the node plugin must publish Ready.
                deadline = self.clock() + self.probe_deadline_s
                entry = self._ready_entry(name)
                while entry is None and self.clock() < deadline:
                    time.sleep(0.01)
                    entry = self._ready_entry(name)
                if entry is None:
                    raise _ProbeFailure(
                        "prepare", f"claim {name} not Ready within "
                        f"{self.probe_deadline_s}s")
                finish_phase("verify")
                # -- verify: the user-visible artifacts materialized.
                if not entry.get("cdiDeviceIDs"):
                    raise _ProbeFailure(
                        "verify", "Ready status entry carries no "
                        "cdiDeviceIDs")
                if self.verify is not None:
                    c = self._claim_obj(name)
                    err = self.verify(node, c) if c is not None else None
                    if err:
                        raise _ProbeFailure("verify", err)
                finish_phase("teardown")
                # -- teardown: unreserve → node unprepares → delete.
                self._teardown(name)
                finish_phase("residue")
            except _ProbeFailure as f:
                result["outcome"] = OUTCOME_FAILED
                result["phase"] = f.phase
                result["error"] = str(f)
                # The failing phase's elapsed time is real signal (a
                # prepare timeout took the whole deadline) — timed like
                # any other phase.
                phases[phase] = round(self.clock() - t0, 6)
                self.metrics.phase_seconds.observe(phases[phase],
                                                   phase=phase)
                self.metrics.probe_total.inc(phase=f.phase,
                                             outcome=OUTCOME_FAILED)
                self._cleanup(name)
                phase = "residue"
                t0 = self.clock()
            except Exception as e:  # noqa: BLE001 — anything unplanned
                # (injected canary.probe rounds land here too) classifies
                # as the phase it interrupted.
                result["outcome"] = OUTCOME_FAILED
                result["phase"] = phase
                result["error"] = repr(e)
                phases[phase] = round(self.clock() - t0, 6)
                self.metrics.phase_seconds.observe(phases[phase],
                                                   phase=phase)
                self.metrics.probe_total.inc(phase=phase,
                                             outcome=OUTCOME_FAILED)
                self._cleanup(name)
                phase = "residue"
                t0 = self.clock()
            # -- residue: the continuous leak detector. A probe that
            # ALSO failed its own lifecycle keeps outcome=failed (the
            # availability verdict and the node_failing streak hang on
            # it) — the residue finding is still counted and recorded.
            leaks = self._residue_scan(node, exclude=name,
                                       exclude_uid=probe_uid)
            phases["residue"] = round(self.clock() - t0, 6)
            self.metrics.phase_seconds.observe(phases["residue"],
                                               phase="residue")
            if leaks:
                result["leaks"] = leaks
                self.metrics.probe_total.inc(phase="residue",
                                             outcome=OUTCOME_LEAKED)
                if result["outcome"] == OUTCOME_OK:
                    result["outcome"] = OUTCOME_LEAKED
            elif result["outcome"] == OUTCOME_OK:
                for ph in PROBE_PHASES:
                    self.metrics.probe_total.inc(phase=ph,
                                                 outcome=OUTCOME_OK)
        finally:
            if result["outcome"] != OUTCOME_OK:
                span.set_status("error", result["error"] or "leaked")
            else:
                span.set_status("ok")
            span.end()
        dt = self.clock() - t_probe
        result["duration_s"] = round(dt, 6)
        # The probe span has ended by now; attribute the whole-probe
        # observation to it explicitly (the exemplar that makes a slow
        # probe clickable into its trace).
        self.metrics.probe_seconds.observe(
            dt, exemplar=getattr(span, "trace_id", "") or None, node=node)
        self.metrics.probes_total.inc(node=node,
                                      outcome=result["outcome"])
        with self._mu:
            self.probes += 1
            st = self._state.setdefault(node, {
                "probes": 0, "failures": 0, "leaked": 0,
                "consecutive_failures": 0, "last_outcome": "",
                "last_error": "", "last_phases": {},
                "history": deque(maxlen=self.history_cap),
            })
            st["probes"] += 1
            st["last_outcome"] = result["outcome"]
            st["last_phases"] = dict(phases)
            # Leak accounting is independent of the outcome verdict: a
            # failed probe's residue findings count too.
            if result["leaks"]:
                self.leaked += len(result["leaks"])
                st["leaked"] += len(result["leaks"])
            if result["outcome"] == OUTCOME_FAILED:
                self.failures += 1
                st["failures"] += 1
                st["consecutive_failures"] += 1
                st["last_error"] = f"{result['phase']}: {result['error']}"
            else:
                st["consecutive_failures"] = 0
                if result["outcome"] == OUTCOME_LEAKED:
                    st["last_error"] = f"residue: {result['leaks'][:3]}"
            st["history"].append({k: result[k] for k in
                                  ("name", "outcome", "phase", "error",
                                   "phases", "at", "duration_s")})
            if result["outcome"] == OUTCOME_OK:
                self._durations.append(dt)
        return result

    def run_once(self) -> list[dict[str, Any]]:
        """One round over every node, sequentially. Never raises."""
        return [self.probe_node(node) for node in self.node_names()]

    # -- verdicts -------------------------------------------------------------

    def node_failing(self, node: str) -> bool:
        """Whether ``node``'s last ``fail_threshold`` probes all failed —
        the lifecycle controller's corroborating (never sufficient
        alone) node-lost input. Leaked probes do not count: residue is a
        cleanup bug, not user-facing unavailability."""
        with self._mu:
            st = self._state.get(node)
            return (st is not None
                    and st["consecutive_failures"] >= self.fail_threshold)

    def success_p99_s(self) -> Optional[float]:
        """p99 of recent SUCCESSFUL probe durations (the gate's
        probe-latency bound), or None without samples."""
        with self._mu:
            xs = sorted(self._durations)
        if not xs:
            return None
        return round(xs[min(len(xs) - 1, int(0.99 * len(xs)))], 6)

    def debug_snapshot(self) -> dict[str, Any]:
        with self._mu:
            nodes = {
                node: {**{k: v for k, v in st.items() if k != "history"},
                       "history": list(st["history"])}
                for node, st in sorted(self._state.items())
            }
            probes, failures, leaked = (self.probes, self.failures,
                                        self.leaked)
        return {
            "interval_s": self.interval_s,
            "deadline_s": self.probe_deadline_s,
            "namespace": self.namespace,
            "probes": probes,
            "failures": failures,
            "leaked": leaked,
            "success_p99_s": self.success_p99_s(),
            "nodes": nodes,
        }

    # -- loop -----------------------------------------------------------------

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def start(self) -> "CanaryProber":
        self._thread = threading.Thread(target=self._run, name="canary",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            if self._paused.is_set():
                continue
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 — the loop must never die
                logger.exception("canary probe round crashed; continuing")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)


def canary_probe_signal(prober: CanaryProber) -> Callable[[str], bool]:
    """Adapt a prober into the lifecycle controller's corroborating
    node-lost signal (the :func:`pkg.nodelease.scraper_staleness_signal`
    shape): True when the node's recent probes are all failing.
    Corroborating only — a fresh lease is never cordoned on this."""
    def failing(node: str) -> bool:
        return prober.node_failing(node)
    return failing


def driver_probe_hooks(
    lookup: Callable[[str], Any],
) -> tuple[Callable[[str, dict], Optional[str]],
           Callable[[str, set], list[str]]]:
    """In-process probe hooks over real GpuDrivers (tests, the chip smoke):
    ``lookup(node)`` returns the node's driver, or None when the node is
    currently unreachable (dead, fenced) — the hooks then skip, exactly
    as an out-of-process prober could not see node-local state.

    verify: the claim's CDI spec must exist on the node and materialize
    ``CUDA_VISIBLE_DEVICES`` (the env a pod would actually receive).
    residue: checkpoint entries for canary-named claims that no longer
    exist in the API — a prior probe's prepare that never unwound."""

    def verify(node: str, claim: dict) -> Optional[str]:
        drv = lookup(node)
        if drv is None:
            return None
        uid = (claim.get("metadata") or {}).get("uid", "")
        spec = drv.cdi.read_claim_spec(uid)
        if spec is None:
            return f"no CDI spec on {node} for claim {uid}"
        if "CUDA_VISIBLE_DEVICES=" not in json.dumps(spec):
            return (f"CDI spec for {uid} materializes no "
                    "CUDA_VISIBLE_DEVICES")
        return None

    def residue(node: str, active_uids: set) -> list[str]:
        drv = lookup(node)
        if drv is None:
            return []
        try:
            prepared = drv.state.prepared_claims_nolock()
        except Exception:  # noqa: BLE001 — raced a commit; next probe
            return []
        return [f"checkpoint:{node}:{pc.name}"
                for uid, pc in sorted(prepared.items())
                if pc.name.startswith("canary-")
                and uid not in active_uids]

    return verify, residue
