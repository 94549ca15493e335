"""Self-healing remediation: taint → drain → repair → rejoin.

The counterpart of the JAX package's ``kubeletplugin/remediation.py``,
GPU-named (``gpu.nvidia.com/drain``). The reference driver stops at
detection — its watchdog publishes device taints and *delegates repair to
operators* (``compute-domain-daemon/process.go``). This module closes that
loop (docs/self-healing.md):

- :class:`DrainController` (node side, one per kubelet plugin process):
  polls the driver's published device taints; for every tainted device it
  gracefully unprepares the affected claims (per-claim flight locks,
  checkpoint-transacted ``PrepareAborted`` tombstones — ``DeviceState.
  drain``), marks each drained claim for reallocation via an annotation,
  then runs the repair stage (a pluggable hook; :class:`SimulatedRepair`
  flips the node boot id and heals the GPU) and rejoins the device —
  health taints cleared in one republish, so the device returns to the
  published ResourceSlice.
- :class:`ClaimReallocator` (cluster side, next to the CD controller):
  watches ResourceClaims for the drain annotation, releases the dead
  allocation, and re-allocates onto healthy devices (the structured
  allocator already excludes ``NoSchedule``-tainted devices, so "healthy"
  is by construction). Claims that cannot be re-placed within the attempt
  budget are failed CLEANLY: a ``ReallocationFailed`` Event plus a
  terminal annotation — never a silent wedge.
- :class:`DefragPlanner`: preempts movable claims through the same drain
  → reallocate pipeline when the allocation-admission SLO alert fires
  (:func:`attach_defrag_planner` subscribes it to an SLO engine).

Crash safety: every node-side step is recorded in the checkpoint (the
tombstone IS the drain record) and every cluster-side step in the API
object (the annotation IS the work queue), so a process death at any
point replays to a clean state.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from k8s_dra_driver_tpu_torch.k8sclient.client import ConflictError, NotFoundError
from k8s_dra_driver_tpu_torch.k8sclient.informer import Informer
from k8s_dra_driver_tpu_torch.kubeletplugin.allocator import (
    ANN_CANARY,
    AllocationError,
    Allocator,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg import bootid, faultpoints, sanitizer
from k8s_dra_driver_tpu_torch.pkg.events import (
    REASON_CLAIM_DRAINED,
    REASON_CLAIM_PREEMPTED,
    REASON_CLAIM_REALLOCATED,
    REASON_DEFRAG_PLANNED,
    REASON_DEVICE_REJOINED,
    REASON_NODE_CORDONED,
    REASON_NODE_UNCORDONED,
    REASON_REALLOCATION_FAILED,
    TYPE_NORMAL,
    TYPE_WARNING,
    EventRecorder,
)
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    RemediationMetrics,
    default_node_metrics,
    default_remediation_metrics,
)
from k8s_dra_driver_tpu_torch.pkg.nodelease import (
    CORDON_NODE_LOST,
    cordon_annotation,
    mutate_with_retry,
)
from k8s_dra_driver_tpu_torch.pkg.slo import SLO_ALLOCATION_ADMISSION

logger = logging.getLogger(__name__)

#: a drained claim awaiting controller-driven reallocation. Value is JSON:
#: {"node": ..., "device": ..., "reason": ..., "at": <unix time>} — the
#: cluster-side work record (crash-safe: it lives in the API object).
ANN_DRAIN = "gpu.nvidia.com/drain"
#: terminal marker: reallocation exhausted its budget; the claim is
#: cleanly failed (paired with a ReallocationFailed Event).
ANN_DRAIN_FAILED = "gpu.nvidia.com/drain-failed"

# Fault points (docs/fault-injection.md). ``remediation.drain`` brackets a
# drain round before any claim is unpreprepared — a failure retries the
# whole round next poll with nothing half-drained; ``remediation.rejoin``
# brackets the taint-clear + republish, which is idempotent per poll.
FP_DRAIN = faultpoints.register(
    "remediation.drain",
    "a device's drain round fails before any claim is unprepared")
FP_REJOIN = faultpoints.register(
    "remediation.rejoin",
    "a repaired device's rejoin (taint clear + republish) fails")

#: API-write retry budget for annotation/status updates (conflicts and
#: injected transients); each attempt is cheap, the work is idempotent.
WRITE_RETRIES = 25


def mutate_claim_with_retry(client, name: str, namespace: str,
                            mutate: Callable[[dict], bool],
                            uid: str = "") -> bool:
    """Read-modify-write one claim with bounded retries over conflicts and
    transient (injected) API failures — the claim-shaped face of the one
    shared RMW loop (``pkg.nodelease.mutate_with_retry``), kept so the
    retry semantics cannot drift between the per-device and node-scale
    pipelines. Returns True when the write landed or was moot; False when
    the budget ran out — callers must keep a durable retry path, never
    drop the work."""
    return mutate_with_retry(client, "ResourceClaim", name, namespace,
                             mutate, uid=uid)


def parse_gpu_index(device: str) -> Optional[int]:
    """``gpu-<i>[...]`` → GPU index, or None for other device names."""
    if not device.startswith("gpu-"):
        return None
    try:
        return int(device.split("-")[1])
    except (ValueError, IndexError):
        return None


class SimulatedRepair:
    """Test stand-in for the operator's "repair the node" step.

    Heals the faulted GPU through a caller-supplied ``heal(device)``
    hook (which knows the device library), then flips the node's boot id
    (:func:`pkg.bootid.flip_boot_id` — the reboot marker checkpoint
    invalidation keys on; a no-op without the alt-path override). Returns
    the new boot id so the drain controller can have every plugin on the
    node adopt it, exactly as a real reboot re-bootstraps them.
    """

    def __init__(self, heal: Optional[Callable[[str], None]] = None,
                 env: Optional[dict[str, str]] = None):
        self.heal = heal
        self.env = env
        self._mu = sanitizer.new_lock("SimulatedRepair._mu")
        self.repairs: list[tuple[str, float, str]] = []  # (device, t, boot)

    def __call__(self, device: str) -> Optional[str]:
        if self.heal is not None:
            self.heal(device)
        new_id = bootid.flip_boot_id(self.env)
        with self._mu:
            self.repairs.append((device, time.monotonic(), new_id))
        return new_id

    def repaired_devices(self) -> list[tuple[str, float, str]]:
        with self._mu:
            return list(self.repairs)


@dataclass
class _DeviceDrain:
    """Per-device pipeline state: DRAINING → REPAIRING → (rejoined)."""

    device: str
    t0: float                       # monotonic: taint first observed
    state: str = "draining"         # draining | repairing
    drained_any: bool = False
    drained_uids: set = field(default_factory=set)
    #: drained claims whose reallocation annotation has not landed yet —
    #: retried every poll (the tombstone removes the claim from
    #: affected_claims, so THIS is the durable retry home) and the device
    #: cannot rejoin while any is outstanding.
    pending_records: dict = field(default_factory=dict)  # uid -> ClaimRef
    repaired: bool = False


class DrainController:
    """Node-side remediation loop: reacts to taints on prepared devices.

    ``driver`` is the taint source (the GPU kubelet plugin driver — it
    exposes ``device_taints``/``device_healthy``/``affected_claims``/
    ``drain_claim``/``rejoin_device``/``adopt_boot_id``). ``companions``
    are other drivers on the same node (the CD kubelet plugin) that adopt
    the flipped boot id when a repair simulates a reboot.

    ``repair``: callable ``(device) -> Optional[str]`` — None means "not
    repaired yet, retry next poll"; a string is the post-repair boot id
    ("" = repaired without a reboot marker). ``repair=None`` (production)
    waits for EXTERNAL repair: the pipeline proceeds to rejoin once the
    device reports healthy again.

    Single-threaded poll loop (one ``poll_once`` at a time); every step is
    idempotent, so a crash at any point replays cleanly from the
    checkpoint + API state.
    """

    def __init__(
        self,
        client,
        driver,
        repair: Optional[Callable[[str], Optional[str]]] = None,
        companions: Iterable[Any] = (),
        poll_interval: float = 5.0,
        events: Optional[EventRecorder] = None,
        metrics: Optional[RemediationMetrics] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.client = client
        self.driver = driver
        self.repair = repair
        self.companions = list(companions)
        self.poll_interval = poll_interval
        self.events = events if events is not None else getattr(
            driver, "events", None)
        self.metrics = metrics or default_remediation_metrics()
        self.clock = clock
        self.node_name = getattr(getattr(driver, "config", None),
                                 "node_name", "")
        self._mu = sanitizer.new_lock("DrainController._mu")
        self._drains: dict[str, _DeviceDrain] = sanitizer.track_state(
            {}, "DrainController._drains")
        # Node-scope drain (docs/self-healing.md, "Whole-node repair"):
        # a VOLUNTARY cordon (the gpu.nvidia.com/cordon Node annotation,
        # written by an operator or autopilot via nodelease.request_
        # cordon) drains every prepared claim gracefully through the
        # per-claim flight locks — no lease expiry, no fence.
        self._node_drain_active = False
        self._node_pending: dict[str, tuple[Any, ClaimRef]] = {}
        self.node_drains = 0
        #: completed recoveries, (device, seconds) — the tests'
        #: device-level recovery distribution source.
        self.recoveries: list[tuple[str, float]] = []
        self.cancelled: list[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- introspection (healthcheck gating, test oracles) --------------------

    @property
    def draining(self) -> bool:
        """Whether any device is inside the pipeline OR a node-scope
        drain is active — the gRPC healthcheck reports NOT_SERVING while
        this holds (docs/self-healing.md)."""
        with self._mu:
            return bool(self._drains) or self._node_drain_active

    @property
    def node_draining(self) -> bool:
        with self._mu:
            return self._node_drain_active

    def active_devices(self) -> list[str]:
        with self._mu:
            return sorted(self._drains)

    def _set_active(self, drains: dict[str, _DeviceDrain]) -> None:
        self.metrics.active_drains.set(len(drains), node=self.node_name)

    # -- one poll (exposed for deterministic tests) --------------------------

    def poll_once(self) -> dict[str, int]:
        """Advance every tainted device's pipeline one step. Returns
        counters for tests: drained claims, rejoined devices, cancelled
        drains this round."""
        counts = {"drained": 0, "rejoined": 0, "cancelled": 0}
        taints = self.driver.device_taints()
        with self._mu:
            for dev in taints:
                if dev not in self._drains:
                    self._drains[dev] = _DeviceDrain(dev, t0=self.clock())
            drains = dict(self._drains)
            self._set_active(self._drains)
        for dev, drain in sorted(drains.items()):
            try:
                done = self._advance(dev, drain, dev in taints, counts)
            except Exception:  # noqa: BLE001 — injected/transient: the
                # pipeline is idempotent, the next poll replays this step.
                logger.exception("remediation of device %s failed this "
                                 "round; retrying next poll", dev)
                continue
            if done:
                with self._mu:
                    self._drains.pop(dev, None)
                    self._set_active(self._drains)
        try:
            self._node_cordon_step(counts)
        except Exception:  # noqa: BLE001 — idempotent: the next poll
            # replays whatever step failed (annotation read, a drain, a
            # republish).
            logger.exception("node-cordon step failed this round; "
                             "retrying next poll")
        return counts

    # -- node-scope drain (voluntary cordon) ---------------------------------

    def _cordonable_drivers(self) -> list[Any]:
        return [d for d in (self.driver, *self.companions)
                if hasattr(d, "set_cordon")]

    def _node_cordon_step(self, counts: dict[str, int]) -> None:
        """React to the node-scope cordon annotation: a voluntary cordon
        drains every prepared claim of every driver on the node (the
        same tombstone + reallocation-annotation path as a per-device
        drain, smallest claims first), with all devices tainted
        NoSchedule in one republish per driver; removing the annotation
        uncordons. A controller-written ``node-lost`` cordon is ignored
        here — by definition this plugin was dead or partitioned when it
        was written, and the fence recovery owns that path."""
        ann = cordon_annotation(self.client, self.node_name)
        requested = ann is not None and ann.get("reason") != CORDON_NODE_LOST
        with self._mu:
            was_active = self._node_drain_active
            self._node_drain_active = requested
        if requested:
            if not was_active:
                self.node_drains += 1
                default_node_metrics().cordons_total.inc(reason="requested")
                if self.events is not None:
                    self.events.event_for_ref(
                        {"apiVersion": "v1", "kind": "Node",
                         "name": self.node_name, "namespace": "", "uid": ""},
                        REASON_NODE_CORDONED,
                        f"node {self.node_name} cordoned on request: "
                        "draining all prepared claims", TYPE_WARNING)
            # Cordon first: no new allocation may land while we drain.
            for drv in self._cordonable_drivers():
                drv.set_cordon("requested")
            # Drain everything prepared, smallest claims first per driver.
            for drv in (self.driver, *self.companions):
                lister = getattr(drv, "all_prepared_claims", None)
                drainer = getattr(drv, "drain_claim", None)
                if lister is None or drainer is None:
                    continue
                for ref in self._drain_order(lister()):
                    if drainer(ref, reason=f"node {self.node_name} "
                                           "cordoned"):
                        counts["drained"] += 1
                        self.metrics.drains_total.inc(
                            driver=getattr(drv.state, "driver_name",
                                           "unknown"))
                        with self._mu:
                            self._node_pending[ref.uid] = (drv, ref)
                        if self.events is not None:
                            self.events.event_for_claim_ref(
                                ref, REASON_CLAIM_DRAINED,
                                f"claim drained off cordoned node "
                                f"{self.node_name}; awaiting reallocation",
                                TYPE_WARNING)
        # Reallocation annotations: durable retry home, exactly like the
        # per-device pipeline's pending_records — flushed every poll,
        # survives the uncordon (an annotation that never lands would
        # strand the drained claim).
        with self._mu:
            pending = dict(self._node_pending)
        for uid, (_drv, ref) in pending.items():
            if self._annotate_drained(ref, f"node:{self.node_name}"):
                with self._mu:
                    self._node_pending.pop(uid, None)
        if not requested:
            # Annotation removed: uncordon — every driver's devices
            # rejoin in one republish each. Derived from the DRIVERS'
            # cordon state, not just this poll's was_active edge: a
            # clear_cordon whose republish fails restores the driver's
            # flag, and the next poll must retry the uncordon rather
            # than strand the taints forever behind a consumed edge.
            still = [d for d in self._cordonable_drivers()
                     if getattr(d, "cordoned", False)]
            if not was_active and not still:
                return
            for drv in still:
                drv.clear_cordon()
            if self.events is not None:
                self.events.event_for_ref(
                    {"apiVersion": "v1", "kind": "Node",
                     "name": self.node_name, "namespace": "", "uid": ""},
                    REASON_NODE_UNCORDONED,
                    f"node {self.node_name} uncordoned: cordon request "
                    "cleared, devices rejoined", TYPE_NORMAL)
            logger.info("node %s voluntary cordon cleared", self.node_name)

    def _advance(self, dev: str, drain: _DeviceDrain, tainted: bool,
                 counts: dict[str, int]) -> bool:
        """One pipeline step for one device. Returns True when the device
        left the pipeline (rejoined or drain cancelled)."""
        # The reallocation annotation is the cluster-side work record: it
        # MUST land for every drained claim. The tombstone keeps drained
        # claims out of affected_claims, so this per-device pending set is
        # the durable retry home — flushed at the top of every poll and
        # blocking BOTH the rejoin and pipeline exit until empty.
        for uid, ref in list(drain.pending_records.items()):
            if self._annotate_drained(ref, dev):
                drain.pending_records.pop(uid, None)
        if not tainted and drain.pending_records:
            return False
        if not tainted:
            # Taint cleared underneath us. After a repair that is the
            # health monitor racing us to the rejoin — count the recovery;
            # before any drain work it is a plain recovery — cancel.
            if drain.repaired or drain.drained_any:
                self._note_rejoined(dev, drain, counts)
            else:
                self.cancelled.append(dev)
                counts["cancelled"] += 1
                logger.info("drain of %s cancelled: taint cleared", dev)
            return True

        if drain.state == "draining":
            if not drain.drained_any and self.driver.device_healthy(dev):
                # Recovered before any unprepare: cancel with NO spurious
                # drain; the health monitor clears the taint on its poll.
                self.cancelled.append(dev)
                counts["cancelled"] += 1
                logger.info("drain of %s cancelled: device recovered "
                            "before drain started", dev)
                return True
            claims = self._drain_order(self.driver.affected_claims(dev))
            if claims:
                faultpoints.maybe_fail(FP_DRAIN)
                for ref in claims:
                    if not drain.drained_any and self.driver.device_healthy(dev):
                        logger.info("drain of %s cancelled mid-round: "
                                    "device recovered", dev)
                        self.cancelled.append(dev)
                        counts["cancelled"] += 1
                        return True
                    if self.driver.drain_claim(ref, reason=f"device {dev} "
                                                           "tainted"):
                        drain.drained_any = True
                        drain.drained_uids.add(ref.uid)
                        drain.pending_records[ref.uid] = ref
                        counts["drained"] += 1
                        self.metrics.drains_total.inc(
                            driver=getattr(self.driver.state, "driver_name",
                                           "unknown"))
                        if self.events is not None:
                            self.events.event_for_claim_ref(
                                ref, REASON_CLAIM_DRAINED,
                                f"claim drained off tainted device {dev} "
                                f"on node {self.node_name}; awaiting "
                                "reallocation", TYPE_WARNING)
                claims = self.driver.affected_claims(dev)
            if not claims:
                drain.state = "repairing"

        # Freshly drained claims' annotations: attempt inline so the
        # normal path completes in one poll.
        for uid, ref in list(drain.pending_records.items()):
            if self._annotate_drained(ref, dev):
                drain.pending_records.pop(uid, None)

        if drain.state == "repairing":
            if drain.pending_records:
                return False  # annotations still pending; retry next poll
            if not drain.repaired:
                if self.repair is not None:
                    new_boot = self.repair(dev)
                    if new_boot is None:
                        return False  # repair pending; retry next poll
                    if new_boot:
                        self.driver.adopt_boot_id(new_boot)
                        for companion in self.companions:
                            companion.adopt_boot_id(new_boot)
                    drain.repaired = True
                elif self.driver.device_healthy(dev):
                    # External repair observed (GPU reports healthy).
                    drain.repaired = True
                else:
                    return False  # still broken; wait for repair
            faultpoints.maybe_fail(FP_REJOIN)
            if self.driver.rejoin_device(dev):
                self._note_rejoined(dev, drain, counts)
                return True
        return False

    def _drain_order(self, refs: list[ClaimRef]) -> list[ClaimRef]:
        """Drain priority (docs/self-healing.md, "Drain ordering"):
        claims holding the FEWEST devices first, uid as the tiebreak —
        a 1-GPU claim vacates the tainted device (and frees capacity
        for its own reallocation) before an 8-GPU claim's
        expensive eviction starts. Size lookups degrade to 0 (uid order)
        when the driver cannot answer."""
        count = getattr(self.driver, "claim_device_count", None)

        def key(ref: ClaimRef) -> tuple[int, str]:
            n = 0
            if count is not None:
                try:
                    n = count(ref)
                except Exception:  # noqa: BLE001 — ordering is a
                    # preference; an unreadable size must not stop a drain.
                    n = 0
            return (n, ref.uid)

        return sorted(refs, key=key)

    def _note_rejoined(self, dev: str, drain: _DeviceDrain,
                       counts: dict[str, int]) -> None:
        dt = self.clock() - drain.t0
        with self._mu:
            self.recoveries.append((dev, dt))
        counts["rejoined"] += 1
        self.metrics.recovery_seconds.observe(dt, node=self.node_name)
        if self.events is not None:
            self.events.event_for_ref(
                {"apiVersion": "v1", "kind": "Node", "name": self.node_name,
                 "namespace": "", "uid": ""},
                REASON_DEVICE_REJOINED,
                f"device {dev} rejoined the published ResourceSlice after "
                f"{dt:.2f}s ({len(drain.drained_uids)} claims drained)",
                TYPE_NORMAL)
        logger.info("device %s rejoined after %.2fs", dev, dt)

    def _annotate_drained(self, ref: ClaimRef, dev: str) -> bool:
        """Write the reallocation annotation for one drained claim.
        Returns whether the work is done (landed or moot); False keeps the
        claim in the device's pending set for the next poll's retry."""
        value = json.dumps({"node": self.node_name, "device": dev,
                            "reason": "device tainted", "at": time.time()})

        def mutate(claim: dict) -> bool:
            anns = claim["metadata"].setdefault("annotations", {})
            if anns.get(ANN_DRAIN) or anns.get(ANN_DRAIN_FAILED):
                return False  # already recorded (or terminally failed)
            anns[ANN_DRAIN] = value
            return True

        done = mutate_claim_with_retry(self.client, ref.name, ref.namespace,
                                       mutate, uid=ref.uid)
        if not done:
            logger.warning("could not annotate drained claim %s/%s for "
                           "reallocation (kept pending; retried next poll)",
                           ref.namespace, ref.name)
        return done

    # -- loop ----------------------------------------------------------------

    def start(self) -> "DrainController":
        self._thread = threading.Thread(
            target=self._run, name="gpu-drain-controller", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the loop must never die
                logger.exception("drain poll crashed; continuing")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class ClaimReallocator:
    """Cluster-side half of the pipeline (wired into the CD controller
    binary): re-binds drained claims onto healthy devices.

    Work discovery is an informer over ResourceClaims (the initial LIST
    doubles as crash recovery — a restarted reallocator re-learns every
    pending drain from the annotations, nothing is lost with the process).
    Per-claim processing:

    1. release the dead allocation: drop ``status.allocation`` and the
       stale per-driver ``status.devices`` entries (``reservedFor`` is
       KEPT — the consumer still wants the claim, that is the whole point
       of reallocating rather than failing);
    2. re-allocate through the structured allocator, which excludes
       ``NoSchedule``-tainted devices — the claim lands on healthy GPUs
       wherever capacity exists (any node);
    3. success → annotation removed + ``ClaimReallocated`` Event; budget
       exhausted → ``ReallocationFailed`` Event + terminal annotation
       (cleanly failed, an accepted terminal state).

    ``alloc_mutex``: scheduler-actor lock shared with whatever else
    allocates in-process (a test's claim workers) — two
    uncoordinated allocators could double-book a device, exactly as two
    schedulers would in a real cluster. Defaults to the allocator's OWN
    reentrant ``mutex``: ``Allocator.allocate`` serializes internally
    now, so the shared lock exists for callers that wrap multi-call
    read-modify sequences (the defrag planner's plan-under-lock reads),
    not for the allocate call itself.
    """

    def __init__(
        self,
        client,
        namespace: Optional[str] = None,
        retry_delay: float = 0.25,
        attempt_budget: int = 40,
        alloc_mutex: Optional[threading.Lock] = None,
        events: Optional[EventRecorder] = None,
        metrics: Optional[RemediationMetrics] = None,
        allocator: Optional[Allocator] = None,
        shard_gate=None,
    ):
        """``allocator``: share the scheduler's Allocator instance (and
        its indexes) instead of building a private one — required when a
        DefragPlanner drives preemption, so victim re-placement sees the
        same free-box geometry the planner scored."""
        self.client = client
        self.namespace = namespace
        self.retry_delay = retry_delay
        self.attempt_budget = attempt_budget
        self.alloc = allocator if allocator is not None else Allocator(client)
        self.alloc_mutex = alloc_mutex if alloc_mutex is not None \
            else self.alloc.mutex
        self.events = events or EventRecorder(client, "claim-reallocator")
        self.metrics = metrics or default_remediation_metrics()
        # Active-active sharding (sharding.ShardGate): a gated replica
        # processes only the pending claims whose shard it confidently
        # owns; the rest STAY pending (every replica's informer sees
        # every claim, so the owner picks them up from its own map).
        self.shard_gate = shard_gate
        self._mu = sanitizer.new_lock("ClaimReallocator._mu")
        self._pending: dict[str, tuple[str, str]] = sanitizer.track_state(
            {}, "ClaimReallocator._pending")  # uid -> (name, ns)
        self._attempts: dict[str, int] = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._informer: Optional[Informer] = None
        self._thread: Optional[threading.Thread] = None
        self.reallocated = 0
        self.failed = 0

    # -- work discovery ------------------------------------------------------

    def _on_claim(self, claim: dict) -> None:
        anns = (claim.get("metadata") or {}).get("annotations") or {}
        if ANN_DRAIN not in anns or ANN_DRAIN_FAILED in anns:
            return
        meta = claim["metadata"]
        with self._mu:
            self._pending[meta.get("uid", "")] = (
                meta.get("name", ""), meta.get("namespace", ""))
        self._wake.set()

    def pending_count(self) -> int:
        with self._mu:
            return len(self._pending)

    # -- one reconcile pass (exposed for deterministic tests) ----------------

    def reconcile_once(self) -> int:
        """Process every pending claim once; returns how many reached a
        terminal outcome (reallocated or cleanly failed) this pass."""
        with self._mu:
            work = dict(self._pending)
        done = 0
        for uid, (name, ns) in sorted(work.items()):
            if self._stop.is_set():
                break
            if self.shard_gate is not None and not self.shard_gate.admit(
                    ns, uid, "realloc"):
                continue  # not this replica's shard; stays pending here
            try:
                finished = self._process(uid, name, ns)
            except Exception:  # noqa: BLE001 — injected/transient API
                # failure: the claim stays pending, retried next pass.
                logger.exception("reallocation of claim %s/%s failed this "
                                 "pass; retrying", ns, name)
                continue
            if finished:
                done += 1
                with self._mu:
                    self._pending.pop(uid, None)
                    self._attempts.pop(uid, None)
        return done

    def _process(self, uid: str, name: str, ns: str) -> bool:
        claim = self.client.try_get("ResourceClaim", name, ns)
        if claim is None or claim["metadata"].get("uid") != uid:
            return True  # deleted/replaced: the drain is moot
        anns = claim["metadata"].get("annotations") or {}
        if ANN_DRAIN not in anns or ANN_DRAIN_FAILED in anns:
            return True  # already resolved
        drained_info = self._parse_ann(anns.get(ANN_DRAIN, ""))

        # Step 1: release the dead allocation (idempotent; crash-safe —
        # a claim released but not yet re-allocated still carries the
        # annotation, so a restarted reallocator resumes here).
        if (claim.get("status") or {}).get("allocation"):
            if not self._release_allocation(name, ns):
                return False  # release never landed; retry next pass

        # Step 2: allocate onto healthy devices (tainted are excluded by
        # the allocator; one scheduler actor at a time). A defrag
        # preemption's annotation names the placement being cleared —
        # the victim must land anywhere BUT there, or the migration
        # would immediately re-create the blockage it is resolving.
        avoid = None
        av = drained_info.get("avoid")
        if isinstance(av, dict) and av.get("pool") and av.get("device"):
            avoid = [(av["pool"], av["device"])]
        with self._mu:
            attempts = self._attempts.get(uid, 0) + 1
            self._attempts[uid] = attempts
        try:
            # allocate() serializes on the allocator's own mutex and does
            # its entry read outside it — no external lock span here, so
            # this contender no longer stretches the section the canary
            # prober and defrag planner wait on.
            self.alloc.allocate(self.client.get("ResourceClaim", name, ns),
                                avoid=avoid)
        except NotFoundError:
            return True
        except AllocationError as e:
            if attempts >= self.attempt_budget:
                self._mark_failed(claim, e)
                return True
            return False  # capacity pressure: retry next pass
        # Step 3: terminal success — annotation off, Event on.
        self._strip_annotation(name, ns)
        self.reallocated += 1
        self.metrics.reallocations_total.inc(outcome="success")
        self.events.event(claim, REASON_CLAIM_REALLOCATED,
                          "claim reallocated onto healthy devices after "
                          f"drain from {drained_info.get('node', '?')}/"
                          f"{drained_info.get('device', '?')}", TYPE_NORMAL)
        return True

    def _release_allocation(self, name: str, ns: str) -> bool:
        """Drop ``status.allocation`` and the released drivers' stale
        ``status.devices`` entries (``reservedFor`` is KEPT). Idempotent;
        returns False when the write never landed (caller retries)."""
        for _ in range(WRITE_RETRIES):
            try:
                fresh = self.client.try_get("ResourceClaim", name, ns)
            except Exception:  # noqa: BLE001 — injected/transient read
                time.sleep(0.002)
                continue
            if fresh is None:
                return True
            fstatus = fresh.setdefault("status", {})
            alloc = fstatus.get("allocation")
            if not alloc:
                return True
            old_drivers = {r.get("driver", "") for r in
                           (alloc.get("devices") or {}).get("results") or []}
            fstatus.pop("allocation", None)
            devices = [d for d in fstatus.get("devices") or []
                       if d.get("driver") not in old_drivers]
            if devices:
                fstatus["devices"] = devices
            else:
                fstatus.pop("devices", None)
            try:
                self.client.update_status(fresh)
                return True
            except ConflictError:
                continue
            except NotFoundError:
                return True
            except Exception:  # noqa: BLE001 — injected/transient write
                time.sleep(0.002)
        return False

    @staticmethod
    def _parse_ann(value: str) -> dict:
        try:
            parsed = json.loads(value)
            return parsed if isinstance(parsed, dict) else {}
        except (ValueError, TypeError):
            return {}

    def _mark_failed(self, claim: dict, err: Exception) -> None:
        self.failed += 1
        self.metrics.reallocations_total.inc(outcome="failed")
        self.events.event(claim, REASON_REALLOCATION_FAILED,
                          f"giving up reallocating drained claim after "
                          f"{self.attempt_budget} attempts: {err}",
                          TYPE_WARNING)

        def mutate(fresh: dict) -> bool:
            anns = fresh["metadata"].setdefault("annotations", {})
            anns[ANN_DRAIN_FAILED] = anns.pop(ANN_DRAIN, "") or "failed"
            return True

        name = claim["metadata"].get("name", "")
        ns = claim["metadata"].get("namespace", "")
        if not mutate_claim_with_retry(self.client, name, ns, mutate):
            logger.warning("could not mark claim %s/%s reallocation-failed",
                           ns, name)
        # A terminally failed claim must not keep its dead allocation (or
        # a stale Ready entry): release it so the claim watchers unwind
        # the tombstone and consumers see the claim cleanly unbound.
        self._release_allocation(name, ns)

    def _strip_annotation(self, name: str, ns: str) -> None:
        def mutate(fresh: dict) -> bool:
            anns = fresh["metadata"].get("annotations") or {}
            if ANN_DRAIN not in anns:
                return False
            anns.pop(ANN_DRAIN, None)
            fresh["metadata"]["annotations"] = anns
            return True

        if not mutate_claim_with_retry(self.client, name, ns, mutate):
            logger.warning("could not strip drain annotation from %s/%s "
                           "(reallocation will no-op on the next event)",
                           ns, name)

    # -- loop ----------------------------------------------------------------

    def start(self) -> "ClaimReallocator":
        self._informer = Informer(
            self.client, "ResourceClaim", self.namespace,
            on_add=self._on_claim,
            on_update=lambda old, new: self._on_claim(new),
        ).start()
        self._informer.wait_for_cache_sync()
        self._thread = threading.Thread(
            target=self._run, name="claim-reallocator", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.retry_delay)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.reconcile_once()
            except Exception:  # noqa: BLE001 — the loop must never die
                logger.exception("reallocation pass crashed; continuing")

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._informer is not None:
            self._informer.stop()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class DefragPlanner:
    """SLO-driven defragmentation (docs/performance.md, "Topology-aware
    allocation") — the designed-for SECOND ``pkg/slo.py subscribe()``
    consumer after GPU-vanish flap damping.

    When a large claim is admission-blocked though aggregate capacity
    exists (the allocator records it as *fragmentation-blocked* and
    counts ``outcome=fragmented``), the fleet's ``allocation_admission``
    SLO burns; the ticket-severity alert transition lands here and
    triggers a planning pass. For each blocked claim the planner:

    1. scores every placement that could host it by eviction cost —
       fewest victim claims first, then fewest total victim GPUs (the
       drain-priority weight: small claims are cheap to move), skipping
       any placement whose victims exceed the per-blocked-claim eviction
       budget (``max_evictions_per_claim`` — the no-preemption-storm
       bound, cumulative across passes);
    2. emits a migration hint (``DefragPlanned`` Event on the blocked
       claim + :meth:`hints`) naming the chosen target box;
    3. preempts the chosen placement's movable victims through the
       EXISTING drain → reallocate pipeline: each victim gets the
       ``gpu.nvidia.com/drain`` annotation (reason ``defrag``, plus the
       target placement as ``avoid`` so the reallocator cannot put it
       straight back) and a ``ClaimPreempted`` Event — the unchanged
       ClaimReallocator releases and re-binds it elsewhere, and the
       claim watchers' move-the-prepare machinery does the rest.

    Movability: a victim must still exist with the same uid, not already
    be draining/drain-failed, and not hold more GPUs than the blocked
    claim needs (evicting something larger than what it admits is a net
    loss). The planner never evicts without the drain pipeline's
    reallocated-or-cleanly-failed contract.
    """

    def __init__(
        self,
        client,
        allocator: Allocator,
        max_evictions_per_claim: int = 4,
        alloc_mutex: Optional[threading.Lock] = None,
        events: Optional[EventRecorder] = None,
        metrics: Optional[RemediationMetrics] = None,
        hints_cap: int = 256,
    ):
        self.client = client
        self.alloc = allocator
        self.max_evictions_per_claim = max(1, max_evictions_per_claim)
        # Defaults to the allocator's own reentrant mutex: the planner's
        # multi-call read sequences (blocked_claims → placement_options)
        # still group under one lock span, and the nested self-locking
        # inside each allocator method composes instead of deadlocking.
        self.alloc_mutex = alloc_mutex if alloc_mutex is not None \
            else allocator.mutex
        self.events = events or EventRecorder(client, "defrag-planner")
        self.metrics = metrics or default_remediation_metrics()
        self.hints_cap = hints_cap
        self._mu = sanitizer.new_lock("DefragPlanner._mu")
        # One planning pass at a time: on_alert runs on the SloEngine's
        # evaluation thread while start()'s poll loop runs on its own —
        # two concurrent passes would each read a fresh eviction budget
        # for the same blocked claim and could TOGETHER exceed the
        # per-claim bound the planner exists to enforce.
        self._plan_mu = sanitizer.new_lock("DefragPlanner._plan_mu")
        #: cumulative evictions spent per blocked-claim uid — the storm
        #: bound survives across passes; bounded like the blocked list.
        self._spent: dict[str, int] = {}
        self._hints: list[dict] = []
        #: True while the admission alert is FIRING (set on the fired
        #: transition, cleared on cleared) — :meth:`maybe_plan` keeps
        #: planning while armed, so a pass that partially failed on
        #: transient API faults is retried without a fresh alert edge.
        self._armed = False
        self.planned = 0
        self.preempted = 0
        self.skipped = 0

    # -- the subscribe() face ------------------------------------------------

    def on_alert(self, transition: Any) -> None:
        """``SloEngine.subscribe`` consumer: a FIRED transition of the
        ``allocation_admission`` SLO arms the planner and triggers one
        immediate pass; the CLEARED transition disarms it. Severity is
        not filtered — by the time even the ticket pair burns, blocked
        large claims are piling up. Failures are logged by the engine's
        fan-out isolation; this method itself must stay cheap (it runs
        on the evaluation thread)."""
        if getattr(transition, "slo", "") != SLO_ALLOCATION_ADMISSION:
            return
        kind = getattr(transition, "transition", "")
        if kind == "fired":
            with self._mu:
                self._armed = True
            self.plan_once()
        elif kind == "cleared":
            with self._mu:
                self._armed = False

    @property
    def armed(self) -> bool:
        with self._mu:
            return self._armed

    def maybe_plan(self) -> dict[str, int]:
        """One planning pass IF the admission alert is currently firing
        — the periodic companion to the edge-triggered :meth:`on_alert`
        (a controller main or a test calls this on its poll
        ticks; it is a no-op while disarmed)."""
        if not self.armed:
            return {}
        return self.plan_once()

    # -- loop (controller-main wiring) ---------------------------------------

    def start(self, poll_interval: float = 15.0) -> "DefragPlanner":
        """Run :meth:`maybe_plan` on a poll loop — the while-firing
        retry path next to the edge-triggered subscription (a pass that
        lost victims to transient API faults must not wait for the next
        alert edge)."""
        self._stop_ev = threading.Event()

        def _run() -> None:
            while not self._stop_ev.wait(poll_interval):
                try:
                    self.maybe_plan()
                except Exception:  # noqa: BLE001 — the loop must never die
                    logger.exception("defrag planning pass crashed; "
                                     "continuing")

        self._thread = threading.Thread(
            target=_run, name="defrag-planner", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        ev = getattr(self, "_stop_ev", None)
        if ev is not None:
            ev.set()
        thread = getattr(self, "_thread", None)
        if thread is not None:
            thread.join(timeout=5.0)

    def hints(self) -> list[dict]:
        """Migration hints emitted so far (bounded history): blocked
        claim, chosen target placement, victims."""
        with self._mu:
            return list(self._hints)

    # -- one planning pass (exposed for deterministic tests) -----------------

    def plan_once(self) -> dict[str, int]:
        counts = {"planned": 0, "preempted": 0, "skipped": 0, "resolved": 0}
        with self._plan_mu:
            with self.alloc_mutex:
                blocked = self.alloc.blocked_claims()
            for info in blocked:
                try:
                    self._plan_one(info, counts)
                except Exception:  # noqa: BLE001 — per-claim, idempotent:
                    # an injected/transient API failure retries next pass.
                    logger.exception("defrag planning for claim %s/%s "
                                     "failed this pass",
                                     info.get("namespace"),
                                     info.get("name"))
        return counts

    def _plan_one(self, info: dict, counts: dict[str, int]) -> None:
        uid, name, ns = info["uid"], info["name"], info["namespace"]
        claim = self.client.try_get("ResourceClaim", name, ns)
        if claim is None or claim["metadata"].get("uid") != uid:
            with self.alloc_mutex:
                self.alloc.blocked.pop(uid, None)
            counts["resolved"] += 1
            return
        if (claim.get("status") or {}).get("allocation"):
            with self.alloc_mutex:
                self.alloc.blocked.pop(uid, None)
            counts["resolved"] += 1
            return
        budget = self.max_evictions_per_claim - self._spent.get(uid, 0)
        if budget <= 0:
            self.metrics.preemptions_total.inc(outcome="skipped_bounded")
            counts["skipped"] += 1
            self.skipped += 1
            return
        with self.alloc_mutex:
            options = self.alloc.placement_options(claim,
                                                   node=info.get("node"))
        blocked_chips = max(1, int(info.get("chips") or 0))
        viable = []
        for opt in options:
            victims = [v for v in opt["victims"] if v["uid"] != uid]
            if not victims:
                # The placement is already free — nothing to preempt,
                # the blocked claim just needs its allocation retried.
                continue
            movable = self._movable(victims, blocked_chips)
            if movable is None:
                continue  # an unmovable occupant poisons this placement
            # Only REAL claims are billed; canary probes are free to
            # evict and do not count toward the storm bound or the cost.
            billable = [v for v in movable if not v.get("canary")]
            if len(billable) > budget:
                continue  # would blow the storm bound
            viable.append((len(billable),
                           sum(v["chips"] for v in billable),
                           opt["device"], opt, movable))
        if not viable:
            self.metrics.preemptions_total.inc(outcome="skipped_unmovable")
            counts["skipped"] += 1
            self.skipped += 1
            return
        viable.sort(key=lambda t: t[:3])
        _n, _chips, _dev, opt, movable = viable[0]
        hint = {
            "claim": f"{ns}/{name}", "uid": uid,
            "target_pool": opt["pool"], "target_device": opt["device"],
            "volume": opt["volume"],
            "victims": [f'{v["namespace"]}/{v["name"]}' for v in movable],
            "victim_chips": sum(v["chips"] for v in movable),
        }
        with self._mu:
            self._hints.append(hint)
            del self._hints[:-self.hints_cap]
        self.events.event(
            claim, REASON_DEFRAG_PLANNED,
            f"defrag hint: place on {opt['pool']}/{opt['device']} by "
            f"migrating {len(movable)} claim(s) holding "
            f"{hint['victim_chips']} GPU(s)", TYPE_NORMAL)
        self.planned += 1
        counts["planned"] += 1
        annotated = 0
        billed = 0
        for v in movable:
            if self._preempt(v, opt, ns, name):
                annotated += 1
                if not v.get("canary"):
                    billed += 1
        self._spent[uid] = self._spent.get(uid, 0) + billed
        while len(self._spent) > _SPENT_MAX:
            self._spent.pop(next(iter(self._spent)))
        self.preempted += annotated
        counts["preempted"] += annotated

    def _movable(self, victims: list[dict],
                 blocked_chips: int) -> Optional[list[dict]]:
        """The victims sorted cheapest-first, or None when any occupant
        is unmovable (already draining, terminally failed, vanished —
        or simply bigger than the claim being admitted). Canary claims
        (``gpu.nvidia.com/canary``, docs/observability.md "Synthetic
        probing") are FREE TO EVICT: always movable regardless of size,
        sorted ahead of real claims, and — in :meth:`_plan_one` — never
        billed against the per-claim eviction budget (evicting a
        synthetic probe is not a preemption storm)."""
        out = []
        for v in victims:
            claim = self.client.try_get("ResourceClaim", v["name"],
                                        v["namespace"])
            if claim is None or claim["metadata"].get("uid") != v["uid"]:
                return None  # stale view: re-plan next pass
            anns = claim["metadata"].get("annotations") or {}
            if ANN_DRAIN in anns or ANN_DRAIN_FAILED in anns:
                return None  # already in the pipeline: wait, don't pile on
            canary = ANN_CANARY in anns
            if not canary and v["chips"] > blocked_chips:
                return None
            out.append({**v, "canary": canary})
        out.sort(key=lambda v: (not v["canary"], v["chips"], v["uid"]))
        return out

    def _preempt(self, victim: dict, opt: dict, blocked_ns: str,
                 blocked_name: str) -> bool:
        """Annotate one victim for the drain → reallocate pipeline, with
        the target placement as the reallocator's avoid hint."""
        value = json.dumps({
            "node": "", "device": opt["device"],
            "reason": f"defrag preemption for {blocked_ns}/{blocked_name}",
            "at": time.time(),
            "avoid": {"pool": opt["pool"], "device": opt["device"]},
        })

        def mutate(fresh: dict) -> bool:
            anns = fresh["metadata"].setdefault("annotations", {})
            if anns.get(ANN_DRAIN) or anns.get(ANN_DRAIN_FAILED):
                return False
            anns[ANN_DRAIN] = value
            return True

        done = mutate_claim_with_retry(self.client, victim["name"],
                                       victim["namespace"], mutate,
                                       uid=victim["uid"])
        if done:
            self.metrics.preemptions_total.inc(outcome="annotated")
            self.events.event_for_claim_ref(
                ClaimRef(uid=victim["uid"], name=victim["name"],
                         namespace=victim["namespace"]),
                REASON_CLAIM_PREEMPTED,
                f"preempted to defragment {opt['pool']}/{opt['device']} "
                f"for {blocked_ns}/{blocked_name}; awaiting reallocation",
                TYPE_WARNING)
        else:
            logger.warning("could not annotate defrag victim %s/%s "
                           "(retried next pass)", victim["namespace"],
                           victim["name"])
        return done


#: bound on the planner's per-blocked-claim eviction ledger.
_SPENT_MAX = 1024


def attach_defrag_planner(engine: Any, planner: DefragPlanner) -> DefragPlanner:
    """Subscribe the planner to an SloEngine's alert transitions — the
    one-line wiring a controller main or a test uses."""
    engine.subscribe(planner.on_alert)
    return planner
