"""Node failure domains: liveness leases, cordon → drain → repair →
rejoin, and partition fencing (docs/self-healing.md, "Whole-node repair").

The counterpart of the JAX package's ``pkg/nodelease.py``, GPU-named
(``gpu.nvidia.com/cordon``), with its ``/debug/nodelease`` registry of
live heartbeats and lifecycle controllers.

The per-device pipeline (``kubeletplugin/remediation.py``) assumes a live
node agent: the health monitor taints, the drain controller tombstones,
the reallocator re-binds. A dead *node* — plugin crash that never comes
back, host reboot, network partition — leaves its prepared claims
squatting with nobody home to taint or drain. The reference driver leans
on kubelet/node-lifecycle machinery for this layer; the fake cluster
carries it itself, the same way ``plugins/compute_domain_controller/
election.py`` reproduces client-go lease-based leader election:

- :class:`NodeLeaseHeartbeat` (node side, one per kubelet plugin main)
  renews a per-node ``Lease`` carrying a monotonically increasing **node
  epoch** — bumped on every plugin restart, persisted next to the
  checkpoint — plus the boot id for diagnostics.
- :class:`NodeLifecycleController` (cluster side, next to the
  ``ClaimReallocator``) watches the leases and, after the lease has gone
  ``lost_factor`` × its duration without a renewal, declares the node lost
  and runs the cordon pipeline: **fence** (stamp ``fencedEpoch`` on the
  lease) → **cordon** (taint every device of the node's ResourceSlices
  ``NoSchedule`` + annotate the Node + Event ``NodeCordoned``) →
  **drain-annotate** every claim allocated there (the ``ClaimReallocator``
  releases and re-binds them) → pluggable whole-node **repair** hook →
  **uncordon** once the lease renews again AND the fence is cleared
  (Event ``NodeUncordoned``).
- **Partition fencing**: the ``k8sclient.partition`` fault point /
  :class:`k8sclient.client.PartitionGate` sever one node's clients. On
  heal, the heartbeat's next renewal observes the ``fencedEpoch`` the
  controller stamped and runs its ``fence_cleanup`` hook — unprepare all
  checkpoint state for claims whose allocation moved while the node was
  gone — before clearing the fence. Until the fence clears the plugin
  reports NOT_SERVING and its claim loop defers, so a healed node can
  never double-prepare a claim that now lives elsewhere. A restart during
  the partition bumps the epoch but the fence STANDS until explicitly
  cleared — fencing is an acknowledgment protocol, not an epoch
  comparison.

The voluntary path: :func:`request_cordon` annotates the Node; the
node-side ``DrainController`` (remediation.py) notices and drains
gracefully through the per-claim flight locks — no lease expiry, no
fence needed, because the node is alive to do its own cleanup.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from k8s_dra_driver_tpu_torch.k8sclient.client import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    new_object,
)
from k8s_dra_driver_tpu_torch.pkg import bootid, durability, sanitizer
from k8s_dra_driver_tpu_torch.pkg.events import (
    REASON_NODE_CORDONED,
    REASON_NODE_FENCED,
    REASON_NODE_UNCORDONED,
    TYPE_NORMAL,
    TYPE_WARNING,
    EventRecorder,
)
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    NodeMetrics,
    default_node_metrics,
)

logger = logging.getLogger(__name__)

KIND_LEASE = "Lease"
#: real-k8s home of node heartbeats (kubelet's NodeLease feature).
LEASE_NAMESPACE = "kube-node-lease"

#: node-scope cordon marker, as an annotation on the Node object. Value
#: is JSON: {"reason": ..., "at": <unix time>, "epoch": <fenced epoch>}.
ANN_CORDON = "gpu.nvidia.com/cordon"
#: device taint applied to every device of a cordoned node — NoSchedule,
#: so the structured allocator excludes the whole node by construction.
TAINT_KEY_CORDON = "gpu.nvidia.com/cordon"

CORDON_NODE_LOST = "node-lost"    # controller-declared (lease expired)
CORDON_REQUESTED = "requested"    # voluntary (operator / autopilot)

DEFAULT_LEASE_DURATION = 10.0
#: a node is declared lost after lost_factor × leaseDurationSeconds
#: without a renewal — detection ≤ 2 × lease duration with poll slack.
DEFAULT_LOST_FACTOR = 1.5
#: the corroborated factor: when the node's metrics target is
#: ALSO staleness-marked, detection tightens to one full duration. Never
#: below 1.0 — a dark scrape target alone must never cordon a node whose
#: lease is still live (staleness corroborates, it does not decide).
DEFAULT_CORROBORATED_FACTOR = 1.0

EPOCH_FILE = "node-epoch.json"
#: bounded conflict/transient retries for cluster-side RMW writes; the
#: pipeline is idempotent so a lost round just retries next poll.
WRITE_RETRIES = 25


def node_lease_name(node: str) -> str:
    return f"node-{node}"


# -- /debug/nodelease (docs/observability.md, "Debug endpoints") -------------
#
# Lease epochs, fence acks, and cordon state are load-bearing incident
# inputs (pkg/blackbox.py) with no introspection surface of their own —
# the same weakref live-registry pattern as informers and workqueues.

_live_heartbeats: "weakref.WeakSet[NodeLeaseHeartbeat]" = weakref.WeakSet()
_live_lifecycles: "weakref.WeakSet[NodeLifecycleController]" = \
    weakref.WeakSet()


def nodelease_debug_snapshot() -> dict[str, Any]:
    """The ``/debug/nodelease`` payload: this process's heartbeats (node
    epoch, boot id, renewals, fence/suspect state) and lifecycle
    controllers (cordoned nodes, bounded cordon/uncordon history)."""
    heartbeats = []
    for hb in list(_live_heartbeats):
        try:
            heartbeats.append({
                "node": hb.node_name,
                "lease": hb.lease_name,
                "identity": hb.identity,
                "epoch": hb.epoch,
                "boot_id": hb.boot_id,
                "lease_duration_s": hb.lease_duration,
                "renewals": hb.renewals,
                "fenced": hb.fenced,
                "suspect": hb.suspect,
                "fence_recoveries": hb.fence_recoveries,
            })
        except Exception as e:  # noqa: BLE001 — one broken heartbeat
            # must not blank the endpoint.
            heartbeats.append({"error": repr(e)})
    lifecycles = []
    for lc in list(_live_lifecycles):
        try:
            lifecycles.append({
                "cordoned": lc.cordoned_nodes(),
                "cordons": [[n, round(t, 3)] for n, t in lc.cordons[-20:]],
                "uncordons": [[n, round(t, 3)]
                              for n, t in lc.uncordons[-20:]],
            })
        except Exception as e:  # noqa: BLE001 — ditto
            lifecycles.append({"error": repr(e)})
    return {"heartbeats": heartbeats, "lifecycle": lifecycles}


def next_node_epoch(state_dir: Optional[str],
                    env: Optional[dict[str, str]] = None) -> tuple[int, str]:
    """Bump-and-persist the node epoch (one per plugin process start).

    The epoch lives in ``<state_dir>/node-epoch.json`` next to the
    checkpoint and increases on EVERY plugin restart; the boot id rides
    along for diagnostics (a reboot shows as epoch+1 with a new boot id,
    a bare plugin restart as epoch+1 with the same one). Without a
    ``state_dir`` the epoch starts at 1 — in-memory assemblies (tests)
    get restart semantics from constructing a fresh heartbeat."""
    boot = bootid.read_boot_id(env)
    prev = 0
    path = os.path.join(state_dir, EPOCH_FILE) if state_dir else None
    if path is not None:
        try:
            with open(path) as f:
                prev = int((json.load(f) or {}).get("epoch", 0))
        except (OSError, ValueError, TypeError):
            prev = 0
    epoch = prev + 1
    if path is not None:
        try:
            os.makedirs(state_dir, exist_ok=True)  # type: ignore[arg-type]
            durability.atomic_publish(
                path, lambda f: json.dump({"epoch": epoch, "bootId": boot}, f))
        except OSError:
            # Tolerate-and-warn: a failed persist costs epoch reuse on the
            # next restart, never a heartbeat that refuses to start.
            logger.warning("node-epoch persist failed (%s); the next "
                           "restart will reuse epoch %d", path, epoch)
    return epoch, boot


def mutate_with_retry(client, kind: str, name: str, namespace: str,
                      mutate: Callable[[dict], bool],
                      status: bool = False, uid: str = "") -> bool:
    """Read-modify-write one object with bounded retries over conflicts
    and transient (injected) failures — THE shared RMW loop for every
    idempotent cluster-side write in the remediation/node-lifecycle
    machinery (``remediation.mutate_claim_with_retry`` delegates here).
    ``mutate(obj) -> bool`` edits the fresh object in place and returns
    False when there is nothing to do; ``uid`` guards against a
    same-name replacement. Returns True when the write landed or was
    moot (object gone/replaced, mutate declined); False when the budget
    ran out — callers retry on their next poll, the work is idempotent."""
    for _ in range(WRITE_RETRIES):
        try:
            obj = client.try_get(kind, name, namespace)
        except Exception:  # noqa: BLE001 — injected/transient read
            time.sleep(0.002)
            continue
        if obj is None or (uid and obj["metadata"].get("uid") != uid):
            return True
        if not mutate(obj):
            return True
        try:
            (client.update_status if status else client.update)(obj)
            return True
        except (ConflictError, NotFoundError):
            continue
        except Exception:  # noqa: BLE001 — injected/transient write
            time.sleep(0.002)
    return False


# --------------------------------------------------------------------------
# Node side: heartbeat + fence recovery
# --------------------------------------------------------------------------

class NodeLeaseHeartbeat:
    """Renews this node's Lease; observes and recovers from fencing.

    One per kubelet plugin main. Both plugins on a node renew the SAME
    per-node lease (conflicts retried; the larger epoch wins on both
    sides, which also resolves epoch ties after a torn lease write).

    ``fence_cleanup``: zero-arg hook run when a renewal observes
    ``fencedEpoch`` on the lease — it must unwind every checkpoint
    artifact for claims whose allocation moved (see
    :func:`fence_cleanup_for`) and raise on failure; only after it
    returns is this plugin's fence ACK recorded. While ``fenced`` (or
    ``suspect`` — no successful renewal within a lease duration) the
    plugin's healthcheck reports NOT_SERVING and its claim loop defers.

    ``identity``: this renewer's name on the lease (the plugin binary).
    The fence is acked PER IDENTITY: the controller stamps the set of
    identities renewing at cordon time as ``fencedIdentities``, each
    heartbeat removes its own identity only after its own cleanup ran,
    and ``fencedEpoch`` falls off the lease when the LAST identity acks
    — so the GPU plugin renewing first after a heal can never clear the
    fence out from under the CD plugin's still-dirty checkpoints. A
    fence with no identity list (a manual/legacy stamp) clears on any
    single ack.
    """

    def __init__(
        self,
        client,
        node_name: str,
        state_dir: Optional[str] = None,
        lease_duration: float = DEFAULT_LEASE_DURATION,
        renew_interval: Optional[float] = None,
        namespace: str = LEASE_NAMESPACE,
        fence_cleanup: Optional[Callable[[], None]] = None,
        identity: str = "node-agent",
        env: Optional[dict[str, str]] = None,
        metrics: Optional[NodeMetrics] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.client = client
        self.node_name = node_name
        self.lease_name = node_lease_name(node_name)
        self.namespace = namespace
        self.lease_duration = lease_duration
        self.renew_interval = (renew_interval if renew_interval is not None
                               else lease_duration / 3.0)
        self.fence_cleanup = fence_cleanup
        self.identity = identity
        self.metrics = metrics or default_node_metrics()
        self.clock = clock
        self.epoch, self.boot_id = next_node_epoch(state_dir, env)
        self.renewals = 0
        self.fence_recoveries = 0
        self._fenced = False
        self._last_success = 0.0  # self.clock() of the last landed renew
        self._mu = sanitizer.new_lock("NodeLeaseHeartbeat._mu")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _live_heartbeats.add(self)

    # -- introspection (healthcheck gating, claim-loop fence gate) -----------

    @property
    def fenced(self) -> bool:
        """The lease carries a fence this plugin has not yet cleared."""
        with self._mu:
            return self._fenced

    @property
    def suspect(self) -> bool:
        """No successful renewal within one lease duration — this node
        may already be fenced without knowing it (mid-partition), so
        fence-gated consumers treat suspect as fenced."""
        with self._mu:
            last = self._last_success
        return self.clock() - last > self.lease_duration

    # -- one renewal round (exposed for deterministic tests) -----------------

    def _spec(self, now: float, prev: Optional[dict] = None) -> dict:
        spec = dict(prev or {})
        renewers = dict(spec.get("renewers") or {})
        renewers[self.identity] = self.epoch
        spec.update({
            "holderIdentity": self.node_name,
            "leaseDurationSeconds": self.lease_duration,
            "renewTime": now,
            "nodeEpoch": self.epoch,
            "bootId": self.boot_id,
            # Who co-renews this lease — the controller snapshots this
            # set into fencedIdentities at cordon time, so every plugin
            # that held state on the node must ack the fence.
            "renewers": renewers,
        })
        return spec

    def renew_once(self) -> bool:
        """One create-or-renew round. Returns True iff the write landed.
        Transport failures propagate — the run loop (and tests) count
        them; a failed round leaves the lease to age toward expiry."""
        now = self.clock()
        spec: Optional[dict] = None
        for _ in range(2):  # a lost create race retries via the update path
            lease = self.client.try_get(KIND_LEASE, self.lease_name,
                                        self.namespace)
            if lease is None:
                obj = new_object(KIND_LEASE, self.lease_name, self.namespace,
                                 api_version="coordination.k8s.io/v1",
                                 spec=self._spec(now))
                try:
                    self.client.create(obj)
                except AlreadyExistsError:
                    # The companion plugin won the creation race; re-read
                    # and take the update path NOW — returning False here
                    # would leave this plugin starting life `suspect`
                    # (claim loop deferring, NOT_SERVING) for a whole
                    # renew interval on every cold start.
                    continue
                spec = obj["spec"]
            else:
                prev = lease.get("spec") or {}
                # Epoch adoption: after a torn write (or a companion
                # plugin's own restart bump) the LARGER epoch wins on
                # both sides, so ties converge instead of see-sawing.
                self.epoch = max(self.epoch,
                                 int(prev.get("nodeEpoch", 0) or 0))
                lease["spec"] = self._spec(now, prev)
                try:
                    self.client.update(lease)
                except (ConflictError, NotFoundError):
                    return False  # racing writer; retry next round
                spec = lease["spec"]
            break
        if spec is None:
            return False
        self.renewals += 1
        with self._mu:
            self._last_success = now
        self.metrics.lease_renewals_total.inc(node=self.node_name)
        self._observe_fence(spec)
        return True

    def _fence_applies(self, spec: dict) -> bool:
        """Whether the lease's fence still binds THIS plugin: a fence
        with an identity list binds only unacked identities (our own
        cleanup may already have run while a sibling's is pending); a
        listless (manual/legacy) fence binds everyone."""
        if "fencedEpoch" not in spec:
            return False
        ids = spec.get("fencedIdentities")
        if ids is None:
            return True
        return self.identity in ids

    def _observe_fence(self, spec: dict) -> None:
        fenced = self._fence_applies(spec)
        with self._mu:
            newly = fenced and not self._fenced
            self._fenced = fenced
        if newly:
            logger.warning(
                "node %s is FENCED for %s (fencedEpoch=%s, our epoch=%d): "
                "running fence cleanup before serving", self.node_name,
                self.identity, spec.get("fencedEpoch"), self.epoch)
        if not fenced:
            return
        # Recovery: cleanup first, ack only after it succeeded. A
        # cleanup failure — or the ABSENCE of a cleanup hook — keeps the
        # fence standing: the fence is an acknowledgment protocol, and a
        # heartbeat that cannot clean up cannot ack. NOTE the epoch is
        # NOT consulted: a restart during the partition bumped it past
        # fencedEpoch, but the stale checkpoint state the fence guards
        # against survived the restart too.
        if self.fence_cleanup is None:
            return
        try:
            self.fence_cleanup()
        except Exception:  # noqa: BLE001 — stay fenced, retry
            logger.exception("fence cleanup failed on node %s; the "
                             "fence stands (retried next renewal)",
                             self.node_name)
            return
        if self.ack_fence():
            with self._mu:
                self._fenced = False
            self.fence_recoveries += 1
            logger.info("node %s fence acked by %s after cleanup",
                        self.node_name, self.identity)

    def ack_fence(self) -> bool:
        """Record THIS identity's cleanup ack on the lease (CAS, bounded
        retries); the fence itself falls off when the last stamped
        identity has acked. Only call after cleanup completed — the
        fence IS the cleanup obligation."""
        def mutate(lease: dict) -> bool:
            spec = lease.setdefault("spec", {})
            if "fencedEpoch" not in spec:
                return False
            ids = spec.get("fencedIdentities")
            if ids is None:
                # Manual/legacy stamp with no identity list: single ack.
                spec.pop("fencedEpoch", None)
                return True
            remaining = [i for i in ids if i != self.identity]
            if remaining:
                spec["fencedIdentities"] = remaining
            else:
                spec.pop("fencedIdentities", None)
                spec.pop("fencedEpoch", None)
            return True

        return mutate_with_retry(self.client, KIND_LEASE, self.lease_name,
                                  self.namespace, mutate)

    def clear_fence(self) -> bool:
        """Forcibly remove the whole fence — identity list included —
        regardless of pending acks (the operator's manual unfence)."""
        def mutate(lease: dict) -> bool:
            spec = lease.setdefault("spec", {})
            if ("fencedEpoch" not in spec
                    and "fencedIdentities" not in spec):
                return False
            spec.pop("fencedEpoch", None)
            spec.pop("fencedIdentities", None)
            return True

        return mutate_with_retry(self.client, KIND_LEASE, self.lease_name,
                                  self.namespace, mutate)

    # -- loop ----------------------------------------------------------------

    def start(self) -> "NodeLeaseHeartbeat":
        # Synchronous first renewal: the loop's consumers (fence gate,
        # healthcheck) read `suspect` from the last success — a plugin
        # must not start life suspect when the API server is reachable.
        try:
            self.renew_once()
        except Exception:  # noqa: BLE001 — the loop retries
            logger.warning("initial node-lease renewal failed; retrying",
                           exc_info=True)
        self._thread = threading.Thread(
            target=self._run, name=f"node-lease-{self.node_name}",
            daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.renew_interval):
            try:
                self.renew_once()
            except Exception:  # noqa: BLE001 — partition/outage: the
                # lease ages toward expiry, exactly the design.
                logger.warning("node-lease renewal failed on %s",
                               self.node_name, exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # A stopped heartbeat leaves /debug/nodelease now, not whenever
        # the collector reclaims it.
        _live_heartbeats.discard(self)


def fence_cleanup_for(driver, client) -> Callable[[], None]:
    """Build a heartbeat ``fence_cleanup`` hook for a kubelet plugin
    driver (GPU or CD — anything with ``state``/``pool_name``/
    ``unprepare_resource_claims``/``republish`` or ``publish_resources``).

    The fencing contract: for every claim in the checkpoint, keep the
    prepared state ONLY if the claim still exists with the same uid and
    its allocation still covers this driver's pool; everything else —
    deleted claims, replaced uids, allocations the reallocator moved to
    another node while we were gone — is unprepared (checkpoint entry
    popped, CDI spec removed). Raises on failure so the fence stands and
    the next renewal retries. Finishes with one republish: the node's
    devices rejoin the published ResourceSlices in a single write."""
    from k8s_dra_driver_tpu_torch.kubeletplugin.types import (
        ClaimRef,
        claim_allocation_results,
    )

    driver_name = getattr(driver.state, "driver_name", "")
    pool = getattr(driver, "pool_name", "")

    def cleanup() -> None:
        prepared = driver.state.prepared_claims_nolock()  # raises → fenced
        stale: list[ClaimRef] = []
        for uid, pc in sorted(prepared.items()):
            ref = ClaimRef(uid=uid, name=pc.name, namespace=pc.namespace)
            claim = client.try_get("ResourceClaim", pc.name, pc.namespace)
            keep = False
            if claim is not None and claim["metadata"].get("uid") == uid:
                keep = any(
                    r.get("driver") == driver_name
                    and r.get("pool") == pool
                    for r in claim_allocation_results(claim))
            if not keep:
                stale.append(ref)
        if stale:
            errs = driver.unprepare_resource_claims(stale)
            bad = {uid: repr(e) for uid, e in errs.items() if e is not None}
            if bad:
                raise RuntimeError(
                    f"fence cleanup could not unprepare moved claims: {bad}")
            logger.info("fence cleanup on %s/%s: unprepared %d moved "
                        "claim(s)", pool, driver_name, len(stale))
        # Rejoin: one republish with fresh enumeration so the devices
        # return to the published slices (and any cluster-written cordon
        # taints are superseded by the node's own healthy view).
        republish = getattr(driver, "republish", None)
        if republish is not None:
            republish()
        else:
            driver.publish_resources()

    return cleanup


def apply_cordon_taint(devices, reason: str) -> None:
    """Append the NoSchedule cordon taint to every published Device that
    lacks one — the generate-time half of a node-scope cordon, shared by
    both kubelet plugins' ``generate_driver_resources``."""
    from k8s_dra_driver_tpu_torch.kubeletplugin.types import DeviceTaint

    cordon = DeviceTaint(key=TAINT_KEY_CORDON, value=reason,
                         effect="NoSchedule")
    for d in devices:
        if all(t.key != TAINT_KEY_CORDON for t in d.taints or []):
            d.taints = list(d.taints or []) + [cordon]


def live_prepared_refs(state) -> list:
    """Every non-tombstoned prepared claim in a plugin's checkpoint as
    ClaimRefs — the node-scope drain's work list, shared by both
    drivers' ``all_prepared_claims``. An unreadable checkpoint returns
    an empty list (the request paths already fail loudly; the drain
    work list just retries next poll)."""
    from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
        STATE_PREPARE_ABORTED,
    )

    try:
        prepared = state.prepared_claims_nolock()
    except Exception:  # noqa: BLE001
        logger.warning("live_prepared_refs: checkpoint unreadable")
        return []
    return [ClaimRef(uid=uid, name=pc.name, namespace=pc.namespace)
            for uid, pc in sorted(prepared.items())
            if pc.state != STATE_PREPARE_ABORTED]


# --------------------------------------------------------------------------
# Voluntary cordon surface (operator / autopilot)
# --------------------------------------------------------------------------

def request_cordon(client, node: str,
                   reason: str = CORDON_REQUESTED) -> bool:
    """Annotate the Node: the node-side DrainController drains every
    prepared claim gracefully (per-claim flight locks) and taints all
    devices — no lease expiry, no fence. Idempotent. A node-lost
    annotation already present is OVERWRITTEN: the operator's request
    must outlive the automated cordon (the lifecycle uncordon removes
    only ``node-lost`` annotations), not be silently dropped with a
    success return."""
    def mutate(obj: dict) -> bool:
        anns = obj["metadata"].setdefault("annotations", {})
        raw = anns.get(ANN_CORDON)
        if raw:
            try:
                cur = (json.loads(raw) or {}).get("reason")
            except (ValueError, TypeError):
                cur = None
            if cur != CORDON_NODE_LOST:
                return False  # an operator request already stands
        anns[ANN_CORDON] = json.dumps(
            {"reason": reason, "at": time.time()})
        return True

    return mutate_with_retry(client, "Node", node, "", mutate)


def clear_cordon_request(client, node: str) -> bool:
    """Remove the cordon annotation — the node-side controller uncordons
    (taints cleared in one republish) on its next poll."""
    def mutate(obj: dict) -> bool:
        anns = obj["metadata"].get("annotations") or {}
        if ANN_CORDON not in anns:
            return False
        anns.pop(ANN_CORDON, None)
        obj["metadata"]["annotations"] = anns
        return True

    return mutate_with_retry(client, "Node", node, "", mutate)


def cordon_annotation(client, node: str) -> Optional[dict]:
    """The parsed cordon annotation on the Node, or None."""
    obj = client.try_get("Node", node)
    if obj is None:
        return None
    raw = (obj["metadata"].get("annotations") or {}).get(ANN_CORDON)
    if not raw:
        return None
    try:
        doc = json.loads(raw)
        return doc if isinstance(doc, dict) else {"reason": str(raw)}
    except (ValueError, TypeError):
        return {"reason": str(raw)}


def scraper_staleness_signal(scraper) -> Callable[[str], bool]:
    """Adapt a metrics scraper (anything with ``target_report()`` rows of
    ``name`` and ``stale``, as the JAX package's ``FleetScraper`` has) into
    the lifecycle controller's corroborating node-lost signal: True when
    the node's metrics target is staleness-marked. Target names must equal
    node names. Corroborating only — the controller never cordons on this
    alone."""
    def stale(node: str) -> bool:
        for t in scraper.target_report():
            if t.get("name") == node:
                return bool(t.get("stale"))
        return False

    return stale


# --------------------------------------------------------------------------
# Cluster side: node lifecycle controller
# --------------------------------------------------------------------------

@dataclass
class _NodeState:
    cordoned: bool = False
    fenced_at: float = 0.0          # monotonic, for gpu_dra_node_fence_seconds
    repair_needed: bool = False
    epoch_at_cordon: int = 0
    pools: set = field(default_factory=set)


class NodeLifecycleController:
    """Watches node leases; runs fence → cordon → drain-annotate →
    repair → uncordon for nodes whose heartbeat went dark.

    ``scrape_stale(node) -> bool``: optional corroborating signal (the
    metrics scraper's staleness marking) — when BOTH the lease is
    expired and the scrape target is dark, detection tightens from
    ``lost_factor`` to ``corroborated_factor`` lease durations. Never
    sufficient alone: a fresh lease is never cordoned.

    ``canary_failing(node) -> bool``: the SECOND corroborating signal
    (docs/observability.md, "Synthetic probing"): the canary prober's
    verdict that the node's recent end-to-end probes all failed. Same
    contract exactly — corroborating, never sufficient alone: a node
    whose probes fail while its lease still renews is never cordoned.

    ``repair(node) -> bool``: optional whole-node repair hook, called
    once per cordon until it returns truthy (simulated in tests:
    node-wide GPU heal + boot-id flip + stack restart; production:
    external — the controller just waits for the lease to renew again).

    Every write is idempotent and individually retried; a poll that dies
    mid-cordon simply re-runs the remaining steps next poll.
    """

    def __init__(
        self,
        client,
        namespace: str = LEASE_NAMESPACE,
        poll_interval: float = 1.0,
        lost_factor: float = DEFAULT_LOST_FACTOR,
        corroborated_factor: float = DEFAULT_CORROBORATED_FACTOR,
        scrape_stale: Optional[Callable[[str], bool]] = None,
        canary_failing: Optional[Callable[[str], bool]] = None,
        repair: Optional[Callable[[str], bool]] = None,
        events: Optional[EventRecorder] = None,
        metrics: Optional[NodeMetrics] = None,
        clock: Callable[[], float] = time.time,
        shard_gate=None,
    ):
        self.client = client
        self.namespace = namespace
        # Active-active sharding (sharding.ShardGate): a gated replica
        # steps only the nodes whose shard it confidently owns (keyed on
        # the node name — node leases have no namespace of their own).
        self.shard_gate = shard_gate
        self.poll_interval = poll_interval
        self.lost_factor = lost_factor
        # "Corroborating, never sufficient alone": the tightened factor
        # still demands at least one full lease duration of silence.
        self.corroborated_factor = max(1.0, corroborated_factor)
        self.scrape_stale = scrape_stale
        self.canary_failing = canary_failing
        self.repair = repair
        self.events = events or EventRecorder(client, "node-lifecycle")
        self.metrics = metrics or default_node_metrics()
        self.clock = clock
        self._nodes: dict[str, _NodeState] = {}
        #: (node, monotonic t) logs for harness oracles / detection math.
        self.cordons: list[tuple[str, float]] = []
        self.uncordons: list[tuple[str, float]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _live_lifecycles.add(self)

    # -- introspection -------------------------------------------------------

    def cordoned_nodes(self) -> list[str]:
        return sorted(n for n, st in self._nodes.items() if st.cordoned)

    def _node_ref(self, node: str) -> dict:
        return {"apiVersion": "v1", "kind": "Node", "name": node,
                "namespace": "", "uid": ""}

    # -- one poll (exposed for deterministic tests) --------------------------

    def poll_once(self) -> dict[str, int]:
        counts = {"cordoned": 0, "uncordoned": 0}
        try:
            leases = self.client.list(KIND_LEASE, self.namespace)
        except Exception:  # noqa: BLE001 — transient: retry next poll
            logger.warning("node-lease list failed; retrying next poll",
                           exc_info=True)
            return counts
        for lease in leases:
            spec = lease.get("spec") or {}
            node = spec.get("holderIdentity", "")
            if not node:
                name = lease.get("metadata", {}).get("name", "")
                node = name[len("node-"):] if name.startswith("node-") else ""
            if not node:
                continue
            if self.shard_gate is not None and not self.shard_gate.admit(
                    "node", node, "lifecycle"):
                continue  # another replica owns this node's shard
            try:
                self._step(node, spec, counts)
            except Exception:  # noqa: BLE001 — idempotent: next poll
                # replays whatever step failed.
                logger.exception("node lifecycle step for %s failed this "
                                 "poll; retrying", node)
        return counts

    def _step(self, node: str, spec: dict, counts: dict[str, int]) -> None:
        duration = float(spec.get("leaseDurationSeconds",
                                  DEFAULT_LEASE_DURATION) or
                         DEFAULT_LEASE_DURATION)
        try:
            renew = float(spec.get("renewTime", 0) or 0)
        except (TypeError, ValueError):
            renew = 0.0
        # Clock-skew tolerance: a renewTime ahead of our clock reads as
        # "renewed just now", never as negative age or instant expiry.
        age = max(0.0, self.clock() - renew)
        st = self._nodes.get(node)
        if st is None:
            st = self._nodes.setdefault(node, _NodeState())
            # Crash recovery: this controller's only state is in-memory,
            # but the cordon itself is durable cluster state. A node
            # first seen with a FRESH lease that still carries a fence
            # or a node-lost annotation was cordoned by a previous
            # controller incarnation and is now healing — adopt it so
            # the uncordon half runs instead of orphaning the cordon.
            # (An EXPIRED lease needs no adoption: the normal path
            # re-runs the idempotent cordon, completing any partial
            # previous attempt.)
            if age <= duration and self._observed_cordoned(node, spec):
                st.cordoned = True
                st.fenced_at = time.monotonic()
                st.epoch_at_cordon = int(spec.get("fencedEpoch", 0) or 0)
                logger.info("adopted existing cordon of %s after a "
                            "controller restart", node)
        if not st.cordoned:
            factor = self.lost_factor
            if self._corroborated(node):
                factor = self.corroborated_factor
            if age > duration * factor:
                self._cordon(node, spec, st,
                             corroborated=factor != self.lost_factor)
                counts["cordoned"] += 1
            return
        # Cordoned: drive repair, then watch for rejoin.
        if st.repair_needed and self.repair is not None:
            try:
                if self.repair(node):
                    st.repair_needed = False
            except Exception:  # noqa: BLE001 — retried next poll
                logger.exception("node repair hook failed for %s", node)
        fenced = "fencedEpoch" in spec
        if age <= duration and not fenced:
            # Lease renewing again AND the plugin cleared its fence
            # (cleanup done): the node earned its devices back.
            self._uncordon(node, st)
            counts["uncordoned"] += 1

    def _observed_cordoned(self, node: str, spec: dict) -> bool:
        """Whether durable cluster state says a previous controller
        cordoned this node: a fence on the lease, or a node-lost cordon
        annotation (the fence may already be plugin-cleared)."""
        if "fencedEpoch" in spec:
            return True
        try:
            ann = cordon_annotation(self.client, node)
        except Exception:  # noqa: BLE001 — retried next poll
            return False
        return ann is not None and ann.get("reason") == CORDON_NODE_LOST

    def _corroborated(self, node: str) -> bool:
        """Whether any corroborating node-lost signal agrees the node is
        dark — metrics-scrape staleness or the canary probe verdict.
        Either tightens detection to ``corroborated_factor``; neither
        can cordon a node whose lease still renews. A crashing signal is
        ignored (it must not change detection semantics)."""
        for label, signal in (("scrape-staleness", self.scrape_stale),
                              ("canary-probe", self.canary_failing)):
            if signal is None:
                continue
            try:
                if signal(node):
                    return True
            except Exception:  # noqa: BLE001 — a broken corroborator
                # must not change detection semantics.
                logger.exception("%s signal failed for %s; using the "
                                 "uncorroborated factor", label, node)
        return False

    # -- cordon pipeline -----------------------------------------------------

    def _cordon(self, node: str, spec: dict, st: _NodeState,
                corroborated: bool = False) -> None:
        epoch = int(spec.get("nodeEpoch", 0) or 0)
        logger.warning("node %s LOST (no lease renewal; epoch %d%s): "
                       "fencing + cordoning", node, epoch,
                       ", scrape-corroborated" if corroborated else "")
        # 1. Fence: stamp the epoch we are abandoning onto the lease so
        # the returning plugin knows claims may have moved under it. A
        # fence already present (double-cordon, crashed previous poll)
        # is kept as-is — idempotent.
        self._stamp_fence(node, epoch)
        # 2. Cordon: taint every device of the node's slices in one
        # update per slice, and collect the pool names for step 3.
        pools = self._cordon_slices(node)
        st.pools = pools
        # 3. Node-scope annotation + Event.
        self._annotate_node(node, epoch)
        # 4. Hand every claim allocated there to the reallocator.
        drained = self._annotate_claims(node, pools)
        st.cordoned = True
        st.fenced_at = time.monotonic()
        st.epoch_at_cordon = epoch
        st.repair_needed = self.repair is not None
        self.cordons.append((node, time.monotonic()))
        self.metrics.cordons_total.inc(reason=CORDON_NODE_LOST)
        self.events.event_for_ref(
            self._node_ref(node), REASON_NODE_CORDONED,
            f"node {node} cordoned: lease expired (epoch {epoch}); "
            f"{len(pools)} pool(s) tainted, {drained} claim(s) handed to "
            "the reallocator", TYPE_WARNING)

    def _stamp_fence(self, node: str, epoch: int) -> None:
        stamped = [False]

        def mutate(lease: dict) -> bool:
            spec = lease.setdefault("spec", {})
            if "fencedEpoch" in spec:
                return False  # already fenced: keep the original stamp
            spec["fencedEpoch"] = epoch
            # Every identity that was co-renewing this lease held state
            # on the node and must ack its own cleanup before the fence
            # clears — the first plugin back must not unfence its
            # sibling's still-dirty checkpoints.
            renewers = sorted(spec.get("renewers") or {})
            if renewers:
                spec["fencedIdentities"] = renewers
            stamped[0] = True
            return True

        if not mutate_with_retry(self.client, KIND_LEASE,
                                  node_lease_name(node), self.namespace,
                                  mutate):
            raise RuntimeError(f"could not stamp fence on {node}'s lease")
        if stamped[0]:
            self.events.event_for_ref(
                self._node_ref(node), REASON_NODE_FENCED,
                f"node {node} fenced at epoch {epoch}: its plugins must "
                "clean up moved claims before serving again", TYPE_WARNING)

    def _cordon_slices(self, node: str) -> set:
        """Taint every device of every ResourceSlice on ``node`` (skip
        already-tainted — idempotent) and return the pool names."""
        pools: set = {node}
        for slc in self.client.list("ResourceSlice"):
            spec = slc.get("spec") or {}
            if spec.get("nodeName") != node:
                continue
            pools.add((spec.get("pool") or {}).get("name") or node)
            name = slc["metadata"]["name"]

            def mutate(obj: dict) -> bool:
                changed = False
                for dev in (obj.get("spec") or {}).get("devices") or []:
                    taints = dev.setdefault("taints", [])
                    if not any(t.get("key") == TAINT_KEY_CORDON
                               for t in taints):
                        taints.append({"key": TAINT_KEY_CORDON,
                                       "value": CORDON_NODE_LOST,
                                       "effect": "NoSchedule"})
                        changed = True
                return changed

            if not mutate_with_retry(self.client, "ResourceSlice",
                                      name, "", mutate):
                raise RuntimeError(f"could not cordon slice {name}")
        return pools

    def _annotate_node(self, node: str, epoch: int) -> None:
        def mutate(obj: dict) -> bool:
            anns = obj["metadata"].setdefault("annotations", {})
            if ANN_CORDON in anns:
                return False  # idempotent double-cordon
            anns[ANN_CORDON] = json.dumps(
                {"reason": CORDON_NODE_LOST, "at": time.time(),
                 "epoch": epoch})
            return True

        # A Node object may not exist in minimal assemblies — the cordon
        # still proceeds through the slice taints and claim annotations.
        mutate_with_retry(self.client, "Node", node, "", mutate)

    def _annotate_claims(self, node: str, pools: Iterable[str]) -> int:
        """Mark every claim allocated on the node for reallocation (the
        same ``gpu.nvidia.com/drain`` record the per-device drain
        writes), so the existing ClaimReallocator releases and re-binds
        them. Returns how many claims were (newly or already) marked."""
        # Lazy import: remediation imports this module for the cordon
        # constants; the annotation contract lives there.
        from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
            ANN_DRAIN,
            ANN_DRAIN_FAILED,
        )
        from k8s_dra_driver_tpu_torch.kubeletplugin.types import (
            claim_allocation_results,
        )

        pool_set = set(pools)
        marked = 0
        for claim in self.client.list("ResourceClaim"):
            results = claim_allocation_results(claim)
            if not any(r.get("pool") in pool_set for r in results):
                continue
            meta = claim["metadata"]
            marked += 1
            value = json.dumps({"node": node, "device": "<node>",
                                "reason": "node lost", "at": time.time()})

            def mutate(obj: dict) -> bool:
                anns = obj["metadata"].setdefault("annotations", {})
                if anns.get(ANN_DRAIN) or anns.get(ANN_DRAIN_FAILED):
                    return False
                anns[ANN_DRAIN] = value
                return True

            if not mutate_with_retry(self.client, "ResourceClaim",
                                      meta.get("name", ""),
                                      meta.get("namespace", ""), mutate):
                raise RuntimeError(
                    f"could not mark claim {meta.get('name')} for "
                    "reallocation")
        return marked

    # -- uncordon ------------------------------------------------------------

    def _uncordon(self, node: str, st: _NodeState) -> None:
        for slc in self.client.list("ResourceSlice"):
            spec = slc.get("spec") or {}
            if spec.get("nodeName") != node:
                continue
            name = slc["metadata"]["name"]

            def mutate(obj: dict) -> bool:
                changed = False
                for dev in (obj.get("spec") or {}).get("devices") or []:
                    taints = dev.get("taints") or []
                    kept = [t for t in taints
                            if t.get("key") != TAINT_KEY_CORDON]
                    if len(kept) != len(taints):
                        if kept:
                            dev["taints"] = kept
                        else:
                            dev.pop("taints", None)
                        changed = True
                return changed

            if not mutate_with_retry(self.client, "ResourceSlice",
                                      name, "", mutate):
                raise RuntimeError(f"could not uncordon slice {name}")

        def unannotate(obj: dict) -> bool:
            anns = obj["metadata"].get("annotations") or {}
            raw = anns.get(ANN_CORDON)
            if not raw:
                return False
            try:
                reason = (json.loads(raw) or {}).get("reason")
            except (ValueError, TypeError):
                reason = None
            if reason != CORDON_NODE_LOST:
                # An operator's standing voluntary cordon (request_cordon
                # preceded the node loss, so _annotate_node kept it): the
                # lifecycle controller must not erase explicit operator
                # intent — the node-side drain controller keeps honoring
                # it after the rejoin.
                return False
            anns.pop(ANN_CORDON, None)
            obj["metadata"]["annotations"] = anns
            return True

        mutate_with_retry(self.client, "Node", node, "", unannotate)
        dt = time.monotonic() - st.fenced_at
        st.cordoned = False
        st.repair_needed = False
        self.uncordons.append((node, time.monotonic()))
        self.metrics.fence_seconds.observe(dt, node=node)
        self.events.event_for_ref(
            self._node_ref(node), REASON_NODE_UNCORDONED,
            f"node {node} uncordoned after {dt:.2f}s: lease renewing and "
            "fence cleared — devices rejoined", TYPE_NORMAL)
        logger.info("node %s uncordoned after %.2fs", node, dt)

    # -- loop ----------------------------------------------------------------

    def start(self) -> "NodeLifecycleController":
        self._thread = threading.Thread(
            target=self._run, name="node-lifecycle", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the loop must never die
                logger.exception("node lifecycle poll crashed; continuing")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
