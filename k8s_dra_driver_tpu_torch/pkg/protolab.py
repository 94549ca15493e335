"""protolab — bounded explicit-state model checking of the coordination
protocols.

racelab explores interleavings at the lock level and crashlab explores
crash points at the durability level; this module is the rung between
them: the small-scope model-checking
discipline TLA+/Stateright apply to production coordination code,
pointed at the REAL protocol implementations — not hand-written
abstractions of them:

- ``elector``   — :class:`LeaderElector` acquire / renew / step-down
  (plugins/compute_domain_controller/election.py).
- ``fence_ack`` — :class:`NodeLeaseHeartbeat` epoch bump + per-identity
  fence ack against the lifecycle controller's fence stamp
  (pkg/nodelease.py).
- ``lifecycle`` — :class:`NodeLifecycleController` fence → cordon →
  drain-annotate → repair → uncordon (pkg/nodelease.py).
- ``shard_map`` — :class:`ShardMap`: the
  elector generalized to lease-claimed shard ownership
  (pkg/shardmap.py).

Each model wraps the real classes in a tiny universe (the existing
FakeClient + a logical clock injected through the classes' own
``clock`` parameters) and exposes atomic ACTIONS — one actor step, a
clock advance past expiry, actor crash+restart (epoch bump), a
PartitionGate partition/heal. The explorer then enumerates ALL action
interleavings breadth-first with state-hash dedup, under counted
depth/state caps (the crashlab discipline: a hit cap fails
``coverage_ok`` — capped exploration never reads as complete).

Safety oracles, checked at every explored state:

- ``single_leader`` — at most one elector simultaneously inside its
  believe-window (``is_leader`` and last renew within its OWN
  ``renew_deadline``). This is the client-go contract: a candidate may
  act as leader without re-checking until the renew deadline lapses, so
  safety REQUIRES ``renew_deadline < lease_duration`` — which is
  exactly what the ``zombie_leader`` planted config violates.
- ``single_owner`` — the same, per shard: no two ShardMap instances
  both confident they own shard S (zero double-reconcile).
- ``fence_acked`` — the fence never leaves the lease while any stamped
  identity still has un-acked cleanup (dirty checkpoint state).
- ``epoch_monotone`` — a restarted heartbeat's node epoch strictly
  exceeds its pre-crash epoch; the lease's ``nodeEpoch`` never
  regresses.
- ``uncordon_gate`` — the lifecycle controller never uncordons a node
  whose lease is still expired or still fenced (the renewal-less
  cordon/uncordon oscillation hazard).

Liveness-under-fairness is checked as bounded reachability: from every
explored state, a fair crash-free continuation (heal all partitions,
then round-robin the live actors with clock advances) must reach the
model's converged state — single owner everywhere, fence clear, node
uncordoned — within ``k`` rounds.

Violations carry a greedily 1-minimized counterexample trace, also
emitted in the seeded-schedule decision-log dialect racelab's
``ScheduleFuzzer`` speaks (sorted ``(point, hit#, action)`` tuples), so
a found trace is immediately a deterministic regression schedule —
``internal/stresslab.py`` replays them through the racelab harness.

Everything is deterministic: exploration is systematic (the ``seed``
parameter tags emitted schedules and logs for downstream seeded-
schedule consumers; it does not randomize the search), universes use a
logical clock, and verdict logs contain no wall times, uids, or paths —
same seed + same model ⇒ byte-identical sorted verdict log, proven by
the double-run in :func:`run_proto_smoke`.
"""

from __future__ import annotations

import json
import logging
import time
from collections import deque
from typing import Callable, Iterable, Optional

from k8s_dra_driver_tpu_torch.k8sclient.client import (
    AlreadyExistsError,
    ConflictError,
    FakeClient,
    NotFoundError,
    PartitionGate,
    PartitionedClient,
    new_object,
)
from k8s_dra_driver_tpu_torch.pkg.nodelease import (
    LEASE_NAMESPACE,
    NodeLeaseHeartbeat,
    NodeLifecycleController,
    mutate_with_retry,
    node_lease_name,
)
from k8s_dra_driver_tpu_torch.pkg.shardmap import (
    ShardMap,
    member_lease_name,
    shard_lease_name,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.election import (
    LeaderElector,
)

logger = logging.getLogger(__name__)

KIND_LEASE = "Lease"

#: The model registry: keep it a plain dict literal. ``module`` is the
#: repo-relative implementation file a model lifts; ``transitions`` is
#: every protocol transition the bounded exploration must reach at least
#: once (an unreached entry is enumeration drift and fails
#: ``coverage_ok``).
PROTOCOL_MODELS = {
    "elector": {
        "module":
            "k8s_dra_driver_tpu_torch/plugins/compute_domain_controller/election.py",
        "transitions": ("acquire", "renew", "expire", "step_down", "release",
                        "crash", "restart", "partition", "heal"),
    },
    "fence_ack": {
        "module": "k8s_dra_driver_tpu_torch/pkg/nodelease.py",
        "transitions": ("renew", "stamp_fence", "cleanup_ack", "fence_clear",
                        "crash", "restart", "partition", "heal"),
    },
    "lifecycle": {
        "module": "k8s_dra_driver_tpu_torch/pkg/nodelease.py",
        "transitions": ("renew", "cordon", "drain_annotate", "repair",
                        "cleanup_ack", "fence_clear", "uncordon",
                        "crash", "restart", "partition", "heal"),
    },
    "shard_map": {
        "module": "k8s_dra_driver_tpu_torch/pkg/shardmap.py",
        "transitions": ("acquire", "renew", "step_down", "release",
                        "crash", "restart", "partition", "heal"),
    },
    "shard_rebalance": {
        "module": "k8s_dra_driver_tpu_torch/pkg/shardmap.py",
        "transitions": ("join", "leave", "acquire", "takeover", "renew",
                        "handoff", "hysteresis_defer"),
    },
}

#: Planted-violation corpus: each flag re-introduces a plausible (or
#: historically real — see ``fence_clear_unconditional``, the fence's
#: first cut) protocol bug inside the MODEL layer only, gated at 100%
#: detection with a minimal, replayable counterexample. ``oracle`` is
#: the violation-line prefix the plant must trip.
PLANTED_VIOLATIONS = {
    "zombie_leader": {"model": "elector", "oracle": "single_leader"},
    "shard_overclaim": {"model": "shard_map", "oracle": "single_owner"},
    "fence_clear_unconditional": {"model": "fence_ack",
                                  "oracle": "fence_acked"},
    "shared_fence_single_ack": {"model": "fence_ack",
                                "oracle": "fence_acked"},
    "epoch_reuse": {"model": "fence_ack", "oracle": "epoch_monotone"},
    "lifecycle_eager_uncordon": {"model": "lifecycle",
                                 "oracle": "uncordon_gate"},
    "rebalance_storm": {"model": "shard_rebalance",
                        "oracle": "rebalance_storm"},
}

#: (max BFS depth, max deduped states) per model — small scopes, tuned
#: so the full reachable space fits WELL under the caps (a full run
#: requires zero cap hits) while a whole-registry run stays seconds-scale.
_DEFAULT_BOUNDS = {
    "elector": (20, 6000),
    "fence_ack": (20, 6000),
    "lifecycle": (18, 4000),
    "shard_map": (16, 6000),
    "shard_rebalance": (26, 8000),
}

_DEFAULT_K_LIVENESS = 6


# --------------------------------------------------------------------------
# Planted implementations (test-only; never imported by product code)
# --------------------------------------------------------------------------

class _UnconditionalClearHeartbeat(NodeLeaseHeartbeat):
    """The fence's first-cut bug, re-introduced for the corpus: observing
    a fence clears it immediately and unconditionally — no cleanup, no
    per-identity ack — so stale checkpoints survive unfenced."""

    def _observe_fence(self, spec: dict) -> None:
        if "fencedEpoch" in spec:
            self.clear_fence()
        with self._mu:
            self._fenced = False


class _SingleAckHeartbeat(NodeLeaseHeartbeat):
    """The shared-fence-single-ack bug: this plugin's ack removes the
    WHOLE fence after its own cleanup, unfencing its sibling's
    still-dirty checkpoints."""

    def ack_fence(self) -> bool:
        def mutate(lease: dict) -> bool:
            spec = lease.setdefault("spec", {})
            if "fencedEpoch" not in spec and "fencedIdentities" not in spec:
                return False
            spec.pop("fencedEpoch", None)
            spec.pop("fencedIdentities", None)
            return True

        return mutate_with_retry(self.client, KIND_LEASE, self.lease_name,
                                 self.namespace, mutate)


class _EagerUncordonLifecycle(NodeLifecycleController):
    """Misreads "fence cleared" alone as "node healthy": uncordons a
    cordoned node the moment the fence is gone, without requiring the
    lease to renew — re-cordoned next poll, oscillating with no renewal
    in between."""

    def _step(self, node: str, spec: dict, counts: dict[str, int]) -> None:
        st = self._nodes.get(node)
        if (st is not None and st.cordoned
                and "fencedEpoch" not in (spec or {})):
            self._uncordon(node, st)
            counts["uncordoned"] += 1
            return
        super()._step(node, spec, counts)


class _OverclaimElector(LeaderElector):
    """Acquires from a stale read: skips the live-holder expiry check,
    so it steals a shard whose owner is still inside its believe
    window — the double-reconcile bug ShardMap exists to prevent."""

    def try_acquire_or_renew(self) -> bool:
        self._lost_to = None
        lease = self.client.try_get(KIND_LEASE, self.lease_name,
                                    self.namespace)
        if lease is None:
            obj = new_object(KIND_LEASE, self.lease_name, self.namespace,
                             api_version="coordination.k8s.io/v1",
                             spec=self._spec(acquisitions=1))
            try:
                self.client.create(obj)
                return True
            except AlreadyExistsError:
                return False
        spec = lease.get("spec") or {}
        transitions = int(spec.get("leaseTransitions", 0))
        if spec.get("holderIdentity") != self.identity:
            transitions += 1
        lease["spec"] = self._spec(transitions)
        try:
            self.client.update(lease)
            return True
        except (ConflictError, NotFoundError):
            return False


class _StormShardMap(ShardMap):
    """Rebalances without the hysteresis window: sheds EVERY
    over-fair-share shard the moment the census shifts — a replica
    joining a loaded fleet triggers a handoff storm instead of a
    bounded trickle."""

    def __init__(self, *args, **kwargs):
        kwargs["rebalance_max_handoffs"] = 10 ** 6
        super().__init__(*args, **kwargs)


# --------------------------------------------------------------------------
# Universes: one tiny deterministic world per model
# --------------------------------------------------------------------------

def _age_bucket(now: float, then: float, quantum: float, cap: int) -> int:
    return min(int(max(0.0, now - then) // quantum), cap)


class _Universe:
    """Shared plumbing: FakeClient + PartitionGate + a logical clock
    injected through the real classes' ``clock`` parameters. Subclasses
    define actions (total: an infeasible action is a no-op, so any
    subsequence of a trace replays cleanly during minimization)."""

    quantum = 4.0

    def __init__(self, planted: frozenset = frozenset()):
        self.planted = planted
        self.fake = FakeClient()
        self.gate = PartitionGate()
        self.now = 1000.0
        # Violations raised by an action itself (e.g. an epoch-bump
        # contract breach at restart) rather than by a state predicate.
        self._action_violations: list[str] = []

    def _clock(self) -> float:
        return self.now

    def _lease_spec(self, name: str, namespace: str) -> Optional[dict]:
        lease = self.fake.try_get(KIND_LEASE, name, namespace)
        return None if lease is None else (lease.get("spec") or {})

    # subclass surface --------------------------------------------------------

    def apply(self, action: str) -> set:
        raise NotImplementedError

    def enabled(self) -> list:
        raise NotImplementedError

    def state_key(self) -> tuple:
        raise NotImplementedError

    def check(self) -> list:
        raise NotImplementedError

    def converged(self) -> bool:
        raise NotImplementedError

    def fair_actions(self) -> list:
        raise NotImplementedError

    def any_partitioned(self) -> bool:
        return bool(getattr(self.gate, "_partitioned", None))


class _ElectorUniverse(_Universe):
    """Two candidates racing for one lease. Scope (documented, not a
    cap): only candidate A crashes/partitions/releases — the protocol
    is symmetric, so one asymmetric aggressor explores every distinct
    behavior class at a fraction of the state count."""

    A, B = "cand-a", "cand-b"
    LEASE = "proto-controller"
    NS = "default"
    DURATION = 10.0
    DEADLINE = 6.0
    quantum = 4.0

    def __init__(self, planted: frozenset = frozenset()):
        super().__init__(planted)
        # zombie_leader: renew_deadline ABOVE lease_duration — the one
        # config constraint client-go safety rests on, inverted.
        self.deadline = 14.0 if "zombie_leader" in planted else self.DEADLINE
        self.electors: dict[str, LeaderElector] = {}
        self.crash_budget = {self.A: 1}
        self.part_budget = {self.A: 1}
        for name in (self.A, self.B):
            self.electors[name] = self._mk_elector(name)

    def _mk_elector(self, name: str) -> LeaderElector:
        return LeaderElector(
            PartitionedClient(self.fake, name, self.gate),
            self.LEASE, name, namespace=self.NS,
            lease_duration=self.DURATION, renew_deadline=self.deadline,
            clock=self._clock)

    def apply(self, action: str) -> set:
        if action == "advance":
            self.now += self.quantum
            return set()
        if action == "heal":
            if not self.any_partitioned():
                return set()
            self.gate.heal()
            return {"heal"}
        verb, _, who = action.partition(":")
        if verb == "round":
            e = self.electors[who]
            was = e.is_leader
            spec = self._lease_spec(self.LEASE, self.NS)
            stale = (spec is not None and spec.get("holderIdentity")
                     and spec.get("holderIdentity") != who
                     and self.now - float(spec.get("renewTime", 0))
                     > float(spec.get("leaseDurationSeconds", self.DURATION)))
            e.run_once()
            if e.is_leader and not was:
                return {"acquire", "expire"} if stale else {"acquire"}
            if e.is_leader:
                return {"renew"}
            if was:
                return {"step_down"}
            return set()
        if verb == "crash":
            if self.crash_budget.get(who, 0) <= 0:
                return set()
            self.crash_budget[who] -= 1
            self.electors[who] = self._mk_elector(who)
            return {"crash", "restart"}
        if verb == "partition":
            if self.part_budget.get(who, 0) <= 0:
                return set()
            self.part_budget[who] -= 1
            self.gate.partition(who)
            return {"partition"}
        if verb == "release":
            e = self.electors[who]
            if not e.is_leader:
                return set()
            try:
                e.stop()
            except Exception:  # noqa: BLE001 — partitioned mid-release:
                return set()  # stepped down locally, lease not emptied
            return {"release"}
        return set()

    def enabled(self) -> list:
        acts = [f"round:{self.A}", f"round:{self.B}", "advance"]
        if self.crash_budget.get(self.A, 0) > 0:
            acts.append(f"crash:{self.A}")
        if (self.part_budget.get(self.A, 0) > 0
                and not self.gate.is_partitioned(self.A)):
            acts.append(f"partition:{self.A}")
        if self.any_partitioned():
            acts.append("heal")
        if (self.electors[self.A].is_leader
                and not self.gate.is_partitioned(self.A)):
            acts.append(f"release:{self.A}")
        return sorted(acts)

    def state_key(self) -> tuple:
        spec = self._lease_spec(self.LEASE, self.NS)
        lease_k = None
        if spec is not None:
            lease_k = (spec.get("holderIdentity", ""),
                       _age_bucket(self.now,
                                   float(spec.get("renewTime", 0)),
                                   self.quantum, 5))
        cands = tuple(
            (name, e.is_leader,
             _age_bucket(self.now, e.last_renew, self.quantum, 5)
             if e.is_leader else -1,
             self.crash_budget.get(name, 0), self.part_budget.get(name, 0),
             self.gate.is_partitioned(name))
            for name, e in sorted(self.electors.items()))
        return ("elector", lease_k, cands)

    def _valid_leaders(self) -> list:
        return sorted(
            name for name, e in self.electors.items()
            if e.is_leader and self.now - e.last_renew <= e.renew_deadline)

    def check(self) -> list:
        out = list(self._action_violations)
        valid = self._valid_leaders()
        if len(valid) > 1:
            out.append(
                f"single_leader: {','.join(valid)} simultaneously inside "
                "their renew windows (split brain)")
        return out

    def converged(self) -> bool:
        return len(self._valid_leaders()) == 1

    def fair_actions(self) -> list:
        return [f"round:{self.A}", f"round:{self.B}", "advance"]


class _FenceMixin:
    """Dirty-checkpoint bookkeeping shared by the fence_ack and
    lifecycle universes: an identity becomes dirty the instant a fence
    stamps it (its claims may move while fenced) and clean only when
    its OWN cleanup hook runs. The ``fence_acked`` oracle then states
    the whole protocol: no fence off the lease while anyone is dirty."""

    def _init_fence(self, node: str, identities: Iterable[str]) -> None:
        self.node = node
        self.lease = node_lease_name(node)
        self.identities = tuple(identities)
        self.dirty: dict[str, bool] = {i: False for i in self.identities}
        self.epochs: dict[str, int] = {i: 1 for i in self.identities}
        self.hbs: dict[str, NodeLeaseHeartbeat] = {}
        self._max_lease_epoch = 0

    def _cleanup_for(self, ident: str) -> Callable[[], None]:
        def cleanup() -> None:
            self.dirty[ident] = False
        return cleanup

    def _hb_class(self, ident: str) -> type:
        if ident == self.identities[0]:
            if "fence_clear_unconditional" in self.planted:
                return _UnconditionalClearHeartbeat
            if "shared_fence_single_ack" in self.planted:
                return _SingleAckHeartbeat
        return NodeLeaseHeartbeat

    def _mk_hb(self, ident: str) -> NodeLeaseHeartbeat:
        hb = self._hb_class(ident)(
            PartitionedClient(self.fake, self.node, self.gate),
            self.node, lease_duration=10.0,
            fence_cleanup=self._cleanup_for(ident), identity=ident,
            clock=self._clock)
        # The persisted-epoch contract (next_node_epoch: +1 on every
        # process start) is exercised at the durability layer by
        # crashlab; here the bump is modeled so the PROTOCOL
        # consequences — lease nodeEpoch monotone via the real adoption
        # path, fences surviving restarts — run through the real code
        # without disk I/O. The epoch_reuse plant withholds the bump.
        hb.epoch = self.epochs[ident]
        return hb

    def _renew(self, ident: str) -> set:
        hb = self.hbs[ident]
        before = self._lease_spec(self.lease, LEASE_NAMESPACE) or {}
        recoveries = hb.fence_recoveries
        try:
            ok = hb.renew_once()
        except Exception:  # noqa: BLE001 — partitioned: the lease ages
            return set()
        if not ok:
            return set()
        self.epochs[ident] = hb.epoch  # adoption may have raised it
        labels = {"renew"}
        after = self._lease_spec(self.lease, LEASE_NAMESPACE) or {}
        if hb.fence_recoveries > recoveries:
            labels.add("cleanup_ack")
        if "fencedEpoch" in before and "fencedEpoch" not in after:
            labels.add("fence_clear")
        self._track_fence(before, after)
        return labels

    def _crash(self, ident: str) -> set:
        hb = self.hbs[ident]
        pre = hb.epoch
        if "epoch_reuse" in self.planted:
            self.epochs[ident] = pre  # the withheld bump
        else:
            self.epochs[ident] = pre + 1
        self.hbs[ident] = self._mk_hb(ident)
        if self.hbs[ident].epoch <= pre:
            self._action_violations.append(
                f"epoch_monotone: {ident} restarted with node epoch "
                f"{self.hbs[ident].epoch}, not past its pre-crash epoch "
                f"{pre}")
        # NOTE self.dirty untouched: stale checkpoints survive restarts,
        # which is exactly why the fence must too.
        return {"crash", "restart"}

    def _track_fence(self, before: dict, after: dict) -> None:
        if "fencedEpoch" in after and "fencedEpoch" not in before:
            for ident in after.get("fencedIdentities") or self.identities:
                if ident in self.dirty:
                    self.dirty[ident] = True

    def _fence_oracle(self) -> list:
        out = []
        spec = self._lease_spec(self.lease, LEASE_NAMESPACE)
        if spec is not None:
            if "fencedEpoch" not in spec:
                pending = sorted(i for i, d in self.dirty.items() if d)
                if pending:
                    out.append(
                        "fence_acked: fence cleared while "
                        f"{','.join(pending)} still had un-acked cleanup")
            epoch = int(spec.get("nodeEpoch", 0) or 0)
            if epoch < self._max_lease_epoch:
                out.append(
                    f"epoch_monotone: lease nodeEpoch regressed "
                    f"{self._max_lease_epoch} -> {epoch}")
            self._max_lease_epoch = max(self._max_lease_epoch, epoch)
        return out

    def _hb_key(self) -> tuple:
        return tuple(
            (i, hb.epoch, hb.fenced,
             _age_bucket(self.now, hb._last_success, self.quantum, 3),
             self.dirty[i])
            for i, hb in sorted(self.hbs.items()))


class _FenceAckUniverse(_FenceMixin, _Universe):
    """Two plugin identities co-renewing one node lease; the fence
    stamped by the real controller code (``_stamp_fence``); crash,
    node partition, and renewal delay as nondeterminism."""

    quantum = 6.0

    def __init__(self, planted: frozenset = frozenset()):
        super().__init__(planted)
        self._init_fence("n9", ("gpu-plugin", "cd-plugin"))
        self.lc = NodeLifecycleController(self.fake, clock=self._clock)
        self.crash_budget = 1
        self.part_budget = 1
        for ident in self.identities:
            self.hbs[ident] = self._mk_hb(ident)

    def apply(self, action: str) -> set:
        if action == "advance":
            self.now += self.quantum
            return set()
        if action == "stamp":
            spec = self._lease_spec(self.lease, LEASE_NAMESPACE)
            if spec is None or "fencedEpoch" in spec:
                return set()
            before = dict(spec)
            self.lc._stamp_fence(self.node,
                                 int(spec.get("nodeEpoch", 0) or 0))
            after = self._lease_spec(self.lease, LEASE_NAMESPACE) or {}
            self._track_fence(before, after)
            return {"stamp_fence"}
        if action == "partition":
            if self.part_budget <= 0 or self.any_partitioned():
                return set()
            self.part_budget -= 1
            self.gate.partition(self.node)
            return {"partition"}
        if action == "heal":
            if not self.any_partitioned():
                return set()
            self.gate.heal()
            return {"heal"}
        verb, _, who = action.partition(":")
        if verb == "renew" and who in self.hbs:
            return self._renew(who)
        if verb == "crash" and who in self.hbs:
            if self.crash_budget <= 0:
                return set()
            self.crash_budget -= 1
            return self._crash(who)
        return set()

    def enabled(self) -> list:
        acts = ["advance"] + [f"renew:{i}" for i in self.identities]
        spec = self._lease_spec(self.lease, LEASE_NAMESPACE)
        if spec is not None and "fencedEpoch" not in spec:
            acts.append("stamp")
        if self.crash_budget > 0:
            acts.append(f"crash:{self.identities[0]}")
        if self.part_budget > 0 and not self.any_partitioned():
            acts.append("partition")
        if self.any_partitioned():
            acts.append("heal")
        return sorted(acts)

    def state_key(self) -> tuple:
        spec = self._lease_spec(self.lease, LEASE_NAMESPACE)
        lease_k = None
        if spec is not None:
            lease_k = (
                spec.get("holderIdentity", ""),
                _age_bucket(self.now, float(spec.get("renewTime", 0)),
                            self.quantum, 3),
                int(spec.get("nodeEpoch", 0) or 0),
                tuple(sorted((spec.get("renewers") or {}).items())),
                spec.get("fencedEpoch"),
                tuple(spec.get("fencedIdentities") or ()) or None)
        return ("fence_ack", lease_k, self._hb_key(),
                self.crash_budget, self.part_budget,
                self.any_partitioned())

    def check(self) -> list:
        return list(self._action_violations) + self._fence_oracle()

    def converged(self) -> bool:
        spec = self._lease_spec(self.lease, LEASE_NAMESPACE)
        return (spec is not None and "fencedEpoch" not in spec
                and not any(self.dirty.values())
                and all(not hb.fenced and not hb.suspect
                        for hb in self.hbs.values()))

    def fair_actions(self) -> list:
        return [f"renew:{i}" for i in self.identities]


class _LifecycleUniverse(_FenceMixin, _Universe):
    """One node (heartbeat + Node + ResourceSlice + an allocated claim)
    against the full lifecycle controller: expire → fence → cordon →
    drain-annotate → repair → heal/renew → ack → uncordon."""

    quantum = 6.0
    DURATION = 10.0

    def __init__(self, planted: frozenset = frozenset()):
        super().__init__(planted)
        self._init_fence("n7", ("node-agent",))
        self.fake.create(new_object("Node", self.node))
        self.fake.create(new_object(
            "ResourceSlice", f"slice-{self.node}",
            spec={"nodeName": self.node, "pool": {"name": self.node},
                  "devices": [{"name": "d0"}]}))
        self.fake.create(new_object(
            "ResourceClaim", "claim-0", "default",
            status={"allocation": {"devices": {"results": [
                {"driver": "gpu.nvidia.com", "pool": self.node,
                 "device": "d0"}]}}}))
        self.repair_calls = 0
        lc_cls = (_EagerUncordonLifecycle
                  if "lifecycle_eager_uncordon" in planted
                  else NodeLifecycleController)
        self.lc = lc_cls(self.fake, repair=self._repair, clock=self._clock)
        self.crash_budget = 1
        self.part_budget = 1
        self.hbs[self.identities[0]] = self._mk_hb(self.identities[0])

    def _repair(self, node: str) -> bool:
        self.repair_calls += 1
        return True

    def _drained(self) -> bool:
        claim = self.fake.try_get("ResourceClaim", "claim-0", "default")
        anns = (claim or {}).get("metadata", {}).get("annotations") or {}
        return any(k.endswith("/drain") or k.endswith("/drain-failed")
                   for k in anns)

    def apply(self, action: str) -> set:
        ident = self.identities[0]
        if action == "advance":
            self.now += self.quantum
            return set()
        if action == "renew":
            return self._renew(ident)
        if action == "crash":
            if self.crash_budget <= 0:
                return set()
            self.crash_budget -= 1
            return self._crash(ident)
        if action == "partition":
            if self.part_budget <= 0 or self.any_partitioned():
                return set()
            self.part_budget -= 1
            self.gate.partition(self.node)
            return {"partition"}
        if action == "heal":
            if not self.any_partitioned():
                return set()
            self.gate.heal()
            return {"heal"}
        if action == "poll":
            before = self._lease_spec(self.lease, LEASE_NAMESPACE) or {}
            drained = self._drained()
            repairs = self.repair_calls
            counts = self.lc.poll_once()
            after = self._lease_spec(self.lease, LEASE_NAMESPACE) or {}
            self._track_fence(before, after)
            labels = set()
            if counts.get("cordoned"):
                labels.add("cordon")
            if counts.get("uncordoned"):
                labels.add("uncordon")
                # uncordon_gate oracle, checked at the transition: the
                # node must have earned it — lease renewing again AND
                # fence gone. (Age is unchanged by the poll itself.)
                age = self.now - float(after.get("renewTime", 0) or 0)
                if age > self.DURATION:
                    self._action_violations.append(
                        "uncordon_gate: uncordoned while the lease was "
                        "still expired (renewal-less oscillation)")
                if "fencedEpoch" in after:
                    self._action_violations.append(
                        "uncordon_gate: uncordoned while the fence "
                        "still stood")
            if not drained and self._drained():
                labels.add("drain_annotate")
            if self.repair_calls > repairs:
                labels.add("repair")
            return labels
        return set()

    def enabled(self) -> list:
        acts = ["advance", "renew", "poll"]
        if self.crash_budget > 0:
            acts.append("crash")
        if self.part_budget > 0 and not self.any_partitioned():
            acts.append("partition")
        if self.any_partitioned():
            acts.append("heal")
        return sorted(acts)

    def state_key(self) -> tuple:
        spec = self._lease_spec(self.lease, LEASE_NAMESPACE)
        lease_k = None
        if spec is not None:
            lease_k = (
                _age_bucket(self.now, float(spec.get("renewTime", 0)),
                            self.quantum, 4),
                int(spec.get("nodeEpoch", 0) or 0),
                spec.get("fencedEpoch"),
                tuple(spec.get("fencedIdentities") or ()) or None)
        return ("lifecycle", lease_k, self._hb_key(),
                tuple(self.lc.cordoned_nodes()), self._drained(),
                self.repair_calls > 0,
                self.crash_budget, self.part_budget,
                self.any_partitioned())

    def check(self) -> list:
        return list(self._action_violations) + self._fence_oracle()

    def converged(self) -> bool:
        spec = self._lease_spec(self.lease, LEASE_NAMESPACE)
        return (spec is not None and "fencedEpoch" not in spec
                and not any(self.dirty.values())
                and not self.lc.cordoned_nodes()
                and not self.hbs[self.identities[0]].suspect)

    def fair_actions(self) -> list:
        return ["renew", "poll"]


class _ShardMapUniverse(_Universe):
    """Two ShardMap instances contending for three shard leases with
    ``max_shards=2`` each — the smallest scope where ownership must
    genuinely spread. Instance 1 is the asymmetric aggressor (crash /
    partition / release); the overclaim plant rides on instance 2."""

    I1, I2 = "ctrl-1", "ctrl-2"
    SHARDS = 3
    PREFIX = "proto-shard"
    NS = "default"
    quantum = 4.0

    def __init__(self, planted: frozenset = frozenset()):
        super().__init__(planted)
        self.maps: dict[str, ShardMap] = {}
        self.crash_budget = {self.I1: 1}
        self.part_budget = {self.I1: 1}
        for ident in (self.I1, self.I2):
            self.maps[ident] = self._mk_map(ident)

    def _mk_map(self, ident: str) -> ShardMap:
        factory = (_OverclaimElector
                   if ident == self.I2 and "shard_overclaim" in self.planted
                   else None)
        return ShardMap(
            PartitionedClient(self.fake, ident, self.gate), ident,
            self.SHARDS, namespace=self.NS, lease_prefix=self.PREFIX,
            max_shards=2, lease_duration=10.0, renew_deadline=6.0,
            clock=self._clock, elector_factory=factory)

    def apply(self, action: str) -> set:
        if action == "advance":
            self.now += self.quantum
            return set()
        if action == "heal":
            if not self.any_partitioned():
                return set()
            self.gate.heal()
            return {"heal"}
        verb, _, who = action.partition(":")
        if verb == "sync" and who in self.maps:
            sm = self.maps[who]
            before = sm.owned()
            after = sm.sync_once()
            labels = set()
            if after - before:
                labels.add("acquire")
            if before - after:
                labels.add("step_down")
            if any(sm._electors[s].last_renew == self.now
                   for s in before & after):
                labels.add("renew")
            return labels
        if verb == "crash":
            if self.crash_budget.get(who, 0) <= 0:
                return set()
            self.crash_budget[who] -= 1
            self.maps[who] = self._mk_map(who)
            return {"crash", "restart"}
        if verb == "partition":
            if self.part_budget.get(who, 0) <= 0:
                return set()
            self.part_budget[who] -= 1
            self.gate.partition(who)
            return {"partition"}
        if verb == "release":
            sm = self.maps[who]
            if not sm.owned():
                return set()
            try:
                sm.release_all()
            except Exception:  # noqa: BLE001 — partitioned mid-release
                return set()
            return {"release"}
        return set()

    def enabled(self) -> list:
        acts = [f"sync:{self.I1}", f"sync:{self.I2}", "advance"]
        if self.crash_budget.get(self.I1, 0) > 0:
            acts.append(f"crash:{self.I1}")
        if (self.part_budget.get(self.I1, 0) > 0
                and not self.gate.is_partitioned(self.I1)):
            acts.append(f"partition:{self.I1}")
        if self.any_partitioned():
            acts.append("heal")
        if (self.maps[self.I1].owned()
                and not self.gate.is_partitioned(self.I1)):
            acts.append(f"release:{self.I1}")
        return sorted(acts)

    def state_key(self) -> tuple:
        leases = []
        for shard in range(self.SHARDS):
            spec = self._lease_spec(shard_lease_name(self.PREFIX, shard),
                                    self.NS)
            leases.append(None if spec is None else (
                spec.get("holderIdentity", ""),
                _age_bucket(self.now, float(spec.get("renewTime", 0)),
                            self.quantum, 5)))
        # Membership leases feed the fair-share census, so their
        # live/expired standing is behaviorally relevant state.
        members = []
        for ident in (self.I1, self.I2):
            spec = self._lease_spec(member_lease_name(self.PREFIX, ident),
                                    self.NS)
            members.append(None if spec is None else (
                spec.get("holderIdentity", ""),
                _age_bucket(self.now, float(spec.get("renewTime", 0)),
                            self.quantum, 5)))
        insts = tuple(
            (ident,
             tuple(sorted(
                 (s, _age_bucket(self.now, sm._electors[s].last_renew,
                                 self.quantum, 5))
                 for s in sm.owned())),
             self.crash_budget.get(ident, 0),
             self.part_budget.get(ident, 0),
             self.gate.is_partitioned(ident))
            for ident, sm in sorted(self.maps.items()))
        return ("shard_map", tuple(leases), tuple(members), insts)

    def _confident_owners(self, shard: int) -> list:
        return sorted(ident for ident, sm in self.maps.items()
                      if sm.confident(shard))

    def check(self) -> list:
        out = list(self._action_violations)
        for shard in range(self.SHARDS):
            owners = self._confident_owners(shard)
            if len(owners) > 1:
                out.append(
                    f"single_owner: shard {shard} owned by "
                    f"{','.join(owners)} simultaneously "
                    "(double reconcile)")
        return out

    def converged(self) -> bool:
        return all(len(self._confident_owners(s)) == 1
                   for s in range(self.SHARDS))

    def fair_actions(self) -> list:
        return [f"sync:{self.I1}", f"sync:{self.I2}", "advance"]


class _ShardRebalanceUniverse(_Universe):
    """Membership churn over four shards with hysteresis cap 1:
    ``ctrl-1`` boots alone and absorbs the keyspace; ``ctrl-2`` joins
    (and may leave once). The fair-share census must drain ctrl-1 down
    to its fair share as a bounded trickle — at most ``CAP`` voluntary
    handoffs per rebalance window, the rest deferred. The planted
    :class:`_StormShardMap` sheds its whole excess the moment the
    census shifts, which the storm oracle rejects at action time.
    Scope (documented, not a cap): no crash/partition legs here — the
    ``shard_map`` model owns those; this one isolates the census +
    hysteresis layer above the proven per-shard lease protocol."""

    I1, I2 = "ctrl-1", "ctrl-2"
    SHARDS = 4
    PREFIX = "rebal-shard"
    NS = "default"
    CAP = 1  # rebalance_max_handoffs under test
    WINDOW = 16.0
    quantum = 4.0

    #: sync-round event reason -> registered transition label.
    #: ``lost`` (involuntary lapse) is deliberately unmapped: it is the
    #: shard_map model's territory, not a rebalance transition.
    _LABELS = {"acquire": "acquire", "takeover": "takeover",
               "renew": "renew", "rebalance": "handoff",
               "defer": "hysteresis_defer"}

    def __init__(self, planted: frozenset = frozenset()):
        super().__init__(planted)
        self.join_budget = 1
        self.leave_budget = 1
        self.joined = False  # ctrl-2; ctrl-1 is always a member
        self.maps: dict[str, Optional[ShardMap]] = {
            self.I1: self._mk_map(self.I1), self.I2: None}

    def _mk_map(self, ident: str) -> ShardMap:
        cls = (_StormShardMap
               if ident == self.I1 and "rebalance_storm" in self.planted
               else ShardMap)
        return cls(
            PartitionedClient(self.fake, ident, self.gate), ident,
            self.SHARDS, namespace=self.NS, lease_prefix=self.PREFIX,
            lease_duration=10.0, renew_deadline=6.0, clock=self._clock,
            rebalance_max_handoffs=self.CAP,
            rebalance_window=self.WINDOW)

    def apply(self, action: str) -> set:
        if action == "advance":
            self.now += self.quantum
            return set()
        verb, _, who = action.partition(":")
        if verb == "sync":
            sm = self.maps.get(who)
            if sm is None:
                return set()
            sm.sync_once()
            shed = sum(1 for reason, _s in sm.last_events
                       if reason == "rebalance")
            if shed > self.CAP:
                self._action_violations.append(
                    f"rebalance_storm: {who} shed {shed} shards in one "
                    f"round (hysteresis cap {self.CAP})")
            return {self._LABELS[reason]
                    for reason, _s in sm.last_events
                    if reason in self._LABELS}
        if verb == "join" and who == self.I2:
            if self.join_budget <= 0 or self.joined:
                return set()
            self.join_budget -= 1
            self.joined = True
            self.maps[self.I2] = self._mk_map(self.I2)
            return {"join"}
        if verb == "leave" and who == self.I2:
            if self.leave_budget <= 0 or not self.joined:
                return set()
            self.leave_budget -= 1
            self.joined = False
            sm = self.maps[self.I2]
            self.maps[self.I2] = None
            try:
                sm.release_all()
            except Exception:  # noqa: BLE001 — leave is best-effort;
                pass           # the membership lease expires instead
            return {"leave"}
        return set()

    def enabled(self) -> list:
        acts = [f"sync:{self.I1}", "advance"]
        if self.joined:
            acts.append(f"sync:{self.I2}")
            if self.leave_budget > 0:
                acts.append(f"leave:{self.I2}")
        elif self.join_budget > 0:
            acts.append(f"join:{self.I2}")
        return sorted(acts)

    def _map_key(self, sm: Optional[ShardMap]):
        if sm is None:
            return None
        # Cooldowns bucket by time REMAINING (they gate future
        # re-acquisition); expired entries are behaviorally inert.
        cools = tuple(sorted(
            (s, min(int((t - self.now) // self.quantum), 2))
            for s, t in sm._cooldown_until.items() if t > self.now))
        return (
            tuple(sorted(
                (s, _age_bucket(self.now, sm._electors[s].last_renew,
                                self.quantum, 3))
                for s in sm.owned())),
            sm._window_handoffs,
            _age_bucket(self.now, sm._window_start, self.quantum, 4),
            cools)

    def state_key(self) -> tuple:
        # Age caps sit just past the behavioral boundaries (renew
        # deadline 6s = bucket 1, lease expiry 10s = bucket 2, window
        # 16s = bucket 4); ages beyond them are behaviorally identical,
        # so coarser buckets close the graph without merging distinct
        # futures. leaseTransitions is deliberately NOT in the key: it
        # only flavors the acquire/takeover label, never a decision.
        leases = []
        for shard in range(self.SHARDS):
            spec = self._lease_spec(shard_lease_name(self.PREFIX, shard),
                                    self.NS)
            leases.append(None if spec is None else (
                spec.get("holderIdentity", ""),
                _age_bucket(self.now, float(spec.get("renewTime", 0)),
                            self.quantum, 3)))
        members = []
        for ident in (self.I1, self.I2):
            spec = self._lease_spec(member_lease_name(self.PREFIX, ident),
                                    self.NS)
            members.append(None if spec is None else (
                spec.get("holderIdentity", ""),
                _age_bucket(self.now, float(spec.get("renewTime", 0)),
                            self.quantum, 3)))
        insts = tuple((ident, self._map_key(self.maps[ident]))
                      for ident in (self.I1, self.I2))
        return ("shard_rebalance", tuple(leases), tuple(members), insts,
                self.joined, self.join_budget, self.leave_budget)

    def _confident_owners(self, shard: int) -> list:
        return sorted(ident for ident, sm in self.maps.items()
                      if sm is not None and sm.confident(shard))

    def check(self) -> list:
        out = list(self._action_violations)
        for shard in range(self.SHARDS):
            owners = self._confident_owners(shard)
            if len(owners) > 1:
                out.append(
                    f"single_owner: shard {shard} owned by "
                    f"{','.join(owners)} simultaneously "
                    "(double reconcile)")
        return out

    def converged(self) -> bool:
        return all(len(self._confident_owners(s)) == 1
                   for s in range(self.SHARDS))

    def fair_actions(self) -> list:
        return [f"sync:{self.I1}", f"sync:{self.I2}", "advance"]


_FACTORIES = {
    "elector": _ElectorUniverse,
    "fence_ack": _FenceAckUniverse,
    "lifecycle": _LifecycleUniverse,
    "shard_map": _ShardMapUniverse,
    "shard_rebalance": _ShardRebalanceUniverse,
}


# --------------------------------------------------------------------------
# Counterexample schedules (racelab's decision-log dialect)
# --------------------------------------------------------------------------

def schedule_point(model: str) -> str:
    return f"protolab.{model}.step"


class CounterexampleSchedule:
    """A found trace as a deterministic schedule, in the exact dialect
    racelab's ``ScheduleFuzzer`` logs: decisions are a pure function of
    ``(point, hit#)`` and ``log()`` returns the sorted
    ``(point, hit#, action)`` tuples. It also implements the fuzzer's
    ``preempt`` surface (as a no-op counter), so stresslab can install
    it via ``racelab.set_fuzzer`` and replay a counterexample through
    the same harness that replays fuzzed schedules."""

    def __init__(self, entries: Iterable[tuple]):
        self._entries = sorted(tuple(e) for e in entries)
        self._decisions = {(p, h): a for p, h, a in self._entries}
        self._hits: dict[str, int] = {}

    @classmethod
    def from_trace(cls, model: str,
                   trace: Iterable[str]) -> "CounterexampleSchedule":
        point = schedule_point(model)
        return cls((point, i + 1, action)
                   for i, action in enumerate(trace))

    def to_trace(self) -> list:
        return [a for _, _, a in sorted(self._entries,
                                        key=lambda e: (e[0], e[1]))]

    def decide(self, point: str, hit: int) -> Optional[str]:
        return self._decisions.get((point, hit))

    def preempt(self, name: str) -> None:
        """ScheduleFuzzer surface: counterexample schedules carry no
        sleep/reprio decisions, only step decisions."""
        self._hits[name] = self._hits.get(name, 0) + 1
        return None

    def log(self) -> list:
        return list(self._entries)


def replay_trace(model: str, trace: Iterable[str],
                 planted: Iterable[str] = ()) -> dict:
    """Deterministically re-execute a trace, checking the safety
    oracles after every step. Returns the violations in first-hit
    order plus the trace's schedule encoding — byte-identical across
    runs for the same inputs."""
    u = _FACTORIES[model](frozenset(planted))
    trace = list(trace)
    violations: list[str] = []
    seen: set = set()
    for v in u.check():
        if v not in seen:
            seen.add(v)
            violations.append(v)
    for action in trace:
        u.apply(action)
        for v in u.check():
            if v not in seen:
                seen.add(v)
                violations.append(v)
    return {
        "model": model,
        "trace": trace,
        "violations": violations,
        "schedule": CounterexampleSchedule.from_trace(model, trace).log(),
    }


def _minimize(model: str, planted: frozenset, trace: tuple,
              target: str) -> tuple:
    """Greedy 1-minimization: drop any action whose removal still
    reproduces ``target`` (actions are total, so every subsequence
    replays). Deterministic; BFS already gives shortest depth, this
    prunes incidental steps within it."""
    cur = list(trace)
    changed = True
    while changed:
        changed = False
        for i in range(len(cur)):
            cand = cur[:i] + cur[i + 1:]
            if target in replay_trace(model, cand, planted)["violations"]:
                cur = cand
                changed = True
                break
    return tuple(cur)


# --------------------------------------------------------------------------
# The explorer
# --------------------------------------------------------------------------

def _fair_continuation(u: "_Universe", k_rounds: int,
                       reached: set) -> tuple:
    """Heal everything, then round-robin the live actors with clock
    advances — the fair crash-free schedule. Returns (converged,
    safety violations seen along the way)."""
    viols: list[str] = []
    if u.converged():
        return True, viols
    if u.any_partitioned():
        reached |= u.apply("heal")
        viols.extend(u.check())
    for _ in range(k_rounds):
        for action in u.fair_actions():
            reached |= u.apply(action)
            viols.extend(u.check())
            if u.converged():
                return True, viols
        u.apply("advance")
    return u.converged(), viols


def explore_model(model: str, planted: Iterable[str] = (),
                  max_depth: Optional[int] = None,
                  max_states: Optional[int] = None,
                  k_liveness: int = _DEFAULT_K_LIVENESS,
                  liveness: bool = True,
                  stop_on_violation: bool = False) -> dict:
    """Exhaustive bounded BFS over one model's action interleavings.

    Replay-based: universes hold live locks and cannot be forked, so
    each dequeued trace rebuilds its universe from the initial state —
    BFS keeps traces (and therefore counterexamples) at shortest depth,
    and an edge memo ((state key, action) -> successor key) prunes
    re-replays of already-seen successors. Depth and state caps are
    COUNTED: any hit fails ``coverage_ok``."""
    planted = frozenset(planted)
    d_depth, d_states = _DEFAULT_BOUNDS[model]
    max_depth = d_depth if max_depth is None else max_depth
    max_states = d_states if max_states is None else max_states
    factory = _FACTORIES[model]
    registered = set(PROTOCOL_MODELS[model]["transitions"])

    t0 = time.monotonic()
    seen: set = set()
    edge_memo: dict = {}
    queue: deque = deque([()])
    reached: set = set()
    # violation line -> dict(trace, kind); first hit wins (shortest).
    violations: dict[str, dict] = {}
    states_explored = 0
    edges_replayed = 0
    depth_cap_hits = 0
    state_cap_unexplored = 0
    liveness_checked = 0

    while queue:
        trace = queue.popleft()
        u = factory(planted)
        key = u.state_key()
        for action in trace:
            labels = u.apply(action)
            reached |= labels
            nxt = u.state_key()
            edge_memo[(key, action)] = nxt
            key = nxt
        edges_replayed += 1
        if key in seen:
            continue
        seen.add(key)
        states_explored += 1
        new_viols = [v for v in u.check() if v not in violations]
        for v in new_viols:
            violations[v] = {"trace": trace, "kind": "safety"}
        if new_viols:
            if stop_on_violation:
                break
            continue  # do not expand past a violating state
        if states_explored >= max_states:
            state_cap_unexplored = len(queue)
            if state_cap_unexplored:
                break
        children = [a for a in u.enabled()
                    if edge_memo.get((key, a)) not in seen
                    or (key, a) not in edge_memo]
        if len(trace) >= max_depth:
            if children:
                depth_cap_hits += 1
            continue
        if liveness:
            liveness_checked += 1
            ok, cont_viols = _fair_continuation(u, k_liveness, reached)
            for v in cont_viols:
                # The continuation's extra steps are not part of
                # ``trace``, so these are reported unminimized (the BFS
                # frontier reaches the same state first-class anyway).
                if v not in violations:
                    violations[v] = {"trace": trace, "kind": "liveness"}
            if not ok:
                line = (f"liveness: no fair crash-free continuation "
                        f"converged within {k_liveness} rounds")
                if line not in violations:
                    violations[line] = {"trace": trace, "kind": "liveness"}
        for a in children:
            queue.append(trace + (a,))

    # Minimize + schedule-encode every safety violation.
    out_violations = []
    for line in sorted(violations):
        rec = violations[line]
        entry = {"oracle": line, "kind": rec["kind"],
                 "trace": list(rec["trace"])}
        if rec["kind"] == "safety":
            minimal = _minimize(model, planted, tuple(rec["trace"]), line)
            entry["trace"] = list(minimal)
            entry["schedule"] = CounterexampleSchedule.from_trace(
                model, minimal).log()
        out_violations.append(entry)

    unreached = sorted(registered - reached)
    coverage_ok = (depth_cap_hits == 0 and state_cap_unexplored == 0
                   and not unreached and not stop_on_violation)
    return {
        "model": model,
        "planted": sorted(planted),
        "states_explored": states_explored,
        "edges_replayed": edges_replayed,
        "transitions_reached": sorted(reached & registered),
        "transitions_unreached": unreached,
        "depth_cap_hits": depth_cap_hits,
        "state_cap_unexplored": state_cap_unexplored,
        "liveness_checked": liveness_checked,
        "violations": out_violations,
        "coverage_ok": coverage_ok,
        "max_depth": max_depth,
        "max_states": max_states,
        "wall_s": time.monotonic() - t0,
    }


def _verdict_lines(res: dict) -> list:
    name = res["model"]
    lines = [
        f"model {name}: states={res['states_explored']} "
        f"reached={','.join(res['transitions_reached']) or '-'} "
        f"unreached={','.join(res['transitions_unreached']) or '-'} "
        f"depth_capped={res['depth_cap_hits']} "
        f"state_capped={res['state_cap_unexplored']} "
        f"liveness_checked={res['liveness_checked']}"
    ]
    for v in res["violations"]:
        lines.append(
            f"violation {name}: [{v['kind']}] {v['oracle']} "
            f"trace={json.dumps(v['trace'], separators=(',', ':'))}")
    return lines


def run_protolab(models: Optional[Iterable[str]] = None,
                 planted: Iterable[str] = (), seed: int = 0,
                 max_depth: Optional[int] = None,
                 max_states: Optional[int] = None,
                 k_liveness: int = _DEFAULT_K_LIVENESS,
                 liveness: bool = True) -> dict:
    """Model-check the real implementations. The gate expects ZERO
    violations, zero cap hits, and every registered transition reached.
    ``seed`` tags the result for seeded-schedule consumers; exploration
    itself is systematic and seed-independent."""
    names = sorted(models) if models else sorted(PROTOCOL_MODELS)
    t0 = time.monotonic()
    prev_disable = logging.root.manager.disable
    logging.disable(logging.CRITICAL)
    try:
        per_model = {}
        for name in names:
            per_model[name] = explore_model(
                name, planted=planted, max_depth=max_depth,
                max_states=max_states, k_liveness=k_liveness,
                liveness=liveness)
    finally:
        logging.disable(prev_disable)
    lines: list[str] = []
    violations: list[str] = []
    for name in names:
        res = per_model[name]
        lines.extend(_verdict_lines(res))
        violations.extend(f"{name}: {v['oracle']}"
                          for v in res["violations"])
    return {
        "seed": seed,
        "models": names,
        "per_model": per_model,
        "states_explored": sum(r["states_explored"]
                               for r in per_model.values()),
        "violations": sorted(violations),
        "transitions_unreached": sorted(
            f"{n}:{t}" for n, r in per_model.items()
            for t in r["transitions_unreached"]),
        "capped_unexplored": sum(
            r["depth_cap_hits"] + r["state_cap_unexplored"]
            for r in per_model.values()),
        "coverage_ok": all(r["coverage_ok"] for r in per_model.values()),
        "verdict_log": sorted(lines),
        "wall_s": time.monotonic() - t0,
    }


def run_planted_corpus(seed: int = 0) -> dict:
    """Run every planted bug, demand detection by its expected oracle,
    1-minimality of the counterexample, and byte-identical replay of
    the violation through the schedule encoding (double replay)."""
    t0 = time.monotonic()
    prev_disable = logging.root.manager.disable
    logging.disable(logging.CRITICAL)
    try:
        per_plant = {}
        lines: list[str] = []
        for plant in sorted(PLANTED_VIOLATIONS):
            info = PLANTED_VIOLATIONS[plant]
            model = info["model"]
            res = explore_model(model, planted=(plant,), liveness=False,
                                stop_on_violation=True)
            hits = [v for v in res["violations"]
                    if v["kind"] == "safety"
                    and v["oracle"].startswith(info["oracle"])]
            detected = bool(hits)
            entry = {"model": model, "expected_oracle": info["oracle"],
                     "detected": detected, "trace": None,
                     "schedule": None, "minimal": False,
                     "replay_identical": False}
            if detected:
                hit = hits[0]
                trace = tuple(hit["trace"])
                sched = CounterexampleSchedule.from_trace(model, trace)
                r1 = replay_trace(model, sched.to_trace(),
                                  planted=(plant,))
                r2 = replay_trace(model, sched.to_trace(),
                                  planted=(plant,))
                entry["replay_identical"] = (
                    r1 == r2 and hit["oracle"] in r1["violations"])
                # Verify 1-minimality explicitly: no single removal may
                # still reproduce.
                entry["minimal"] = all(
                    hit["oracle"] not in replay_trace(
                        model, trace[:i] + trace[i + 1:],
                        planted=(plant,))["violations"]
                    for i in range(len(trace)))
                entry["trace"] = list(trace)
                entry["schedule"] = sched.log()
            per_plant[plant] = entry
            lines.append(
                f"planted {plant}: model={model} detected={detected} "
                f"minimal={entry['minimal']} "
                f"replay={entry['replay_identical']} "
                f"trace={json.dumps(entry['trace'], separators=(',', ':'))}")
    finally:
        logging.disable(prev_disable)
    detected_n = sum(1 for e in per_plant.values() if e["detected"])
    return {
        "seed": seed,
        "planted_total": len(per_plant),
        "planted_detected": detected_n,
        "all_detected": detected_n == len(per_plant),
        "all_minimal": all(e["minimal"] for e in per_plant.values()),
        "all_replay_identical": all(e["replay_identical"]
                                    for e in per_plant.values()),
        "per_plant": per_plant,
        "verdict_log": sorted(lines),
        "wall_s": time.monotonic() - t0,
    }


def run_proto_smoke(seed: int = 0) -> dict:
    """The protocol smoke: the full planted corpus at 100%
    detection, a clean-implementation check over the two cheapest
    models, and the double-run byte-identity proof (with each model's
    state count). :func:`run_protolab` runs every model with liveness;
    this is the seconds-scale front door."""
    t0 = time.monotonic()
    corpus = run_planted_corpus(seed=seed)
    real = run_protolab(models=("elector", "fence_ack"), seed=seed)
    real2 = run_protolab(models=("elector", "fence_ack"), seed=seed)
    deterministic = (real["verdict_log"] == real2["verdict_log"])
    return {
        "seed": seed,
        "planted_total": corpus["planted_total"],
        "planted_detected": corpus["planted_detected"],
        "all_minimal": corpus["all_minimal"],
        "all_replay_identical": corpus["all_replay_identical"],
        "violations": real["violations"],
        "coverage_ok": real["coverage_ok"],
        "states": {name: r["states_explored"]
                   for name, r in real["per_model"].items()},
        "deterministic": deterministic,
        "verdict_log": sorted(corpus["verdict_log"]
                              + real["verdict_log"]),
        "wall_s": time.monotonic() - t0,
    }
