"""Active-active controller sharding in the port, held against the JAX
package: the shard-key partition, the lease-claimed ShardMap, the
epoch-stamped op ledger, the reconcile-path ShardGate, leader-pinned
singleton failover (usage-meter conservation, no double canary probes,
no duplicate incident bundles), the partitioned-replica handoff replayed
under the seeded schedule fuzzer, rebalance hysteresis and the orphan
sweep's ``min_gap`` debounce — the classes of ``tests/test_sharding.py``
on the port's modules. ``TestAgainstJax`` routes one seeded corpus of
keys through both packages' ``shard_for``, audits the same op lists with
both ledgers, runs both ``run_shard_smoke()`` legs, and starts the
controller's binary with ``--shards 2``.
"""

import os
import random
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import pytest

from k8s_dra_driver_tpu.internal import stresslab as jax_stresslab
from k8s_dra_driver_tpu.pkg import shardmap as jax_shardmap
from k8s_dra_driver_tpu.plugins.compute_domain_controller import main as jax_controller_main
from k8s_dra_driver_tpu_torch.internal.stresslab import run_shard_smoke
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import (
    PartitionGate,
    PartitionedClient,
)
from k8s_dra_driver_tpu_torch.k8sclient.httpapi import ApiServer, HttpClient
from k8s_dra_driver_tpu_torch.pkg import racelab
from k8s_dra_driver_tpu_torch.pkg.canary import CanaryMetrics, CanaryProber
from k8s_dra_driver_tpu_torch.pkg.blackbox import BlackboxMetrics, FlightRecorder
from k8s_dra_driver_tpu_torch.pkg.metrics import ShardMetrics
from k8s_dra_driver_tpu_torch.pkg.shardmap import (
    ShardMap,
    ShardOpLedger,
    member_lease_name,
    shard_for,
    shard_lease_name,
)
from k8s_dra_driver_tpu_torch.pkg.usage import (
    ANN_USAGE_SINCE,
    UsageMeter,
    UsageMetrics,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.cleanup import (
    CleanupManager,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.election import (
    KIND_LEASE,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.sharding import (
    LEADER_SHARD,
    ShardedController,
    SingletonHandle,
)

REPO = str(__import__("pathlib").Path(__file__).resolve().parent.parent)

# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _settle(replicas, now, rounds=200, step=1.0):
    """Round-robin sync_once (advancing the shared fake clock) until the
    fleet partitions the keyspace at fair share."""
    shards = replicas[0].shard_map.shards
    fair = -(-shards // len(replicas))
    for _ in range(rounds):
        owned = [r.sync_once() for r in replicas]
        flat = [s for o in owned for s in o]
        if (len(flat) == shards and len(set(flat)) == shards
                and all(len(o) <= fair for o in owned)):
            return True
        now[0] += step
    return False


def _mk_fleet(client, n, shards, now, lease_prefix="t-shard",
              lease_duration=10.0, renew_deadline=6.0, **kw):
    fleet = [
        ShardedController(
            client, f"r-{i}", shards, lease_prefix=lease_prefix,
            lease_duration=lease_duration, renew_deadline=renew_deadline,
            clock=lambda: now[0], metrics=ShardMetrics(), **kw)
        for i in range(n)
    ]
    # Register every membership before anyone acquires so the census is
    # complete from round one (same pre-settle the bench uses).
    for s in fleet:
        s.shard_map._renew_membership()
    return fleet


# --------------------------------------------------------------------------
# shard_for: the keyspace partition
# --------------------------------------------------------------------------

class TestShardFor:
    def test_stable_across_calls(self):
        for ns, uid in [("default", "u1"), ("tenant-a", "abc"),
                        ("", "x"), ("n", "")]:
            assert shard_for(ns, uid, 8) == shard_for(ns, uid, 8)

    def test_in_range(self):
        for shards in (1, 2, 3, 7, 16):
            for i in range(100):
                assert 0 <= shard_for("ns", f"uid-{i}", shards) < shards

    def test_spreads_a_namespace(self):
        """One namespace's objects must spread, not herd (namespace AND
        uid are both in the key)."""
        hit = {shard_for("tenant-a", f"uid-{i}", 8) for i in range(256)}
        assert hit == set(range(8))

    def test_distribution_roughly_uniform(self):
        shards, n = 8, 4000
        counts = [0] * shards
        for i in range(n):
            counts[shard_for("ns", f"uid-{i}", shards)] += 1
        # crc32 over distinct keys: no shard may be starved or hot by
        # more than 2x the fair share.
        assert min(counts) > n / shards / 2
        assert max(counts) < n / shards * 2

    def test_lease_names(self):
        assert shard_lease_name("p", 3) == "p-3"
        assert member_lease_name("p", "r-0") == "p-member-r-0"


# --------------------------------------------------------------------------
# ShardOpLedger: zero-double-reconcile, machine-checkable
# --------------------------------------------------------------------------

class TestShardOpLedger:
    def test_clean_history(self):
        led = ShardOpLedger()
        led.record(0, 1, "a", "reconcile:ns/u1")
        led.record(0, 1, "a", "reconcile:ns/u2")
        led.record(1, 1, "b", "reconcile:ns/u3")
        assert led.violations() == []

    def test_handoff_epoch_bump_is_clean(self):
        """A new owner under a HIGHER epoch is the legal handoff."""
        led = ShardOpLedger()
        led.record(0, 1, "a", "op")
        led.record(0, 2, "b", "op")
        assert led.violations() == []

    def test_double_reconcile_detected(self):
        led = ShardOpLedger()
        led.record(0, 3, "a", "op1")
        led.record(0, 3, "b", "op2")
        v = led.violations()
        assert len(v) == 1 and "double_reconcile" in v[0]
        assert "shard 0" in v[0] and "epoch 3" in v[0]

    def test_epoch_regression_detected(self):
        """A stale owner acting after the handoff: its op carries the
        older epoch."""
        led = ShardOpLedger()
        led.record(0, 2, "b", "op")
        led.record(0, 1, "a", "stale-op")
        v = led.violations()
        assert any("epoch_regression" in x for x in v)

    def test_per_shard_epochs_independent(self):
        led = ShardOpLedger()
        led.record(0, 5, "a", "op")
        led.record(1, 1, "b", "op")  # lower epoch, different shard: fine
        assert led.violations() == []

    def test_ops_snapshot(self):
        led = ShardOpLedger()
        led.record(0, 1, "a", "op")
        snap = led.ops()
        led.record(0, 1, "a", "op2")
        assert len(snap) == 1 and len(led.ops()) == 2


# --------------------------------------------------------------------------
# ShardMap: lease-claimed ownership
# --------------------------------------------------------------------------

class TestShardMap:
    def test_fleet_partitions_keyspace(self):
        now = [1000.0]
        client = FakeClient()
        fleet = _mk_fleet(client, 2, 4, now)
        assert _settle(fleet, now)
        owned = [r.shard_map.owned() for r in fleet]
        assert owned[0] | owned[1] == {0, 1, 2, 3}
        assert owned[0] & owned[1] == set()
        assert {len(o) for o in owned} == {2}  # fair share each

    def test_confidence_lapses_at_renew_deadline(self):
        now = [1000.0]
        client = FakeClient()
        (r,) = _mk_fleet(client, 1, 1, now, renew_deadline=6.0)
        r.sync_once()
        assert r.shard_map.confident(0)
        now[0] += 6.5  # past the renew deadline, before lease expiry
        assert not r.shard_map.confident(0)
        r.sync_once()  # renews
        assert r.shard_map.confident(0)

    def test_epoch_bumps_across_takeover(self):
        now = [1000.0]
        client = FakeClient()
        a, b = _mk_fleet(client, 2, 1, now, lease_duration=10.0)
        a.sync_once()
        assert a.shard_map.owned() == {0}
        e1 = a.shard_map.epoch(0)
        now[0] += 30.0  # a's lease long dead
        b.shard_map._renew_membership()
        b.sync_once()
        assert b.shard_map.owned() == {0}
        assert b.shard_map.epoch(0) > e1

    def test_release_all_hands_off_immediately(self):
        """A graceful leave empties the leases: the successor acquires
        without waiting out a lease duration, and the leaver drops out
        of the census at once."""
        now = [1000.0]
        client = FakeClient()
        a, b = _mk_fleet(client, 2, 4, now)
        assert _settle([a, b], now)
        t_leave = now[0]
        a.shard_map.release_all()
        lease = client.get(KIND_LEASE,
                           member_lease_name("t-shard", "r-0"), "default")
        assert lease["spec"]["holderIdentity"] == ""
        # No clock advance needed beyond sync rounds: leases are empty.
        for _ in range(20):
            b.sync_once()
            if b.shard_map.owned() == {0, 1, 2, 3}:
                break
            now[0] += 0.5
        assert b.shard_map.owned() == {0, 1, 2, 3}
        assert now[0] - t_leave < 10.0  # well inside one lease duration

    def test_census_counts_members_not_holders(self):
        """A fresh replica that owns nothing must still count toward the
        fair share, or the incumbent would never shed to it."""
        now = [1000.0]
        client = FakeClient()
        (a,) = _mk_fleet(client, 1, 4, now)
        a.sync_once()
        assert len(a.shard_map.owned()) == 4
        (b,) = [ShardedController(
            client, "r-late", 4, lease_prefix="t-shard",
            lease_duration=10.0, renew_deadline=6.0,
            clock=lambda: now[0], metrics=ShardMetrics())]
        b.shard_map._renew_membership()
        assert a.shard_map._census() == {"r-0", "r-late"}
        # and the incumbent starts shedding down to ceil(4/2)=2
        for _ in range(100):
            a.sync_once()
            b.sync_once()
            if (len(a.shard_map.owned()) == 2
                    and len(b.shard_map.owned()) == 2):
                break
            now[0] += 1.0
        assert len(a.shard_map.owned()) == 2
        assert len(b.shard_map.owned()) == 2

    def test_expired_membership_leaves_census(self):
        now = [1000.0]
        client = FakeClient()
        a, b = _mk_fleet(client, 2, 2, now)
        a.sync_once()
        assert a.shard_map._census() == {"r-0", "r-1"}
        now[0] += 11.0  # past lease_duration: b never renewed
        a.shard_map._renew_membership()
        assert a.shard_map._census() == {"r-0"}

    def test_zero_shards_rejected(self):
        with pytest.raises(ValueError):
            ShardMap(FakeClient(), "r", 0, metrics=ShardMetrics())


class TestHysteresis:
    def test_bounded_trickle_and_deferrals(self):
        """A join causes at most ``rebalance_max_handoffs`` voluntary
        sheds per window — the unit form of the bench's hysteresis leg."""
        now = [1000.0]
        client = FakeClient()
        window, cap = 50.0, 1
        mk = lambda ident: ShardedController(  # noqa: E731
            client, ident, 8, lease_prefix="h-shard",
            lease_duration=10.0, renew_deadline=6.0,
            clock=lambda: now[0], metrics=ShardMetrics(),
            rebalance_max_handoffs=cap, rebalance_window=window)
        a = mk("h-a")
        a.shard_map._renew_membership()
        a.sync_once()
        assert len(a.shard_map.owned()) == 8  # sole member: owns all
        b = mk("h-b")
        b.shard_map._renew_membership()

        window_handoffs: dict[int, int] = {}
        deferred = 0
        converged = False
        for _ in range(600):
            for r in (a, b):
                r.sync_once()
                for reason, _shard in r.shard_map.last_events:
                    if reason == "rebalance":
                        bucket = int(now[0] // window)
                        window_handoffs[bucket] = (
                            window_handoffs.get(bucket, 0) + 1)
                    elif reason == "defer":
                        deferred += 1
            if (len(a.shard_map.owned()) == 4
                    and len(b.shard_map.owned()) == 4):
                converged = True
                break
            now[0] += 1.0
        assert converged
        assert max(window_handoffs.values(), default=0) <= cap
        assert deferred > 0  # the excess was counted, not silently shed
        assert a.shard_map.deferred == deferred
        # and the metric families saw the same events
        assert a.shard_map.metrics.rebalance_deferred_total.value() == deferred


# --------------------------------------------------------------------------
# ShardGate: the reconcile-path admission point
# --------------------------------------------------------------------------

class TestShardGate:
    def _owner_and_bystander(self):
        now = [1000.0]
        client = FakeClient()
        led = ShardOpLedger()
        fleet = _mk_fleet(client, 2, 2, now, ledger=led)
        assert _settle(fleet, now)
        return fleet, led, now

    def test_admit_iff_confident_owner(self):
        fleet, led, now = self._owner_and_bystander()
        ns, uid = "tenant", "uid-1"
        shard = shard_for(ns, uid, 2)
        owner = next(r for r in fleet if shard in r.shard_map.owned())
        other = next(r for r in fleet if r is not owner)
        assert owner.gate.admit(ns, uid, "reconcile")
        assert not other.gate.admit(ns, uid, "reconcile")

    def test_admitted_op_recorded_with_epoch(self):
        fleet, led, now = self._owner_and_bystander()
        ns, uid = "tenant", "uid-1"
        shard = shard_for(ns, uid, 2)
        owner = next(r for r in fleet if shard in r.shard_map.owned())
        owner.gate.admit(ns, uid, "reconcile")
        ops = led.ops()
        assert (shard, owner.shard_map.epoch(shard), owner.identity,
                f"reconcile:{ns}/{uid}") in ops
        assert led.violations() == []

    def test_skip_not_recorded(self):
        fleet, led, now = self._owner_and_bystander()
        ns, uid = "tenant", "uid-1"
        shard = shard_for(ns, uid, 2)
        other = next(r for r in fleet if shard not in r.shard_map.owned())
        before = len(led.ops())
        assert not other.gate.admit(ns, uid, "reconcile")
        assert len(led.ops()) == before

    def test_gate_metrics_by_component_and_outcome(self):
        fleet, led, now = self._owner_and_bystander()
        ns, uid = "tenant", "uid-1"
        shard = shard_for(ns, uid, 2)
        owner = next(r for r in fleet if shard in r.shard_map.owned())
        other = next(r for r in fleet if r is not owner)
        owner.gate.admit(ns, uid, "reconcile")
        owner.gate.admit(ns, uid, "realloc")
        other.gate.admit(ns, uid, "reconcile")
        g_owner = owner.metrics.gated_ops_total
        g_other = other.metrics.gated_ops_total
        assert g_owner.value(component="reconcile",
                             outcome="admitted") == 1.0
        assert g_owner.value(component="realloc", outcome="admitted") == 1.0
        assert g_other.value(component="reconcile",
                             outcome="skipped") == 1.0

    def test_no_admission_past_renew_deadline(self):
        """The confidence window closes BEFORE the lease expires: a
        partitioned owner stops admitting while its lease still blocks
        the successor — that gap is what makes handoff race-free."""
        fleet, led, now = self._owner_and_bystander()
        ns, uid = "tenant", "uid-1"
        shard = shard_for(ns, uid, 2)
        owner = next(r for r in fleet if shard in r.shard_map.owned())
        now[0] += 6.5  # past renew_deadline=6, before lease_duration=10
        assert not owner.gate.admit(ns, uid, "reconcile")


# --------------------------------------------------------------------------
# Leader-pinned singletons
# --------------------------------------------------------------------------

class _FakeSingleton:
    def __init__(self, name, log):
        self.name = name
        self.log = log
        log.append(("start", name))

    def stop(self):
        self.log.append(("stop", self.name))


class TestSingletonPinning:
    def _mk(self, client, ident, now, factories, **kw):
        return ShardedController(
            client, ident, 2, lease_prefix="s-shard",
            lease_duration=10.0, renew_deadline=6.0,
            clock=lambda: now[0], metrics=ShardMetrics(),
            singleton_factories=factories, **kw)

    def test_factories_run_on_leader_acquire_in_insertion_order(self):
        now = [1000.0]
        client = FakeClient()
        log = []
        factories = {
            "meter": lambda: _FakeSingleton("meter", log),
            "prober": lambda: _FakeSingleton("prober", log),
            "recorder": lambda: _FakeSingleton("recorder", log),
        }
        r = self._mk(client, "s-a", now, factories)
        r.shard_map._renew_membership()
        r.sync_once()
        assert LEADER_SHARD in r.shard_map.owned()
        assert log == [("start", "meter"), ("start", "prober"),
                       ("start", "recorder")]
        assert r.running_singletons() == ["meter", "prober", "recorder"]
        assert r.singleton_incarnations == {
            "meter": 1, "prober": 1, "recorder": 1}

    def test_stop_in_reverse_order_on_release(self):
        now = [1000.0]
        client = FakeClient()
        log = []
        factories = {
            "meter": lambda: _FakeSingleton("meter", log),
            "recorder": lambda: _FakeSingleton("recorder", log),
        }
        r = self._mk(client, "s-a", now, factories)
        r.shard_map._renew_membership()
        r.sync_once()
        del log[:]
        r.shard_map.release_all()
        assert log == [("stop", "recorder"), ("stop", "meter")]
        assert r.running_singletons() == []
        assert r.singleton("meter") is None

    def test_non_leader_runs_nothing(self):
        now = [1000.0]
        client = FakeClient()
        log = []
        a = self._mk(client, "s-a", now,
                     {"x": lambda: _FakeSingleton("x", log)})
        b = self._mk(client, "s-b", now,
                     {"x": lambda: _FakeSingleton("x", log)})
        for s in (a, b):
            s.shard_map._renew_membership()
        assert _settle([a, b], now)
        leaders = [s for s in (a, b)
                   if LEADER_SHARD in s.shard_map.owned()]
        assert len(leaders) == 1
        assert len([e for e in log if e[0] == "start"]) == 1
        bystander = b if leaders[0] is a else a
        assert bystander.running_singletons() == []

    def test_broken_factory_does_not_block_the_rest(self):
        now = [1000.0]
        client = FakeClient()
        log = []

        def boom():
            raise RuntimeError("factory broke")

        factories = {
            "first": lambda: _FakeSingleton("first", log),
            "broken": boom,
            "last": lambda: _FakeSingleton("last", log),
        }
        r = self._mk(client, "s-a", now, factories)
        r.shard_map._renew_membership()
        r.sync_once()
        assert r.running_singletons() == ["first", "last"]
        assert "broken" not in r.singleton_incarnations

    def test_failover_builds_fresh_incarnations(self):
        now = [1000.0]
        client = FakeClient()
        log = []

        def mk(ident):
            return self._mk(client, ident, now, {
                "meter": lambda: _FakeSingleton(f"meter@{ident}", log)})

        a, b = mk("s-a"), mk("s-b")
        for s in (a, b):
            s.shard_map._renew_membership()
        assert _settle([a, b], now)
        victim = next(s for s in (a, b)
                      if LEADER_SHARD in s.shard_map.owned())
        survivor = b if victim is a else a
        # Kill strictly AFTER the last renewal: the one-lease failover
        # clock starts at the victim's final renew, in the past.
        now[0] += 0.5
        victim._stop_singletons()  # the dead process takes its singletons
        t_kill = now[0]
        while now[0] < t_kill + 30.0:
            survivor.sync_once()
            if LEADER_SHARD in survivor.shard_map.owned():
                break
            now[0] += 0.25
        assert survivor.singleton("meter") is not None
        assert now[0] - t_kill <= 10.0  # within one lease duration
        starts = [e for e in log if e[0] == "start"]
        stops = [e for e in log if e[0] == "stop"]
        # strict alternation: old incarnation fully down before the new
        # one exists — no overlap window.
        assert len(starts) == 2 and len(stops) == 1
        assert log.index(stops[0]) < log.index(starts[1])


class TestUsageMeterFailover:
    def test_exact_conservation_across_incarnations(self):
        """The unit form of the bench's failover leg: the successor's
        FRESH meter rebuilds the open interval from the durable
        ``usage-since`` stamp and closes it bit-exactly."""
        now = [20_000.0]
        client = FakeClient()
        meters = []

        def meter_factory():
            m = UsageMeter(client, metrics=UsageMetrics(),
                           clock=lambda: now[0])
            meters.append(m)
            return SingletonHandle(m, lambda: None)

        def mk(ident):
            return ShardedController(
                client, ident, 2, lease_prefix="u-shard",
                lease_duration=10.0, renew_deadline=6.0,
                clock=lambda: now[0], metrics=ShardMetrics(),
                singleton_factories={"meter": meter_factory})

        a, b = mk("u-a"), mk("u-b")
        for s in (a, b):
            s.shard_map._renew_membership()
        assert _settle([a, b], now)

        claim = {
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": "c1", "namespace": "tenant-a",
                         "uid": "c1-uid"},
            "status": {"allocation": {"devices": {"results": [
                {"pool": "node-0", "device": "gpu-0"},
                {"pool": "node-0", "device": "gpu-1"},
                {"pool": "node-0", "device": "gpu-2"},
            ]}}},
        }
        client.create(claim)
        t_open = now[0]

        victim = next(s for s in (a, b)
                      if LEADER_SHARD in s.shard_map.owned())
        survivor = b if victim is a else a
        victim.singleton("meter").obj.observe(now[0])  # stamps durably
        anns = (client.get("ResourceClaim", "c1", "tenant-a")
                ["metadata"].get("annotations") or {})
        assert ANN_USAGE_SINCE in anns

        now[0] += 3.0
        victim._stop_singletons()  # page-out; leases expire on their own
        t_kill = now[0]
        while now[0] < t_kill + 30.0:
            survivor.sync_once()
            if LEADER_SHARD in survivor.shard_map.owned():
                break
            now[0] += 0.5

        # The successor's FIRST observe runs while the claim is still
        # allocated: it rebuilds the open interval from LIST, reading
        # the true start from the victim's durable stamp.
        successor = survivor.singleton("meter").obj
        successor.observe(now[0])

        now[0] += 4.0
        live = client.get("ResourceClaim", "c1", "tenant-a")
        live["status"] = {}
        client.update(live)
        t_close = now[0]
        successor.observe(now[0])
        assert len(meters) == 2 and successor is not meters[0]
        expected = 3 * max(0.0, t_close - t_open)
        assert successor.completed().get("tenant-a") == expected  # bit-exact


class TestCanaryProberPinning:
    def test_no_double_probes_across_failover(self):
        """Each probe round goes to whichever replica holds the live
        leader-shard handle — summed across incarnations, rounds in ==
        probes out, through a failover."""
        now = [30_000.0]
        client = FakeClient()
        probers = []

        class _NullAllocator:
            def allocate(self, claim, node=None):
                raise RuntimeError("no capacity in this unit test")

        def prober_factory():
            p = CanaryProber(client, _NullAllocator(), nodes=["node-a"],
                             metrics=CanaryMetrics(),
                             clock=lambda: now[0])
            probers.append(p)
            return SingletonHandle(p, lambda: None)

        def mk(ident):
            return ShardedController(
                client, ident, 2, lease_prefix="c-shard",
                lease_duration=10.0, renew_deadline=6.0,
                clock=lambda: now[0], metrics=ShardMetrics(),
                singleton_factories={"prober": prober_factory})

        a, b = mk("c-a"), mk("c-b")
        for s in (a, b):
            s.shard_map._renew_membership()
        assert _settle([a, b], now)

        def probe_round():
            live = [s.singleton("prober") for s in (a, b)]
            live = [h for h in live if h is not None]
            assert len(live) == 1  # never two live probers
            live[0].obj.probe_node("node-a")

        rounds = 0
        for _ in range(3):
            probe_round()
            rounds += 1
        victim = next(s for s in (a, b)
                      if LEADER_SHARD in s.shard_map.owned())
        survivor = b if victim is a else a
        victim._stop_singletons()
        t_kill = now[0]
        while now[0] < t_kill + 30.0:
            survivor.sync_once()
            if LEADER_SHARD in survivor.shard_map.owned():
                break
            now[0] += 0.5
        for _ in range(3):
            probe_round()
            rounds += 1
        assert len(probers) == 2
        assert sum(p.probes for p in probers) == rounds


class TestFlightRecorderPinning:
    def test_no_duplicate_bundles_across_failover(self, tmp_path):
        """Alert fan-out goes only to the live incarnation (the
        SingletonHandle teardown unsubscribes, exactly as main.py wires
        it) — so one fired alert is one bundle, fleet-wide, through a
        failover."""
        now = [40_000.0]
        client = FakeClient()
        subscribers = []
        recorders = []

        def recorder_factory():
            rec = FlightRecorder(str(tmp_path / f"rec{len(recorders)}"),
                                 client=client,
                                 metrics=BlackboxMetrics(),
                                 wall_clock=lambda: now[0])
            recorders.append(rec)
            subscribers.append(rec.on_alert)

            def teardown():
                subscribers.remove(rec.on_alert)
            return SingletonHandle(rec, teardown)

        def mk(ident):
            return ShardedController(
                client, ident, 2, lease_prefix="f-shard",
                lease_duration=10.0, renew_deadline=6.0,
                clock=lambda: now[0], metrics=ShardMetrics(),
                singleton_factories={"recorder": recorder_factory})

        a, b = mk("f-a"), mk("f-b")
        for s in (a, b):
            s.shard_map._renew_membership()
        assert _settle([a, b], now)

        def fire(n):
            assert len(subscribers) == 1  # never two live recorders
            for cb in list(subscribers):
                cb({"slo": f"slo-{n}", "severity": "page",
                    "transition": "fired"})

        fire(1)
        fire(2)
        victim = next(s for s in (a, b)
                      if LEADER_SHARD in s.shard_map.owned())
        survivor = b if victim is a else a
        victim._stop_singletons()
        t_kill = now[0]
        while now[0] < t_kill + 30.0:
            survivor.sync_once()
            if LEADER_SHARD in survivor.shard_map.owned():
                break
            now[0] += 0.5
        fire(3)
        assert len(recorders) == 2
        assert sum(r.captures for r in recorders) == 3
        bundles = [b_ for rec in recorders for b_ in rec.list_bundles()]
        assert len(bundles) == 3
        assert len({b_["id"] for b_ in bundles}) == 3  # no duplicates


# --------------------------------------------------------------------------
# Partitioned-replica handoff, replayed under the schedule fuzzer
# --------------------------------------------------------------------------

class TestPartitionHandoffFuzzed:
    def _one_run(self, seed):
        """Two threaded replicas behind PartitionedClients, short real
        leases; the victim is partitioned mid-flight while both gates
        face every shard's traffic. The shared epoch-stamped ledger must
        audit clean — zero double-reconcile, zero epoch regression —
        under seeded schedule perturbation at every tracked lock."""
        base = FakeClient()
        gate = PartitionGate()
        ledger = ShardOpLedger()
        shards = 2
        lease_d, renew_d = 0.5, 0.3

        def mk(ident):
            return ShardedController(
                PartitionedClient(base, ident, gate), ident, shards,
                lease_prefix="rp-shard", lease_duration=lease_d,
                renew_deadline=renew_d, metrics=ShardMetrics(),
                ledger=ledger)

        a, b = mk("rp-a"), mk("rp-b")
        for s in (a, b):
            s.shard_map._renew_membership()

        keys = []
        i = 0
        while len(keys) < shards and i < 10_000:
            uid = f"uid-{i}"
            sh = shard_for("tenant", uid, shards)
            if sh not in [k[1] for k in keys]:
                keys.append((uid, sh))
            i += 1

        stop = threading.Event()

        def drive(replica):
            while not stop.is_set():
                replica.sync_once()
                for uid, _sh in keys:
                    replica.gate.admit("tenant", uid, "reconcile")
                time.sleep(0.01)

        threads = [threading.Thread(target=drive, args=(r,), daemon=True)
                   for r in (a, b)]
        with racelab.fuzz(seed=seed, yield_rate=0.2, max_sleep_s=0.002):
            for t in threads:
                t.start()
            # let the fleet settle into a full partition of the keyspace
            deadline = time.monotonic() + 5.0
            settled = False
            while time.monotonic() < deadline:
                owned = (a.shard_map.owned(), b.shard_map.owned())
                if (owned[0] | owned[1] == set(range(shards))
                        and not owned[0] & owned[1]):
                    settled = True
                    break
                time.sleep(0.02)
            assert settled, "fleet never settled"
            victim = a if a.shard_map.owned() else b
            if len(a.shard_map.owned()) >= len(b.shard_map.owned()):
                victim, survivor = a, b
            else:
                victim, survivor = b, a
            gate.partition(victim.identity)
            # the survivor must own everything within ~one lease of the
            # victim's confidence lapsing
            deadline = time.monotonic() + 4.0 * lease_d + 2.0
            took_over = False
            while time.monotonic() < deadline:
                if survivor.shard_map.owned() == set(range(shards)):
                    took_over = True
                    break
                time.sleep(0.02)
            stop.set()
            for t in threads:
                t.join(timeout=5.0)
            gate.heal()
        assert took_over, "survivor never took over the keyspace"
        return ledger

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_zero_double_reconcile_under_fuzzed_schedules(self, seed):
        ledger = self._one_run(seed)
        assert ledger.violations() == []
        assert len(ledger.ops()) > 0  # both replicas actually admitted


# --------------------------------------------------------------------------
# CleanupManager min_gap: the sweep-storm debounce
# --------------------------------------------------------------------------

class TestCleanupMinGap:
    def _counting(self, mgr):
        count = [0]
        orig = mgr.sweep_once

        def counted():
            count[0] += 1
            return orig()

        mgr.sweep_once = counted
        return count

    def test_kicks_coalesce_inside_gap(self):
        """A reconcile storm's kicks collapse into bounded sweeps: with
        min_gap, 20 rapid kicks may not produce 20 full-store LISTs."""
        client = FakeClient()
        mgr = CleanupManager(client, interval=3600.0, min_gap=0.15)
        count = self._counting(mgr)
        mgr.start()
        try:
            for _ in range(20):
                mgr.kick()
                time.sleep(0.01)
            time.sleep(0.4)  # let the debounced sweep(s) run
        finally:
            mgr.stop()
        assert 1 <= count[0] <= 4  # not 20

    def test_default_keeps_immediate_sweeps(self):
        """min_gap=0 (the default) preserves the historical behavior:
        each kick sweeps promptly."""
        client = FakeClient()
        mgr = CleanupManager(client, interval=3600.0)
        count = self._counting(mgr)
        mgr.start()
        try:
            deadline = time.monotonic() + 2.0
            while count[0] < 3 and time.monotonic() < deadline:
                mgr.kick()
                time.sleep(0.05)
        finally:
            mgr.stop()
        assert count[0] >= 3

    def test_late_kick_still_sweeps_after_gap(self):
        """Debounce delays, never drops: a kick inside the gap is
        absorbed by the sweep that runs when the gap expires."""
        client = FakeClient()
        mgr = CleanupManager(client, interval=3600.0, min_gap=0.1)
        count = self._counting(mgr)
        mgr.start()
        try:
            mgr.kick()
            assert self._wait(lambda: count[0] >= 1)
            mgr.kick()  # lands inside the fresh gap
            assert self._wait(lambda: count[0] >= 2, timeout=2.0)
        finally:
            mgr.stop()

    @staticmethod
    def _wait(cond, timeout=2.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return True
            time.sleep(0.01)
        return False


# --------------------------------------------------------------------------
# held against the JAX package
# --------------------------------------------------------------------------

def _key_corpus(seed=0, n=2000):
    rng = random.Random(seed)
    namespaces = ["default", "tenant-a", "tenant-b", "kube-system", "",
                  "serve-tenant"]
    return [(rng.choice(namespaces),
             f"{rng.getrandbits(128):032x}" if i % 2 else f"uid-{i}")
            for i in range(n)]


def _op_lists(seed):
    rng = random.Random(seed)
    return [(rng.randrange(3), rng.randrange(1, 4), rng.choice("abc"),
             f"reconcile:ns/u{i}") for i in range(rng.randrange(5, 60))]


class TestAgainstJax:
    @pytest.mark.parametrize("shards", [1, 3, 4, 16])
    def test_shard_for_routes_every_key_alike(self, shards):
        corpus = _key_corpus()
        assert [shard_for(ns, uid, shards) for ns, uid in corpus] == \
            [jax_shardmap.shard_for(ns, uid, shards) for ns, uid in corpus]

    def test_lease_names_alike(self):
        for prefix, i, ident in (("controller-shard", 0, "ctl-a"),
                                 ("p", 15, "r-0")):
            assert shard_lease_name(prefix, i) == \
                jax_shardmap.shard_lease_name(prefix, i)
            assert member_lease_name(prefix, ident) == \
                jax_shardmap.member_lease_name(prefix, ident)

    @pytest.mark.parametrize("seed", range(6))
    def test_ledger_violations_alike(self, seed):
        ops = _op_lists(seed)
        port, ref = ShardOpLedger(), jax_shardmap.ShardOpLedger()
        for op in ops:
            port.record(*op)
            ref.record(*op)
        assert port.violations() == ref.violations()
        assert port.ops() == ref.ops()

    def test_shard_smokes_agree(self):
        port = run_shard_smoke()
        ref = jax_stresslab.run_shard_smoke()
        assert port["ok"], port["result"]
        assert ref["ok"], ref["result"]
        p, r = port["result"], ref["result"]
        for key in ("n_domains", "n_replicas", "shards"):
            assert p[key] == r[key]
        for res in (p, r):
            assert res["throughput"]["ledger_violations"] == []
            assert res["partition"]["ledger_violations"] == []
            assert res["failover"]["within_one_lease"]
            assert res["failover"]["conservation_exact"]
        assert (p["failover"]["expected_gpu_seconds"]
                == p["failover"]["observed_gpu_seconds"])
        assert (r["failover"]["expected_chip_seconds"]
                == r["failover"]["observed_chip_seconds"])

    def test_controller_binary_with_two_shards(self):
        """``--shards 2`` as an OS process: it takes both shards of an
        empty fleet, counts them in ``gpu_dra_shard_owned``, and on
        SIGTERM empties its leases and exits 0 — as the JAX binary does
        with the same flags."""
        server = ApiServer().start()
        client = HttpClient(server.endpoint)
        env = dict(os.environ, PYTHONPATH=REPO)
        with tempfile.NamedTemporaryFile("w+", suffix=".log") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "k8s_dra_driver_tpu_torch.plugins.compute_domain_controller",
                 "--api-endpoint", server.endpoint, "--metrics-port", "0",
                 "--shards", "2", "--identity", "ctl-x"],
                stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=env)
            try:
                def logged(pattern):
                    log.seek(0)
                    m = re.search(pattern, log.read())
                    return m.group(1) if m else None

                def holders():
                    return [(client.try_get(KIND_LEASE, shard_lease_name(
                        "controller-shard", i), "default") or {})
                        .get("spec", {}).get("holderIdentity")
                        for i in range(2)]

                assert _until(lambda: logged(
                    r"(compute-domain-controller running)")), logged("(.*)")
                port = logged(r"metrics on http://127\.0\.0\.1:(\d+)/")
                assert _until(lambda: holders() == ["ctl-x", "ctl-x"],
                              timeout=15.0), holders()
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                    text = r.read().decode()
                assert 'gpu_dra_shard_owned{identity="ctl-x"} 2.0' in text
                assert 'gpu_dra_shard_handoffs_total{reason="acquire"} 2.0' \
                    in text
                proc.terminate()
                assert proc.wait(timeout=30) == 0
                assert holders() == ["", ""]
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=10)
                server.stop()
        jax_args = jax_controller_main.build_parser().parse_args(
            ["--shards", "2", "--identity", "ctl-x"])
        assert (jax_args.shards, jax_args.identity) == (2, "ctl-x")


def _until(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()
