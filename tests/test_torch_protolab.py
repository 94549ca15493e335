"""The port's protocol model checker (``pkg/protolab.py``) over the port's
real coordination code, held against the JAX package's
``tests/test_protolab.py`` case for case: full transition coverage with
zero violations on the real implementations, counted caps that refuse to
read as complete, every planted bug detected with a 1-minimal
counterexample, byte-identical same-seed double-runs, counterexample
schedules that replay through the racelab fuzzer's slot
(``stresslab.replay_protocol_counterexample``), and ``ShardMap``'s
``max_shards``. Then against the JAX package itself: each model's states,
edges and sorted verdict log, and every planted counterexample's trace,
equal through both packages (the port's plugin identity ``gpu-plugin``
where JAX's is ``tpu-plugin``). One module-scoped run of each package's
``run_protolab()`` and ``run_planted_corpus()`` feeds the cases.
"""

import logging

import pytest

from k8s_dra_driver_tpu.pkg import protolab as jax_protolab
from k8s_dra_driver_tpu_torch.internal.stresslab import (
    replay_protocol_counterexample,
)
from k8s_dra_driver_tpu_torch.k8sclient.client import FakeClient
from k8s_dra_driver_tpu_torch.pkg import racelab
from k8s_dra_driver_tpu_torch.pkg.protolab import (
    PLANTED_VIOLATIONS,
    PROTOCOL_MODELS,
    CounterexampleSchedule,
    explore_model,
    replay_trace,
    run_planted_corpus,
    run_proto_smoke,
    run_protolab,
)
from k8s_dra_driver_tpu_torch.pkg.shardmap import ShardMap, shard_lease_name

#: Every registered model:transition pair, as quoted literals: an
#: enumeration-drift regression (a transition the exploration can no
#: longer reach) fails the reachability test below, and a registry edit
#: without a matching edit here fails test_expected_matches_registry.
EXPECTED_TRANSITIONS = (
    "elector:acquire", "elector:renew", "elector:expire",
    "elector:step_down", "elector:release", "elector:crash",
    "elector:restart", "elector:partition", "elector:heal",
    "fence_ack:renew", "fence_ack:stamp_fence", "fence_ack:cleanup_ack",
    "fence_ack:fence_clear", "fence_ack:crash", "fence_ack:restart",
    "fence_ack:partition", "fence_ack:heal",
    "lifecycle:renew", "lifecycle:cordon", "lifecycle:drain_annotate",
    "lifecycle:repair", "lifecycle:cleanup_ack", "lifecycle:fence_clear",
    "lifecycle:uncordon", "lifecycle:crash", "lifecycle:restart",
    "lifecycle:partition", "lifecycle:heal",
    "shard_map:acquire", "shard_map:renew", "shard_map:step_down",
    "shard_map:release", "shard_map:crash", "shard_map:restart",
    "shard_map:partition", "shard_map:heal",
    "shard_rebalance:join", "shard_rebalance:leave",
    "shard_rebalance:acquire", "shard_rebalance:takeover",
    "shard_rebalance:renew", "shard_rebalance:handoff",
    "shard_rebalance:hysteresis_defer",
)

#: Each model's deduped state count on the JAX package's exploration,
#: which the port's must equal.
JAX_STATES = {"elector": 271, "fence_ack": 660, "lifecycle": 222,
              "shard_map": 965, "shard_rebalance": 2118}


def _as_jax(text: str) -> str:
    """A port verdict line or action in the JAX package's identities."""
    return text.replace("gpu-plugin", "tpu-plugin")


@pytest.fixture(autouse=True)
def _quiet():
    # Direct explore_model calls bypass run_protolab's logging guard;
    # election/nodelease log every step-down and cordon.
    logging.disable(logging.CRITICAL)
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture(scope="module")
def full_runs():
    """Both packages' ``run_protolab()`` over every model, once."""
    return {"port": run_protolab(), "jax": jax_protolab.run_protolab()}


@pytest.fixture(scope="module")
def real_runs(full_runs):
    return full_runs["port"]["per_model"]


@pytest.fixture(scope="module")
def corpus():
    return run_planted_corpus()


@pytest.fixture(scope="module")
def jax_corpus():
    return jax_protolab.run_planted_corpus()


class TestRegistry:
    def test_expected_matches_registry(self):
        """The evidence literals above and the live registry are the
        same set, both directions."""
        registered = {f"{name}:{t}"
                      for name, entry in PROTOCOL_MODELS.items()
                      for t in entry["transitions"]}
        assert set(EXPECTED_TRANSITIONS) == registered

    def test_at_least_four_protocols_modeled(self):
        assert len(PROTOCOL_MODELS) >= 4
        assert {"elector", "fence_ack", "lifecycle",
                "shard_map"} <= set(PROTOCOL_MODELS)

    def test_planted_corpus_covers_the_fence_bugs(self):
        """The corpus must at least re-introduce the two historical
        fence bugs the fence-ack protocol exists to prevent."""
        assert "fence_clear_unconditional" in PLANTED_VIOLATIONS
        assert "shared_fence_single_ack" in PLANTED_VIOLATIONS

    def test_modules_are_the_ports_files(self):
        """Each model lifts a file of the port, the counterpart of the
        file JAX's registry names."""
        from pathlib import Path

        root = Path(__file__).resolve().parent.parent
        for name, entry in PROTOCOL_MODELS.items():
            path = entry["module"]
            assert path.startswith("k8s_dra_driver_tpu_torch/"), name
            assert (root / path).is_file(), path
            jax = jax_protolab.PROTOCOL_MODELS[name]
            assert path.split("/", 1)[1] == jax["module"].split("/", 1)[1]
            assert entry["transitions"] == jax["transitions"]


class TestRealImplementations:
    @pytest.mark.parametrize("model", sorted(PROTOCOL_MODELS))
    def test_no_violations(self, real_runs, model):
        res = real_runs[model]
        assert res["violations"] == [], res["violations"]

    @pytest.mark.parametrize("model", sorted(PROTOCOL_MODELS))
    def test_full_transition_coverage(self, real_runs, model):
        res = real_runs[model]
        expected = {p.split(":", 1)[1] for p in EXPECTED_TRANSITIONS
                    if p.startswith(model + ":")}
        assert set(res["transitions_reached"]) == expected
        assert res["transitions_unreached"] == []

    @pytest.mark.parametrize("model", sorted(PROTOCOL_MODELS))
    def test_uncapped_and_coverage_ok(self, real_runs, model):
        res = real_runs[model]
        assert res["depth_cap_hits"] == 0
        assert res["state_cap_unexplored"] == 0
        assert res["coverage_ok"]
        assert res["states_explored"] > 100  # genuinely explored, not a
        # degenerate two-state walk

    @pytest.mark.parametrize("model", sorted(PROTOCOL_MODELS))
    def test_liveness_checked_everywhere(self, real_runs, model):
        """Every interior explored state got a fair-continuation
        convergence check (liveness as bounded reachability)."""
        res = real_runs[model]
        assert res["liveness_checked"] == res["states_explored"]


class TestCoverageAccounting:
    def test_depth_cap_counted_and_fails_coverage(self):
        res = explore_model("elector", max_depth=3, liveness=False)
        assert res["depth_cap_hits"] > 0
        assert not res["coverage_ok"]

    def test_state_cap_counted_and_fails_coverage(self):
        res = explore_model("elector", max_states=40, liveness=False)
        assert res["state_cap_unexplored"] > 0
        assert not res["coverage_ok"]


class TestDeterminism:
    def test_same_seed_double_run_byte_identical(self):
        r1 = run_protolab(models=("elector",), seed=7)
        r2 = run_protolab(models=("elector",), seed=7)
        assert r1["verdict_log"] == r2["verdict_log"]
        assert r1["verdict_log"], "verdict log must not be empty"

    def test_replay_trace_deterministic(self):
        trace = ["round:cand-a", "advance", "advance", "advance",
                 "round:cand-b"]
        r1 = replay_trace("elector", trace, planted=("zombie_leader",))
        r2 = replay_trace("elector", trace, planted=("zombie_leader",))
        assert r1 == r2
        assert any(v.startswith("single_leader") for v in r1["violations"])


class TestPlantedCorpus:
    def test_all_detected(self, corpus):
        assert corpus["planted_total"] == len(PLANTED_VIOLATIONS)
        assert corpus["planted_detected"] == corpus["planted_total"]
        assert corpus["all_detected"]

    def test_expected_oracle_per_plant(self, corpus):
        for plant, entry in corpus["per_plant"].items():
            assert entry["detected"], plant
            assert entry["model"] == PLANTED_VIOLATIONS[plant]["model"]

    def test_counterexamples_one_minimal(self, corpus):
        """No single action can be removed from any counterexample and
        still reproduce — verified by exhaustive single-removal replay
        inside run_planted_corpus, asserted here per plant."""
        for plant, entry in corpus["per_plant"].items():
            assert entry["minimal"], (plant, entry["trace"])

    def test_counterexamples_replay_identical(self, corpus):
        for plant, entry in corpus["per_plant"].items():
            assert entry["replay_identical"], plant

    def test_corpus_verdict_log_deterministic(self, corpus):
        r2 = run_planted_corpus()
        assert corpus["verdict_log"] == r2["verdict_log"]

    def test_proto_smoke(self):
        """The smoke the card runs: 7 of 7 plants detected, minimal and
        replayed identically, the two cheapest real models clean and
        deterministic, with their state counts."""
        r = run_proto_smoke()
        assert r["planted_detected"] == r["planted_total"] == 7
        assert r["all_minimal"] and r["all_replay_identical"]
        assert r["violations"] == [] and r["coverage_ok"]
        assert r["deterministic"]
        assert r["states"] == {m: JAX_STATES[m]
                               for m in ("elector", "fence_ack")}


class TestCounterexampleReplay:
    """Every planted-violation trace re-runs as a seeded deterministic
    schedule through the racelab fuzzer harness and reproduces the
    violation byte-for-byte."""

    def test_every_plant_replays_through_racelab_harness(self, corpus):
        for plant, entry in corpus["per_plant"].items():
            info = PLANTED_VIOLATIONS[plant]
            out = replay_protocol_counterexample(
                info["model"], entry["schedule"], planted=(plant,))
            assert any(v.startswith(info["oracle"])
                       for v in out["violations"]), (plant, out)
            assert out["schedule_identical"], plant
            assert out["trace"] == entry["trace"], plant

    def test_replay_restores_prior_fuzzer(self, corpus):
        sentinel = racelab.ScheduleFuzzer(seed=3)
        prev = racelab.set_fuzzer(sentinel)
        try:
            entry = corpus["per_plant"]["zombie_leader"]
            replay_protocol_counterexample(
                "elector", entry["schedule"], planted=("zombie_leader",))
            assert racelab.current_fuzzer() is sentinel
        finally:
            racelab.set_fuzzer(prev)

    def test_schedule_round_trip(self):
        sched = CounterexampleSchedule.from_trace(
            "elector", ["round:cand-a", "advance"])
        entries = sched.log()
        assert entries == [("protolab.elector.step", 1, "round:cand-a"),
                           ("protolab.elector.step", 2, "advance")]
        again = CounterexampleSchedule(entries)
        assert again.to_trace() == ["round:cand-a", "advance"]
        assert again.log() == entries
        # The racelab fuzzer surface: preempt() is a counting no-op.
        again.preempt("sanitizer.lock")
        assert again.decide("protolab.elector.step", 2) == "advance"


class TestShardMap:
    def _mk(self, client, ident, **kw):
        kw.setdefault("lease_duration", 10.0)
        kw.setdefault("renew_deadline", 6.0)
        return ShardMap(client, ident, 3, lease_prefix="t-shard",
                        max_shards=kw.pop("max_shards", 3), **kw)

    def test_single_instance_claims_all_shards(self):
        fake = FakeClient()
        now = [1000.0]
        sm = self._mk(fake, "a", clock=lambda: now[0])
        assert sm.sync_once() == {0, 1, 2}
        assert sm.acquisitions == 3
        assert all(sm.confident(s) for s in range(3))

    def test_max_shards_caps_ownership(self):
        fake = FakeClient()
        now = [1000.0]
        sm1 = self._mk(fake, "a", clock=lambda: now[0], max_shards=2)
        sm2 = self._mk(fake, "b", clock=lambda: now[0], max_shards=2)
        owned1 = sm1.sync_once()
        owned2 = sm2.sync_once()
        assert len(owned1) == 2
        assert owned1 | owned2 == {0, 1, 2}
        assert not owned1 & owned2

    def test_confident_expires_with_renew_deadline(self):
        fake = FakeClient()
        now = [1000.0]
        sm = self._mk(fake, "a", clock=lambda: now[0])
        sm.sync_once()
        assert sm.confident(0)
        now[0] += 7.0  # past renew_deadline, inside lease_duration
        assert not sm.confident(0)
        assert 0 in sm.owned()  # believes — but must not act
        sm.sync_once()  # renews
        assert sm.confident(0)

    def test_release_all_hands_over_immediately(self):
        fake = FakeClient()
        now = [1000.0]
        released = []
        sm1 = self._mk(fake, "a", clock=lambda: now[0],
                       on_released=released.append)
        sm2 = self._mk(fake, "b", clock=lambda: now[0])
        sm1.sync_once()
        sm1.release_all()
        assert sorted(released) == [0, 1, 2]
        assert sm1.owned() == set()
        assert sm1.releases == 3
        # No clock advance: the emptied leases hand over at once
        # (ReleaseOnCancel per shard).
        assert sm2.sync_once() == {0, 1, 2}

    def test_scan_order_identity_rotated_and_stable(self):
        fake = FakeClient()
        sm_a = self._mk(fake, "a")
        sm_b = self._mk(fake, "ctrl-b")
        assert sm_a._scan_order() == sm_a._scan_order()
        assert sorted(sm_a._scan_order()) == [0, 1, 2]
        assert sorted(sm_b._scan_order()) == [0, 1, 2]

    def test_shard_lease_name(self):
        assert shard_lease_name("controller-shard", 2) == "controller-shard-2"

    def test_rejects_nonpositive_shards(self):
        with pytest.raises(ValueError):
            ShardMap(FakeClient(), "a", 0)

    def test_debug_snapshot_counts(self):
        fake = FakeClient()
        now = [1000.0]
        sm = self._mk(fake, "a", clock=lambda: now[0], max_shards=2)
        sm.sync_once()
        now[0] += 1.5
        snap = sm.debug_snapshot()
        assert snap["identity"] == "a" and snap["max_shards"] == 2
        assert snap["owned"] == sorted(sm.owned()) and len(snap["owned"]) == 2
        assert snap["acquisitions"] == 2 and snap["releases"] == 0
        assert snap["renew_age_s"] == {s: 1.5 for s in snap["owned"]}


class TestOracleSpecifics:
    def test_zombie_leader_needs_the_bad_config(self):
        """The split-brain trace is only a violation under the planted
        renew_deadline > lease_duration config; the correct config
        holds the single-leader invariant on the same actions."""
        trace = ["round:cand-a", "advance", "advance", "advance",
                 "round:cand-b"]
        bad = replay_trace("elector", trace, planted=("zombie_leader",))
        good = replay_trace("elector", trace)
        assert any(v.startswith("single_leader") for v in bad["violations"])
        assert good["violations"] == []

    def test_epoch_reuse_detected_at_restart(self):
        res = replay_trace("fence_ack", ["crash:gpu-plugin"],
                           planted=("epoch_reuse",))
        assert any(v.startswith("epoch_monotone")
                   for v in res["violations"])

    def test_single_ack_unfences_dirty_sibling(self):
        """The shared-fence-single-ack plant: gpu-plugin's ack removes
        the whole fence while cd-plugin's cleanup never ran."""
        trace = ["renew:cd-plugin", "renew:gpu-plugin", "stamp",
                 "renew:gpu-plugin"]
        res = replay_trace("fence_ack", trace,
                           planted=("shared_fence_single_ack",))
        hits = [v for v in res["violations"]
                if v.startswith("fence_acked")]
        assert hits and "cd-plugin" in hits[0]


class TestAgainstJax:
    @pytest.mark.parametrize("model", sorted(PROTOCOL_MODELS))
    def test_model_matches_jax(self, full_runs, model):
        """States, edges, the transitions reached and the verdict lines
        of one model, equal through both packages."""
        got = full_runs["port"]["per_model"][model]
        want = full_runs["jax"]["per_model"][model]
        for key in ("states_explored", "edges_replayed",
                    "transitions_reached", "liveness_checked"):
            assert got[key] == want[key], key
        assert got["states_explored"] == JAX_STATES[model]
        prefix = f"model {model}:"
        assert [ln for ln in full_runs["port"]["verdict_log"]
                if ln.startswith(prefix)] == \
            [ln for ln in full_runs["jax"]["verdict_log"]
             if ln.startswith(prefix)]

    def test_verdict_log_matches_jax(self, full_runs):
        assert full_runs["port"]["verdict_log"] == \
            full_runs["jax"]["verdict_log"]
        assert full_runs["port"]["coverage_ok"]

    def test_planted_traces_match_jax(self, corpus, jax_corpus):
        """Every plant's minimal counterexample is the same trace and the
        same schedule through both packages."""
        assert sorted(corpus["per_plant"]) == sorted(jax_corpus["per_plant"])
        for plant, entry in corpus["per_plant"].items():
            want = jax_corpus["per_plant"][plant]
            assert [_as_jax(a) for a in entry["trace"]] == want["trace"]
            assert [(p, n, _as_jax(a)) for p, n, a in entry["schedule"]] \
                == [tuple(e) for e in want["schedule"]]
        assert [_as_jax(ln) for ln in corpus["verdict_log"]] == \
            jax_corpus["verdict_log"]


def test_the_smokes_proto_phase(capsys):
    """``chip_smoke.phase_proto`` as the card runs it (host only): 7 of 7
    plants, minimal and replayed, the real models clean, deterministic."""
    import chip_smoke

    r = chip_smoke.phase_proto("mock")
    assert r["planted_detected"] == 7 and r["deterministic"]
    text = capsys.readouterr().out
    assert "[proto]" in text and "planted=7/7" in text
    assert '"elector": 271' in text and '"fence_ack": 660' in text


def test_the_smokes_proto_phase_holds_every_plant(monkeypatch):
    """No fallback: an undetected plant fails the phase."""
    import chip_smoke

    def missed(seed=0):
        return dict(run_proto_smoke(seed), planted_detected=6)

    monkeypatch.setattr(chip_smoke.protolab, "run_proto_smoke", missed)
    with pytest.raises(SystemExit, match="proto: detected 6 of 7"):
        chip_smoke.phase_proto("mock")
