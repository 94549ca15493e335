"""The port's crash explorer (``pkg/crashlab.py``) and its shared
atomic-publish helper (``pkg/durability.py``), held against the JAX
package's ``tests/test_crashlab.py`` case for case: the explorer
enumerates deterministically, its oracle catches broken recovery, and the
torn-file recovery matrix holds at the bootstrap layer. Then against the
JAX package itself: each scenario's crash-site list and the full corpus's
sorted verdict log through both explorers (the port's GPU stack on the
``h100-8`` mock, JAX's TPU stack on ``v5e-8``) are equal.
"""

import json
import os

import pytest

from k8s_dra_driver_tpu.pkg import crashlab as jax_crashlab
from k8s_dra_driver_tpu_torch.cdi.spec import CDIDevice
from k8s_dra_driver_tpu_torch.pkg import crashlab, durability, faultpoints
from k8s_dra_driver_tpu_torch.pkg.durability import (
    atomic_publish,
    fsync_enabled,
)
from k8s_dra_driver_tpu_torch.pkg.faultpoints import FaultCrash
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_COMPLETED,
    Checkpoint,
    CheckpointManager,
    CorruptCheckpointError,
    PreparedClaimCP,
    bootstrap_checkpoint,
)


class TestAtomicPublish:
    def test_payload_forms(self, tmp_path):
        p = tmp_path / "f"
        atomic_publish(p, "text")
        assert p.read_text() == "text"
        atomic_publish(p, b"bytes")
        assert p.read_bytes() == b"bytes"
        atomic_publish(p, lambda f: json.dump({"k": 1}, f))
        assert json.loads(p.read_text()) == {"k": 1}
        assert not (tmp_path / "f.tmp").exists()

    def test_returns_published_stat_sig(self, tmp_path):
        p = tmp_path / "f"
        sig = atomic_publish(p, "x")
        st = os.stat(p)
        assert sig == (st.st_ino, st.st_size, st.st_mtime_ns)

    def test_crash_before_write_leaves_file_untouched(self, tmp_path):
        p = tmp_path / "f"
        atomic_publish(p, "old")
        with faultpoints.injected("durability.write=crash-nth:1"):
            with pytest.raises(FaultCrash):
                atomic_publish(p, "new")
        assert p.read_text() == "old"
        assert not (tmp_path / "f.tmp").exists()

    def test_crash_in_torn_window_leaves_old_published(self, tmp_path):
        """`durability.replace=crash-nth` dies with the .tmp durable and
        the published path untouched — the protocol's whole promise."""
        p = tmp_path / "f"
        atomic_publish(p, "old")
        with faultpoints.injected("durability.replace=crash-nth:1"):
            with pytest.raises(FaultCrash):
                atomic_publish(p, "new")
        assert p.read_text() == "old"
        assert (tmp_path / "f.tmp").read_text() == "new"
        # And the next publish rolls straight over the stale .tmp.
        atomic_publish(p, "newer")
        assert p.read_text() == "newer"

    def test_before_replace_runs_in_torn_window(self, tmp_path):
        p = tmp_path / "f"
        atomic_publish(p, "old")
        seen = {}

        def hook(tmp):
            seen["tmp_content"] = open(tmp).read()
            seen["published"] = p.read_text()

        atomic_publish(p, "new", before_replace=hook)
        assert seen == {"tmp_content": "new", "published": "old"}

    def test_custom_tmp_path(self, tmp_path):
        p = tmp_path / "cp.json"
        atomic_publish(p, "x", tmp=p.with_suffix(".tmp"))
        assert p.read_text() == "x"
        assert not p.with_suffix(".tmp").exists()

    def test_injected_error_propagates(self, tmp_path):
        with faultpoints.injected("durability.write=nth:1"):
            with pytest.raises(faultpoints.InjectedFault):
                atomic_publish(tmp_path / "f", "x")


class TestFsyncEnvParsing:
    """GPU_DRA_CHECKPOINT_FSYNC edge cases: only the documented truthy
    spellings enable the per-write fsync."""

    @pytest.mark.parametrize("value", ["1", "true", "TRUE", " on ",
                                       "Always"])
    def test_truthy(self, value):
        assert fsync_enabled({durability.ENV_CHECKPOINT_FSYNC: value})

    @pytest.mark.parametrize("value", ["0", "", "  ", "no", "off",
                                       "false", "yes", "2", "enable"])
    def test_falsy_and_unknown(self, value):
        assert not fsync_enabled({durability.ENV_CHECKPOINT_FSYNC: value})

    def test_unset(self):
        assert not fsync_enabled({})

    def test_sync_param_overrides_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv(durability.ENV_CHECKPOINT_FSYNC, "1")
        atomic_publish(tmp_path / "f", "x", sync=False)  # must not raise
        assert (tmp_path / "f").read_text() == "x"


def _cp_with_claim(boot: str) -> Checkpoint:
    cp = Checkpoint(node_boot_id=boot)
    cp.prepared_claims["uid-1"] = PreparedClaimCP(
        state=STATE_PREPARE_COMPLETED,
        prepared_devices=[{"device": "gpu-0"}])
    return cp


class TestTornBootstrapFixtures:
    """The byte-level recovery matrix at the bootstrap layer."""

    def _mgr(self, tmp_path) -> CheckpointManager:
        return CheckpointManager(str(tmp_path / "cp.json"))

    def test_truncated_main_good_bak_reboot_recovers(self, tmp_path):
        mgr = self._mgr(tmp_path)
        mgr.write(_cp_with_claim("boot-1"))
        mgr.backup_path.write_text(mgr.path.read_text())  # last publish
        data = mgr.path.read_bytes()
        mgr.path.write_bytes(data[: len(data) // 2])      # torn mid-rename
        discarded = []
        bootstrap_checkpoint(self._mgr(tmp_path), "boot-2",
                             on_discard=lambda uid, pc: discarded.append(uid))
        assert discarded == ["uid-1"]  # the .bak's claims were discarded
        got = self._mgr(tmp_path).read()
        assert got.node_boot_id == "boot-2"
        assert got.prepared_claims == {}

    def test_garbage_main_no_bak_reboot_resets(self, tmp_path):
        mgr = self._mgr(tmp_path)
        mgr.write(_cp_with_claim("boot-1"))
        mgr.path.write_bytes(b"\x00not json{{{")
        discarded = []
        bootstrap_checkpoint(self._mgr(tmp_path), "boot-2",
                             on_discard=lambda uid, pc: discarded.append(uid))
        assert discarded == []  # nothing recoverable to discard
        got = self._mgr(tmp_path).read()
        assert got.node_boot_id == "boot-2"
        assert got.prepared_claims == {}

    def test_both_torn_reboot_resets_not_misparses(self, tmp_path):
        mgr = self._mgr(tmp_path)
        mgr.write(_cp_with_claim("boot-1"))
        mgr.backup_path.write_bytes(b"\xff\xfe torn bytes")  # invalid UTF-8
        mgr.path.write_bytes(b"{\"v2\": 17")
        bootstrap_checkpoint(self._mgr(tmp_path), "boot-2")
        got = self._mgr(tmp_path).read()
        assert got.node_boot_id == "boot-2"
        assert got.prepared_claims == {}

    def test_same_boot_corruption_refuses_loudly(self, tmp_path):
        """Same-boot corruption is unexplainable by the rename protocol:
        bootstrap must raise, never resume from possibly-stale state."""
        mgr = self._mgr(tmp_path)
        mgr.write(_cp_with_claim("boot-1"))
        mgr.backup_path.write_text(mgr.path.read_text())
        mgr.path.write_bytes(b"\x00not json{{{")
        with pytest.raises(CorruptCheckpointError):
            bootstrap_checkpoint(self._mgr(tmp_path), "boot-1")

    def test_invalid_utf8_main_is_corruption_not_crash(self, tmp_path):
        """A torn file is arbitrary bytes, and read() must surface
        CorruptCheckpointError, not die with UnicodeDecodeError."""
        mgr = self._mgr(tmp_path)
        mgr.write(_cp_with_claim("boot-1"))
        mgr.path.write_bytes(b"\xff\xfe not utf8")
        with pytest.raises(CorruptCheckpointError):
            self._mgr(tmp_path).read()

    def test_unreadable_boot_id_never_resets_over_torn_state(self, tmp_path):
        mgr = self._mgr(tmp_path)
        mgr.write(_cp_with_claim("boot-1"))
        mgr.backup_path.write_text(mgr.path.read_text())
        mgr.path.write_bytes(b"\x00garbage")
        with pytest.raises(CorruptCheckpointError):
            bootstrap_checkpoint(self._mgr(tmp_path), "")


class TestCrashCapableSchedules:
    """Literal crash-position schedules for every crash-capable point the
    chaos tests do not already cover."""

    def test_checkpoint_read_crash(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "cp.json"))
        mgr.write(_cp_with_claim("boot-1"))
        with faultpoints.injected("checkpoint.read=crash-nth:1"):
            with pytest.raises(FaultCrash):
                mgr.read()
        assert list(mgr.read().prepared_claims) == ["uid-1"]

    def test_devicestate_prepare_crash_then_replay(self, tmp_path):
        env = crashlab._gpu_env(str(tmp_path))
        scenario = crashlab.SCENARIOS["prepare"]
        scenario.setup(env)
        with faultpoints.injected("devicestate.prepare=crash-nth:1"):
            with pytest.raises(FaultCrash):
                scenario.run(env)
        problems: list[str] = []
        scenario.recover(env)
        scenario.oracle(env, problems)
        assert problems == []

    def test_durability_write_and_replace_crash(self, tmp_path):
        p = tmp_path / "f"
        atomic_publish(p, "old")
        with faultpoints.injected(
                "durability.write=crash-nth:1;"
                "durability.replace=crash-nth:1"):
            with pytest.raises(FaultCrash):
                atomic_publish(p, "new")
        assert p.read_text() == "old"


class TestExplorer:
    def test_enumeration_covers_every_capable_point(self):
        """Corpus-wide, every crash-capable point appears in at least
        one scenario's path — the 'zero un-crashed points' half."""
        seen: set[str] = set()
        for name in sorted(crashlab.SCENARIOS):
            seen.update(p for p, _ in crashlab.enumerate_sites(
                crashlab.SCENARIOS[name]))
        assert seen == set(crashlab.CRASH_CAPABLE_POINTS)

    def test_enumeration_is_deterministic(self):
        scenario = crashlab.SCENARIOS["prepare"]
        assert crashlab.enumerate_sites(scenario) == \
            crashlab.enumerate_sites(scenario)

    def test_smoke_slice_green_and_deterministic(self):
        r1 = crashlab.run_crash_smoke(seed=3)
        assert r1["oracle_violations"] == [], r1["oracle_violations"]
        assert r1["sites_explored"] == r1["sites_enumerated"] > 0
        assert r1["torn_explored"] == len(crashlab.TORN_VARIANTS)
        r2 = crashlab.run_crash_smoke(seed=3)
        assert r1["verdict_log"] == r2["verdict_log"]
        assert r1["sites_enumerated"] == r2["sites_enumerated"]

    def test_capped_run_counts_skips_never_full_coverage(self):
        r = crashlab.run_crashlab(scenarios=["node_epoch"],
                                  max_sites_per_scenario=1, torn=False)
        assert r["sites_explored"] == 1
        assert r["sites_skipped"] == r["sites_enumerated"] - 1 > 0
        assert not r["coverage_ok"]

    def test_unknown_scenario_rejected(self):
        with pytest.raises(ValueError):
            crashlab.run_crashlab(scenarios=["nope"])

    def test_broken_recovery_is_reported(self):
        """The oracle is live, not decorative: a recovery path that
        leaks an artifact must surface as a violation."""

        class BrokenRecovery(crashlab.PrepareScenario):
            name = "broken-recovery"
            torn = False

            def recover(self, env):
                super().recover(env)
                # Sabotage: a CDI spec nothing checkpointed owns — the
                # startup sweep was "forgotten".
                env["driver"].cdi.create_claim_spec_file(
                    "deadbeef", [CDIDevice(name="x")])

        r = crashlab.explore_site(BrokenRecovery(), "checkpoint.write",
                                  1, seed=0)
        assert r["crashed"]
        assert any("CDI spec" in p for p in r["problems"]), r["problems"]

    def test_never_crashing_site_is_a_verdict(self):
        """A site the scenario's path never reaches reads as enumeration
        drift, not silence."""
        r = crashlab.explore_site(crashlab.SCENARIOS["node_epoch"],
                                  "cdi.write", 1, seed=0)
        assert not r["crashed"]
        assert any("never crashed" in p for p in r["problems"])

    def test_torn_variant_verdicts(self):
        for variant in crashlab.TORN_VARIANTS:
            r = crashlab.explore_torn(crashlab.SCENARIOS["prepare"],
                                      variant)
            assert r["problems"] == [], (variant, r["problems"])

    def test_full_corpus_green(self):
        r = crashlab.run_crashlab()
        assert r["oracle_violations"] == [] and r["coverage_ok"]
        assert r["uncrashed_capable_points"] == []
        assert r["sites_explored"] == r["sites_enumerated"] == 97
        assert r["torn_explored"] == len(crashlab.TORN_VARIANTS)

    def test_setup_may_swap_the_driver_factory(self, tmp_path):
        """A scenario reaches another device library through its own
        ``setup`` (the smoke's card leg does): the factory it installs
        builds every driver of the run and of the recovery."""
        from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
            GpuDriver,
        )

        profile = dl._h100_8_profile(0)
        profile["gpus"] = profile["gpus"][:4]
        built = []

        class OnOtherLib(crashlab.PrepareScenario):
            name = "other-lib"
            torn = False

            def setup(self, env):
                def new_driver():
                    drv = GpuDriver(env["client"], env["cfg"],
                                    device_lib=dl.MockDeviceLib(profile)
                                    ).start()
                    built.append(drv)
                    env["driver"] = drv
                    return drv

                env["new_driver"] = new_driver
                super().setup(env)

        sites = crashlab.enumerate_sites(OnOtherLib())
        r = crashlab.explore_site(OnOtherLib(), *sites[0], seed=0)
        assert r["crashed"] and r["problems"] == []
        assert all(len(d.state.gpus) == 4 for d in built) and built


class TestFaultPlanHits:
    def test_hits_counts_scheduled_points_only(self):
        plan = faultpoints.FaultPlan(seed=0)
        plan.add("durability.write", "nth:999")
        with faultpoints.injected(plan=plan):
            faultpoints.maybe_fail("durability.write")
            faultpoints.maybe_fail("durability.write")
            faultpoints.maybe_fail("k8sclient.fake.read")  # unscheduled
        assert plan.hits() == {"durability.write": 2}


class TestAgainstJax:
    def test_capable_points_and_variants_match(self):
        assert crashlab.CRASH_CAPABLE_POINTS == \
            jax_crashlab.CRASH_CAPABLE_POINTS
        assert crashlab.TORN_VARIANTS == jax_crashlab.TORN_VARIANTS
        assert sorted(crashlab.SCENARIOS) == sorted(jax_crashlab.SCENARIOS)
        assert {n: s.torn for n, s in crashlab.SCENARIOS.items()} == \
            {n: s.torn for n, s in jax_crashlab.SCENARIOS.items()}

    @pytest.mark.parametrize("name", sorted(crashlab.SCENARIOS))
    def test_site_list_matches_jax(self, name):
        """The GPU stack hits every crash-capable point as often as the
        TPU stack on the same scenario: the same publishes, in the same
        number."""
        got = crashlab.enumerate_sites(crashlab.SCENARIOS[name])
        want = jax_crashlab.enumerate_sites(jax_crashlab.SCENARIOS[name])
        assert sorted(got) == sorted(want)
        assert got

    def test_verdict_log_matches_jax(self):
        got = crashlab.run_crashlab(seed=5)
        want = jax_crashlab.run_crashlab(seed=5)
        assert got["verdict_log"] == want["verdict_log"]
        assert got["per_scenario"] == want["per_scenario"]
        assert {s: v["sites"] for s, v in got["per_scenario"].items()} == {
            "prepare": 34, "unprepare": 14, "drain_tombstone": 7,
            "reallocation": 16, "fence_cleanup": 14, "node_epoch": 4,
            "incident_bundle": 8}


def _one_gpu_node():
    from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl

    profile = dl._h100_8_profile(0)
    profile["gpus"] = profile["gpus"][:1]
    lib = dl.MockDeviceLib(profile)
    return lib, lib.enumerate_gpus()[0]


#: The crash and race phases' engine at a CPU engine's size.
SMALL_CHECK_WIDTH = {"max_batch": 4, "heads": 2, "head_dim": 8, "kv_cap": 64,
                     "prompts": (8, 40), "new_tokens": 4, "requests": 6,
                     "device": "cpu"}


def test_the_smokes_crash_phase_on_a_mock_node(tmp_path, monkeypatch,
                                               capsys):
    """``chip_smoke.phase_crash`` as the card runs it, on a mock node of one
    GPU with a small CPU engine: the full corpus twice, then the one claim
    crashed at every site of its prepare and recovered, prepared again on
    the recovered plugin and served, nothing and no thread left."""
    import chip_smoke
    from k8s_dra_driver_tpu_torch.compute import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib, gpu = _one_gpu_node()
    out = chip_smoke.phase_crash("mock", 0, lib, gpu, width={
        **SMALL_CHECK_WIDTH, "uuids": {gpu.uuid: 0}})
    assert out["host"]["coverage_ok"] and out["host"]["sites_explored"] == 97
    assert out["card_sites"] == 18
    assert out["launches"] == 0 and out["decode_steps"] > 0  # plain on CPU
    assert out["residue"] == [] and out["threads_left"] == []
    assert out["max_abs_err"] is None
    text = capsys.readouterr().out
    assert text.count("[crash]") == 3 and "violations=0" in text


def test_the_smokes_crash_phase_holds_the_host_oracle(monkeypatch):
    """No fallback: a host run with an oracle violation fails the phase
    before the card leg."""
    import chip_smoke

    run = crashlab.run_crashlab

    def violated(**kw):
        return dict(run(**kw), oracle_violations=["prepare|cdi.write|1: x"])

    monkeypatch.setattr(chip_smoke.crashlab, "run_crashlab", violated)
    lib, gpu = _one_gpu_node()
    with pytest.raises(SystemExit, match="crash: violations"):
        chip_smoke.phase_crash("mock", 0, lib, gpu, width={
            **SMALL_CHECK_WIDTH, "uuids": {gpu.uuid: 0}})
