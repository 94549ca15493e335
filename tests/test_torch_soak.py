"""The GPU port's self-healing soak and its serving node-kill leg.

The scenarios of the JAX package's ``tests/test_serving.py``
``TestClaimReadySlo``, ``tests/test_remediation.py::TestSoakSmoke`` and
``tests/test_chaos.py::TestChaosSelfHealingQuick`` on the port's
``internal/stresslab.py``, with ``h100-8`` mock nodes: the ``claim_ready``
SLO's math, the replica loop, the soak's oracle under GPU chaos (and a
light API fault mix), the node-kill and partition legs, and
``run_serving_soak(device="cpu")``: tenant replicas decoding through a
node kill while the ``claim_ready`` page fires and clears, the flight
recorder resolves the incident and the usage meter conserves
GPU-seconds. ``TestAgainstJax`` runs the JAX package's serving soak at the
same seed: both oracles pass and the outcomes agree in kind."""

import time

import pytest
import torch

from k8s_dra_driver_tpu_torch.compute.serving import ServingMetrics
from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
from k8s_dra_driver_tpu_torch.internal.stresslab import (
    SOAK_FAULT_MIX,
    SOAK_SERVING_ENGINE,
    ServingReplica,
    run_serving_soak,
    run_soak,
)
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.pkg import faultpoints, slo as slolib
from k8s_dra_driver_tpu_torch.pkg.telemetry import (
    FLEET_SERVING_CLAIM_ATTEMPTS,
    RecordingRules,
    default_rules,
    parse_exposition,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    DRIVER_NAME,
)


class TestClaimReadySlo:
    def _rules_with(self, clock, rows_t0, rows_t1, dt=60.0):
        rules = RecordingRules(clock=lambda: clock[0])

        def fam(rows):
            text = (f"# TYPE {FLEET_SERVING_CLAIM_ATTEMPTS} counter\n"
                    + "".join(
                        f'{FLEET_SERVING_CLAIM_ATTEMPTS}'
                        f'{{tenant="{t}",outcome="{o}"}} {v}\n'
                        for t, o, v in rows))
            return parse_exposition(text)

        rules.observe(fam(rows_t0), now=clock[0])
        clock[0] += dt
        rules.observe(fam(rows_t1), now=clock[0])
        return rules

    def test_burns_on_failed_sessions(self):
        clock = [1000.0]
        rules = self._rules_with(
            clock,
            [("tenant-a", "ok", 100.0), ("tenant-a", "error", 0.0)],
            [("tenant-a", "ok", 130.0), ("tenant-a", "error", 20.0)])
        s = slolib.claim_ready_slo(0.99)
        # 30 ok of 50 sessions in the window → error ratio 0.4.
        assert s.name == slolib.SLO_CLAIM_READY
        assert s.error_ratio(rules, 120.0) == pytest.approx(0.4)
        assert s.burn_rate(rules, 120.0) == pytest.approx(40.0)

    def test_no_sessions_no_verdict(self):
        clock = [1000.0]
        rules = RecordingRules(clock=lambda: clock[0])
        assert slolib.claim_ready_slo().error_ratio(rules, 300.0) is None

    def test_all_green_burns_nothing(self):
        clock = [1000.0]
        rules = self._rules_with(
            clock,
            [("tenant-a", "ok", 10.0)], [("tenant-a", "ok", 60.0)])
        assert slolib.claim_ready_slo().error_ratio(rules, 120.0) \
            == pytest.approx(0.0)

    def test_recording_rule_is_default_and_computes_ratio(self):
        names = [r.name for r in default_rules()]
        assert "serving_claim_ready_ratio" in names
        rule = next(r for r in default_rules()
                    if r.name == "serving_claim_ready_ratio")
        clock = [1000.0]
        rules = self._rules_with(
            clock,
            [("tenant-a", "ok", 0.0), ("tenant-a", "error", 0.0)],
            [("tenant-a", "ok", 30.0), ("tenant-a", "error", 10.0)])
        assert rule.fn(rules, 120.0) == pytest.approx(0.75)


class TestReplicaLoop:
    def test_loop_cycles_sessions_until_stopped(self, tmp_path):
        """start() cycles bounded sessions through the claim path; stop()
        lets the session in flight finish and leaves the replica usable
        for a synchronous session (the soak's green round)."""
        client = FakeClient()
        client.create(new_object(
            "DeviceClass", DRIVER_NAME,
            spec={"selectors": [{"cel": {
                "expression": "device.attributes['type'] == 'gpu'"}}]}))
        client.create(new_object("Node", "node-0"))
        lib = MockDeviceLib("h100-8")
        driver = GpuDriver(client, DriverConfig(
            node_name="node-0", state_dir=str(tmp_path / "s"),
            cdi_root=str(tmp_path / "c"), env={}, retry_timeout=2.0,
        ), device_lib=lib).start()
        loop = NodePrepareLoop(client, driver, DRIVER_NAME, "node-0").start()
        rep = ServingReplica(
            name="r0", tenant="t", client=client,
            allocator=Allocator(client), node="node-0",
            metrics=ServingMetrics(),
            cdi_lookup=lambda _n, uid: driver.cdi.read_claim_spec(uid),
            serve_s=0.05, deadline_s=3.0, requests_per_burst=8,
            prompt_tokens=4, max_new_tokens=4,
            engine_kwargs=dict(SOAK_SERVING_ENGINE), device="cpu",
            uuids={g.uuid: g.index for g in lib.enumerate_gpus()})
        try:
            rep.start()
            deadline = time.monotonic() + 10.0
            while rep.sessions < 3 and time.monotonic() < deadline:
                time.sleep(0.02)
            rep.stop()
            assert rep._thread is None and not rep._stop.is_set()
            n = rep.sessions
            assert n >= 3 and rep.errors == 0, rep.last_error
            rec = rep.serve_once()
            assert rec["outcome"] == "ok" and rep.sessions == n + 1
            assert rep.completed + rep.shed + rep.rejected == rep.submitted
            assert rep.decode_steps > 0
            assert rep.decode_tokens >= rep.decode_steps
        finally:
            rep.stop()
            loop.stop()
            driver.stop()


class TestSoakSmoke:
    def test_short_soak_oracle_green(self):
        """Seconds-scale soak (no API fault mix): zero leaks, every claim
        terminal, every injection repaired + rejoined, SLO held."""
        r = run_soak(duration_s=2.0, n_nodes=2, gpu_fault_interval_s=0.4,
                     recovery_slo_s=5.0)
        assert r["error_count"] == 0, r["errors"]
        assert not r["leaks"], r["leaks"]
        assert r["outcomes"]["stuck"] == 0
        assert r["unresolved_injections"] == 0
        assert r["gpu_injections"] > 0
        assert r["slo_ok"]
        assert r["profile"] == "h100-8"


class TestChaosSelfHealingQuick:
    """A light mix still drains, reallocates, and rejoins with the oracle
    green."""

    def test_soak_light_mix(self, tmp_path):
        out = run_soak(duration_s=2.5, n_nodes=2, tmpdir=str(tmp_path),
                       gpu_fault_interval_s=0.4,
                       faults="k8sclient.fake.mutate=rate:0.005;"
                              "k8sclient.watch.drop=rate:0.005",
                       fault_seed=11)
        assert out["error_count"] == 0, out["errors"]
        assert not out["leaks"], out["leaks"]
        assert out["outcomes"]["stuck"] == 0
        assert out["unresolved_injections"] == 0
        assert out["slo_ok"]
        assert out["faults"]["injected"] > 0


class TestNodeLegs:
    def test_node_kill_and_partition_detected_and_rejoined(self, tmp_path):
        """Both node-scale legs in one run: node 0 killed, node 1
        partitioned from the API server; each is detected within twice
        the lease, uncordons and rejoins, and the fencing contract
        holds."""
        out = run_soak(duration_s=5.0, n_nodes=2, tmpdir=str(tmp_path),
                       gpu_fault_interval_s=0.0, lease_duration_s=0.6,
                       node_kill_at_s=1.0, partition_at_s=2.5,
                       partition_duration_s=1.2, recovery_slo_s=8.0)
        assert out["error_count"] == 0, out["errors"]
        assert not out["leaks"], out["leaks"]
        assert out["outcomes"]["stuck"] == 0, out["outcomes"]
        nf = out["node_failure"]
        assert nf["node_kills"] == 1 and nf["partitions"] == 1, nf
        assert nf["cordons"] >= 2 and nf["uncordons"] >= nf["cordons"], nf
        assert not nf["cordoned_at_end"], nf
        assert set(nf["detections_s"]) == {"node_kill", "partition"}, nf
        assert nf["split_brain_violations"] == 0, nf["split_brain_samples"]

    def test_fault_mix_names_gpulib_points(self):
        points = [part.split("=")[0] for part in SOAK_FAULT_MIX.split(";")]
        assert "gpulib.gpu.vanish" in points
        registered = faultpoints.registered()
        assert all(p in registered for p in points), points

    def test_crash_schedules_refused(self):
        with pytest.raises(ValueError, match="crash"):
            run_soak(duration_s=0.1, faults="cdi.write=crash:1")


@pytest.fixture(scope="module")
def serving_soak():
    return run_serving_soak(device="cpu")


def _assert_serving_oracle(r: dict, kill_node: str = "node-0") -> None:
    sv = r["serving"]
    assert r["error_count"] == 0, r["errors"]
    assert not r["leaks"], r["leaks"]
    assert r["outcomes"]["stuck"] == 0
    assert sv["fired_page"] and sv["cleared"], sv
    assert sv["pre_kill_pages"] == 0 and sv["fault_free_failures"] == 0, sv
    assert sv["bundle_captured"], sv
    assert sv["conservation_ok"], sv["conservation"]
    assert sv["green_after_rejoin"], sv
    assert sv["accounting"]["ok"], sv["accounting"]
    assert sv["ok_sessions"] > 0 and sv["error_sessions"] > 0, sv


class TestServingSoak:
    def test_oracle_whole_on_the_cpu(self, serving_soak):
        r = serving_soak
        _assert_serving_oracle(r)
        sv = r["serving"]
        assert sv["device"] == "cpu"
        assert sv["kv_isolation_max_err"] < 1e-4
        assert sv["detection_delay_s"] is not None
        assert sv["rejoin_after_kill_s"] is not None
        assert sv["clear_after_rejoin_s"] is not None
        for name, rep in sv["per_replica"].items():
            assert rep["accounted"], (name, rep)
            assert rep["ok"] > 0, (name, rep)
        # The replica pinned to the killed node took the errors.
        assert sv["per_replica"]["r0"]["errors"] > 0
        assert sv["per_replica"]["r1"]["errors"] == 0
        assert sv["decode_steps"] == sum(
            rep["decode_steps"] for rep in sv["per_replica"].values())
        assert sv["decode_tokens"] >= sv["decode_steps"] > 0

    @pytest.mark.skipif(torch.cuda.is_available(),
                        reason="checks the refusal on a machine without "
                               "a CUDA device")
    def test_the_card_is_the_default_and_refused_without_one(self):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_serving_soak(duration_s=0.5)


class TestAgainstJax:
    def test_serving_soak_outcomes_agree_with_jax(self, serving_soak):
        from k8s_dra_driver_tpu.internal.stresslab import (
            run_serving_soak as jax_run_serving_soak,
        )
        jr = jax_run_serving_soak(fault_seed=0)
        _assert_serving_oracle(jr)
        _assert_serving_oracle(serving_soak)
        jsv, psv = jr["serving"], serving_soak["serving"]
        for key in ("fired_page", "cleared", "bundle_captured",
                    "conservation_ok", "green_after_rejoin",
                    "pre_kill_pages", "fault_free_failures", "replicas",
                    "session_s", "deadline_s"):
            assert psv[key] == jsv[key], key
        assert psv["accounting"]["ok"] == jsv["accounting"]["ok"]
        for key in ("n_nodes", "workers", "errors", "leaks"):
            assert serving_soak[key] == jr[key], key
        assert (set(serving_soak["node_failure"]["detections_s"])
                == set(jr["node_failure"]["detections_s"]))
        assert serving_soak["node_failure"]["node_kills"] == \
            jr["node_failure"]["node_kills"] == 1


def test_the_smokes_soak_phase_on_the_cpu(capsys):
    """``chip_smoke.phase_soak`` as the card runs it, with the engines on
    the CPU at the JAX leg's width: the oracle whole, no kernel launch
    (the plain version runs there)."""
    import numpy as np

    import chip_smoke

    out = chip_smoke.phase_soak(
        "mock", np.random.default_rng(0), device="cpu",
        engine=dict(SOAK_SERVING_ENGINE, heads=2, head_dim=8))
    assert out["launches"] == 0 and out["decode_steps"] > 0
    assert out["max_abs_err"] is None      # the card's kernel check
    text = capsys.readouterr().out
    assert "[soak] replica=r0" in text and "clear_after_rejoin_s=" in text
