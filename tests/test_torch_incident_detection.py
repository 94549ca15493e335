"""The first failed prepare after a node loss, as the burn-rate alert sees it.

The node-kill soak's incident leg
(``tests/test_torch_blackbox.py::TestIncidentLeg``) needs the
``prepare_errors`` alert to fire before the lease-expiry fence (1.5 leases
after the kill): the oracle audits each incident bundle's timeline for
injection → burn → fence → repair → clear, in that order. A node exports
its failed prepares as ``gpu_dra_node_prepare_errors_total{error_type}``,
a series that exists only from the first failure of its kind. The fleet's
recording rules took a series' first point as its baseline, so the first
failed request after the kill (0.3–0.6 s after it) counted for nothing and
the alert fired only on the second (0.9–1.2 s after it). Beside fsyncing
writers and other test processes on an 8-core machine the second came
after the fence in 3 of 48 soaks (``python -m
k8s_dra_driver_tpu_torch.internal.soakload --runs 8 --hogs 8
--disk-writers 8 --rounds 6``): every bundle lacked the burn before the
fence, on disk and over ``/debug/incidents``. The port's rules now open
a series that a target's previous snapshot lacked with a zero at that
snapshot's time; the JAX package's rules keep the first point as the
baseline (pinned last).
"""

from __future__ import annotations

import json
import os

import pytest

from k8s_dra_driver_tpu_torch.internal import soakload
from k8s_dra_driver_tpu_torch.pkg import slo as slolib, telemetry
from k8s_dra_driver_tpu_torch.pkg.metrics import DRAMetrics
from k8s_dra_driver_tpu_torch.pkg.telemetry import (
    FleetMetrics,
    RecordingRules,
    parse_exposition,
)

DRIVER = "gpu.nvidia.com"
TICK_S = 0.05


def _scrape(metrics) -> dict:
    return parse_exposition(metrics.registry.expose_text())


def _request(metrics, failed: bool, driver: str = DRIVER) -> None:
    metrics.requests_total.inc(driver=driver, operation="prepare")
    if failed:
        metrics.node_prepare_errors_total.inc(driver=driver,
                                              error_type="InjectedFault")


class TestSeriesBornBetweenSnapshots:
    def setup_method(self):
        self.clk = [0.0]
        self.rules = RecordingRules(clock=lambda: self.clk[0],
                                    metrics=FleetMetrics())
        self.node = DRAMetrics()

    def observe(self, t: float, target: str = "node-1") -> None:
        self.clk[0] = t
        self.rules.observe_targets({target: _scrape(self.node)})

    def test_the_first_failure_of_a_kind_counts(self):
        for i in range(4):
            _request(self.node, failed=False)
            self.observe(0.1 * (i + 1))
        _request(self.node, failed=True)
        self.observe(0.5)
        assert self.rules.increase(telemetry.FLEET_PREPARE_ERRORS,
                                   0.3) == pytest.approx(1.0)
        assert self.rules.ratio(
            telemetry.FLEET_PREPARE_ERRORS, telemetry.FLEET_REQUESTS_TOTAL,
            0.08, den_match={"operation": "prepare"}) == pytest.approx(1.0)
        _request(self.node, failed=True)
        self.observe(0.6)
        assert self.rules.increase(telemetry.FLEET_PREPARE_ERRORS,
                                   1.0) == pytest.approx(2.0)

    def test_a_targets_first_snapshot_is_its_baseline(self):
        # Telemetry that starts beside a node with a history: its lifetime
        # totals are not burn.
        for _ in range(5):
            _request(self.node, failed=True)
        self.observe(1.0)
        assert self.rules.increase(telemetry.FLEET_PREPARE_ERRORS,
                                   10.0) is None
        self.observe(1.1)
        assert self.rules.increase(telemetry.FLEET_PREPARE_ERRORS,
                                   10.0) == pytest.approx(0.0)

    def test_a_series_born_while_its_target_was_away(self):
        # Scraped healthy, then absent (down), then back as a restarted
        # process whose first request failed: that failure and the reset
        # request counter both count once.
        for i in range(3):
            _request(self.node, failed=False)
            self.observe(0.1 * (i + 1))
        for t in (0.4, 0.5, 0.6):
            self.clk[0] = t
            self.rules.observe_targets({})
        self.node = DRAMetrics()
        _request(self.node, failed=True)
        self.observe(0.7)
        assert self.rules.increase(telemetry.FLEET_PREPARE_ERRORS,
                                   0.2) == pytest.approx(1.0)
        assert self.rules.increase(telemetry.FLEET_REQUESTS_TOTAL,
                                   0.2) == pytest.approx(1.0)

    def test_each_target_keeps_its_own_bound(self):
        # node-2 is first seen holding a failure: its baseline. node-1's
        # failure is born between two of its snapshots: counted.
        self.observe(0.1, "node-1")
        other = DRAMetrics()
        _request(other, failed=True)
        self.clk[0] = 0.2
        self.rules.observe_targets({"node-2": _scrape(other)})
        _request(self.node, failed=True)
        self.observe(0.3, "node-1")
        assert self.rules.increase(telemetry.FLEET_PREPARE_ERRORS,
                                   1.0) == pytest.approx(1.0)


def _first_page_after_kill(side: str) -> tuple[float, float]:
    """The incident leg's SLO pair (objective 0.99; page 0.3/1.0 s at
    14.4, ticket 2.4/7.2 s at 1.0) over one node scraped every 50 ms:
    healthy prepares every 0.25 s up to the kill at 2.0 s, then every
    request fails, one each 0.3 s from 2.35 s (the soak's pattern).
    Returns (the first failed request's time, the page's)."""
    if side == "port":
        metrics, tel, sl, driver = DRAMetrics(), telemetry, slolib, DRIVER
    else:
        from k8s_dra_driver_tpu.pkg import slo as jslo, telemetry as jtel
        from k8s_dra_driver_tpu.pkg.metrics import DRAMetrics as JaxMetrics
        metrics, tel, sl, driver = JaxMetrics(), jtel, jslo, "tpu.google.com"
    clk = [0.0]
    rules = tel.RecordingRules(clock=lambda: clk[0],
                               metrics=tel.FleetMetrics())
    engine = sl.SloEngine(
        rules,
        slos=(sl.ratio_slo("prepare_errors_incident", 0.99,
                           tel.FLEET_PREPARE_ERRORS, tel.FLEET_REQUESTS_TOTAL,
                           total_match={"operation": "prepare"}),),
        windows=(sl.BurnWindow(sl.SEVERITY_PAGE, 0.3, 1.0, 14.4),
                 sl.BurnWindow(sl.SEVERITY_TICKET, 2.4, 7.2, 1.0)),
        clock=lambda: clk[0], metrics=sl.SloMetrics())
    first_failure = None
    for k in range(1, 101):
        t = round(k * TICK_S, 6)
        if k <= 40 and k % 5 == 0:
            _request(metrics, failed=False, driver=driver)
        elif k >= 47 and (k - 47) % 6 == 0:
            _request(metrics, failed=True, driver=driver)
            if first_failure is None:
                first_failure = t
        clk[0] = t
        rules.observe_targets({"node-1": tel.parse_exposition(
            metrics.registry.expose_text())})
        for tr in engine.evaluate():
            if (tr.severity, tr.transition) == (sl.SEVERITY_PAGE, "fired"):
                return first_failure, t
    raise AssertionError("the page never fired")


class TestIncidentPage:
    def test_the_first_failed_prepare_pages(self):
        first_failure, paged = _first_page_after_kill("port")
        assert (first_failure, paged) == (2.35, 2.35)

    def test_jax_pages_on_the_second_failed_prepare(self):
        """The JAX package's rules, which stay as they are, take the
        failure series' first point as its baseline: its page waits for the
        second failed request, 0.3 s later here (0.6 s in the soak)."""
        first_failure, paged = _first_page_after_kill("jax")
        assert (first_failure, paged) == (2.35, 2.65)


# A soak stand-in for soakload's round: reports where its temporary files
# go and what the disk writers left there.
_STAND_IN = """
import json, os, tempfile, time
d = tempfile.gettempdir()
deadline = time.monotonic() + 30.0
while time.monotonic() < deadline and not any(
        n.startswith("w") and not n.endswith(".tmp") for n in os.listdir(d)):
    time.sleep(0.05)
print("RESULT ok")
print(json.dumps({"dir": d, "names": sorted(os.listdir(d))}))
"""


class TestSoakloadDiskWriters:
    def test_writers_share_the_rounds_directory(self, monkeypatch):
        monkeypatch.setattr(soakload, "_SOAK", _STAND_IN)
        (verdict,) = soakload.run_round(runs=1, hogs=0, timeout=60.0,
                                        disk_writers=2)
        assert verdict["result"] == "ok"
        seen = json.loads(verdict["detail"])
        assert os.path.basename(seen["dir"]).startswith("soakload-")
        writers = {n.split("-")[0] for n in seen["names"]
                   if n.startswith("w") and not n.endswith(".tmp")}
        assert writers
        # The round's directory, the writers' files in it, went with the
        # round.
        assert not os.path.exists(seen["dir"])

    def test_summary_names_the_writers(self, monkeypatch, capsys):
        monkeypatch.setattr(soakload, "_SOAK", _STAND_IN)
        assert soakload.main(["--runs", "1", "--hogs", "0",
                              "--disk-writers", "1", "--rounds", "1"]) == 0
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert last.startswith("SUMMARY ")
        summary = json.loads(last[len("SUMMARY "):])
        assert (summary["disk_writers"], summary["ok"]) == (1, 1)
