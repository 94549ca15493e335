"""The GPU port's fleet telemetry plane and SLO engine.

The scenarios of the JAX package's ``tests/test_telemetry.py`` (all but
``TestRunFleetwatch``, which ``test_torch_overhead.py`` holds) on the port's
``pkg/telemetry.py`` and ``pkg/slo.py``: the exposition parser's round
trip, the fleet scraper's per-target fault tolerance
(``telemetry.scrape``), cross-target aggregation, recording rules, the
multi-window burn-rate engine, and the assembled ``FleetTelemetry``
plane over real HTTP. ``TestAgainstJax`` holds the parser/renderer on a
corpus of both packages' families, and the rules and the engine on one
seeded counter series, against the JAX package."""

import math
import re
import threading
import time

import pytest

from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.pkg import faultpoints, slo as slolib, telemetry
from k8s_dra_driver_tpu_torch.pkg.events import (
    REASON_SLO_BURN_RATE_CLEARED,
    REASON_SLO_BURN_RATE_HIGH,
    EventRecorder,
    list_events,
)
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    Counter,
    DRAMetrics,
    Gauge,
    Histogram,
    MetricsServer,
    Registry,
)
from k8s_dra_driver_tpu_torch.pkg.telemetry import (
    Family,
    FleetAggregator,
    FleetMetrics,
    FleetScraper,
    FleetTelemetry,
    RecordingRules,
    Sample,
    fleet_family_name,
    parse_exposition,
    render_exposition,
    semantic_samples,
)

NASTY = 'back\\slash "quote"\nnewline'


def rich_registry() -> Registry:
    r = Registry()
    c = r.register(Counter("gpu_dra_requests_total", "reqs",
                           ("driver", "operation")))
    c.inc(3, driver="gpu", operation="prepare")
    c.inc(driver=NASTY, operation="unprepare")
    g = r.register(Gauge("gpu_dra_requests_inflight", "inflight",
                         ("driver", "operation")))
    g.set(2, driver="gpu", operation="prepare")
    h = r.register(Histogram("gpu_dra_request_duration_seconds", "dur",
                             (0.05, 0.1, 0.2), ("driver", "operation")))
    for v in (0.01, 0.07, 0.07, 0.15, 5.0):
        h.observe(v, driver="gpu", operation="prepare")
    return r


class TestExpositionParser:
    def test_round_trip_parse_what_we_emit(self):
        text = rich_registry().expose_text()
        fams = parse_exposition(text)
        assert fams["gpu_dra_requests_total"].type == "counter"
        assert fams["gpu_dra_requests_inflight"].type == "gauge"
        assert fams["gpu_dra_request_duration_seconds"].type == "histogram"
        # emit → parse → render → parse is a fixed point semantically.
        again = parse_exposition(render_exposition(fams.values()))
        assert semantic_samples(fams) == semantic_samples(again)

    def test_escaped_label_values_survive(self):
        text = rich_registry().expose_text()
        fams = parse_exposition(text)
        labels = [s.labels for s in
                  fams["gpu_dra_requests_total"].samples]
        assert {"driver": NASTY, "operation": "unprepare"} in labels
        # And the whole exposition stays line-parseable (no raw newline
        # leaked into the payload by the nasty value).
        for line in text.splitlines():
            assert not line.startswith("back")

    def test_bucket_cumulativity_and_count(self):
        fams = parse_exposition(rich_registry().expose_text())
        fam = fams["gpu_dra_request_duration_seconds"]
        buckets = sorted(
            (float(s.labels["le"]), s.value)
            for s in fam.samples if s.name.endswith("_bucket"))
        values = [v for _le, v in buckets]
        assert values == sorted(values), "bucket counts must be cumulative"
        count = next(s.value for s in fam.samples
                     if s.name.endswith("_count"))
        assert buckets[-1][0] == math.inf
        assert buckets[-1][1] == count == 5
        total = next(s.value for s in fam.samples
                     if s.name.endswith("_sum"))
        assert total == pytest.approx(0.01 + 0.07 + 0.07 + 0.15 + 5.0)

    def test_histogram_suffix_samples_join_their_family(self):
        fams = parse_exposition(rich_registry().expose_text())
        assert "gpu_dra_request_duration_seconds_bucket" not in fams
        names = {s.name for s in
                 fams["gpu_dra_request_duration_seconds"].samples}
        assert {"gpu_dra_request_duration_seconds_bucket",
                "gpu_dra_request_duration_seconds_sum",
                "gpu_dra_request_duration_seconds_count"} == names

    @pytest.mark.parametrize("bad", [
        "metric_no_value",
        'metric{l="unterminated} 1',
        'metric{l="x"} notanumber',
        'metric{noequals} 1',
    ])
    def test_malformed_lines_raise(self, bad):
        with pytest.raises(telemetry.ExpositionParseError):
            parse_exposition(bad)

    def test_inf_values_round_trip(self):
        fams = parse_exposition('m{le="+Inf"} 4\n')
        s = fams["m"].samples[0]
        assert s.labels["le"] == "+Inf" and s.value == 4
        assert 'le="+Inf"' in render_exposition(fams.values())

    def test_concurrent_scrape_while_observe(self):
        """4 writer threads hammer a registry while 30 scrapes parse it:
        every scrape must parse clean with monotone cumulative buckets
        (the exposition lock contract, shared with the emit-side test in
        test_observability)."""
        r = Registry()
        c = r.register(Counter("gpu_dra_requests_total", "r", ("w",)))
        h = r.register(Histogram("gpu_dra_request_duration_seconds", "d",
                                 (0.1, 1.0), ("w",)))
        stop = threading.Event()

        def writer(i: int) -> None:
            while not stop.is_set():
                c.inc(w=f"w{i}")
                h.observe(0.05 * (i + 1), w=f"w{i}")

        threads = [threading.Thread(target=writer, args=(i,), daemon=True)
                   for i in range(4)]
        for t in threads:
            t.start()
        try:
            for _ in range(30):
                fams = parse_exposition(r.expose_text())
                fam = fams.get("gpu_dra_request_duration_seconds")
                if fam is None:
                    continue
                by_series: dict[str, list[tuple[float, float]]] = {}
                for s in fam.samples:
                    if s.name.endswith("_bucket"):
                        by_series.setdefault(s.labels["w"], []).append(
                            (float(s.labels["le"]), s.value))
                for series in by_series.values():
                    vals = [v for _le, v in sorted(series)]
                    assert vals == sorted(vals)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)

    def test_fleet_naming_contract_matches_driverlint(self):
        """pkg/telemetry.fleet_family_name is the JAX driverlint's
        fleet_mirror_name under the prefix: every family the port's
        pkg/metrics.py declares mirrors as the JAX name's mirror does."""
        import sys
        from pathlib import Path
        root = Path(__file__).resolve().parents[1]
        if str(root) not in sys.path:
            sys.path.insert(0, str(root))
        from tools.analysis.invariants import fleet_mirror_name
        text = (root / "k8s_dra_driver_tpu_torch" / "pkg"
                / "metrics.py").read_text()
        names = set(re.findall(r'"(gpu_dra_[a-z0-9_]+)"', text))
        assert len(names) > 20
        for name in names:
            jax_name = "tpu_dra_" + name[len("gpu_dra_"):]
            assert fleet_family_name(name) == fleet_mirror_name(
                jax_name).replace("tpu_dra_", "gpu_dra_", 1)
        assert fleet_family_name("gpu_dra_fleet_targets") == \
            "gpu_dra_fleet_targets"  # no double prefix


class TestFleetScraper:
    def _registry(self, n: float) -> Registry:
        r = Registry()
        c = r.register(Counter("gpu_dra_requests_total", "r",
                               ("driver", "operation")))
        c.inc(n, driver="gpu", operation="prepare")
        return r

    def test_scrapes_real_metrics_server_over_http(self):
        srv = MetricsServer(self._registry(7)).start()
        try:
            scraper = FleetScraper([f"127.0.0.1:{srv.port}"],
                                   metrics=FleetMetrics())
            out = scraper.scrape_once()
            (fams,) = out.values()
            sample = fams["gpu_dra_requests_total"].samples[0]
            assert sample.value == 7
        finally:
            srv.stop()

    def test_injected_scrape_failure_absorbed_per_target(self):
        """``telemetry.scrape`` in schedule position: the first target's
        scrape fails, the round still returns the second target, nothing
        raises."""
        fm = FleetMetrics()
        texts = {"a": self._registry(1).expose_text(),
                 "b": self._registry(2).expose_text()}
        scraper = FleetScraper(
            [("a", "http://a/metrics"), ("b", "http://b/metrics")],
            metrics=fm, fetch=lambda name, url: texts[name])
        with faultpoints.injected("telemetry.scrape=nth:1"):
            out = scraper.scrape_once()
        assert sorted(out) == ["b"]
        assert fm.scrapes_total.value(outcome="error") == 1
        assert fm.scrapes_total.value(outcome="success") == 1
        # Next round is clean: both targets back.
        assert sorted(scraper.scrape_once()) == ["a", "b"]

    def test_target_stale_after_consecutive_failures_then_recovers(self):
        fm = FleetMetrics()
        good = self._registry(5).expose_text()
        fail = {"on": False}

        def fetch(name, url):
            if fail["on"]:
                raise OSError("connection refused")
            return good

        scraper = FleetScraper([("a", "http://a/metrics")], metrics=fm,
                               stale_after=3, fetch=fetch)
        assert sorted(scraper.scrape_once()) == ["a"]
        fail["on"] = True
        # Failures 1 and 2: last-good families still serve.
        assert sorted(scraper.scrape_once()) == ["a"]
        assert sorted(scraper.scrape_once()) == ["a"]
        # Failure 3: staleness-marked, excluded.
        assert scraper.scrape_once() == {}
        assert fm.targets.value(state="stale") == 1
        report = scraper.target_report()[0]
        assert report["stale"] and report["consecutive_failures"] == 3
        # One clean scrape: back in the pool.
        fail["on"] = False
        assert sorted(scraper.scrape_once()) == ["a"]
        assert fm.targets.value(state="up") == 1

    def test_corrupt_exposition_counts_as_scrape_failure(self):
        fm = FleetMetrics()
        scraper = FleetScraper(
            [("a", "http://a/metrics")], metrics=fm,
            fetch=lambda n, u: 'broken{l="x" 1')
        assert scraper.scrape_once() == {}
        assert fm.scrapes_total.value(outcome="error") == 1

    def test_down_http_target_never_fatal(self):
        scraper = FleetScraper(["127.0.0.1:1"], timeout_s=0.2,
                               metrics=FleetMetrics())
        assert scraper.scrape_once() == {}  # connection refused, absorbed


class TestFleetAggregator:
    def test_counters_and_gauges_sum_across_targets(self):
        fams_a = parse_exposition(rich_registry().expose_text())
        fams_b = parse_exposition(rich_registry().expose_text())
        merged = FleetAggregator().aggregate({"a": fams_a, "b": fams_b})
        fam = merged["gpu_dra_fleet_requests_total"]
        assert fam.type == "counter"
        by_labels = {tuple(sorted(s.labels.items())): s.value
                     for s in fam.samples}
        assert by_labels[(("driver", "gpu"),
                          ("operation", "prepare"))] == 6  # 3 + 3
        gauge = merged["gpu_dra_fleet_requests_inflight"].samples[0]
        assert gauge.value == 4  # fleet-wide occupancy 2 + 2

    def test_histograms_merge_bucketwise(self):
        fams_a = parse_exposition(rich_registry().expose_text())
        fams_b = parse_exposition(rich_registry().expose_text())
        merged = FleetAggregator().aggregate({"a": fams_a, "b": fams_b})
        fam = merged["gpu_dra_fleet_request_duration_seconds"]
        count = next(s.value for s in fam.samples
                     if s.name == "gpu_dra_fleet_request_duration_"
                     "seconds_count")
        assert count == 10
        buckets = sorted(
            (float(s.labels["le"]), s.value) for s in fam.samples
            if s.name.endswith("_bucket"))
        vals = [v for _le, v in buckets]
        assert vals == sorted(vals) and vals[-1] == 10

    def test_reserved_exposition_parses_back(self):
        agg = FleetAggregator()
        agg.aggregate({"a": parse_exposition(
            rich_registry().expose_text())})
        fams = parse_exposition(agg.expose_text())
        assert all(n.startswith("gpu_dra_fleet_") for n in fams)
        assert "gpu_dra_fleet_requests_total" in fams


def mk_counter_fams(req: float, err: float) -> dict:
    return {
        telemetry.FLEET_REQUESTS_TOTAL: Family(
            telemetry.FLEET_REQUESTS_TOTAL, "counter", samples=[
                Sample(telemetry.FLEET_REQUESTS_TOTAL,
                       {"driver": "gpu", "operation": "prepare"}, req)]),
        telemetry.FLEET_PREPARE_ERRORS: Family(
            telemetry.FLEET_PREPARE_ERRORS, "counter", samples=[
                Sample(telemetry.FLEET_PREPARE_ERRORS,
                       {"driver": "gpu", "error_type": "X"}, err)]),
    }


def mk_hist_fams(buckets: dict[float, float], total: float,
                 name: str = telemetry.FLEET_REQUEST_DURATION) -> dict:
    samples = [Sample(f"{name}_bucket",
                      {"operation": "prepare",
                       "le": "+Inf" if math.isinf(le) else str(le)}, v)
               for le, v in buckets.items()]
    samples.append(Sample(f"{name}_count", {"operation": "prepare"}, total))
    return {name: Family(name, "histogram", samples=samples)}


class TestRecordingRules:
    def setup_method(self):
        self.clk = [0.0]
        self.rules = RecordingRules(clock=lambda: self.clk[0],
                                    metrics=FleetMetrics())

    def feed(self, req, err, dt=1.0):
        self.clk[0] += dt
        self.rules.observe(mk_counter_fams(req, err))

    def test_increase_and_rate_over_window(self):
        for i in range(10):
            self.feed(req=10 * (i + 1), err=0)
        # Trailing 5 s window: 5 increments of 10.
        assert self.rules.increase(
            telemetry.FLEET_REQUESTS_TOTAL, 5.0) == pytest.approx(50)
        assert self.rules.rate(
            telemetry.FLEET_REQUESTS_TOTAL, 5.0) == pytest.approx(10)

    def test_counter_reset_detected(self):
        for v in (10, 20, 30):
            self.feed(req=v, err=0)
        self.feed(req=5, err=0)   # process restart: counter reset
        self.feed(req=15, err=0)
        # 10 + 10 (pre-reset) + 5 (post-reset start) + 10 = 35
        assert self.rules.increase(
            telemetry.FLEET_REQUESTS_TOTAL, 100.0) == pytest.approx(35)

    def test_no_data_returns_none(self):
        assert self.rules.increase("nope_total", 5.0) is None
        assert self.rules.ratio("a_total", "b_total", 5.0) is None

    def test_ratio_of_increases(self):
        self.feed(req=100, err=0)
        self.feed(req=200, err=10)
        assert self.rules.ratio(
            telemetry.FLEET_PREPARE_ERRORS, telemetry.FLEET_REQUESTS_TOTAL,
            10.0, den_match={"operation": "prepare"},
        ) == pytest.approx(0.1)

    def test_label_match_filters_series(self):
        self.feed(req=100, err=0)
        self.feed(req=200, err=0)
        assert self.rules.increase(
            telemetry.FLEET_REQUESTS_TOTAL, 10.0,
            match={"operation": "unprepare"}) is None

    def test_quantile_interpolates(self):
        clk = [0.0]
        rules = RecordingRules(clock=lambda: clk[0],
                               metrics=FleetMetrics())
        rules.observe(mk_hist_fams(
            {0.1: 0, 1.0: 0, math.inf: 0}, 0), now=0.0)
        clk[0] = 10.0
        # 50 obs ≤ 0.1, 90 ≤ 1.0, 100 total.
        rules.observe(mk_hist_fams(
            {0.1: 50, 1.0: 90, math.inf: 100}, 100), now=10.0)
        p50 = rules.quantile(telemetry.FLEET_REQUEST_DURATION, 0.50, 60.0)
        assert p50 == pytest.approx(0.1)
        p90 = rules.quantile(telemetry.FLEET_REQUEST_DURATION, 0.90, 60.0)
        assert p90 == pytest.approx(1.0)
        # q=0.95 lands in +Inf: Prometheus returns the highest finite le.
        assert rules.quantile(
            telemetry.FLEET_REQUEST_DURATION, 0.95, 60.0) == 1.0

    def test_bucket_good_ratio(self):
        clk = [0.0]
        rules = RecordingRules(clock=lambda: clk[0],
                               metrics=FleetMetrics())
        rules.observe(mk_hist_fams({0.8: 0, math.inf: 0}, 0), now=0.0)
        clk[0] = 5.0
        rules.observe(mk_hist_fams({0.8: 95, math.inf: 100}, 100), now=5.0)
        good = rules.bucket_good_ratio(
            telemetry.FLEET_REQUEST_DURATION, 0.8, 60.0)
        assert good == pytest.approx(0.95)

    def test_target_dropout_fabricates_no_increase(self):
        """Series are ringed PER TARGET: a staleness-excluded target
        dropping out of the scrape set must contribute ZERO increase —
        ringing the fleet SUM instead would read the drop as a counter
        reset and inject the surviving node's lifetime totals into every
        window (a false page)."""
        clk = [0.0]
        fm = FleetMetrics()
        rules = RecordingRules(clock=lambda: clk[0], metrics=fm)

        def base_fams(n: float) -> dict:
            return {"gpu_dra_requests_total": Family(
                "gpu_dra_requests_total", "counter", samples=[
                    Sample("gpu_dra_requests_total",
                           {"driver": "gpu", "operation": "prepare"}, n)])}

        # Two nodes with big lifetime counters, barely moving.
        for i in range(5):
            clk[0] += 1.0
            rules.observe_targets({"a": base_fams(100_000 + i),
                                   "b": base_fams(100_000 + i)})
        # Node a goes stale: excluded from the round entirely.
        for i in range(5, 10):
            clk[0] += 1.0
            rules.observe_targets({"b": base_fams(100_000 + i)})
        inc = rules.increase(telemetry.FLEET_REQUESTS_TOTAL, 20.0)
        assert inc == pytest.approx(9 + 4)  # b's 9 steps + a's 4 — no
        # 100k lifetime totals leaking in

    def test_target_rejoin_fabricates_no_increase(self):
        """A target rejoining after an outage resumes its own monotone
        series: the increase across the gap is its true delta, not a
        fleet-sum jump."""
        clk = [0.0]
        rules = RecordingRules(clock=lambda: clk[0],
                               metrics=FleetMetrics())

        def fams(n: float) -> dict:
            return {"gpu_dra_requests_total": Family(
                "gpu_dra_requests_total", "counter", samples=[
                    Sample("gpu_dra_requests_total",
                           {"driver": "gpu", "operation": "prepare"}, n)])}

        clk[0] = 1.0
        rules.observe_targets({"a": fams(50_000)})
        for t in (2.0, 3.0, 4.0):  # outage: a absent
            clk[0] = t
            rules.observe_targets({})
        clk[0] = 5.0
        rules.observe_targets({"a": fams(50_010)})
        assert rules.increase(
            telemetry.FLEET_REQUESTS_TOTAL, 10.0) == pytest.approx(10)

    def test_window_past_retention_counted_not_silent(self):
        """A query window reaching past the ring's retained span bumps
        gpu_dra_fleet_window_truncated_total — the 6h/3d production
        windows over an undersized ring must be visible."""
        clk = [0.0]
        fm = FleetMetrics()
        rules = RecordingRules(ring_capacity=4, clock=lambda: clk[0],
                               metrics=fm)
        for i in range(10):  # ring keeps only the last 4 points
            clk[0] += 1.0
            rules.observe(mk_counter_fams(10.0 * i, 0.0))
        assert rules.increase(telemetry.FLEET_REQUESTS_TOTAL,
                              100.0) is not None
        assert fm.window_truncated_total.value() >= 1
        before = fm.window_truncated_total.value()
        # A window inside retention does not count as truncated.
        rules.increase(telemetry.FLEET_REQUESTS_TOTAL, 2.0)
        assert fm.window_truncated_total.value() == before

    def test_series_cap_drops_counted_not_silent(self):
        fm = FleetMetrics()
        rules = RecordingRules(max_series=2, metrics=fm,
                               clock=lambda: 1.0)
        fams = {
            "c_total": Family("c_total", "counter", samples=[
                Sample("c_total", {"i": str(i)}, i) for i in range(5)])}
        rules.observe(fams)
        assert rules.series_count() == 2
        assert rules.dropped_series == 3
        assert fm.series_dropped_total.value() == 3


def scaled_windows():
    """Production window PAIRS compressed 3600× (page 83 ms/1 s is too
    twitchy for a fake-clock unit test, so use explicit seconds-scale
    pairs of the same shape)."""
    return (
        slolib.BurnWindow(slolib.SEVERITY_PAGE, 0.5, 2.0, 14.4),
        slolib.BurnWindow(slolib.SEVERITY_TICKET, 4.0, 12.0, 1.0),
    )


class TestSloEngine:
    def make(self, client=None, windows=None):
        self.clk = [0.0]
        self.rules = RecordingRules(clock=lambda: self.clk[0],
                                    metrics=FleetMetrics())
        slo = slolib.ratio_slo(
            "prepare_errors", 0.999,
            telemetry.FLEET_PREPARE_ERRORS, telemetry.FLEET_REQUESTS_TOTAL,
            total_match={"operation": "prepare"})
        events = (EventRecorder(client, "fleetwatch")
                  if client is not None else None)
        self.engine = slolib.SloEngine(
            self.rules, slos=(slo,),
            windows=windows or scaled_windows(),
            clock=lambda: self.clk[0], events=events,
            metrics=slolib.SloMetrics())
        return self.engine

    def run_traffic(self, steps, err_rate, req_rate=100, dt=0.1):
        """Advance the clock, feeding cumulative counters."""
        for _ in range(steps):
            self.clk[0] += dt
            self.state_req = getattr(self, "state_req", 0) + req_rate * dt
            self.state_err = (getattr(self, "state_err", 0)
                              + err_rate * req_rate * dt)
            self.rules.observe(mk_counter_fams(self.state_req,
                                               self.state_err))
            self.engine.evaluate()

    def test_fire_requires_both_windows(self):
        engine = self.make()
        # Clean traffic long enough to fill both windows.
        self.run_traffic(40, err_rate=0.0)
        assert engine.firing() == {}
        # A burst much hotter than 14.4 × the 0.1% budget.
        self.run_traffic(10, err_rate=0.5)
        firing = engine.firing()
        assert ("prepare_errors", slolib.SEVERITY_PAGE) in firing
        assert engine.fast_burn_firing()

    def test_short_blip_does_not_page(self):
        """One sub-short-window error spike: the LONG window gate keeps
        the page quiet (the whole point of multi-window alerting)."""
        engine = self.make(windows=(
            slolib.BurnWindow(slolib.SEVERITY_PAGE, 0.5, 8.0, 14.4),))
        self.run_traffic(60, err_rate=0.0)
        # 0.2 s of 2% errors: short-window burn 20x, but over the 8 s
        # long window the ratio is ~0.05% → burn < 1.
        self.run_traffic(2, err_rate=0.02)
        self.run_traffic(20, err_rate=0.0)
        assert engine.firing() == {}
        assert engine.transitions() == []

    def test_clears_when_short_window_recovers(self):
        engine = self.make()
        self.run_traffic(40, err_rate=0.0)
        self.run_traffic(15, err_rate=0.5)
        assert engine.fast_burn_firing()
        self.run_traffic(30, err_rate=0.0)
        assert not engine.fast_burn_firing()
        kinds = [(t.severity, t.transition) for t in engine.transitions()]
        assert (slolib.SEVERITY_PAGE, "fired") in kinds
        assert (slolib.SEVERITY_PAGE, "cleared") in kinds
        # fired strictly before cleared
        fired_i = kinds.index((slolib.SEVERITY_PAGE, "fired"))
        cleared_i = kinds.index((slolib.SEVERITY_PAGE, "cleared"))
        assert fired_i < cleared_i

    def test_transitions_recorded_as_events(self):
        client = FakeClient()
        engine = self.make(client=client)
        self.run_traffic(40, err_rate=0.0)
        self.run_traffic(15, err_rate=0.5)
        self.run_traffic(45, err_rate=0.0)
        high = list_events(client, reason=REASON_SLO_BURN_RATE_HIGH)
        cleared = list_events(client, reason=REASON_SLO_BURN_RATE_CLEARED)
        assert high and cleared
        assert high[0]["involvedObject"]["name"] == "prepare_errors"
        assert high[0]["type"] == "Warning"
        assert cleared[0]["type"] == "Normal"
        assert engine is not None

    def test_subscribers_notified_and_isolated(self):
        engine = self.make()
        seen = []
        engine.subscribe(lambda a: (_ for _ in ()).throw(
            RuntimeError("bad consumer")))
        engine.subscribe(seen.append)
        self.run_traffic(40, err_rate=0.0)
        self.run_traffic(15, err_rate=0.5)
        assert seen and seen[0].transition == "fired"
        assert seen[0].slo == "prepare_errors"

    def test_no_traffic_no_burn(self):
        engine = self.make()
        self.clk[0] += 100
        assert engine.evaluate() == []
        assert engine.firing() == {}

    def test_metrics_updated(self):
        engine = self.make()
        self.run_traffic(40, err_rate=0.0)
        self.run_traffic(15, err_rate=0.5)
        m = engine.metrics
        assert m.alert_firing.value(
            slo="prepare_errors", severity="page") == 1.0
        assert m.alert_transitions_total.value(
            slo="prepare_errors", severity="page", transition="fired") == 1
        assert m.burn_rate.value(
            slo="prepare_errors", severity="page", window="short") > 14.4
        remaining = m.error_budget_remaining.value(slo="prepare_errors")
        assert 0.0 <= remaining < 1.0

    def test_latency_slo_fires_on_slow_tail(self):
        clk = [0.0]
        rules = RecordingRules(clock=lambda: clk[0],
                               metrics=FleetMetrics())
        engine = slolib.SloEngine(
            rules,
            slos=(slolib.latency_slo("lat", 0.99,
                                     telemetry.FLEET_REQUEST_DURATION,
                                     threshold_le=0.8,
                                     match={"operation": "prepare"}),),
            windows=(slolib.BurnWindow("page", 0.5, 2.0, 10.0),),
            clock=lambda: clk[0], metrics=slolib.SloMetrics())
        good = total = 0.0
        for i in range(50):
            clk[0] += 0.1
            # After step 30, half of the new observations are slow.
            fast = 10 if i < 30 else 5
            good += fast
            total += 10
            rules.observe(mk_hist_fams(
                {0.8: good, math.inf: total}, total))
            engine.evaluate()
        assert ("lat", "page") in engine.firing()

    def test_compressed_windows_scale_and_validate(self):
        ws = slolib.compressed_windows(3600.0)
        assert ws[0].short_s == pytest.approx(300 / 3600)
        assert ws[0].threshold == 14.4
        with pytest.raises(ValueError):
            slolib.compressed_windows(0)
        with pytest.raises(ValueError):
            slolib.Slo("bad", 1.5, lambda r, w: None)


class TestFleetTelemetryPlane:
    def test_scrape_aggregate_rules_over_real_http(self):
        """Two live DRAMetrics registries behind real MetricsServers →
        one tick → fleet families + rule values, served back as
        exposition and /debug-shaped snapshot."""
        nodes = [DRAMetrics(), DRAMetrics()]
        servers = [MetricsServer(m.registry).start() for m in nodes]
        try:
            for m in nodes:
                for _ in range(20):
                    with m.timed_request("gpu.nvidia.com", "prepare"):
                        pass
            tel = FleetTelemetry(
                targets=[f"127.0.0.1:{s.port}" for s in servers],
                interval_s=999, rule_window_s=60.0,
                metrics=FleetMetrics())
            fams = tel.tick()
            req = next(
                s for s in fams["gpu_dra_fleet_requests_total"].samples
                if s.labels.get("operation") == "prepare")
            assert req.value == 40
            time.sleep(0.01)
            for m in nodes:
                with m.timed_request("gpu.nvidia.com", "prepare"):
                    pass
            tel.tick()
            values = tel.rule_values()
            assert values["claim_ready_p99_seconds"] is not None
            snap = tel.debug_snapshot()
            assert snap["ticks"] == 2
            assert len(snap["targets"]) == 2
            assert not snap["targets"][0]["stale"]
            assert "gpu_dra_fleet_requests_total" in snap["families"]
        finally:
            for s in servers:
                s.stop()

    def test_aggregate_served_by_metrics_server(self):
        """The aggregator duck-types a Registry: a MetricsServer serves
        the fleet families next to its own, and the result re-parses."""
        node = DRAMetrics()
        node_srv = MetricsServer(node.registry).start()
        try:
            with node.timed_request("gpu.nvidia.com", "prepare"):
                pass
            fm = FleetMetrics()
            tel = FleetTelemetry(targets=[f"127.0.0.1:{node_srv.port}"],
                                 interval_s=999, metrics=fm)
            tel.tick()
            ctrl_srv = MetricsServer(
                fm.registry, tel.aggregator,
                debug={"fleet": tel.debug_snapshot}).start()
            try:
                import json
                import urllib.request
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{ctrl_srv.port}/metrics",
                        timeout=5) as resp:
                    text = resp.read().decode()
                fams = parse_exposition(text)
                assert "gpu_dra_fleet_requests_total" in fams
                assert "gpu_dra_fleet_scrapes_total" in fams
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{ctrl_srv.port}/debug/fleet",
                        timeout=5) as resp:
                    snap = json.loads(resp.read().decode())
                assert snap["ticks"] == 1
            finally:
                ctrl_srv.stop()
        finally:
            node_srv.stop()

    def test_scrape_fault_during_tick_non_fatal(self):
        """telemetry.scrape firing inside a live tick: the tick
        completes, the other target still aggregates."""
        nodes = [DRAMetrics(), DRAMetrics()]
        servers = [MetricsServer(m.registry).start() for m in nodes]
        try:
            for m in nodes:
                with m.timed_request("gpu.nvidia.com", "prepare"):
                    pass
            tel = FleetTelemetry(
                targets=[f"127.0.0.1:{s.port}" for s in servers],
                interval_s=999, metrics=FleetMetrics())
            with faultpoints.injected("telemetry.scrape=nth:1"):
                fams = tel.tick()
            req = next(
                s for s in fams["gpu_dra_fleet_requests_total"].samples
                if s.labels.get("operation") == "prepare")
            assert req.value == 1  # one target dropped, one aggregated
        finally:
            for s in servers:
                s.stop()

    def test_fast_burn_alert_tightens_vanish_damping(self):
        """The remediation consumer end to end: a REAL SloEngine's
        fast_burn_firing drives the health monitor's flap damping — a
        single-poll vanish taints immediately while the page alert
        fires, and is damped once it clears."""
        from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
        from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
            DriverConfig,
            GpuDriver,
        )
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.health import (
            EVENT_GPU_LOST,
            attach_health_monitor,
        )
        import tempfile
        clk = [0.0]
        rules = RecordingRules(clock=lambda: clk[0], metrics=FleetMetrics())
        engine = slolib.SloEngine(
            rules,
            slos=(slolib.ratio_slo(
                "prepare_errors", 0.999,
                telemetry.FLEET_PREPARE_ERRORS,
                telemetry.FLEET_REQUESTS_TOTAL,
                total_match={"operation": "prepare"}),),
            windows=scaled_windows(), clock=lambda: clk[0],
            metrics=slolib.SloMetrics())
        client = FakeClient()
        client.create(new_object(
            "DeviceClass", "gpu.nvidia.com",
            spec={"selectors": [{"cel": {
                "expression": "device.attributes['type'] == 'gpu'"}}]}))
        with tempfile.TemporaryDirectory(prefix="fastburn-") as tmp:
            driver = GpuDriver(client, DriverConfig(
                node_name="node-a", state_dir=f"{tmp}/state",
                cdi_root=f"{tmp}/cdi", env={}, retry_timeout=0.5),
                device_lib=MockDeviceLib("h100-8")).start()
            monitor = attach_health_monitor(
                driver, start=False, vanish_grace=3,
                fast_drain=engine.fast_burn_firing)
            try:
                monitor.poll_once()
                lib = driver.state.device_lib
                real = lib.enumerate_gpus
                # Feed a burst → page alert fires.
                req = err = 0.0
                for i in range(60):
                    clk[0] += 0.1
                    req += 10
                    if i >= 40:
                        err += 5
                    rules.observe(mk_counter_fams(req, err))
                    engine.evaluate()
                assert engine.fast_burn_firing()
                lib.enumerate_gpus = lambda: [
                    g for g in real() if g.index != 5]
                events = monitor.poll_once()  # NOT damped: alert firing
                assert [e.event_type for e in events] == [EVENT_GPU_LOST]
                assert driver.device_taints()
            finally:
                driver.stop()



# -- held against the JAX package --------------------------------------------

def _jax():
    from k8s_dra_driver_tpu.pkg import slo as jslo, telemetry as jtel
    return jtel, jslo


def _registries(side: str) -> list:
    """One instance of every metrics class of one package, each on its own
    registry."""
    if side == "jax":
        from k8s_dra_driver_tpu.compute import serving as srv
        from k8s_dra_driver_tpu.pkg import (
            blackbox as bb, canary as cn, metrics as mt, slo as sl,
            telemetry as tl, usage as us,
        )
    else:
        from k8s_dra_driver_tpu_torch.compute import serving as srv
        from k8s_dra_driver_tpu_torch.pkg import (
            blackbox as bb, canary as cn, metrics as mt, slo as sl,
            telemetry as tl, usage as us,
        )
    classes = [getattr(mod, name) for mod in (mt, bb, cn, sl, tl, us, srv)
               for name in dir(mod)
               if name.endswith("Metrics") and name[0].isupper()
               and isinstance(getattr(mod, name), type)
               and getattr(mod, name).__module__ == mod.__name__]
    return [cls().registry for cls in classes]


def _fill(registry, seed: int) -> None:
    """Seeded values on every family: two label sets (one with the nasty
    value), three observations per histogram series, each with an
    explicit exemplar trace id."""
    import numpy as np
    rng = np.random.default_rng(seed)
    for m in list(registry._metrics):
        for k in range(2):
            labels = {n: (NASTY if k == 1 and i == 0 else f"v{k}{i}")
                      for i, n in enumerate(m.label_names)}
            if hasattr(m, "buckets"):
                for v in rng.exponential(0.5, 3):
                    m.observe(float(v), exemplar=f"{seed:04x}{k}", **labels)
            elif hasattr(m, "set"):
                m.set(float(rng.integers(0, 50)), **labels)
            else:
                m.inc(float(rng.integers(1, 50)), **labels)


class TestAgainstJax:
    def test_parse_then_render_equals_jax_on_both_registries(self):
        """Every family of both packages' registries, seeded, with escaped
        labels and exemplar lines, plus hand-written edge lines: the port
        parses and renders the same text as the JAX package, up to the
        family prefix."""
        jtel, _ = _jax()
        jax_regs, port_regs = _registries("jax"), _registries("port")
        assert len(port_regs) >= 14
        for i, r in enumerate(jax_regs):
            _fill(r, i)
        for i, r in enumerate(port_regs):
            _fill(r, 100 + i)
        extra = ('# HELP tpu_dra_extra_total extra "help"\n'
                 '# TYPE tpu_dra_extra_total counter\n'
                 'tpu_dra_extra_total{a="x\\\\y",b="q\\"z",c="n\\nl"} 3\n'
                 'tpu_dra_extra_total 1e-07\n'
                 '# EXEMPLAR tpu_dra_extra_total{a="1"} trace_id=abc '
                 'value=0.5 ts=12.5\n'
                 '# EXEMPLAR malformed\n'
                 'untyped_gauge{le="+Inf"} +Inf\n')
        corpus = ("".join(r.expose_text() for r in jax_regs)
                  + "".join(r.expose_text() for r in port_regs).replace(
                      "gpu_dra_", "tpu_dra_")
                  + extra)
        assert corpus.count("# EXEMPLAR") > 10
        jax_out = jtel.render_exposition(
            jtel.parse_exposition(corpus).values())
        port_out = render_exposition(parse_exposition(
            corpus.replace("tpu_dra_", "gpu_dra_")).values())
        assert port_out == jax_out.replace("tpu_dra_", "gpu_dra_")
        assert "\\n" in port_out and "# EXEMPLAR" in port_out

    def test_aggregate_matches_jax(self):
        jtel, _ = _jax()
        texts = [rich_registry().expose_text() for _ in range(3)]
        jax_fams = jtel.FleetAggregator().aggregate(
            {f"n{i}": jtel.parse_exposition(t.replace("gpu_dra_",
                                                      "tpu_dra_"))
             for i, t in enumerate(texts)})
        port_fams = FleetAggregator().aggregate(
            {f"n{i}": parse_exposition(t) for i, t in enumerate(texts)})
        assert render_exposition(port_fams.values()) == \
            jtel.render_exposition(jax_fams.values()).replace(
                "tpu_dra_", "gpu_dra_")

    def _run_side(self, side: str, seed: int) -> dict:
        """One seeded counter/histogram series (clean traffic, an error
        burst, a process restart's counter reset, a slow tail, recovery)
        through one package's RecordingRules, default rules and SloEngine
        on a fake clock."""
        import numpy as np
        jtel, jslo = _jax()
        tel, sl = (jtel, jslo) if side == "jax" else (telemetry, slolib)
        pre = "tpu_dra_" if side == "jax" else "gpu_dra_"
        clk = [0.0]
        fm = tel.FleetMetrics()
        rules = tel.RecordingRules(clock=lambda: clk[0], metrics=fm,
                                   ring_capacity=64)
        windows = (sl.BurnWindow(sl.SEVERITY_PAGE, 0.5, 2.0, 14.4),
                   sl.BurnWindow(sl.SEVERITY_TICKET, 4.0, 12.0, 1.0))
        slos = (*sl.default_slos(), sl.allocation_admission_slo(),
                sl.canary_availability_slo(), sl.claim_ready_slo())
        engine = sl.SloEngine(rules, slos=slos, windows=windows,
                              clock=lambda: clk[0],
                              metrics=sl.SloMetrics())
        rng = np.random.default_rng(seed)
        req = err = alloc_ok = alloc_frag = good = total = 0.0
        serve_ok = serve_err = 0.0
        burns, rule_vals = [], []
        for step in range(120):
            clk[0] += 0.1
            if step == 70:  # node-plugin restart: counters reset
                req = err = 0.0
            n = float(rng.integers(5, 20))
            req += n
            burst = 40 <= step < 60
            err += float(rng.binomial(int(n), 0.4 if burst else 0.0005))
            alloc_ok += float(rng.integers(0, 4))
            alloc_frag += float(rng.integers(0, 2)) if burst else 0.0
            total += n
            good += n - (float(rng.integers(0, int(n))) if burst else 0.0)
            serve_ok += 1.0
            serve_err += 1.0 if burst else 0.0
            lbl = {"driver": "x", "operation": "prepare"}
            fams = {
                pre + "requests_total": tel.Family(
                    pre + "requests_total", "counter", samples=[
                        tel.Sample(pre + "requests_total", lbl, req)]),
                pre + "node_prepare_errors_total": tel.Family(
                    pre + "node_prepare_errors_total", "counter", samples=[
                        tel.Sample(pre + "node_prepare_errors_total",
                                   {"error_type": "X"}, err)]),
                pre + "allocator_allocations_total": tel.Family(
                    pre + "allocator_allocations_total", "counter",
                    samples=[
                        tel.Sample(pre + "allocator_allocations_total",
                                   {"outcome": "ok"}, alloc_ok),
                        tel.Sample(pre + "allocator_allocations_total",
                                   {"outcome": "fragmented"}, alloc_frag)]),
                pre + "serving_claim_attempts_total": tel.Family(
                    pre + "serving_claim_attempts_total", "counter",
                    samples=[
                        tel.Sample(pre + "serving_claim_attempts_total",
                                   {"tenant": "t", "outcome": "ok"},
                                   serve_ok),
                        tel.Sample(pre + "serving_claim_attempts_total",
                                   {"tenant": "t", "outcome": "error"},
                                   serve_err)]),
                pre + "request_duration_seconds": tel.Family(
                    pre + "request_duration_seconds", "histogram",
                    samples=[
                        tel.Sample(pre + "request_duration_seconds_bucket",
                                   {**lbl, "le": le}, v)
                        for le, v in (("0.4", good * 0.9), ("0.8", good),
                                      ("+Inf", total))]),
            }
            rules.observe_targets({"node-0": fams})
            engine.evaluate()
            for s in engine.slos:
                for w in engine.windows:
                    burns.append((s.name, w.severity,
                                  s.burn_rate(rules, w.short_s),
                                  s.burn_rate(rules, w.long_s)))
            rule_vals.append([r.fn(rules, 3.0)
                              for r in tel.default_rules()])
        return {"burns": burns, "rules": rule_vals,
                "transitions": [(t.slo, t.severity, t.transition,
                                 t.burn_short, t.burn_long, t.threshold,
                                 round(t.at, 9))
                                for t in engine.transitions()],
                "truncated": fm.window_truncated_total.value()}

    @pytest.mark.parametrize("seed", [0, 1])
    def test_rules_and_engine_match_jax(self, seed):
        jax_run = self._run_side("jax", seed)
        port_run = self._run_side("port", seed)
        assert port_run["transitions"] == jax_run["transitions"]
        kinds = {(t[0], t[1], t[2]) for t in port_run["transitions"]}
        assert ("prepare_errors", "page", "fired") in kinds
        assert ("prepare_errors", "page", "cleared") in kinds
        assert ("claim_ready", "page", "fired") in kinds
        assert port_run["truncated"] == jax_run["truncated"]
        assert len(port_run["burns"]) == len(jax_run["burns"])
        for p, j in zip(port_run["burns"], jax_run["burns"]):
            assert p[:2] == j[:2]
            for a, b in zip(p[2:], j[2:]):
                assert (a is None) == (b is None)
                if a is not None:
                    assert abs(a - b) <= 1e-9
        for p, j in zip(port_run["rules"], jax_run["rules"]):
            for a, b in zip(p, j):
                assert (a is None) == (b is None)
                if a is not None:
                    assert abs(a - b) <= 1e-9
