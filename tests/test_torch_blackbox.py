"""The GPU port's flight recorder, timeline and chain audit.

The scenarios of the JAX package's ``tests/test_blackbox.py``
``TestTimeline``, ``TestChainAudit``, ``TestFlightRecorder``,
``TestDebugEndpoints`` and ``TestIncidentLeg`` (its node-kill soak) on the
port's ``pkg/blackbox.py``: the causally-ordered timeline, the
completeness chain, incident bundles captured on SLO transitions (under
injected API faults, with counted retention and schema versioning), and
``/debug/{slo,incidents}`` over HTTP. ``TestProfiler``, the
``TestLockContention`` cases but the ``TrackedLock`` one (which waits for
the sanitizer's lock-order tracking) and the overhead harness are held in
``test_torch_overhead.py``. ``TestExemplars`` and
``TestPrepareSpanEvents`` wait for the tracer. ``TestAgainstJax`` holds
``build_timeline`` and ``audit_timeline_chain`` against the JAX package on
seeded event lists, and one recorder's bundle on the same transitions."""

import json
import os
import random
import urllib.request

import pytest

from k8s_dra_driver_tpu_torch.internal.common import standard_debug_handlers
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.pkg import (
    blackbox,
    faultpoints,
    slo as slolib,
    tracing,
)
from k8s_dra_driver_tpu_torch.pkg.blackbox import (
    INCIDENT_CHAIN,
    BlackboxMetrics,
    ContinuousProfiler,
    FlightRecorder,
    attach_profiler_burst,
    audit_timeline_chain,
    build_timeline,
)
from k8s_dra_driver_tpu_torch.pkg.metrics import MetricsServer


def fired(slo="prepare_errors", severity="page", at=10.0):
    return slolib.AlertTransition(
        slo=slo, severity=severity, transition="fired",
        burn_short=20.0, burn_long=16.0, threshold=14.4, at=at)


def cleared(slo="prepare_errors", severity="page", at=20.0):
    return slolib.AlertTransition(
        slo=slo, severity=severity, transition="cleared",
        burn_short=0.1, burn_long=2.0, threshold=14.4, at=at)


# --------------------------------------------------------------------------
# Timeline
# --------------------------------------------------------------------------

class TestTimeline:
    def test_merges_all_sources_in_causal_order(self):
        events = [{"reason": "NodeFenced", "type": "Warning",
                   "firstTimestamp": 103.0, "lastTimestamp": 103.0,
                   "involvedObject": {"name": "node-0", "kind": "Node"},
                   "message": "fenced"}]
        transitions = [vars(fired(at=2.0)), vars(cleared(at=6.0))]
        spans = [{"trace_id": "t1", "span_id": "s1", "name": "prepare",
                  "start": 101.0, "end": 101.5, "status": "ok",
                  "events": [{"time": 101.2, "name": "fault.injected",
                              "attributes": {"point": "x"}}]}]
        points = [{"t": 1.5, "series": "errs", "value": 3, "delta": 1}]
        # Engine/rules clocks are monotonic: offset 100 places them on
        # the same wall axis as the events and spans.
        tl, truncated = build_timeline(
            events=events, transitions=transitions, spans=spans,
            metric_points=points, mono_offset=100.0)
        assert truncated == 0
        ts = [e["t"] for e in tl]
        assert ts == sorted(ts)
        kinds = [e["kind"] for e in tl]
        assert kinds.index("prepare") < kinds.index("fault.injected")
        assert "SloBurnRateHigh" in kinds and "SloBurnRateCleared" in kinds
        assert "NodeFenced" in kinds and "errs" in kinds
        assert tl[0]["kind"] == "prepare"          # 101.0 start edge
        assert tl[-1]["kind"] == "SloBurnRateCleared"   # 106.0

    def test_order_is_stable_under_input_shuffle(self):
        rng = random.Random(42)
        events = [{"reason": f"R{i % 3}", "type": "Normal",
                   "firstTimestamp": float(i % 7),
                   "lastTimestamp": float(i % 7),
                   "involvedObject": {"name": "x", "kind": "Pod"},
                   "message": ""} for i in range(30)]
        transitions = [vars(fired(at=float(i % 5))) for i in range(10)]
        ref, _ = build_timeline(events=events, transitions=transitions)
        for _ in range(5):
            ev = list(events)
            tr = list(transitions)
            rng.shuffle(ev)
            rng.shuffle(tr)
            got, _ = build_timeline(events=ev, transitions=tr)
            assert got == ref

    def test_truncation_drops_oldest_and_is_counted(self):
        events = [{"reason": "E", "type": "Normal",
                   "firstTimestamp": float(i), "lastTimestamp": float(i),
                   "involvedObject": {"name": "x", "kind": "Pod"},
                   "message": ""} for i in range(50)]
        tl, truncated = build_timeline(events=events, cap=10)
        assert truncated == 40
        assert len(tl) == 10
        # The recent edge survives; the oldest entries are the ones cut.
        assert tl[0]["t"] == 40.0 and tl[-1]["t"] == 49.0

    def test_count_aggregated_event_contributes_both_edges(self):
        events = [{"reason": "PrepareFailed", "type": "Warning",
                   "count": 9, "firstTimestamp": 1.0,
                   "lastTimestamp": 8.0,
                   "involvedObject": {"name": "c", "kind": "RC"},
                   "message": "boom"}]
        tl, _ = build_timeline(events=events)
        assert [e["t"] for e in tl] == [1.0, 8.0]
        assert tl[1]["detail"]["edge"] == "last"


class TestChainAudit:
    def _entry(self, t, kind):
        return {"t": t, "source": "event", "kind": kind, "detail": {}}

    def test_complete_chain_passes(self):
        tl = [self._entry(1.0, "DeviceTainted"),
              self._entry(2.0, "SloBurnRateHigh"),
              self._entry(3.0, "NodeFenced"),
              self._entry(4.0, "NodeUncordoned"),
              self._entry(5.0, "SloBurnRateCleared")]
        assert audit_timeline_chain(tl) == []

    def test_missing_stage_reported(self):
        tl = [self._entry(1.0, "DeviceTainted"),
              self._entry(2.0, "SloBurnRateHigh"),
              self._entry(4.0, "NodeUncordoned"),
              self._entry(5.0, "SloBurnRateCleared")]
        problems = audit_timeline_chain(tl)
        assert any("fence" in p for p in problems)

    def test_out_of_order_stage_reported(self):
        # The only clear precedes the burn: present, but not causal.
        tl = [self._entry(1.0, "DeviceTainted"),
              self._entry(1.5, "SloBurnRateCleared"),
              self._entry(2.0, "SloBurnRateHigh"),
              self._entry(3.0, "NodeFenced"),
              self._entry(4.0, "DeviceRejoined")]
        problems = audit_timeline_chain(tl)
        assert any("clear" in p for p in problems)

    def test_greedy_match_tolerates_early_extra_markers(self):
        # Markers repeating before AND after the causal chain must not
        # break it — the audit needs SOME ordered occurrence chain.
        tl = [self._entry(0.5, "SloBurnRateHigh"),   # early stray
              self._entry(1.0, "PrepareFailed"),
              self._entry(2.0, "SloBurnRateHigh"),
              self._entry(3.0, "NodeFenced"),
              self._entry(4.0, "NodeUncordoned"),
              self._entry(5.0, "SloBurnRateCleared")]
        assert audit_timeline_chain(tl) == []

    def test_shipped_chain_shape(self):
        stages = [s for s, _ in INCIDENT_CHAIN]
        assert stages == ["injection", "burn", "fence", "repair", "clear"]


# --------------------------------------------------------------------------
# Continuous profiler + lock contention
# --------------------------------------------------------------------------



# Flight recorder
# --------------------------------------------------------------------------

@pytest.fixture()
def client():
    c = FakeClient()
    c.create(new_object("Node", "node-0"))
    return c


class TestFlightRecorder:
    def test_fired_then_cleared_yields_resolved_bundle(self, tmp_path,
                                                       client):
        rec = FlightRecorder(str(tmp_path), client=client,
                             metrics=BlackboxMetrics())
        rec.on_alert(fired())
        assert [b["status"] for b in rec.list_bundles()] == ["open"]
        rec.on_alert(cleared())
        bundles = rec.list_bundles()
        assert [b["status"] for b in bundles] == ["resolved"]
        doc = rec.bundle(bundles[0]["id"])
        assert doc["version"] == blackbox.BUNDLE_VERSION
        assert doc["status"] == "resolved"
        assert doc["trigger"]["transition"] == "fired"
        assert doc["cleared"]["transition"] == "cleared"
        assert not doc["partial"]
        assert "events" in doc["sections"]
        assert "nodelease" in doc["sections"]
        assert isinstance(doc["timeline"], list)
        # Atomic publish: no tmp files left behind.
        assert not [f for f in os.listdir(rec.dir)
                    if f.endswith(".tmp")]

    def test_unmatched_cleared_is_ignored(self, tmp_path, client):
        rec = FlightRecorder(str(tmp_path), client=client,
                             metrics=BlackboxMetrics())
        rec.on_alert(cleared())
        assert rec.list_bundles() == []
        assert rec.capture_errors == 0

    def test_retention_evicts_oldest_and_counts(self, tmp_path, client):
        m = BlackboxMetrics()
        rec = FlightRecorder(str(tmp_path), client=client, retention=2,
                             metrics=m)
        for i in range(4):
            rec.on_alert(fired(slo=f"s{i}"))
            rec.on_alert(cleared(slo=f"s{i}"))
        files = sorted(os.listdir(rec.dir))
        assert len(files) == 2
        assert all("s2" in f or "s3" in f for f in files)
        assert rec.evicted == 2
        assert m.bundles_evicted_total.value() == 2

    def test_failing_section_marks_partial_never_raises(self, tmp_path,
                                                        client):
        m = BlackboxMetrics()

        def broken():
            raise RuntimeError("snapshot exploded")

        rec = FlightRecorder(str(tmp_path), client=client,
                             debug={"broken": broken}, metrics=m)
        rec.on_alert(fired())
        doc = rec.bundle(rec.list_bundles()[0]["id"])
        assert doc["partial"] is True
        assert "debug.broken" in doc["partial_sections"]
        assert "error" in doc["sections"]["debug.broken"]
        assert m.capture_section_failures_total.value(
            section="debug.broken") > 0
        assert m.bundles_total.value(outcome="partial") == 1
        assert rec.capture_errors == 0

    def test_injected_api_faults_mid_capture_degrade_to_partial(
            self, tmp_path, client):
        """The EventRecorder discipline under the chaos tier's verbs:
        every API read failing (rate:1.0 beats the bounded section
        retries) costs the API-backed sections, never the capture."""
        rec = FlightRecorder(str(tmp_path), client=client,
                             metrics=BlackboxMetrics())
        with faultpoints.injected("k8sclient.fake.read=rate:1.0"):
            rec.on_alert(fired())
        assert rec.capture_errors == 0
        doc = rec.bundle(rec.list_bundles()[0]["id"])
        assert doc["partial"] is True
        assert "events" in doc["partial_sections"]
        # A later clean capture of the same incident is complete again.
        rec.on_alert(cleared())
        doc = rec.bundle(rec.list_bundles()[0]["id"])
        assert doc["status"] == "resolved" and not doc["partial"]

    def test_bundle_reader_refuses_future_schema(self, tmp_path, client):
        rec = FlightRecorder(str(tmp_path), client=client,
                             metrics=BlackboxMetrics())
        rec.on_alert(fired())
        bid = rec.list_bundles()[0]["id"]
        path = os.path.join(rec.dir, f"{bid}.json")
        doc = json.load(open(path))
        doc["version"] = blackbox.BUNDLE_VERSION + 1
        json.dump(doc, open(path, "w"))
        with pytest.raises(ValueError, match="future schema"):
            rec.bundle(bid)

    def test_capture_timeline_carries_slo_and_events(self, tmp_path,
                                                     client):
        from k8s_dra_driver_tpu_torch.pkg.events import EventRecorder
        ev = EventRecorder(client, "test")
        ev.event(client.get("Node", "node-0"), "NodeFenced", "fenced",
                 "Warning")
        rec = FlightRecorder(str(tmp_path), client=client,
                             metrics=BlackboxMetrics())
        rec.on_alert(fired())
        doc = rec.bundle(rec.list_bundles()[0]["id"])
        kinds = {e["kind"] for e in doc["timeline"]}
        assert "NodeFenced" in kinds
        # The fired transition itself is part of the record via the
        # engine only; with no engine wired the slo sections are absent.
        assert "slo" not in doc["sections"]

    def test_debug_snapshot_serves_index_and_latest(self, tmp_path,
                                                    client):
        rec = FlightRecorder(str(tmp_path), client=client,
                             metrics=BlackboxMetrics())
        rec.on_alert(fired())
        rec.on_alert(cleared())
        snap = rec.debug_snapshot()
        assert snap["captures"] == 2
        assert snap["open"] == []
        assert snap["bundles"][0]["status"] == "resolved"
        assert snap["latest"]["status"] == "resolved"
        assert snap["capture_errors"] == 0

    def test_profiler_burst_follows_engine_firing(self, tmp_path, client):
        engine = slolib.SloEngine(rules=None, slos=slolib.default_slos(),
                                  metrics=slolib.SloMetrics())
        prof = ContinuousProfiler(metrics=BlackboxMetrics())
        rec = FlightRecorder(str(tmp_path), client=client, engine=engine,
                             profiler=prof, metrics=BlackboxMetrics())
        engine.subscribe(rec.on_alert)
        tr = engine._transition(engine.slos[0], engine.windows[0],
                                "fired", 20.0, 16.0, 1.0)
        assert prof.snapshot()["burst"]
        assert rec.list_bundles()[0]["status"] == "open"
        # Bundle carries the profiler section.
        doc = rec.bundle(rec.list_bundles()[0]["id"])
        assert "stacks" in doc["sections"]["profile"]
        engine._transition(engine.slos[0], engine.windows[0],
                           "cleared", 0.0, 0.0, 2.0)
        assert not prof.snapshot()["burst"]
        assert tr.transition == "fired"


# --------------------------------------------------------------------------
# Debug endpoints
# --------------------------------------------------------------------------

class TestDebugEndpoints:
    def test_standard_handlers_include_the_new_endpoints(self):
        handlers = standard_debug_handlers()
        for name in ("slo", "nodelease", "incidents", "profile"):
            assert name in handlers
            handlers[name]()  # callable without any live component

    def test_served_over_http_with_live_components(self, tmp_path,
                                                   client):
        engine = slolib.SloEngine(rules=None, slos=slolib.default_slos(),
                                  metrics=slolib.SloMetrics())
        rec = FlightRecorder(str(tmp_path), client=client, engine=engine,
                             metrics=BlackboxMetrics())
        engine.subscribe(rec.on_alert)
        engine._transition(engine.slos[0], engine.windows[0], "fired",
                           20.0, 16.0, 1.0)
        from k8s_dra_driver_tpu_torch.pkg.metrics import Registry
        srv = MetricsServer(Registry(), port=0,
                            debug=standard_debug_handlers()).start()
        try:
            def get(path):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}{path}",
                        timeout=5.0) as resp:
                    return json.loads(resp.read().decode())

            slo_doc = get("/debug/slo")
            assert any(e.get("firing") for e in slo_doc
                       if isinstance(e, dict))
            incidents = get("/debug/incidents")
            assert any(r.get("captures", 0) >= 1 for r in incidents
                       if isinstance(r, dict))
            nodelease = get("/debug/nodelease")
            assert "heartbeats" in nodelease
            get("/debug/profile")
        finally:
            srv.stop()


# --------------------------------------------------------------------------
# Span events replacing the t_prep_* debug log lines
# --------------------------------------------------------------------------



class TestIncidentLeg:
    def test_node_kill_soak_captures_complete_timeline(self):
        from k8s_dra_driver_tpu_torch.internal.stresslab import run_soak
        r = run_soak(duration_s=6.0, gpu_fault_interval_s=0.8,
                     lease_duration_s=1.2, node_kill_at_s=1.2,
                     recovery_slo_s=8.0, blackbox=True)
        # A string message: pytest cuts a non-string one at 240 characters,
        # which hid which quiesce condition held and which claim stuck.
        assert r["error_count"] == 0, "\n".join(map(str, r["errors"]))
        assert not r["leaks"], r["leaks"]
        assert r["outcomes"]["stuck"] == 0
        bb = r["blackbox"]
        assert bb["resolved"] >= 1
        assert bb["timeline_complete"] >= 1, bb["audit_samples"]
        assert bb["http_timeline_complete"] >= 1
        assert bb["capture_errors"] == 0
        assert bb["profiler"]["samples"]["burst"] > 0


class TestPortSurface:
    def test_attach_profiler_burst_follows_engine(self):
        engine = slolib.SloEngine(rules=None, slos=slolib.default_slos(),
                                  metrics=slolib.SloMetrics())
        prof = ContinuousProfiler(metrics=BlackboxMetrics())
        attach_profiler_burst(engine, prof)
        engine._transition(engine.slos[0], engine.windows[0], "fired",
                           20.0, 16.0, 1.0)
        assert prof.snapshot()["burst"]
        engine._transition(engine.slos[0], engine.windows[0], "cleared",
                           0.0, 0.0, 2.0)
        assert not prof.snapshot()["burst"]

    def test_disabled_tracer_leaves_the_trace_section_empty(self, tmp_path,
                                                            client):
        """A recorder wired to the tracer while tracing is off captures an
        empty trace section, not a made-up one."""
        rec = FlightRecorder(str(tmp_path), client=client,
                             tracer=tracing.default_tracer(),
                             metrics=BlackboxMetrics())
        rec.on_alert(fired())
        doc = rec.bundle(rec.list_bundles()[0]["id"])
        assert doc["sections"]["traces"] == {"spans": [], "dropped": 0}
        assert not doc["partial"]
        assert not [e for e in doc["timeline"] if e["source"] == "span"]


# -- held against the JAX package --------------------------------------------

_KINDS = ("PrepareFailed", "DeviceTainted", "NodeFenced", "NodeUncordoned",
          "DeviceRejoined", "ClaimDrained", "fault.injected")


def _seeded_streams(seed: int) -> dict:
    """Events (some count-aggregated), SLO transitions, spans with span
    events and metric points, on a shuffled order with ties."""
    rng = random.Random(seed)
    events = []
    for i in range(40):
        first = float(rng.randrange(0, 30))
        last = first + (rng.choice((0.0, 0.0, 2.5)))
        events.append({"reason": rng.choice(_KINDS),
                       "type": rng.choice(("Normal", "Warning")),
                       "count": rng.randrange(1, 4),
                       "firstTimestamp": first, "lastTimestamp": last,
                       "involvedObject": {"name": f"o{i % 5}",
                                          "kind": "Node"},
                       "message": "m" * rng.randrange(0, 300)})
    transitions = [vars(fired(at=float(rng.randrange(0, 20))))
                   for _ in range(3)]
    transitions += [vars(cleared(at=float(rng.randrange(10, 30))))
                    for _ in range(3)]
    spans = [{"trace_id": f"t{i}", "span_id": f"s{i}", "name": "prepare",
              "start": float(rng.randrange(0, 30)), "end": 31.0,
              "status": "ok",
              "events": [{"time": float(rng.randrange(0, 30)),
                          "name": "fault.injected",
                          "attributes": {"point": "x"}}]}
             for i in range(4)]
    points = [{"t": float(rng.randrange(0, 30)), "series": f"s{i % 3}",
               "value": i, "delta": 1} for i in range(10)]
    for xs in (events, transitions, spans, points):
        rng.shuffle(xs)
    return {"events": events, "transitions": transitions, "spans": spans,
            "metric_points": points}


class TestAgainstJax:
    @pytest.mark.parametrize("seed", range(6))
    def test_timeline_and_audit_match_jax(self, seed):
        from k8s_dra_driver_tpu.pkg import blackbox as jbb
        streams = _seeded_streams(seed)
        for offset, cap in ((0.0, 2000), (3.5, 25)):
            jax_tl = jbb.build_timeline(**streams, mono_offset=offset,
                                        cap=cap)
            port_tl = build_timeline(**streams, mono_offset=offset, cap=cap)
            assert port_tl == jax_tl
            assert audit_timeline_chain(port_tl[0]) == \
                jbb.audit_timeline_chain(jax_tl[0])
        # The chain itself, and a verdict on a list cut at each stage.
        assert INCIDENT_CHAIN == jbb.INCIDENT_CHAIN
        tl = build_timeline(**streams)[0]
        for k in range(len(tl)):
            assert audit_timeline_chain(tl[k:]) == \
                jbb.audit_timeline_chain(tl[k:])

    def test_bundle_matches_jax_on_the_same_incident(self, tmp_path):
        """One fired→cleared incident over a cluster with a fenced-node
        Event and a lease, through both packages' recorders: the same
        sections, the same timeline kinds in order, the same index."""
        from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxFakeClient
        from k8s_dra_driver_tpu.k8sclient.client import (
            new_object as jax_new_object,
        )
        from k8s_dra_driver_tpu.pkg import blackbox as jbb, slo as jslo
        from k8s_dra_driver_tpu.pkg.events import (
            EventRecorder as JaxEventRecorder,
        )
        from k8s_dra_driver_tpu_torch.pkg.events import EventRecorder

        def run(side):
            if side == "jax":
                cl, new, ev, bb, sl = (JaxFakeClient(), jax_new_object,
                                       JaxEventRecorder, jbb, jslo)
            else:
                cl, new, ev, bb, sl = (FakeClient(), new_object,
                                       EventRecorder, blackbox, slolib)
            cl.create(new("Node", "node-0"))
            ev(cl, "test").event(cl.get("Node", "node-0"), "NodeFenced",
                                 "fenced", "Warning")
            rec = bb.FlightRecorder(str(tmp_path / side), client=cl,
                                    metrics=bb.BlackboxMetrics(),
                                    debug={"x": lambda: {"a": 1}})
            for tr in ("fired", "cleared"):
                rec.on_alert(sl.AlertTransition(
                    slo="claim_ready", severity="page", transition=tr,
                    burn_short=20.0, burn_long=16.0, threshold=14.4,
                    at=1.0))
            doc = rec.bundle(rec.list_bundles()[0]["id"])
            return rec, doc

        jrec, jdoc = run("jax")
        prec, pdoc = run("port")
        assert sorted(pdoc["sections"]) == sorted(jdoc["sections"])
        assert [(e["source"], e["kind"]) for e in pdoc["timeline"]] == \
            [(e["source"], e["kind"]) for e in jdoc["timeline"]]
        for k in ("version", "id", "status", "trigger", "cleared",
                  "partial", "partial_sections", "timeline_truncated"):
            assert pdoc[k] == jdoc[k], k
        strip = ("file", "opened_at", "resolved_at")
        assert [{k: v for k, v in m.items() if k not in strip}
                for m in prec.list_bundles()] == \
            [{k: v for k, v in m.items() if k not in strip}
             for m in jrec.list_bundles()]
